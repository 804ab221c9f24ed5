"""Run one function in N spawned processes that form a process group.

`Ranks(fn, devices, backend).start()` spawns one process per entry of
`devices`; rank r sets its device, joins the group (parallel/mesh.py::init,
a file:// store in the work directory, every collective with a timeout),
calls fn(device, *args) and saves what fn returns. `join()` waits with a
deadline, ends every process still running at the deadline, raises on any
rank's failure (with its traceback) and returns the ranks' results in rank
order, loaded on the CPU (a failed rank ends the others at once). The
caller may work between start() and join():
the ranks run meanwhile. `fn` must be importable by its module name (spawn).

Used by graft_entry.dryrun_multichip, the multi-rank tests and
chip_smoke.py's parallel phase.
"""
from __future__ import annotations

import multiprocessing
import os
import shutil
import tempfile
import time
import traceback

import torch

from . import mesh as pmesh


def _rank_main(fn, args, r, devices, backend, init_method, out_dir, timeout_s, threads):
    device = torch.device(devices[r])
    if threads:
        torch.set_num_threads(threads)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    try:
        pmesh.init(backend, init_method, len(devices), r, device, timeout_s)
        out = fn(device, *args)
        tmp = os.path.join(out_dir, f"rank{r}.pt.tmp")
        torch.save(out, tmp)
        os.replace(tmp, os.path.join(out_dir, f"rank{r}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{r}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        pmesh.shutdown()


class Ranks:
    """fn(device, *args) on len(devices) spawned ranks (see the module
    docstring). backend "gloo" or "nccl"; `workdir` holds the store and the
    results (a new temporary directory, removed by join(), when None);
    `threads` sets each rank's torch CPU threads (0: torch's default)."""

    def __init__(self, fn, devices, backend: str = "gloo", args=(), *,
                 workdir: str | None = None, timeout_s: float = pmesh.TIMEOUT_S,
                 threads: int = 1):
        self.fn, self.args, self.backend = fn, tuple(args), backend
        self.devices = [str(d) for d in devices]
        self.timeout_s, self.threads = timeout_s, threads
        self._own = workdir is None
        self.workdir = tempfile.mkdtemp(prefix="acfm_ranks_") if workdir is None else workdir
        self.procs = []

    def start(self) -> "Ranks":
        os.makedirs(self.workdir, exist_ok=True)
        init_method = "file://" + os.path.join(os.path.abspath(self.workdir), "store")
        ctx = multiprocessing.get_context("spawn")
        self.procs = [
            ctx.Process(target=_rank_main, name=f"acfm-rank{r}",
                        args=(self.fn, self.args, r, self.devices, self.backend,
                              init_method, self.workdir, self.timeout_s, self.threads))
            for r in range(len(self.devices))
        ]
        self._deadline = time.monotonic() + self.timeout_s
        for p in self.procs:
            p.start()
        return self

    def join(self) -> list:
        try:
            # until every rank has exited, one has failed or the deadline:
            # a failed rank leaves the others waiting in a collective
            while (any(p.is_alive() for p in self.procs)
                   and not any(p.exitcode not in (None, 0) for p in self.procs)
                   and time.monotonic() < self._deadline):
                time.sleep(0.05)
            late = [r for r, p in enumerate(self.procs) if p.is_alive()
                    and all(q.exitcode in (None, 0) for q in self.procs)]
            for p in self.procs:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
            errors = []
            for r, p in enumerate(self.procs):
                path = os.path.join(self.workdir, f"rank{r}.err")
                if os.path.exists(path):
                    with open(path) as f:
                        errors.append(f"rank {r}:\n{f.read()}")
            if late:
                raise TimeoutError(f"ranks {late} still running after {self.timeout_s} s"
                                   + "".join("\n" + e for e in errors))
            bad = [(r, p.exitcode) for r, p in enumerate(self.procs) if p.exitcode != 0]
            if bad:
                raise RuntimeError(f"ranks failed (rank, exit code): {bad}"
                                   + "".join("\n" + e for e in errors))
            return [torch.load(os.path.join(self.workdir, f"rank{r}.pt"), map_location="cpu",
                               weights_only=False) for r in range(len(self.procs))]
        finally:
            if self._own:
                shutil.rmtree(self.workdir, ignore_errors=True)

    def run(self) -> list:
        return self.start().join()
