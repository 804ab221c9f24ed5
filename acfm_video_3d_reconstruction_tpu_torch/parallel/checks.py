"""Holding a group's ranks against one process on the whole batch, step by
step (the multi-rank tests and chip_smoke.py's parallel phase).

The reference process runs a Program (modules, optimizers, steps) on the
whole batch with no group and saves its state before the first step and
after each (`record_reference`); every rank runs the same Program on its
block of each batch, from the reference's state before each step, keeping
its own multiplex write-back (`run_rank`), and the ranks judge their
states after each step against the reference's (`judge`, `merge`). Steps are held one at a time
from the same state: a free run of Adam steps parts at rounding level, as
the repo's other kernel-vs-plain checks found.

`judge`'s rules, per tensor (parameters, BatchNorm statistics, multiplex
tables, Adam moments) and per metric:
  * within RTOL / ATOL (probs PROBS_RTOL, on the rows the step wrote: a
    rank reads its own write-back), as tests/test_multichip.py holds the
    JAX mesh against one device;
  * or, where summation order alone moves a tensor further, within FLOOR_X
    times the floor: the reference step re-run from the same state under
    other arithmetic (other CPU thread counts, or the card's default
    algorithms), its largest distance from the reference. The multiframe
    encoder's first layers' gradients cancel to ~1e-3 of their terms, so
    they move ~1e-3 relative with the summation order;
  * the parameters (the model's and the multiplex tables') on the elements
    whose Adam step the gradients decide: Adam's first steps are sign steps (-lr * m / (sqrt(v) + 1e-8)),
    so an element whose gradient sits at its f32 rounding moves by up to
    2 lr either way (tests/test_torch_port_train.py holds the port's update
    against JAX's so). Decided: the reference's |g| > DECIDED and the rank's
    gradient has its sign; the undecided elements may be UNDECIDED_MAX of
    the decided ones, or FLOOR_X times the floor's count.
The ranks' states must be identical bit for bit (`digest`).
"""
from __future__ import annotations

import contextlib
import copy
import hashlib
import math
import os
import time

import torch

from . import mesh as pmesh

RTOL, ATOL, PROBS_RTOL = 1e-4, 1e-5, 1e-3
DECIDED = 1e-6        # |g| above which rounding does not pick the sign of Adam's step
UNDECIDED_MAX = 3e-3  # share of the decided parameter elements a rank may not decide alike
FLOOR_X = 4.0         # off the tolerances, a rank may be this many floors away
WAIT_S = 600.0        # the longest a rank waits for the reference's next state


@contextlib.contextmanager
def cpu_threads(n: int):
    """torch's CPU threads set to n within the block."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cpu(v) for v in tree]
    return copy.deepcopy(tree)


class Program:
    """Steps over modules whose state is read and loaded between steps:
    `model`, `opts` ({name: optimizer}), `mpx` (the multiplex tables'
    module, or None) and `mods` (whose `.step` counts the multiframe steps,
    or None). `steps`: [(name, run)], run() -> metrics, each on this
    process's block of its batch (parallel/mesh.py::shard_batch)."""

    def __init__(self, model, opts: dict, steps: list, mpx=None, mods=None):
        self.model, self.opts, self.steps, self.mpx, self.mods = model, opts, steps, mpx, mods

    def state(self) -> dict:
        st = {"model": _cpu(self.model.state_dict()),
              "opts": {k: _cpu(o.state_dict()) for k, o in self.opts.items()}}
        if self.mpx is not None:
            st["mpx"] = _cpu(self.mpx.state_dict())
        if self.mods is not None:
            st["step"] = self.mods.step
        return st

    def load(self, st: dict, keep_probs: bool) -> None:
        """Load a state; keep_probs keeps this process's probability table
        (its own write-back)."""
        self.model.load_state_dict(st["model"])
        for k, o in self.opts.items():
            o.load_state_dict(st["opts"][k])
        if self.mpx is not None:
            probs = self.mpx.probs.clone()
            self.mpx.load_state_dict(st["mpx"])
            if keep_probs:
                self.mpx.probs.copy_(probs)
        if self.mods is not None:
            self.mods.step = st["step"]

    def after(self, run) -> dict:
        """Run one step: the state after it, the gradient signs, the metrics."""
        metrics = {k: float(v) for k, v in run().items()}
        signs = grad_signs(self.model, "model.")
        if self.mpx is not None:
            signs.update(grad_signs(self.mpx, "mpx."))
        return {"state": self.state(), "signs": signs, "metrics": metrics}


def grad_signs(module, prefix: str = "") -> dict:
    """Per element of each parameter's gradient: its sign where |g| >
    DECIDED, else 0 (int8, on the CPU), by prefix + parameter name."""
    return {prefix + n: torch.where(p.grad.abs() > DECIDED, torch.sign(p.grad), 0)
            .to(torch.int8).cpu() for n, p in module.named_parameters() if p.grad is not None}


def save(obj, path: str) -> None:
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)


def wait_load(path: str, timeout_s: float = WAIT_S):
    """torch.load once the file exists (the reference may still be writing
    its states while the ranks run)."""
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(path)
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def flat(st: dict) -> dict:
    """name -> value over the model, the multiplex tables and the Adam
    moments and step counts of a Program state."""
    out = {f"model.{k}": v for k, v in st["model"].items()}
    out.update({f"mpx.{k}": v for k, v in st.get("mpx", {}).items()})
    for name, sd in st["opts"].items():
        for i, moments in sd["state"].items():
            out.update({f"{name}[{i}].{k}": v for k, v in moments.items()})
    return out


def _tol(name: str) -> dict:
    return dict(rtol=PROBS_RTOL if name == "mpx.probs" else RTOL, atol=ATOL)


def distances(got: dict, want: dict, part: tuple = (0, 1)) -> dict:
    """One run's `after` against the reference's after the same step from
    the same state: per tensor and metric (within the tolerances, vector
    distance), and the parameters' undecided and decided element counts.
    part = (i, n): only every n-th tensor from the i-th (the metrics with
    part 0), so that n ranks share the work."""
    g, w = flat(got["state"]), flat(want["state"])
    if g.keys() != w.keys():
        raise KeyError(sorted(set(g) ^ set(w)))
    out, undecided, decided = {}, 0, 0
    i, n = part
    for k in sorted(w)[i::n]:
        v, gv = w[k], g[k]
        if not torch.is_tensor(v) or not v.is_floating_point():
            out[k] = (bool(torch.equal(gv, v)) if torch.is_tensor(v) else gv == v, 0.0)
            continue
        diff = gv - v
        close = diff.abs() <= _tol(k)["atol"] + _tol(k)["rtol"] * v.abs()
        if k == "mpx.probs" and want.get("probs_written") is not None:
            # the rows this step wrote; the others were held at their own step
            held = want["probs_written"][:, None].expand_as(v)
        elif k in want["signs"]:
            big = want["signs"][k] != 0
            held = big & (got["signs"][k] == want["signs"][k])
            undecided += int((big & ~held).sum())
            decided += int(big.sum())
        else:
            held = None
        if held is not None:
            close, diff = close | ~held, torch.where(held, diff, 0.0)
        out[k] = (bool(close.all()), float(torch.linalg.vector_norm(diff.double())))
    for k, v in (want["metrics"] if i == 0 else {}).items():
        out[f"metric {k}"] = (
            math.isclose(got["metrics"][k], v, rel_tol=RTOL, abs_tol=ATOL),
            abs(got["metrics"][k] - v))
    return {"dist": out, "undecided": undecided, "decided": decided}


def _worst(ds: list) -> dict:
    """The largest distance of each entry over several floors."""
    return {"dist": {k: (all(d["dist"][k][0] for d in ds), max(d["dist"][k][1] for d in ds))
                     for k in ds[0]["dist"]},
            "undecided": max(d["undecided"] for d in ds)}


def digest(st: dict) -> str:
    """A hash of every value of a Program state (bit-for-bit equality)."""
    h = hashlib.sha1()
    for k, v in sorted(flat(st).items()):
        h.update(k.encode())
        h.update(v.contiguous().numpy() if torch.is_tensor(v) else repr(v).encode())
    return h.hexdigest()


def record_reference(prog: Program, work: str, tag: str, floors=()) -> None:
    """The reference: `prog` on the whole batch with no group, each step
    from the state before it, saved under `work` as `<tag>_<i>.pt` (i = 0:
    before the first step). `floors`: context-manager factories under each
    of which the step is re-run from the same state first; their largest
    distance from the reference is saved with it. run_rank removes the
    files as the ranks have read them."""
    save({"state": prog.state()}, f"{work}/{tag}_0.pt")
    for i, (_, run) in enumerate(prog.steps, 1):
        runs = []
        before = prog.state()
        for variant in floors:
            with variant():
                runs.append(prog.after(run))
            prog.load(before, keep_probs=False)
        want = prog.after(run)
        if prog.mpx is not None:
            want["probs_written"] = (want["state"]["mpx"]["probs"]
                                     != before["mpx"]["probs"]).any(1)
        want["floor"] = _worst([distances(f, want) for f in runs]) if runs else None
        save(want, f"{work}/{tag}_{i}.pt")


def judge(got: dict, want: dict, part: tuple = (0, 1)) -> dict:
    """One run's `after` against the reference's after the same step from
    the same state, by the rules of the module docstring, over `part` of
    the tensors (distances): {fails, floor_held, undecided, decided,
    floor_undecided}. `merge` joins the parts."""
    d = distances(got, want, part)
    floor = want.get("floor") or {"dist": {k: (True, 0.0) for k in d["dist"]}, "undecided": 0}
    fails, floor_held = [], []
    for k, (ok, dist) in d["dist"].items():
        f_dist = floor["dist"][k][1]
        if not ok:
            (floor_held if dist <= FLOOR_X * f_dist else fails).append((k, dist, f_dist))
    return {"fails": fails, "floor_held": floor_held, "undecided": d["undecided"],
            "decided": d["decided"], "floor_undecided": floor["undecided"]}


def merge(reports: list) -> dict:
    """The `judge` reports of every part of one step as one; the step holds
    when `fails` is empty and `undecided_ok` is true."""
    out = {"fails": [x for r in reports for x in r["fails"]],
           "floor_held": [x for r in reports for x in r["floor_held"]],
           "undecided": sum(r["undecided"] for r in reports),
           "decided": sum(r["decided"] for r in reports),
           "floor_undecided": reports[0]["floor_undecided"]}
    out["undecided_ok"] = out["undecided"] <= max(UNDECIDED_MAX * out["decided"],
                                                  FLOOR_X * out["floor_undecided"])
    return out


def run_rank(prog: Program, work: str, tag: str) -> list:
    """On every rank of a group: `prog` from the reference's initial state,
    then each step from the reference's state before it (this rank's own
    probability write-back kept). Each rank judges its part of the tensors
    after each step against the reference's (the ranks' states are checked
    equal by their digests), and rank 0 removes each reference file once
    every rank has read it. Returns per step {step, digest, report}: `merge`
    joins the ranks' reports."""
    def take(i):
        path = f"{work}/{tag}_{i}.pt"
        ref = wait_load(path)
        return ref, path

    first, path = take(0)
    prog.load(first["state"], keep_probs=False)
    del first
    steps = []
    for i, (name, run) in enumerate(prog.steps, 1):
        pmesh.barrier()  # every rank has read the previous reference file
        if pmesh.rank() == 0:
            os.remove(path)
        got = prog.after(run)
        want, path = take(i)
        step = {"step": name, "digest": digest(got["state"]),
                "report": judge(got, want, (pmesh.rank(), pmesh.world_size()))}
        prog.load(want["state"], keep_probs=True)
        steps.append(step)
        del got, want
    pmesh.barrier()
    if pmesh.rank() == 0:
        os.remove(path)
    return steps
