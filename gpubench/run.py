#!/usr/bin/env python3
"""The benchmark of the PyTorch / CUDA port on one NVIDIA H100.

    python3 gpubench/run.py --workload CELL --seed N --seconds S --trace 0|1

One cell per process: it loads, warms up the cell's own shapes, measures
for S seconds, checks what the timed path produced against the plain
reference, and prints one JSON line last on standard output: with
--trace 0 the cell's end-to-end metrics, with --trace 1 its per-layer
metrics (from torch.profiler over the window and the harness's spans),
with the device and the compared numbers beside their limits. Exits
non-zero, printing no result, without a CUDA device (or fewer than the
cell asks for), and when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import gc
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed directory in the checkout
    (the port's own nvcc builds go to its _build/ directory there)."""
    from gpubench.harness.bench import CACHE

    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")


class Context:
    """What the per-layer readers read."""

    def __init__(self, cell, drv, device, window, spans, trace, info):
        self.cell = cell
        self.drv = drv
        self.device = device
        self.window_s = window.window_s
        self.units = window.units
        self.spans = spans
        self.trace = trace
        self.info = info
        self.shapes = info.get("shapes", {})
        self._flops = None

    def unit_flops(self):
        if self._flops is None:
            self._flops = self.drv.unit_flops(self.cell, self.device, self.info)
        return self._flops


def make_profiler():
    """torch.profiler over host and device, recording every thread's spans
    (the flow pass runs on the loop's prefetch thread)."""
    from torch.profiler import ProfilerActivity, profile

    kw = {}
    try:
        from torch._C._profiler import _ExperimentalConfig

        kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        pass
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **kw)


def power_limit() -> str:
    """The card's power limit as nvidia-smi reads it ("unknown" without)."""
    import subprocess

    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                            "-i", "0"], capture_output=True, text=True, timeout=20)
        return r.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def device_info(torch, device) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}


def run_cell(cell, seed: int, seconds: float, trace: bool, device, limits=None):
    """Run one cell in this process; returns (result dict, checks dict)."""
    import torch

    from gpubench.harness import bench, compare
    from gpubench.harness.trace import Trace

    drv = cell.driver()
    tmp = tempfile.mkdtemp(prefix="gpubench-")
    profiler = None
    if trace:
        profiler = make_profiler()
    seconds = min(seconds, cell.traffic["trace_seconds"]) if trace else seconds
    on_cuda = torch.device(device).type == "cuda"
    try:
        if on_cuda:
            torch.cuda.set_device(device)
            torch.cuda.reset_peak_memory_stats(device)
        window, spans, state, info = drv.run(cell, seed, seconds, device, tmp, profiler)
        e2e = drv.end_to_end(window, info)
        dev = device_info(torch, device) if on_cuda else {"platform": "cpu", "kind": "cpu",
                                                           "count": 1}
        dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device)) if on_cuda else 0
        tr = Trace(profiler) if profiler is not None else None
        if tr is not None:
            dev["busy_s"] = tr.busy_s
            dev["window_s"] = window.window_s
        gc.collect()
        if on_cuda:
            torch.cuda.empty_cache()
        numbers = drv.check(cell, seed, device, state, info)
        del state
        gc.collect()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    correct, checks = compare.judge(numbers, cell.limits if limits is None else limits)
    metrics = {}
    if trace:
        ctx = Context(cell, drv, device, window, spans, tr, info)
        for m in cell.per_layer:
            reader = bench.load_module(os.path.join(bench.GPUBENCH, "metrics", m["name"] + ".py"))
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = window.setup_s if m["name"] == "setup_s" else e2e.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": window.units, "failed": 0,
              "metrics": metrics, "device": dev}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.by_kind()[:10], "idle_gaps": tr.idle_gaps(10)}
        bench.log("top kernels: " + "; ".join(f"{n} {s:.6f} s" for n, s in tr.top_kernels(10)))
        bench.log(f"device s in the window: {tr.kernel_total_s:.6f} (busy "
                  f"{tr.busy_s:.6f}); in the harness's spans: {tr.span_device} counts "
                  f"{tr.span_count}")
    return result, checks


def main(argv=None) -> int:
    args = parse(argv)
    from gpubench.harness import bench

    set_cache_dirs()
    cell = bench.Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        bench.log(f"{cell.name} needs {cell.chips} CUDA device(s); this machine has {n}")
        return 2
    device = torch.device("cuda", 0)
    peak = cell.config["peak"]
    bench.log(f"peak: {peak['name']}: {peak['flops_per_s']:.4g} FLOP/s, "
              f"{peak['bytes_per_s']:.4g} B/s; card: {torch.cuda.get_device_name(device)}, "
              f"power limit {power_limit()}")
    result, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    found = bench.loaded_forbidden()
    if found:
        bench.log(f"modules of JAX or the JAX package were loaded: {found}")
        return 3
    bench.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
