"""The run: its arguments, the benchmark's files, the window and the result.

`gpubench/run.py --workload CELL --seed N --seconds S --trace 0|1` finds
the cell in BENCHMARK.json, its configuration (configs/<config>.json), its
traffic (traffic/<traffic>.json, which names the driver in entries/) and
its limits (workloads/<cell>.json). Everything that belongs to one cell,
configuration, traffic mix, metric or kernel is a file of its own, found by
the name BENCHMARK.json gives it.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
GPUBENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(GPUBENCH)
CACHE = os.path.join(GPUBENCH, "cache")

# top-level module names that must not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "acfm_video_3d_reconstruction_tpu")


class WindowClosed(Exception):
    """Raised from a per-step hook to end the program's loop once the
    measured window is over."""


def log(msg: str) -> None:
    print(f"[gpubench] {msg}", file=sys.stderr, flush=True)


def seconds_since_process_start() -> float:
    """Wall seconds since this process was created (from /proc: the
    interpreter's start-up and every import count)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def read_json(*parts) -> dict:
    with open(os.path.join(GPUBENCH, *parts)) as f:
        return json.load(f)


def load_module(path: str):
    """A module from a file under gpubench/ (its name may hold dots)."""
    name = "gpubench_file_" + os.path.relpath(path, GPUBENCH).replace("/", "_").replace(
        ".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


class Cell:
    """One entry of BENCHMARK.json's workloads with its files."""

    def __init__(self, name: str, bench: dict | None = None):
        bench = bench or benchmark()
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = entry
        self.chips = int(entry["chips"])
        self.config = read_json("configs", entry["config"] + ".json")
        self.traffic = read_json("traffic", entry["traffic"] + ".json")
        self.limits = read_json("workloads", name + ".json")["limits"]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])
                          and any(e["name"] == m["moves"] for e in self.end_to_end)]

    def driver(self):
        return importlib.import_module("gpubench.entries." + self.traffic["driver"])


class Window:
    """The measured window of a loop that calls `tick()` once per finished
    unit of work (a step, a batch, a request).

    The first `warm` ticks are set-up. At the next, the device is
    synchronised and the window opens (with `trace`, the profiler starts);
    at the first tick once `seconds` have passed the device is synchronised
    again, the window closes and WindowClosed is raised. A unit is never
    cut in half."""

    def __init__(self, seconds: float, warm: int, sync, profiler=None):
        self.seconds = seconds
        self.warm = warm
        self.sync = sync
        self.profiler = profiler
        self.ticks = 0
        self.units = 0
        self.t0 = self.t1 = None
        self.setup_s = None
        self.closed = False

    @property
    def open(self) -> bool:
        return self.t0 is not None and not self.closed

    def tick(self) -> None:
        """Count one finished unit."""
        self.ticks += 1
        if self.t0 is None:
            if self.ticks >= self.warm:
                self.sync()
                self.setup_s = seconds_since_process_start()
                log(f"set-up: the window opens at {self.setup_s:.2f} s")
                if self.profiler is not None:
                    self.profiler.start()
                self.t0 = time.perf_counter()
            return
        self.units += 1
        if time.perf_counter() - self.t0 >= self.seconds:
            self.sync()
            self.t1 = time.perf_counter()
            if self.profiler is not None:
                self.profiler.stop()
            self.closed = True
            raise WindowClosed

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


class Spans:
    """Host-clock totals of the harness's spans around its calls into the
    program; each is also a torch.profiler record_function range, so a
    traced run can sum the device time of the kernels launched inside."""

    def __init__(self):
        self.total = {}

    @contextlib.contextmanager
    def span(self, name: str):
        from torch.profiler import record_function

        t = time.perf_counter()
        with record_function(f"gpubench.{name}"):
            try:
                yield
            finally:
                self.total[name] = self.total.get(name, 0.0) + time.perf_counter() - t

    def reset(self) -> None:
        self.total.clear()


def loaded_forbidden() -> list:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def emit(result: dict, checks: dict) -> None:
    """Print each compared number beside its limit on standard error (the
    last lines there) and the result as the last line of standard output,
    with the checks under the last key."""
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["checks"] = {name: {"value": v if math.isfinite(v) else 1e300, "limit": lim}
                      for name, (v, lim) in checks.items()}
    print(json.dumps(line), flush=True)
