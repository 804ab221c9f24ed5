"""Spans and counters of the port's layers.

Tracing is on exactly while a torch profiler records in this process. That
is read from `torch.autograd.profiler._is_profiler_enabled`, which every
thread sees (the C check is per thread, and the flow pass runs on the
prefetch thread). So a run under `torch.profiler` gets the spans with no
option to set; record every thread's spans with the profiler's
`_ExperimentalConfig(profile_all_threads=True)`.

* `span(name, unit=None)`: on, it enters `record_function("acfm.<name>")`,
  so the span lies in the profiler's trace, on the device trace's clock,
  around the operations it launched; and it keeps a `Span` in memory:
  name, thread, start and end on `time.perf_counter_ns`, the span that
  encloses it on its thread, and its unit (a step, a request). Off, it
  reads one flag and returns: no `record_function`, no clock, no
  allocation.
* `count(name, n=1)`: a host counter, always on (the kernels' launches are
  `launch.<kernel>`).
* `count_traced(name, n=1)`: a host counter of the session: it adds `n`
  while tracing is on and reads one flag otherwise (the multiplex's views,
  the mask-only clips of the batches).
* `count_device(name, tensor)`: adds `tensor`'s sum into a counter on its
  device while tracing is on; nothing is read back until `counters()`.
* `collect()`: on its thread, for the life of the block, `count_traced`
  and `count_device` go to the collection it returns, whether tracing is
  on or not (a CUDA graph's capture, utils/graphs.py: the device counts
  become the graph's outputs, which each replay under tracing adds to the
  session). `counting()` says whether a count is taken on this thread:
  callers that compute what they count only for it ask that.

The record and the session's counters (device and traced host) hold one
profiling session: the first span or count of them after the profiler
turned on clears what an earlier session left, once that session was read
(`record()`, `counters()`) or one of its spans ended after the profiler
stopped; until then it stays in memory.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

PREFIX = "acfm."

_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    id: int
    name: str
    thread: str
    start_ns: int
    end_ns: int
    parent: Optional[int]  # id of the enclosing span on the same thread
    unit: object


class Collected(NamedTuple):
    device: dict  # name -> int64 tensor: the sums the block counted
    traced: dict  # name -> int


class _Registry:
    def __init__(self):
        self.lock = threading.Lock()
        self.host = {}
        self.device = {}  # (name, device) -> int64 tensor
        self.traced = {}  # the session's host counters
        self.spans = []
        self.ids = itertools.count()
        self.local = threading.local()
        self.live = False  # a session is being recorded, not yet read

    def begin(self) -> None:
        """Called on the on path: a new session clears the last one."""
        if not self.live:
            with self.lock:
                if not self.live:
                    self.spans = []
                    self.device = {}
                    self.traced = {}
                    self.live = True

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def read(self) -> None:
        """A session read after the profiler stopped is over."""
        if not _profiler._is_profiler_enabled:
            self.live = False


_REG = _Registry()


class _Span:
    __slots__ = ("name", "unit", "id", "parent", "start_ns", "rf")

    def __init__(self, name: str, unit):
        self.name = name
        self.unit = unit

    def __enter__(self):
        _REG.begin()
        stack = _REG.stack()
        self.parent = stack[-1].id if stack else None
        self.id = next(_REG.ids)
        stack.append(self)
        self.rf = _profiler.record_function(
            PREFIX + self.name, None if self.unit is None else str(self.unit))
        self.rf.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        _REG.stack().pop()
        _REG.spans.append(Span(self.id, self.name, threading.current_thread().name,
                               self.start_ns, end_ns, self.parent, self.unit))
        _REG.read()
        return False


def on() -> bool:
    """Whether tracing is on: a torch profiler records in this process."""
    return _profiler._is_profiler_enabled


def span(name: str, unit=None):
    """A context manager: the span `name` (of unit `unit`) while tracing is
    on, nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, unit)


def _collection() -> Optional[Collected]:
    return getattr(_REG.local, "collected", None)


def counting() -> bool:
    """Whether count_device and count_traced take a count on this thread:
    tracing is on, or a collect() block is open."""
    return _profiler._is_profiler_enabled or _collection() is not None


@contextlib.contextmanager
def collect():
    """Within the block, this thread's count_traced and count_device calls
    go to the Collected it yields, and not to the session."""
    got = Collected({}, {})
    _REG.local.collected = got
    try:
        yield got
    finally:
        _REG.local.collected = None


def count(name: str, n: int = 1) -> None:
    """Add `n` to the host counter `name`."""
    with _REG.lock:
        _REG.host[name] = _REG.host.get(name, 0) + n


def count_traced(name: str, n: int = 1) -> None:
    """While tracing is on, add `n` to the session's host counter `name`
    (within collect(), to the collection)."""
    got = _collection()
    if got is not None:
        got.traced[name] = got.traced.get(name, 0) + n
        return
    if not _profiler._is_profiler_enabled:
        return
    _REG.begin()
    with _REG.lock:
        _REG.traced[name] = _REG.traced.get(name, 0) + n


def count_device(name: str, tensor: torch.Tensor) -> None:
    """While tracing is on, add the sum of `tensor` (integers or booleans)
    to the device counter `name`, on `tensor`'s device, without a read
    (within collect(), the sum goes to the collection)."""
    got = _collection()
    if got is None and not _profiler._is_profiler_enabled:
        return
    with torch.no_grad():
        n = tensor.sum(dtype=torch.int64)
        if got is not None:
            got.device[name] = got.device[name] + n if name in got.device else n
            return
        _REG.begin()
        key = (name, n.device)
        acc = _REG.device.get(key)
        if acc is None:
            # a normal tensor, also when the count comes from inference mode
            with torch.inference_mode(False), _REG.lock:
                acc = _REG.device.setdefault(
                    key, torch.zeros((), dtype=torch.int64, device=n.device))
        acc.add_(n)


def record() -> list:
    """The session's spans, in the order they ended."""
    _REG.read()
    return list(_REG.spans)


def counters() -> dict:
    """Every counter: the host counters, the session's traced host counters,
    and its device counters (read back here, summed over devices)."""
    _REG.read()
    with _REG.lock:
        out = dict(_REG.host)
        for name, n in _REG.traced.items():
            out[name] = out.get(name, 0) + n
        device = list(_REG.device.items())
    for (name, _), acc in device:
        out[name] = out.get(name, 0) + int(acc.item())
    return out


def reset() -> None:
    """Clear the record and every counter."""
    with _REG.lock:
        _REG.host = {}
        _REG.device = {}
        _REG.traced = {}
        _REG.spans = []
        _REG.live = False


def self_ns(spans: list) -> dict:
    """{span id: its duration less that of its child spans on its thread}."""
    out = {s.id: s.end_ns - s.start_ns for s in spans}
    for s in spans:
        if s.parent in out:
            out[s.parent] -= s.end_ns - s.start_ns
    return out
