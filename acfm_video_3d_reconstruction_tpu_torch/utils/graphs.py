"""Work replayed as a CUDA graph: the port's one mechanism for it.

The callers' work (eval/predict_graph.py: predict_monocular's forward;
flow/infer.py::make_flow_fn: the frozen MaskFlownet pass;
train/multiframe.py::make_train_step: the multiframe training step) is
hundreds to thousands of small kernels whose launches keep the host busy
far longer than the device computes. `run` captures it once per signature
as a torch.cuda.CUDAGraph on the caller's static inputs; a call copies its
data into the static inputs, replays the graph and returns clones of its
static outputs, which later calls leave alone. The graph holds the eager
kernels in the same order, so a replay gives the eager outputs bit for
bit. The rules:

* How a call runs (`choose`): eagerly off CUDA, while tracing is on
  (utils/tracing.py) with no graph for the signature yet (a capture is
  never traced), and for a training step's warm-up calls (below).
* Warm-ups (kernel builds, library state, the caller's caches, the caching
  allocator). Work that changes no state (inference) runs WARMUP_RUNS
  times on a side stream before its capture. A training step (`train`)
  mutates its state (parameters, Adam's moments, the tables), so it runs
  no extra time: its warm-ups are the caller's own first TRAIN_WARM_CALLS
  calls under the signature's own part, eager, each a real update; the
  next call captures with autograd on and, since a capture records without
  running, replays at once. A training capture replaces the owner's other
  graphs: a run's signature only moves forward (fewer hypotheses, a lower
  rate), and each graph's pool holds a step's activations.
* The signature (`graph_key`): the caller's own part (shapes, dtypes, what
  the graph bakes in), the addresses of every tensor the work reads, and
  the switches that pick kernels (matmul's and cuDNN's TF32, cuDNN's
  `enabled`, deterministic algorithms). An in-place weight load keeps the
  addresses, and a replay reads the new values; a replaced tensor means a
  new capture, which evicts the owner's graphs of older addresses.
* Graphs are kept per owner (the modules, the net) and go with it.
* The capture is "thread_local": the caller's other threads may launch,
  allocate and wait on their own streams meanwhile (the trainer's loop
  beside the prefetch thread's flow pass), but none may synchronize the
  whole device, which CUDA refuses while any stream captures.
* A replay runs under the profiler op `acfm.<name>.graph_replay`, to which
  the device trace ties the graph's kernels.
* Counts (tracing.collect): the traced host counts and the device counts
  the capture made are kept, the device ones as outputs of the graph; a
  replay under tracing adds them to the session, as an eager call would
  count (no host read).
* Host counters (always on): `<name>.graph_captures`, `.graph_replays`
  (calls that replayed a graph captured earlier), `.eager_calls`.
  `launch.*` counts the kernels that ran: the warm-up runs count, a replay
  adds the captured launches, and the capture, during which no kernel
  runs, takes its own back.
"""
from __future__ import annotations

import itertools
import weakref
from typing import Any, Callable

import torch

from . import tracing

WARMUP_RUNS = 3  # eager runs on the side stream before an inference capture
TRAIN_WARM_CALLS = 1  # a training step's own eager calls before its capture

# id(owner) -> the owner's _Owned, which goes with the owner
_GRAPHS: dict = {}


class _Owned(dict):
    """An owner's graphs by signature; `warm`: the training case's eager
    calls by the signature's own part."""

    def __init__(self):
        super().__init__()
        self.warm = {}


def choose(device_type: str, tracing_on: bool, captured: bool, warmed: bool = True) -> str:
    """How a call runs: "eager" on a device other than CUDA, while tracing
    is on with no graph for the signature, or while the signature is not
    warmed; else "replay" of the signature's graph, or its "capture"."""
    if device_type != "cuda":
        return "eager"
    if captured:
        return "replay"
    return "capture" if warmed and not tracing_on else "eager"


def read_tensors(*modules: torch.nn.Module) -> list:
    """Every parameter and buffer of the modules, from each module's own
    `_parameters` and `_buffers`: `Module.parameters()` and `.buffers()`
    walk the tree about four times slower, ~1 ms a call on the monocular
    CLI's modules, which every call pays."""
    return [t for net in modules for m in net.modules()
            for t in itertools.chain(m._parameters.values(), m._buffers.values())
            if t is not None]


def graph_key(own: tuple, read: list) -> tuple:
    """The signature a graph is kept under: (the caller's own part, the
    addresses of the tensors `read`, the switches that pick the kernels)."""
    switches = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                torch.backends.cudnn.enabled, torch.are_deterministic_algorithms_enabled())
    return own, tuple(t.data_ptr() for t in read), switches


def _launches() -> dict:
    return {k: v for k, v in tracing.counters().items() if k.startswith("launch.")}


class _Graph:
    """One capture of fn(inputs): the static inputs and outputs, the kernel
    launches one replay makes, and the tensors it reads (held, so that no
    address it reads is handed to another tensor)."""

    def __init__(self, fn: Callable, inputs, read: list, device: torch.device,
                 train: bool = False):
        self.inputs, self.read = inputs, read
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.set_grad_enabled(train):
            if not train:
                with torch.cuda.stream(side):
                    for _ in range(WARMUP_RUNS):
                        fn(inputs)
                torch.cuda.current_stream(device).wait_stream(side)
            before = _launches()
            self.graph = torch.cuda.CUDAGraph()
            with tracing.collect() as self.counts, torch.cuda.graph(
                    self.graph, stream=side, capture_error_mode="thread_local"):
                self.outputs = fn(inputs)
        self.launches = {k: n - before.get(k, 0) for k, n in _launches().items()
                         if n != before.get(k, 0)}
        for k, n in self.launches.items():
            tracing.count(k, -n)

    def replay(self, op: str):
        if tracing.on():
            # an op of the profiler's own scope, to which the graph's
            # kernels are tied (a record_function's range takes none)
            with torch._C._profiler._RecordFunctionFast(op):
                self.graph.replay()
            for k, n in self.counts.device.items():
                tracing.count_device(k, n)
            for k, n in self.counts.traced.items():
                tracing.count_traced(k, n)
        else:
            self.graph.replay()
        for k, n in self.launches.items():
            tracing.count(k, n)
        if isinstance(self.outputs, dict):
            return {k: v.clone() for k, v in self.outputs.items()}
        return self.outputs.clone()


def _owned(owner) -> _Owned:
    """The owner's graphs, kept from its first call until it goes."""
    graphs = _GRAPHS.get(id(owner))
    if graphs is None:
        graphs = _GRAPHS[id(owner)] = _Owned()
        weakref.finalize(owner, _GRAPHS.pop, id(owner), None)
    return graphs


def run(name: str, owner, device: torch.device, signature: Callable[[], tuple],
        eager: Callable[[], Any], static: Callable[[], Any], load: Callable[[Any], None],
        fn: Callable[[Any], Any], train: bool = False):
    """One call of the work `name` ("predict", "flow", "train") on `device`,
    as `choose` says: eager(), or the replay of the graph of fn(static
    inputs) that `owner` keeps under graph_key(*signature()), captured first
    if there is none. signature() gives (the caller's own part of the key,
    the tensors fn reads); static() makes the static inputs and load(inputs)
    copies the call's data into them, before the capture and every replay.
    `train`: the training case (no extra runs; the caller's first calls
    warm up). Outputs: a tensor or a dict of tensors."""
    graphs = key = own = None
    if device.type == "cuda":
        own, read = signature()
        key, graphs = graph_key(own, read), _owned(owner)
    warmed = not train or graphs is None or graphs.warm.get(own, 0) >= TRAIN_WARM_CALLS
    how = choose(device.type, tracing.on(), graphs is not None and key in graphs, warmed)
    if how == "eager":
        tracing.count(f"{name}.eager_calls")
        if train and graphs is not None:
            graphs.warm[own] = graphs.warm.get(own, 0) + 1
        return eager()
    if how == "capture":
        for old in [k for k in graphs if train or k[1] != key[1]]:
            del graphs[old]
        inputs = static()
        load(inputs)
        graphs[key] = _Graph(fn, inputs, read, device, train)
        tracing.count(f"{name}.graph_captures")
    else:
        tracing.count(f"{name}.graph_replays")
    graph = graphs[key]
    load(graph.inputs)
    return graph.replay(f"{tracing.PREFIX}{name}.graph_replay")
