"""make_flow_fn's frozen MaskFlownet pass, replayed as a CUDA graph.

A pass over a batch of clips (infer.py::clip_flows: the resizes to the
net's size, centralize, both MaskFlownet stages with their 15 cost volumes,
the upsample, the rescale and resize back, the zero last slot) is about
4,800 small kernels for ~130 ms of device work at the multiframe trainer's
8 pairs at 384x768, and their launches keep the host busy far longer than
the device: the trainer runs the pass on its prefetch thread, which shares
the interpreter and the stream with the loop's forward and backward. On a
CUDA device the first call with a new signature runs the pass a few times
on a side stream (the resize weights' cache, the cost volume's build, the
caching allocator), captures it once as a torch.cuda.CUDAGraph on a static
input buffer, and replays it; a later call with the same signature copies
the clips into the static input (a device-to-device copy: the caller's
batch is on the device already), replays the graph and returns a clone of
its static output, so a returned flow is never overwritten by the next
call (the prefetch queue holds two). The graph holds the eager pass's own
kernels in the same order, so a replay gives the eager flows bit for bit;
only the host's launch of each kernel is gone.

The capture runs in the "thread_local" capture mode, so that the caller's
other threads may launch, allocate and wait on their own streams during
it. None of them may synchronize the whole device (torch.cuda.synchronize)
then: CUDA refuses that while any stream captures. The trainer's one
signature is captured at its first batch, while the loop waits for it.

A signature (`graph_key`) is the input's shape, dtype and device, the
output size and the net's size, the storage address of every parameter
and buffer of the net, the TF32 switches, cuDNN's switch and whether
deterministic algorithms are on. An in-place weight load (`copy_`,
`load_state_dict`) keeps the addresses, and the replay reads the new
values; a replaced tensor means a new capture. Graphs are kept per net and
live as long as it does, across the trainer's epochs (each builds a new
prefetch thread).

The pass runs eagerly on an input that is not a CUDA tensor, and while
tracing is on (utils/tracing.py) with no graph for the signature yet, as
eval/predict_graph.py does for the prediction's forward.

Host counters (utils/tracing.py, always on): `flow.graph_captures`,
`flow.graph_replays` (calls that replayed a graph captured by an earlier
call) and `flow.eager_calls`. `launch.corr_md4` / `launch.corr_md2` count
one pass a call, whichever way it runs: a replay adds the captured cost
volumes' launches, and a capture takes back those of its warm-up runs and
of the capture itself, during which no kernel runs.
"""
from __future__ import annotations

import itertools
import weakref
from typing import Callable

import torch

from ..utils import tracing

WARMUP_RUNS = 3  # eager runs on the side stream before the capture

# id(net) -> {signature: _Graph}; an entry goes with its net
_GRAPHS: dict = {}


def choose(device_type: str, tracing_on: bool, captured: bool) -> str:
    """How a call runs: "eager" on a device other than CUDA, or while tracing
    is on with no graph for the signature; else "replay" of the signature's
    graph, or its "capture"."""
    if device_type != "cuda":
        return "eager"
    if captured:
        return "replay"
    return "eager" if tracing_on else "capture"


def read_tensors(net: torch.nn.Module) -> list:
    """Every parameter and buffer of the net, from each module's own
    `_parameters` and `_buffers` (faster than `parameters()`, which every
    call would pay)."""
    return [t for m in net.modules()
            for t in itertools.chain(m._parameters.values(), m._buffers.values())
            if t is not None]


def graph_key(net: torch.nn.Module, imgs: torch.Tensor, image_size: int, net_hw) -> tuple:
    """The signature a graph is kept under: (the input's shape, dtype and
    device, the sizes, the addresses of read_tensors(net), the switches that
    pick the pass's kernels)."""
    inputs = tuple(imgs.shape), str(imgs.dtype), str(imgs.device)
    weights = tuple(t.data_ptr() for t in read_tensors(net))
    switches = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                torch.backends.cudnn.enabled, torch.are_deterministic_algorithms_enabled())
    return inputs, (image_size, tuple(net_hw)), weights, switches


def _launches() -> dict:
    return {k: v for k, v in tracing.counters().items() if k.startswith("launch.")}


class _Graph:
    """One captured pass: its static input and output, the kernel launches
    one replay makes, and the tensors it reads (held, so that no address it
    reads is handed to another tensor)."""

    def __init__(self, pass_fn: Callable, net, imgs: torch.Tensor, image_size: int, net_hw):
        self.read = read_tensors(net)
        device = imgs.device
        self.input = torch.empty(imgs.shape, dtype=torch.float32, device=device)
        self.input.copy_(imgs)
        before = _launches()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.no_grad():
            with torch.cuda.stream(side):
                for _ in range(WARMUP_RUNS):
                    pass_fn(net, self.input, image_size, net_hw)
            torch.cuda.current_stream(device).wait_stream(side)
            warm = _launches()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=side, capture_error_mode="thread_local"):
                self.output = pass_fn(net, self.input, image_size, net_hw)
        after = _launches()
        self.launches = {k: n - warm.get(k, 0) for k, n in after.items()
                         if n != warm.get(k, 0)}
        for k, n in after.items():
            tracing.count(k, before.get(k, 0) - n)

    def replay(self, imgs: torch.Tensor) -> torch.Tensor:
        self.input.copy_(imgs)
        if tracing.on():
            # an op of the profiler's own scope, to which the graph's
            # kernels are tied (a record_function's range takes none)
            with torch._C._profiler._RecordFunctionFast("acfm.flow.graph_replay"):
                self.graph.replay()
        else:
            self.graph.replay()
        for k, n in self.launches.items():
            tracing.count(k, n)
        return self.output.clone()


def _graphs_of(net) -> dict:
    key = id(net)
    if key not in _GRAPHS:
        _GRAPHS[key] = {}
        weakref.finalize(net, _GRAPHS.pop, key, None)
    return _GRAPHS[key]


def run(pass_fn: Callable, net, imgs, image_size: int, net_hw) -> torch.Tensor:
    """pass_fn(net, imgs, image_size, net_hw) (infer.py::clip_flows), through
    a graph where `choose` says so: on clips `imgs` that are a CUDA tensor,
    on the net's device."""
    graphs = key = None
    cuda = torch.is_tensor(imgs) and imgs.is_cuda
    if cuda:
        graphs, key = _graphs_of(net), graph_key(net, imgs, image_size, net_hw)
    how = choose("cuda" if cuda else "cpu", tracing.on(),
                 graphs is not None and key in graphs)
    if how == "eager":
        tracing.count("flow.eager_calls")
        return pass_fn(net, imgs, image_size, net_hw)
    if how == "capture":
        # graphs of other weights read tensors the net no longer holds
        for old in [k for k in graphs if k[2] != key[2]]:
            del graphs[old]
        graphs[key] = _Graph(pass_fn, net, imgs, image_size, net_hw)
        tracing.count("flow.graph_captures")
    else:
        tracing.count("flow.graph_replays")
    return graphs[key].replay(imgs)
