"""predict_monocular's eval-mode forward, replayed as a CUDA graph.

At B = 1 the forward is hundreds of small kernels (the MeshNet encoder and
heads, the texture decoder, the screened-Poisson solve, the projection,
the soft and the mirrored hard rasterization, LPIPS and the losses), and
the host's launch of each of them costs far more than the device's work.
On a CUDA device the first call with a new signature runs the forward a
few times on a side stream (kernel builds, cuBLAS / cuDNN / cuSOLVER
state, the caching allocator), captures it once as a torch.cuda.CUDAGraph
on static input tensors, and replays it; a later call with the same
signature copies the request's arrays into the static inputs, replays the
graph and returns clones of its static outputs, so a returned tensor is
never overwritten by the next call. The graph holds the eager path's own
kernels in the same order, so a replay gives the eager outputs bit for
bit; only the host's launch of each kernel is gone.

A signature (`graph_key`) is the batch's shapes and dtypes, the storage
address of every tensor the forward reads from the modules (the model's
and LPIPS's parameters and buffers, the faces, edges and Laplacian), the
TF32 switches, and the configuration (its autocast dtype, sizes and loss
weights are baked into the graph). An in-place weight load (`copy_`) keeps
the addresses, and the replay reads the new values; a replaced tensor
means a new capture.

The forward runs eagerly on a CPU device, and while tracing is on
(utils/tracing.py) with no graph for the signature yet: `count_device`
makes its accumulators at first use, and a capture would bake them into
the graph's pool. A graph captured with tracing off counts nothing on the
device when it is replayed with tracing on.

Host counters (utils/tracing.py, always on): `predict.graph_captures`,
`predict.graph_replays` (calls that replayed a graph captured by an
earlier call) and `predict.eager_calls`. Every replay adds the captured
kernels' launches to `launch.*`; the capture, during which no kernel
runs, takes its own launches back.
"""
from __future__ import annotations

import itertools
import math
import weakref

import numpy as np
import torch

from ..train import monocular
from ..utils import tracing

FORWARD_OUTPUTS = ("kp_pred", "pred_v", "cam_pred", "mask_pred")
WARMUP_RUNS = 3  # eager runs on the side stream before the capture

# id(modules) -> {signature: _Graph}; an entry goes with its modules
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


def read_tensors(mods: monocular.MonoModules) -> list:
    """Every tensor of the modules that the forward reads. Each module's own
    `_parameters` and `_buffers`: `Module.parameters()` and `.buffers()`
    walk the tree about four times slower, ~1 ms a call on the monocular
    CLI's modules, which every call pays."""
    nets = [mods.model] if mods.lpips is None else [mods.model, mods.lpips]
    return [t for net in nets for m in net.modules()
            for t in itertools.chain(m._parameters.values(), m._buffers.values())
            if t is not None] + [mods.faces, mods.edges, mods.lap]


def graph_key(mods: monocular.MonoModules, batch: dict) -> tuple:
    """The signature a graph is kept under: (the batch's shapes and dtypes,
    the addresses of read_tensors(mods), the TF32 switches, the
    configuration)."""
    inputs = tuple((tuple(batch[k].shape), str(batch[k].dtype)) for k in monocular.BATCH_KEYS)
    weights = tuple(t.data_ptr() for t in read_tensors(mods))
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    return inputs, weights, tf32, mods.cfg


def _eager(mods, inputs: dict) -> dict:
    _, aux = monocular.forward(mods, inputs)
    model = mods.model
    return dict({k: aux[k] for k in FORWARD_OUTPUTS}, lbs=model.get_lbs(),
                mean_shape=model.get_mean_shape().detach())


def _launches() -> dict:
    return {k: v for k, v in tracing.counters().items() if k.startswith("launch.")}


class _Graph:
    """One captured forward: its static inputs (views of one device buffer,
    filled from one pinned host buffer) and outputs, the kernel launches one
    replay makes, and the tensors it reads (held, so that no address it
    reads is handed to another tensor)."""

    def __init__(self, mods, batch: dict):
        self.read = read_tensors(mods)
        shapes = {k: tuple(batch[k].shape) for k in monocular.BATCH_KEYS}
        n = sum(_padded(math.prod(s)) for s in shapes.values())
        self.host = torch.empty(n, dtype=torch.float32, pin_memory=True)
        self.device = torch.empty(n, dtype=torch.float32, device=mods.device)
        self.host_inputs, self.inputs = _views(self.host, shapes), _views(self.device, shapes)
        self.uploaded = torch.cuda.Event()
        self._upload(batch)
        side = torch.cuda.Stream(mods.device)
        side.wait_stream(torch.cuda.current_stream(mods.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                _eager(mods, self.inputs)
        torch.cuda.current_stream(mods.device).wait_stream(side)
        before = _launches()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=side):
            self.outputs = _eager(mods, self.inputs)
        self.launches = {k: n - before.get(k, 0) for k, n in _launches().items()
                         if n != before.get(k, 0)}
        for k, n in self.launches.items():
            tracing.count(k, -n)

    def _upload(self, batch: dict) -> None:
        """The request's arrays as float32 into the static inputs, in one
        copy; the pinned buffer is written once the last copy from it is
        done. Arrays go in through numpy, on this thread: torch's CPU copy
        of an image wakes its thread pool, whose tail on a busy host reaches
        tens of ms."""
        self.uploaded.synchronize()
        for k, t in self.host_inputs.items():
            src = batch[k]
            if torch.is_tensor(src):
                t.copy_(src)
            else:
                np.copyto(t.numpy(), src, casting="unsafe")
        self.device.copy_(self.host, non_blocking=True)
        self.uploaded.record()

    def replay(self, batch: dict) -> dict:
        self._upload(batch)
        if tracing.on():
            # an op of the profiler's own scope, to which the graph's
            # kernels are tied (a record_function's range takes none)
            with torch._C._profiler._RecordFunctionFast("acfm.predict.graph_replay"):
                self.graph.replay()
        else:
            self.graph.replay()
        for k, n in self.launches.items():
            tracing.count(k, n)
        return {k: v.clone() for k, v in self.outputs.items()}


def _padded(n: int) -> int:
    """n floats rounded up to the caching allocator's 512-byte blocks, so
    that each input starts as aligned as the eager path's own tensors (a
    kernel may pick its vector width by alignment)."""
    return -(-n // 128) * 128


def _views(flat: torch.Tensor, shapes: dict) -> dict:
    """Consecutive views of `flat`, one of each shape, each at _padded."""
    out, at = {}, 0
    for k, shape in shapes.items():
        n = math.prod(shape)
        out[k] = flat[at:at + n].view(shape)
        at += _padded(n)
    return out


def _graphs_of(mods) -> dict:
    key = id(mods)
    if key not in _GRAPHS:
        _GRAPHS[key] = {}
        weakref.finalize(mods, _GRAPHS.pop, key, None)
    return _GRAPHS[key]


def forward_outputs(mods: monocular.MonoModules, batch: dict) -> dict:
    """FORWARD_OUTPUTS of monocular.forward in eval mode on `batch` (arrays
    of monocular.BATCH_KEYS), and the model's `lbs` and `mean_shape`,
    through a graph where `choose` says so. Call it under
    torch.inference_mode()."""
    graphs = key = None
    if mods.device.type == "cuda":
        graphs, key = _graphs_of(mods), graph_key(mods, batch)
    how = choose(mods.device.type, tracing.on(), graphs is not None and key in graphs)
    if how == "eager":
        tracing.count("predict.eager_calls")
        return _eager(mods, monocular.to_device_batch(mods, batch))
    if how == "capture":
        # graphs of other weights read tensors the modules no longer hold
        for old in [k for k in graphs if k[1] != key[1]]:
            del graphs[old]
        graphs[key] = _Graph(mods, batch)
        tracing.count("predict.graph_captures")
    else:
        tracing.count("predict.graph_replays")
    return graphs[key].replay(batch)
