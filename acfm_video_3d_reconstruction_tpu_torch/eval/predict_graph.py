"""predict_monocular's eval-mode forward, replayed as a CUDA graph by
utils/graphs.py: at B = 1 its hundreds of small kernels (MeshNet, the
texture decoder, the solve, both rasterizations, LPIPS and the losses) cost
the host far more to launch than the device to run. Here: the forward, its
static inputs (views of one device buffer, filled from one pinned host
buffer in one copy) and its part of the signature, the batch's shapes and
dtypes and the configuration (autocast dtype, sizes and loss weights are
baked into the graph). Counters `predict.*`.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..train import monocular
from ..utils import graphs

FORWARD_OUTPUTS = ("kp_pred", "pred_v", "cam_pred", "mask_pred")


def graph_signature(mods: monocular.MonoModules, batch: dict) -> tuple:
    """(the batch's shapes and dtypes and the configuration, every tensor the
    forward reads: the model's and LPIPS's, the faces, edges and Laplacian)."""
    inputs = tuple((tuple(batch[k].shape), str(batch[k].dtype)) for k in monocular.BATCH_KEYS)
    nets = [mods.model] if mods.lpips is None else [mods.model, mods.lpips]
    return (inputs, mods.cfg), graphs.read_tensors(*nets) + [mods.faces, mods.edges, mods.lap]


def _eager(mods, inputs: dict) -> dict:
    _, aux = monocular.forward(mods, inputs)
    model = mods.model
    return dict({k: aux[k] for k in FORWARD_OUTPUTS}, lbs=model.get_lbs(),
                mean_shape=model.get_mean_shape().detach())


class _Inputs:
    """The static inputs: views of one device buffer, filled from one pinned
    host buffer."""

    def __init__(self, mods, batch: dict):
        shapes = {k: tuple(batch[k].shape) for k in monocular.BATCH_KEYS}
        n = sum(_padded(math.prod(s)) for s in shapes.values())
        self.host = torch.empty(n, dtype=torch.float32, pin_memory=True)
        self.device = torch.empty(n, dtype=torch.float32, device=mods.device)
        self.host_views, self.views = _views(self.host, shapes), _views(self.device, shapes)
        self.uploaded = torch.cuda.Event()

    def upload(self, batch: dict) -> None:
        """The request's arrays as float32 into the static inputs, in one
        copy; the pinned buffer is written once the last copy from it is
        done. Arrays go in through numpy, on this thread: torch's CPU copy
        of an image wakes its thread pool, whose tail on a busy host reaches
        tens of ms."""
        self.uploaded.synchronize()
        for k, t in self.host_views.items():
            src = batch[k]
            if torch.is_tensor(src):
                t.copy_(src)
            else:
                np.copyto(t.numpy(), src, casting="unsafe")
        self.device.copy_(self.host, non_blocking=True)
        self.uploaded.record()


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


def forward_outputs(mods: monocular.MonoModules, batch: dict) -> dict:
    """FORWARD_OUTPUTS of monocular.forward in eval mode on `batch` (arrays
    of monocular.BATCH_KEYS), and the model's `lbs` and `mean_shape`,
    through graphs.run. Call it under torch.inference_mode()."""
    return graphs.run(
        "predict", mods, mods.device, lambda: graph_signature(mods, batch),
        eager=lambda: _eager(mods, monocular.to_device_batch(mods, batch)),
        static=lambda: _Inputs(mods, batch), load=lambda inputs: inputs.upload(batch),
        fn=lambda inputs: _eager(mods, inputs.views))
