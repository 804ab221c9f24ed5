"""What the references share: the seeds a run derives, the precision they
run in and the count of a step's operations.

The reference is plain PyTorch: the frozen copies under frozen/ (the
port's modules with their plain rasterizer and cost volume, taken at the
commit that added the benchmark), in float32 at the precision the
configuration states (multiframe: TF32 off; monocular: PyTorch's default,
cuDNN convolutions in TF32). It imports nothing of the program.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn


def weight_seed(seed: int, net: int) -> int:
    """The weights' generator seed of net number `net` for a run's seed."""
    return int(seed) * 8 + net


def loader_seed(seed: int) -> int:
    return int(seed)


def data_seed(seed: int) -> int:
    return int(seed) + 1


TF32_ALL = {"matmul_tf32": True, "cudnn_tf32": True}


def set_precision(p: dict) -> None:
    """The backends' TF32 switches as the configuration states them."""
    torch.backends.cuda.matmul.allow_tf32 = bool(p["matmul_tf32"])
    torch.backends.cudnn.allow_tf32 = bool(p["cudnn_tf32"])


@contextlib.contextmanager
def precision(p: dict):
    """The TF32 switches of `p` (a configuration's precision) for the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    set_precision(p)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class FlopCounter:
    """Operations of the convolutions and linear layers a module runs,
    counted by forward hooks from the shapes they see (an FMA is two)."""

    def __init__(self, module: nn.Module):
        self.flops = 0
        self.handles = [m.register_forward_hook(self._hook) for m in module.modules()
                        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))]

    def _hook(self, m, inputs, out):
        x = inputs[0]
        if isinstance(m, nn.Linear):
            self.flops += 2 * m.in_features * out.numel()
        elif isinstance(m, nn.Conv2d):
            k = m.kernel_size[0] * m.kernel_size[1] * (m.in_channels // m.groups)
            self.flops += 2 * k * out.numel()
        else:  # transposed: every input element meets the whole kernel
            k = m.kernel_size[0] * m.kernel_size[1] * (m.out_channels // m.groups)
            self.flops += 2 * k * x.numel()

    def close(self) -> int:
        for h in self.handles:
            h.remove()
        return self.flops


def count_flops(module: nn.Module, call) -> int:
    counter = FlopCounter(module)
    try:
        with torch.no_grad():
            call()
    finally:
        flops = counter.close()
    return flops


def solve_flops(num_verts: int, rhs_columns: int) -> int:
    """The screened-Poisson solve of one call: the normal matrix (2V^3), its
    Cholesky factor (V^3/3) and the two triangular solves of every
    right-hand column (2V^2 each), forward, and the backward's two solves."""
    V = num_verts
    return 2 * V ** 3 + V ** 3 // 3 + 2 * (2 * V * V * rhs_columns)
