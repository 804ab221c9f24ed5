"""Cost volume, plain PyTorch: a frozen copy of the port's
flow/correlation_cuda.py without the CUDA kernel's wrapper and launch plan.

Layout NCHW: f1, f2 (B, C, H, W) -> (B, (2md+1)^2, H, W), where channel
d = (dy+md)(2md+1) + (dx+md) holds sum_c f1[:, c, y, x] * f2[:, c, y+dy, x+dx]
/ C, zero outside the image. `correlation` runs `correlation_plain` on any
device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# the displacement radii of MaskFlownet's two stages
MDS = (4, 2)


def _check(f1: torch.Tensor, f2: torch.Tensor, md: int) -> None:
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"f1 {tuple(f1.shape)} / f2 {tuple(f2.shape)}: two equal (B, C, H, W)")
    if f1.numel() == 0:
        raise ValueError("empty feature maps")
    if md not in MDS:
        raise ValueError(f"md={md}: the kernel takes {MDS}")


def correlation_plain(f1: torch.Tensor, f2: torch.Tensor, md: int = 4) -> torch.Tensor:
    """Plain PyTorch version: one shifted product per displacement, summed
    over the channels, then scaled by 1/C (the kernel's order of
    operations)."""
    _check(f1, f2, md)
    B, C, H, W = f1.shape
    f2p = F.pad(f2, (md, md, md, md))
    side = 2 * md + 1
    outs = [(f1 * f2p[:, :, dy:dy + H, dx:dx + W]).sum(1)
            for dy in range(side) for dx in range(side)]
    return torch.stack(outs, dim=1) * (1.0 / C)


def correlation(f1: torch.Tensor, f2: torch.Tensor, md: int = 4) -> torch.Tensor:
    """The cost volume: the plain version on every device."""
    return correlation_plain(f1, f2, md)
