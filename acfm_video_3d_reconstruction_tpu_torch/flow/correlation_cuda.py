"""Cost volume: the CUDA kernel's wrapper, its plain PyTorch version and the
dispatch between them.

Counterpart of acfm_video_3d_reconstruction_tpu/flow/correlation_pallas.py
(the TPU kernel) and of flow/ops.py::correlation (the XLA function it is
held against). `correlation` launches csrc/correlation.cu on a CUDA tensor,
at every shape (no size-based fallback), and runs `correlation_plain` on a
CPU tensor. Layout NCHW: f1, f2 (B, C, H, W) -> (B, (2md+1)^2, H, W), where
channel d = (dy+md)(2md+1) + (dx+md) holds
sum_c f1[:, c, y, x] * f2[:, c, y+dy, x+dx] / C, zero outside the image.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..ops.cuda_build import load

# the displacement radii of MaskFlownet's two stages, for which the kernel
# is instantiated
MDS = (4, 2)

# Kernel launches on the card, by displacement radius; the plain version
# never counts.
LAUNCHES = {f"corr_md{md}": 0 for md in MDS}


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


def correlation_cuda(f1: torch.Tensor, f2: torch.Tensor, md: int = 4) -> torch.Tensor:
    """Launch csrc/correlation.cu on f32 CUDA tensors."""
    _check(f1, f2, md)
    if not (f1.is_cuda and f2.is_cuda and f1.device == f2.device):
        raise ValueError("correlation_cuda takes CUDA tensors on one device")
    if f1.dtype != torch.float32 or f2.dtype != torch.float32:
        raise ValueError(f"f32 expected, got {f1.dtype} / {f2.dtype}")
    B, C, H, W = f1.shape
    fn = load("correlation.cu").acfm_correlation
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                   ctypes.c_void_p]
    f1 = f1.contiguous()
    f2 = f2.contiguous()
    out = torch.empty((B, (2 * md + 1) ** 2, H, W), dtype=torch.float32, device=f1.device)
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream(f1.device).cuda_stream
        err = fn(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), B, C, H, W, md, 1.0 / C, stream)
    if err:
        raise RuntimeError(f"correlation kernel launch failed: CUDA error {err}")
    LAUNCHES[f"corr_md{md}"] += 1
    return out


def correlation(f1: torch.Tensor, f2: torch.Tensor, md: int = 4) -> torch.Tensor:
    """The cost volume: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    fn = correlation_cuda if f1.is_cuda else correlation_plain
    return fn(f1, f2, md)
