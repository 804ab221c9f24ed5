"""Cost volume: the CUDA kernel's wrapper, its launch plan, its plain
PyTorch version and the dispatch between them.

Counterpart of acfm_video_3d_reconstruction_tpu/flow/correlation_pallas.py
(the TPU kernel) and of flow/ops.py::correlation (the XLA function it is
held against). `correlation` launches csrc/correlation.cu on a CUDA tensor,
at every shape (no size-based fallback), and runs `correlation_plain` on a
CPU tensor. Layout NCHW: f1, f2 (B, C, H, W) -> (B, (2md+1)^2, H, W), where
channel d = (dy+md)(2md+1) + (dx+md) holds
sum_c f1[:, c, y, x] * f2[:, c, y+dy, x+dx] / C, zero outside the image.

`launch_plan(B, C, H, W, md)` is the kernel's launch, a fixed function of
the shape: which of the source's two templates runs and with what tiles,
grid, block and shared memory. `launch(fn, f1, f2, out, md)` only
launches, on contiguous inputs and an output made by the caller;
`correlation_cuda` checks, allocates, launches and counts.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops.cuda_build import load

# the displacement radii of MaskFlownet's two stages, for which the kernel
# is instantiated
MDS = (4, 2)

# Kernel launches on the card, by displacement radius; the plain version
# never counts.
LAUNCHES = {f"corr_md{md}": 0 for md in MDS}

# csrc/correlation.cu's templates, in the order of its `kernel` argument,
# and the constants it is compiled with: P pixels of a row a thread; the
# tile kernel's TILE_GX threads along a 32-pixel strip, TILE_TY output rows
# and TILE_CC channels a chunk; the split kernel's 32 four-pixel groups and
# at most SPLIT_MAX_THREADS threads a block.
TEMPLATES = ("tile", "split")
P, TILE_GX, TILE_TY, TILE_CC = 4, 8, 4, 8
SPLIT_GROUPS, SPLIT_MAX_THREADS = 32, 512
# The H100's streaming multiprocessors: the tile kernel runs where its grid
# holds at least 1.5 blocks for each.
NUM_SMS = 132


class Plan(NamedTuple):
    template: str  # "tile" or "split"
    p: int  # pixels of a row a thread
    ty: int  # output rows a block (tile; 1 for split)
    dy: int  # displacement rows a block
    cs: int  # channel groups a block (split; 1 for tile)
    chunk: int  # channels staged a step (tile), or a group's channels (split)
    grid: tuple[int, int, int]
    block: int  # threads
    smem: int  # dynamic shared bytes


@functools.lru_cache(maxsize=None)
def launch_plan(B: int, C: int, H: int, W: int, md: int) -> Plan:
    """The kernel's launch for this shape.

    tile: a block owns TILE_TY = 4 output rows of a 32-pixel strip and
    every displacement row; thread (g, dy, ty) the 4 pixels 4g.. of its row
    for one dy. Grid (ceil(W/32), ceil(H/4), B), 8 (2md+1) 4 threads,
    channels staged TILE_CC = 8 at a time (f1's 4 rows and f2's 4 + 2md
    rows, 40 wide, as float4s). It runs where that grid holds at least
    1.5 NUM_SMS = 198 blocks: levels 3 and 2 of the trainer's pass (12
    pairs, net at 384x768; 432 and 1728 blocks), level 2 of the flow CLI's
    at one pair (224 blocks at 448x1024, 240 at 384x1280). Both templates
    timed at all three passes on an H100: the tile kernel is the faster at
    224 blocks and more, the split one at 144 (the trainer's level 4) and
    fewer (PERF.md).
    split, everywhere else (levels 6-4; 6-3 at one pair): a block owns 32
    four-pixel groups of the flattened (b, y, x/4) range and DY
    displacement rows; its CS
    channel groups of `chunk` channels each (about 12, at most 16 groups,
    none empty) sum their slices, then meet in shared memory (one float4
    per group, row and thread). DY is the largest divisor of 2md+1 that
    keeps the block within SPLIT_MAX_THREADS threads and 48 KB, else 1.
    """
    side = 2 * md + 1
    grid = (math.ceil(W / (P * TILE_GX)), math.ceil(H / TILE_TY), B)
    if grid[0] * grid[1] * grid[2] >= 3 * NUM_SMS // 2:
        staged = TILE_CC * ((TILE_TY + 2 * md) * (P * TILE_GX + 8) + TILE_TY * P * TILE_GX)
        return Plan("tile", P, TILE_TY, side, 1, TILE_CC, grid, TILE_GX * side * TILE_TY,
                    4 * staged)
    chunk = math.ceil(C / min(16, math.ceil(C / 12)))
    cs = math.ceil(C / chunk)

    def smem(dy):
        return 16 * cs * dy * side * SPLIT_GROUPS

    dy = max([d for d in range(1, side + 1) if side % d == 0 and smem(d) <= 48 * 1024
              and SPLIT_GROUPS * d * cs <= SPLIT_MAX_THREADS], default=1)
    groups = B * H * math.ceil(W / P)
    grid = (math.ceil(groups / SPLIT_GROUPS), side // dy, 1)
    return Plan("split", P, 1, dy, cs, chunk, grid, SPLIT_GROUPS * dy * cs, smem(dy))


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


# acfm_correlation(f1, f2, out, B, C, H, W, md, inv_c, kernel, p, ty, dy,
# cs, chunk, grid x, y, z, block, smem, stream)
ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_float]
            + [ctypes.c_int] * 11 + [ctypes.c_void_p])


def entry():
    """The kernel's C entry, csrc/correlation.cu built at first use."""
    fn = load("correlation.cu").acfm_correlation
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ARGTYPES
    return fn


def launch(fn, f1: torch.Tensor, f2: torch.Tensor, out: torch.Tensor, md: int) -> None:
    """One launch of a C entry `fn` (entry(), or another build's) on
    contiguous f32 CUDA tensors at launch_plan's numbers, writing out
    (B, (2md+1)^2, H, W). correlation_cuda's launch; timing code calls it
    with an output made once. Raises on a non-zero CUDA error (a plan the
    entry refuses included)."""
    B, C, H, W = f1.shape
    plan = launch_plan(B, C, H, W, md)
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream(f1.device).cuda_stream
        err = fn(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), B, C, H, W, md, 1.0 / C,
                 TEMPLATES.index(plan.template), plan.p, plan.ty, plan.dy, plan.cs, plan.chunk,
                 *plan.grid, plan.block, plan.smem, stream)
    if err:
        raise RuntimeError(f"correlation kernel launch failed: CUDA error {err}")


def correlation_cuda(f1: torch.Tensor, f2: torch.Tensor, md: int = 4) -> torch.Tensor:
    """Launch csrc/correlation.cu on f32 CUDA tensors."""
    _check(f1, f2, md)
    if not (f1.is_cuda and f2.is_cuda and f1.device == f2.device):
        raise ValueError("correlation_cuda takes CUDA tensors on one device")
    if f1.dtype != torch.float32 or f2.dtype != torch.float32:
        raise ValueError(f"f32 expected, got {f1.dtype} / {f2.dtype}")
    B, C, H, W = f1.shape
    if max(B, C, (2 * md + 1) ** 2) * H * W >= 2 ** 31:
        raise ValueError(f"{tuple(f1.shape)}: the kernel indexes a pair's planes with int32")
    f1 = f1.contiguous()
    f2 = f2.contiguous()
    out = torch.empty((B, (2 * md + 1) ** 2, H, W), dtype=torch.float32, device=f1.device)
    launch(entry(), f1, f2, out, md)
    LAUNCHES[f"corr_md{md}"] += 1
    return out


def correlation(f1: torch.Tensor, f2: torch.Tensor, md: int = 4) -> torch.Tensor:
    """The cost volume: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    fn = correlation_cuda if f1.is_cuda else correlation_plain
    return fn(f1, f2, md)
