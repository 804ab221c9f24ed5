"""The cost-volume kernel's launch plan, on the CPU.

flow/correlation_cuda.py::launch_plan picks, from the shape alone, which of
csrc/correlation.cu's two templates runs and with what numbers. The kernel
runs only on the card; here the plan is held to what the kernel's index
map (csrc/correlation.cu's note, modelled below in numpy) needs: the grid
and the threads' tiles cover every output (b, d, y, x) exactly once, a
block has at most 1024 threads and 232,448 bytes of shared memory, and the
channel chunks or groups partition [0, C). At the 10 shapes of each pass
of the flow net that the port runs, and at ragged shapes. The card's
kernel tests (tests/test_torch_port_kernels.py) take their shapes from
here.
"""
import math

import numpy as np
import pytest

from acfm_video_3d_reconstruction_tpu_torch.flow import correlation_cuda as cc
from acfm_video_3d_reconstruction_tpu_torch.flow.maskflownet import PYR_CH



def _pass_shapes(B, nh, nw):
    """(B, C, H, W, md) of the net's cost volumes at an nh x nw input,
    levels 6..2, md 4 and 2."""
    return [(B, PYR_CH[lvl - 1], nh >> lvl, nw >> lvl, md)
            for md in (4, 2) for lvl in (6, 5, 4, 3, 2)]


# the multiframe trainer's pass (12 pairs, net at 384x768) and the flow
# CLI's on one Sintel frame (436x1024 -> 448x1024) and one KITTI frame
# (375x1242 -> 384x1280)
FLOW_SHAPES = _pass_shapes(12, 384, 768)
NATIVE_SHAPES = _pass_shapes(1, 448, 1024) + _pass_shapes(1, 384, 1280)
RAGGED_SHAPES = [
    (1, 32, 96, 190, 4),   # W not a multiple of the pixels a thread
    (2, 20, 40, 29, 2),    # W under the strip, C not a multiple of the chunk
    (12, 7, 96, 33, 4),    # one pixel past a strip; C under the chunk
    (3, 5, 3, 50, 4),      # H < 2md+1
    (1, 1, 1, 1, 4),       # H = W = C = B = 1
    (4, 3, 1, 17, 2),      # H = 1
    (5, 9, 13, 1, 2),      # W = 1
    (1, 1, 200, 300, 2),   # C = 1, a tile grid
    (2, 197, 6, 12, 4),    # C one past a multiple of the groups
    (1, 50, 7, 5, 2),      # B = 1, C not a multiple of the groups
]
CORR_SHAPES = FLOW_SHAPES + NATIVE_SHAPES + RAGGED_SHAPES
CORR_IDS = [f"{B}x{C}x{H}x{W}md{md}" for B, C, H, W, md in CORR_SHAPES]


def _tile_cover(plan, B, H, W, md):
    """Per output (b, d, y, x), how many tile-kernel threads write it:
    block (bx, by, bz), thread t = g + GX * (dyi + side * ty) writes
    pixels x = 32 bx + 4 g + i (i < P, x < W) of row y = TY by + ty (< H)
    for d = dyi * side + dx, every dx."""
    side = 2 * md + 1
    gx_threads = plan.block // (side * plan.ty)
    xs = plan.p * gx_threads
    count = np.zeros((B, side * side, H, W), np.int64)
    t = np.arange(plan.block)
    g, dyi, ty = t % gx_threads, (t // gx_threads) % side, t // (gx_threads * side)
    for bx in range(plan.grid[0]):
        for by in range(plan.grid[1]):
            for i in range(plan.p):
                x = xs * bx + plan.p * g + i
                y = plan.ty * by + ty
                ok = (x < W) & (y < H)
                for dx in range(side):
                    np.add.at(count, (slice(None), dyi[ok] * side + dx, y[ok], x[ok]), 1)
    assert plan.grid[2] == B  # blockIdx.z is the pair
    return count


def _split_cover(plan, B, H, W, md):
    """Per output, how many split-kernel writes it gets: block (bx, by)
    reduces element e = (d * side + dx) * 32 + l, l < 32, into the 4
    pixels x = 4 (m % gw) + i (x < W) of group m = 32 bx + l of the
    flattened (b, y, x/4) range (gw = ceil(W/4) groups a row) and
    displacement row dyi = DY by + d, where m < B H gw and dyi < side."""
    side = 2 * md + 1
    gw = math.ceil(W / plan.p)
    count = np.zeros((B, H, W, side, side), np.int64)
    e = np.arange(plan.dy * side * 32)
    lane, dx, d = e % 32, (e // 32) % side, e // (32 * side)
    for bx in range(plan.grid[0]):
        for by in range(plan.grid[1]):
            m, dyi = 32 * bx + lane, plan.dy * by + d
            ok = (m < B * H * gw) & (dyi < side)
            b, y = m // (H * gw), m // gw % H
            for i in range(plan.p):
                x = plan.p * (m % gw) + i
                o = ok & (x < W)
                np.add.at(count, (b[o], y[o], x[o], dyi[o], dx[o]), 1)
    return count.reshape(B, H, W, side * side).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("B,C,H,W,md", CORR_SHAPES, ids=CORR_IDS)
def test_launch_plan_covers_every_output_once(B, C, H, W, md):
    plan = cc.launch_plan(B, C, H, W, md)
    side = 2 * md + 1
    assert plan.template in cc.TEMPLATES
    assert 1 <= plan.block <= 1024
    assert 0 <= plan.smem <= 232_448
    assert all(1 <= n < 2 ** 31 for n in plan.grid) and plan.grid[1] <= 65_535
    if plan.template == "tile":
        assert plan.block == cc.TILE_GX * side * plan.ty and plan.dy == side and plan.cs == 1
        assert plan.smem == 4 * plan.chunk * ((plan.ty + 2 * md) * (plan.p * cc.TILE_GX + 8)
                                              + plan.ty * plan.p * cc.TILE_GX)
        count = _tile_cover(plan, B, H, W, md)
        # the chunks [c0, c0 + chunk) for c0 = 0, chunk, ... < C, zero past C
        walked = [c for c0 in range(0, C, plan.chunk) for c in range(c0, c0 + plan.chunk) if c < C]
        assert walked == list(range(C))
    else:
        assert plan.block == 32 * plan.dy * plan.cs <= cc.SPLIT_MAX_THREADS and plan.ty == 1
        assert plan.smem == 16 * plan.cs * plan.dy * side * 32
        count = _split_cover(plan, B, H, W, md)
        groups = [range(k * plan.chunk, min(C, (k + 1) * plan.chunk)) for k in range(plan.cs)]
        assert all(len(r) > 0 for r in groups)  # no empty group
        assert [c for r in groups for c in r] == list(range(C))
    assert count.shape == (B, side * side, H, W)
    assert (count == 1).all()


def test_launch_plan_tiles_fine_levels_and_splits_coarse_ones():
    """The tile kernel where its strip grid holds 1.5 blocks per SM, the
    channel split below, for both radii: at 12 pairs levels 3 and 2 tile
    (432 and 1728 blocks) and levels 6-4 split (level 4: 144 blocks); at
    one pair level 2 tiles (224 or 240 blocks) and levels 6-3 split."""
    for B, C, H, W, md in FLOW_SHAPES + NATIVE_SHAPES:
        plan = cc.launch_plan(B, C, H, W, md)
        fine = H >= (48 if B == 12 else 96)
        assert plan.template == ("tile" if fine else "split"), (B, C, H, W, md)
