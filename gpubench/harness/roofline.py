"""A kernel's least time: the larger of its operations over the
configuration's peak and its bytes over the card's bandwidth, each input
byte read once and each output byte written once (the arithmetic of
chip_smoke.py's _bound, _raster_ops and the cost volume's counts, kept
with the benchmark).
"""
from __future__ import annotations


def least_s(ops: float, nbytes: float, peak: dict) -> float:
    return max(ops / peak["flops_per_s"], nbytes / peak["bytes_per_s"])


def raster_bins(image_size: int, num_faces: int) -> tuple:
    """(bins per view, bin capacity K) of the binned rasterizer."""
    from ..reference.frozen.ops import rasterizer as ras
    from ..reference.frozen.ops import rasterizer_cuda as rc

    th, tw = rc._pick_tiles(image_size)
    K = rc._round_up(min(rc.auto_K(num_faces, image_size, ras.DEFAULT_K), num_faces), rc.K_CHUNK)
    return (image_size // th) * (image_size // tw), K


def raster_fwd_bytes(views: int, image_size: int, num_faces: int) -> int:
    """The forward's table (9 floats a slot), slot ids and counts read, and
    its five maps written."""
    T, K = raster_bins(image_size, num_faces)
    return 4 * (views * T * K * 9 + views * T * K + views * T + 5 * views * image_size ** 2)


def raster_bwd_bytes(views: int, image_size: int, num_faces: int) -> int:
    """The backward's table and counts and dS read, the table's gradient
    written."""
    T, K = raster_bins(image_size, num_faces)
    return 4 * (2 * views * T * K * 9 + views * T + views * image_size ** 2)


def flow_levels(net_hw) -> list:
    """(md, C, H, W, launches per pass) of the cost volumes of one
    two-stage MaskFlownet pass at net_hw: stage 1 one md=4 volume a level,
    stage 2 two md=2 volumes a level, levels 6 to 2."""
    from ..reference.frozen.flow.maskflownet import PYR_CH

    nh, nw = net_hw
    return [(md, PYR_CH[lvl - 1], nh >> lvl, nw >> lvl, per)
            for md, per in ((4, 1), (2, 2)) for lvl in (6, 5, 4, 3, 2)]


def corr_ops_bytes(pairs: int, md: int, C: int, H: int, W: int) -> tuple:
    """2*B*H*W*C*nd operations; 4*(2*B*H*W*C + B*H*W*nd) bytes."""
    nd = (2 * md + 1) ** 2
    return 2 * pairs * H * W * C * nd, 4 * (2 * pairs * H * W * C + pairs * H * W * nd)
