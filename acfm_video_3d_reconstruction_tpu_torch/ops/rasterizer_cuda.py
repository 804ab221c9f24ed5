"""Binned rasterizer: the bin pass, the forward and backward CUDA kernels'
wrappers and their plain PyTorch versions.

Counterpart of acfm_video_3d_reconstruction_tpu/ops/rasterizer_tpu.py. The
bin geometry is part of the semantics, not a tuning
choice, because a bin keeps at most K faces and silently drops the rest:
  * bins are the TPU layout's row strips (16 x 128 px at 256^2, _pick_tiles);
  * K = round_up(min(K, F), 64), with K from auto_K;
  * each (view, bin) keeps its overlapping faces in ascending face order,
    so on overflow the lowest face indices win;
  * the bin margin is sqrt(max(blur_radius, BLUR_RADIUS)) in both modes.
So the port drops exactly the faces the TPU kernels drop.

`rasterize_binned` runs the forward kernel csrc/raster_fwd.cu on a CUDA
tensor and its plain PyTorch version (`forward_plain`) on a CPU tensor. It
returns untiled (B, H, W) maps. In soft mode it goes through `SoftRasterize`,
whose backward is the kernel csrc/raster_bwd.cu on a CUDA tensor and
`backward_plain` on a CPU tensor. The kernels and the plain versions skip
the (pixel, slot) pairs outside `cull_windows`, which are out of radius, and
`cull_pair_counts` gives the pairs the kernels walk.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .cuda_build import load

SIGMA = 1e-4
# blur_radius = log(1/1e-4 - 1) * sigma (PyTorch3D blend defaults)
BLUR_RADIUS = math.log(1.0 / 1e-4 - 1.0) * SIGMA
BIG = 1e10  # empty z-buffer value
K_CHUNK = 64  # the bin capacity is rounded up to a multiple of this
SLOT_CHUNK = 8  # slots per step of the plain versions' walk over a bin

# Kernel launches on the card, by kernel; the plain versions never count.
LAUNCHES = {"soft": 0, "hard": 0, "soft_bwd": 0}


class BinnedFrags(NamedTuple):
    """Per-pixel forward outputs, each (B, H, W)."""

    S: torch.Tensor            # sum of log(1 - p_f); mask = 1 - exp(S)
    pix_to_face: torch.Tensor  # int32 argmin-z in-radius face, -1 = none
    b0: torch.Tensor           # clipped renormalised barycentrics of it
    b1: torch.Tensor
    zbuf: torch.Tensor         # its depth, BIG = none


# ---------------------------------------------------------------- binning --

def _pick_tiles(image_size: int) -> tuple[int, int]:
    """Bin shape: width 128 where it divides the image, height 16."""
    tile_w = min(128, image_size)
    while image_size % tile_w:
        tile_w //= 2
    tile_h = max(8, min(16, image_size // 2))
    while image_size % tile_h:
        tile_h //= 2
    return tile_h, tile_w


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def auto_K(num_faces: int, image_size: int, requested: int) -> int:
    """Bin capacity that cannot silently drop faces at small sizes: the
    exact face count below 256^2, `requested` (192 covers a frame-filling
    1280-face mesh) from 256^2 up."""
    if num_faces <= requested or image_size >= 256:
        return requested
    return num_faces


def _margin(blur_radius: float) -> float:
    return math.sqrt(max(blur_radius, BLUR_RADIUS))


def _tile_overlap(verts, faces, image_size, tile_h, tile_w, margin):
    """(B, T, F) bool: face bbox (+margin) overlaps pixel bin t."""
    xy = verts[:, faces.long(), :2]  # (B, F, 3, 2)
    xmin = xy[..., 0].amin(-1) - margin
    xmax = xy[..., 0].amax(-1) + margin
    ymin = xy[..., 1].amin(-1) - margin
    ymax = xy[..., 1].amax(-1) + margin

    def extent(n, size):
        start = torch.arange(n, device=verts.device) * size
        lo = (2.0 * start.float() + 1.0) / image_size - 1.0
        hi = (2.0 * (start + size - 1).float() + 1.0) / image_size - 1.0
        return lo, hi

    n_ty, n_tx = image_size // tile_h, image_size // tile_w
    y0, y1 = extent(n_ty, tile_h)
    x0, x1 = extent(n_tx, tile_w)
    ty0, ty1 = y0.repeat_interleave(n_tx), y1.repeat_interleave(n_tx)
    tx0, tx1 = x0.repeat(n_ty), x1.repeat(n_ty)
    return (
        (xmin[:, None, :] <= tx1[None, :, None])
        & (xmax[:, None, :] >= tx0[None, :, None])
        & (ymin[:, None, :] <= ty1[None, :, None])
        & (ymax[:, None, :] >= ty0[None, :, None])
    )


def bin_overflow_counts(verts, faces, image_size: int, K: int,
                        margin: float = BLUR_RADIUS) -> torch.Tensor:
    """(B, T) number of faces each bin drops at capacity K."""
    th, tw = _pick_tiles(image_size)
    ov = _tile_overlap(verts, faces, image_size, th, tw, margin)
    return torch.clamp(ov.sum(-1) - K, min=0)


def _face_tables(verts, faces, image_size, tile_h, tile_w, K, margin):
    """Per-bin compacted face tables.

    Returns (table (B, T, K, 9) f32 rows [ax ay bx by cx cy za zb zc],
    idx (B, T, K) int32 face ids, -1 past the bin's count). The k-th
    overlapping face of a bin lands in slot k (inclusive cumsum - 1), so
    slots hold faces in ascending order and faces past K are dropped:
    O(B*T*F) work, the same idx as the TPU binning's compare-reduce. Only
    the gather of the face rows is differentiable: its backward scatters
    the slots' rows to the faces, and an invalid slot (which gathers face
    0) must carry a zero row.
    """
    with torch.no_grad():  # a boolean overlap: no graph to keep
        ov = _tile_overlap(verts, faces, image_size, tile_h, tile_w, margin)
    B, T, F = ov.shape
    c = torch.cumsum(ov.to(torch.int32), dim=-1)
    pos = torch.where(ov & (c <= K), c - 1, K).long()  # slot K = dump
    idx = torch.full((B, T, K + 1), -1, dtype=torch.int32, device=verts.device)
    face_ids = torch.arange(F, dtype=torch.int32, device=verts.device)
    idx.scatter_(2, pos, face_ids.expand(B, T, F))
    idx = idx[..., :K].contiguous()

    fv = verts[:, faces.long()]  # (B, F, 3, 3)
    comp = torch.cat([fv[..., :, :2].reshape(B, F, 6), fv[..., :, 2]], dim=-1)
    safe = idx.clamp(min=0).reshape(B, T * K, 1).long().expand(-1, -1, 9)
    table = torch.gather(comp, 1, safe).reshape(B, T, K, 9)
    return table, idx


# ------------------------------------------------------------ face culling --
#
# The kernels evaluate a (pixel, slot) pair only where the pixel centre lies
# in the slot's window: the face's box widened by the cull margin m, or the
# whole bin for a face whose f32 area is under the threshold below. Every
# pair outside the window has in_radius == False under _face_geometry (the
# proof is in csrc/raster_geometry.cuh; tests/test_torch_port_raster.py
# checks it exhaustively), so skipping it changes no output bit: its log
# term is +0 and it never wins the z-test. csrc/raster_geometry.cuh's
# cull_window computes the same f32 expressions, constant for constant.

CULL_MIN_MARGIN_PX = 1.0  # least cull margin, in pixels (hard mode's margin)
FWD_PATCH = (4, 8)  # pixel patch of one warp in csrc/raster_fwd.cu (rows, cols)


def cull_windows(table, image_size, tile_h, tile_w, blur_radius, soft) -> torch.Tensor:
    """(B, T, K, 4) int32 bin-local pixel windows [x0, x1, y0, y1]
    (inclusive; empty when x0 > x1 or y0 > y1) of every slot of `table`
    (B, T, K, 9). A pixel of bin t outside its slot's window has
    in_radius == False for that slot.

    With the face box [xmin, xmax] x [ymin, ymax], the bin's pixel-centre
    extent [qx0, qx1] x [qy0, qy1] and Dx = max(xmax - qx0, qx1 - xmin) (Dy
    alike), Ex = xmax - xmin (Ey alike):
      m = max(sqrt(blur)(1 + 2^-12) + 2^-18 (Dx + Dy + Ex + Ey + 4), 1 px),
          with blur = blur_radius in soft mode and 0 in hard mode;
      T = max(2^-24 (64 Dx Dy max(Dx, Dy) / m + 16 Ex Ey), 1e-12);
      a slot with |area| < T (or a NaN area) gets the whole bin, any other
      the pixel centres within [xmin - m, xmax + m] x [ymin - m, ymax + m].
    Every operation is the kernels' f32 operation, in their order.
    """
    B, T, K, _ = table.shape
    f32 = table.new_tensor  # an f32 scalar on table's device
    S, one, half = f32(float(image_size)), f32(1.0), f32(0.5)
    n_bx = image_size // tile_w
    t = torch.arange(T, device=table.device)
    bx0 = ((t % n_bx) * tile_w).float()[None, :, None]
    by0 = ((t // n_bx) * tile_h).float()[None, :, None]

    def centre(i):  # the kernels' pixel centre, (2i + 1) / S - 1
        return (f32(2.0) * i + one) / S - one

    qx0, qx1 = centre(bx0), centre(bx0 + float(tile_w - 1))
    qy0, qy1 = centre(by0), centre(by0 + float(tile_h - 1))
    ax, ay, bx, by, cx, cy = table[..., :6].unbind(-1)
    xmin = torch.minimum(torch.minimum(ax, bx), cx)
    xmax = torch.maximum(torch.maximum(ax, bx), cx)
    ymin = torch.minimum(torch.minimum(ay, by), cy)
    ymax = torch.maximum(torch.maximum(ay, by), cy)
    area = _fma(bx - ax, cy - ay, -((by - ay) * (cx - ax)))
    Dx = torch.maximum(xmax - qx0, qx1 - xmin)
    Dy = torch.maximum(ymax - qy0, qy1 - ymin)
    Ex, Ey = xmax - xmin, ymax - ymin
    pad = f32(2.0 ** -18) * ((((Dx + Dy) + Ex) + Ey) + f32(4.0))
    blur = f32(blur_radius if soft else 0.0)
    m = torch.maximum(torch.sqrt(blur) * f32(1.0 + 2.0 ** -12) + pad,
                      f32(CULL_MIN_MARGIN_PX) * f32(2.0) / S)
    Dm = torch.maximum(Dx, Dy)
    thresh = torch.clamp(f32(2.0 ** -24) * (f32(64.0) * ((Dx * Dy) * Dm) / m
                                            + f32(16.0) * (Ex * Ey)), min=1e-12)
    whole = ~(torch.abs(area) >= thresh)
    hs = S * half

    def first(lo, origin, size):  # first bin-local pixel with centre >= lo
        return torch.clamp(torch.ceil((lo + one) * hs - half) - origin, 0.0, float(size))

    def last(hi, origin, size):  # last bin-local pixel with centre <= hi
        return torch.clamp(torch.floor((hi + one) * hs - half) - origin, -1.0, float(size - 1))

    x0, x1 = first(xmin - m, bx0, tile_w), last(xmax + m, bx0, tile_w)
    y0, y1 = first(ymin - m, by0, tile_h), last(ymax + m, by0, tile_h)
    zero = torch.zeros_like(x0)
    x0, y0 = torch.where(whole, zero, x0), torch.where(whole, zero, y0)
    x1 = torch.where(whole, zero + float(tile_w - 1), x1)
    y1 = torch.where(whole, zero + float(tile_h - 1), y1)
    return torch.stack([x0, x1, y0, y1], -1).to(torch.int32)


def cull_pair_counts(windows, idx, tile_h, tile_w, patch=FWD_PATCH) -> dict:
    """(pixel, slot) pair counts over the valid slots of `idx`:
      bin:    every pixel of the bin (what the kernels walked before culling);
      patch:  the pixels of every patch of `patch` (rows, cols) pixels that
              meets the window (the forward kernel's granularity);
      warp:   each window's pixels rounded up to whole warps of 32 (the
              backward kernel's granularity);
      needed: the window's pixels (the work these inputs need)."""
    valid = idx >= 0
    w = windows[valid].long()
    x0, x1, y0, y1 = w.unbind(-1)
    nx, ny = (x1 - x0 + 1).clamp(min=0), (y1 - y0 + 1).clamp(min=0)
    needed = nx * ny
    ph, pw = patch

    def patch_pixels(lo, hi, n, size, p):
        # pixels of the bin in the patches (along one axis) that meet [lo, hi]
        first, last = lo.div(p, rounding_mode="floor"), hi.div(p, rounding_mode="floor")
        span = (torch.clamp((last + 1) * p, max=size) - first * p).clamp(min=0)
        return torch.where(n > 0, span, torch.zeros_like(span))

    patch_px = patch_pixels(x0, x1, nx, tile_w, pw) * patch_pixels(y0, y1, ny, tile_h, ph)
    return {"bin": int(valid.sum()) * tile_h * tile_w, "patch": int(patch_px.sum()),
            "warp": int(((needed + 31) // 32 * 32).sum()), "needed": int(needed.sum())}


# ------------------------------------------------------- plain PyTorch path --

def _bin_pixels(n_t, image_size, tile_h, tile_w, device):
    """(T, P) pixel-centre NDC coords (x, y) of each bin's pixels, row-major."""
    n_bx = image_size // tile_w
    t = torch.arange(n_t, device=device)[:, None]
    p = torch.arange(tile_h * tile_w, device=device)[None, :]
    y = (t // n_bx) * tile_h + p // tile_w
    x = (t % n_bx) * tile_w + p % tile_w
    px = (2.0 * x.float() + 1.0) / image_size - 1.0
    py = (2.0 * y.float() + 1.0) / image_size - 1.0
    return px, py


def _fma(a, b, c):
    """float32 a*b + c with one rounding (the f64 product is exact)."""
    return (a.double() * b.double() + c.double()).float()


def _barycentric(ax, ay, bx, by, cx, cy, px, py):
    """Unclipped barycentrics: the signed sub-areas over the face's area,
    a near-zero area replaced by 1e-12 (csrc/raster_geometry.cuh)."""
    w0 = _fma(bx - px, cy - py, -((by - py) * (cx - px)))
    w1 = _fma(cx - px, ay - py, -((cy - py) * (ax - px)))
    w2 = _fma(ax - px, by - py, -((ay - py) * (bx - px)))
    area = _fma(bx - ax, cy - ay, -((by - ay) * (cx - ax)))
    denom = torch.where(torch.abs(area) < 1e-12, torch.full_like(area, 1e-12), area)
    return w0 / denom, w1 / denom, w2 / denom


def _seg(ux, uy, vx, vy, px, py):
    """(d^2, dx, dy, t) of the distance from p to segment u -> v, with
    d = w - t*e, w = p - u, e = v - u and t clamped to [0, 1]."""
    ex, ey = vx - ux, vy - uy
    wx, wy = px - ux, py - uy
    ee = torch.clamp(_fma(ex, ex, ey * ey), min=1e-12)
    t = torch.clamp(_fma(wx, ex, wy * ey) / ee, 0.0, 1.0)
    dx = _fma(-t, ex, wx)
    dy = _fma(-t, ey, wy)
    return _fma(dx, dx, dy * dy), dx, dy, t


def _face_geometry(c, px, py, sigma, blur_radius, soft):
    """The kernel's per-(pixel, face) arithmetic, in the same order and
    with the same fused multiply-adds (see csrc/raster_fwd.cu).

    c: (..., 9) face rows broadcast against px/py. Returns (log term, z,
    b0, b1, in_radius).
    """
    ax, ay, bx, by, cx, cy, za, zb, zc = c.unbind(-1)
    b0, b1, b2 = _barycentric(ax, ay, bx, by, cx, cy, px, py)
    inside = (b0 >= 0.0) & (b1 >= 0.0) & (b2 >= 0.0)

    b0c, b1c, b2c = (torch.clamp(v, 0.0, 1.0) for v in (b0, b1, b2))
    s = torch.clamp(b0c + b1c + b2c, min=1e-12)
    b0c, b1c, b2c = b0c / s, b1c / s, b2c / s
    z = _fma(b2c, zc, _fma(b0c, za, b1c * zb))

    if soft:
        d2 = torch.minimum(
            torch.minimum(_seg(ax, ay, bx, by, px, py)[0], _seg(bx, by, cx, cy, px, py)[0]),
            _seg(cx, cy, ax, ay, px, py)[0],
        )
        signed = torch.where(inside, -d2, d2)
        in_radius = inside | (signed < blur_radius)
        v = signed / sigma
        log_sig = torch.clamp(v, max=0.0) - torch.log1p(torch.exp(-torch.abs(v)))
        log1mp = torch.where(in_radius, log_sig, torch.zeros_like(v))
    else:
        in_radius = inside
        log1mp = torch.where(inside, torch.full_like(z, -16.0), torch.zeros_like(z))
    return log1mp, z, b0c, b1c, in_radius


def _untile(x, image_size, tile_h, tile_w):
    """(B, T, th*tw, ...) -> (B, H, W, ...)."""
    B, rest = x.shape[0], x.shape[3:]
    n_by, n_bx = image_size // tile_h, image_size // tile_w
    x = x.reshape(B, n_by, n_bx, tile_h, tile_w, *rest).transpose(2, 3)
    return x.reshape(B, image_size, image_size, *rest)


def _tile(x, image_size, tile_h, tile_w):
    """(B, H, W) -> (B, T, th*tw): the inverse of _untile."""
    B = x.shape[0]
    n_by, n_bx = image_size // tile_h, image_size // tile_w
    x = x.reshape(B, n_by, tile_h, n_bx, tile_w).transpose(2, 3)
    return x.reshape(B, n_by * n_bx, tile_h * tile_w)


def _bins_with_faces(valid_all, k0, kc):
    """The flat indices of the bins (B * T of them) with a valid slot in
    [k0, k0 + kc): the others leave every output as it is in that step."""
    B, T, K = valid_all.shape
    return valid_all.reshape(B * T, K)[:, k0:k0 + kc].any(-1).nonzero()[:, 0]


def _window_pairs(windows, rows_valid, rows, k0, kc, tile_h, tile_w):
    """The valid pairs of bins `rows` and slots [k0, k0 + kc) whose pixel
    lies in the slot's cull window, as flat indices into (len(rows), P, kc)
    and their (row, pixel, slot) indices: windows (B*T, K, 4) and rows_valid
    (B*T, K) as cull_windows and idx >= 0 give them. Every other pair is out
    of radius."""
    w = windows[rows, k0:k0 + kc].long()  # (R, kc, 4)
    lx = torch.arange(tile_w, device=w.device)[None, :, None]
    ly = torch.arange(tile_h, device=w.device)[None, :, None]
    in_x = (lx >= w[:, None, :, 0]) & (lx <= w[:, None, :, 1])  # (R, tw, kc)
    in_y = (ly >= w[:, None, :, 2]) & (ly <= w[:, None, :, 3])  # (R, th, kc)
    pairs = in_y[:, :, None] & in_x[:, None] & rows_valid[rows, None, None, k0:k0 + kc]
    flat = pairs.reshape(-1).nonzero()[:, 0]
    per_row = tile_h * tile_w * kc
    return flat, flat // per_row, flat % per_row // kc, flat % kc


PAIR_BUDGET = 1 << 22  # pairs whose geometry one step of the plain walks evaluates


def _chunk_groups(valid_all, windows, rows_valid, slot_chunk, tile_h, tile_w):
    """The plain walks' chunks of `slot_chunk` slots, each (k0, kc, rows, f,
    r, p, k) as _bins_with_faces and _window_pairs give them, in groups of
    consecutive chunks with at most PAIR_BUDGET pairs (a larger chunk
    alone): the geometry of a group's pairs is evaluated at once, elementwise,
    and each chunk then reduces its own pairs in the walk's order."""
    B, T, K = valid_all.shape
    n_valid = int(valid_all.sum(-1).max())
    group, n = [], 0
    for k0 in range(0, n_valid, slot_chunk):
        rows = _bins_with_faces(valid_all, k0, slot_chunk)
        kc = min(slot_chunk, K - k0)
        chunk = (k0, kc, rows) + _window_pairs(windows, rows_valid, rows, k0, kc, tile_h,
                                               tile_w)
        if group and n + len(chunk[3]) > PAIR_BUDGET:
            yield group
            group, n = [], 0
        group.append(chunk)
        n += len(chunk[3])
    if group:
        yield group


def _group_pairs(group, T):
    """A group's pairs as (bin row, slot, bin, pixel) index tensors and each
    chunk's span in them."""
    rows_of = torch.cat([rows[r] for _, _, rows, _, r, _, _ in group])
    slots = torch.cat([k0 + k for k0, _, _, _, _, _, k in group])
    pixels = torch.cat([p for _, _, _, _, _, p, _ in group])
    ends = torch.tensor([len(c[3]) for c in group]).cumsum(0).tolist()
    return rows_of, slots, rows_of % T, pixels, list(zip([0] + ends[:-1], ends))


def forward_plain(table, idx, image_size, tile_h, tile_w, sigma, blur_radius,
                  soft, slot_chunk: int = SLOT_CHUNK) -> BinnedFrags:
    """Plain PyTorch version of the kernel: the same binned function, walked
    over the slots `slot_chunk` at a time so it fits in memory at full width,
    each step over the bins with a face in its slots.

    Like the kernel it evaluates only the pairs inside `cull_windows`; the
    others are out of radius, so they take the values that out-of-radius
    pairs take (log term +0, z BIG) and every output bit stays as a walk of
    every pair gives it. Within a chunk the z-buffer takes the first minimal
    slot and across chunks a strict <, which equals the kernel's
    slot-by-slot strict <. S is summed chunk by chunk (another order than
    the kernel's).
    """
    B, T, K, _ = table.shape
    P = tile_h * tile_w
    px, py = _bin_pixels(T, image_size, tile_h, tile_w, table.device)  # (T, P)
    valid_all = idx >= 0
    rows_table, rows_valid = table.reshape(B * T, K, 9), valid_all.reshape(B * T, K)
    windows = cull_windows(table, image_size, tile_h, tile_w, blur_radius,
                           soft).reshape(B * T, K, 4)
    S = table.new_zeros(B * T, P)
    zbuf = table.new_full((B * T, P), BIG)
    b0 = table.new_zeros(B * T, P)
    b1 = table.new_zeros(B * T, P)
    slot = torch.full((B * T, P), -1, dtype=torch.long, device=table.device)
    for group in _chunk_groups(valid_all, windows, rows_valid, slot_chunk, tile_h, tile_w):
        rows_of, slots, t, pixels, spans = _group_pairs(group, T)
        geometry = _face_geometry(rows_table[rows_of, slots], px[t, pixels], py[t, pixels],
                                  sigma, blur_radius, soft)
        for (k0, kc, rows, f, _, _, k), (a, b) in zip(group, spans):
            _forward_chunk(S, zbuf, b0, b1, slot, rows, f, k, k0, kc, P,
                           [g[a:b] for g in geometry])
    S, zbuf, b0, b1, slot = (v.reshape(B, T, P) for v in (S, zbuf, b0, b1, slot))
    covered = slot >= 0
    p2f = torch.gather(idx, 2, slot.clamp(min=0).reshape(B, T, P).to(torch.long))
    p2f = torch.where(covered, p2f, torch.full_like(p2f, -1))
    return BinnedFrags(*(_untile(v, image_size, tile_h, tile_w) for v in (S, p2f, b0, b1, zbuf)))


def _forward_chunk(S, zbuf, b0, b1, slot, rows, f, k, k0, kc, P, geometry):
    """One chunk's step of forward_plain over the (bin row, pixel) positions
    with a pair in it (the others add +0 to S and keep the z-buffer): its
    pairs' geometry (at flat indices f of (len(rows), P, kc), slots k)
    placed over the positions' kc slots, S summed over the slots, the z-test against the
    running buffers."""
    log1mp_n, z_n, b0_n, b1_n, in_r = geometry
    pos, inverse = torch.unique(f // kc, return_inverse=True)
    at = inverse * kc + k
    n = len(pos) * kc
    log1mp, zm = S.new_zeros(n), S.new_full((n,), BIG)
    bb0, bb1 = S.new_zeros(n), S.new_zeros(n)
    log1mp[at] = log1mp_n
    zm[at] = torch.where(in_r, z_n, torch.full_like(z_n, BIG))
    bb0[at], bb1[at] = b0_n, b1_n
    log1mp, zm, bb0, bb1 = (v.view(len(pos), kc) for v in (log1mp, zm, bb0, bb1))
    where = (rows[pos // P], pos % P)
    S[where] = S[where] + log1mp.sum(-1)
    j = torch.argmin(zm, dim=-1, keepdim=True)  # first minimal slot
    z_best = torch.gather(zm, -1, j)[..., 0]
    z_old = zbuf[where]
    better = z_best < z_old
    zbuf[where] = torch.where(better, z_best, z_old)
    b0[where] = torch.where(better, torch.gather(bb0, -1, j)[..., 0], b0[where])
    b1[where] = torch.where(better, torch.gather(bb1, -1, j)[..., 0], b1[where])
    slot[where] = torch.where(better, j[..., 0] + k0, slot[where])


def _soft_grad_terms(c, px, py, A, sigma, blur_radius):
    """The backward kernel's per-(pixel, slot) arithmetic (csrc/raster_bwd.cu):
    c (N, 9) face rows at pixels px, py with dL/dS A, each (N,) -> the six
    terms of d(A*S)/d[ax ay bx by cx cy] / 2, each (N,)."""
    ax, ay, bx, by, cx, cy = c[..., :6].unbind(-1)
    b0, b1, b2 = _barycentric(ax, ay, bx, by, cx, cy, px, py)
    inside = (b0 >= 0.0) & (b1 >= 0.0) & (b2 >= 0.0)
    d20, dx0, dy0, t0 = _seg(ax, ay, bx, by, px, py)
    d21, dx1, dy1, t1 = _seg(bx, by, cx, cy, px, py)
    d22, dx2, dy2, t2 = _seg(cx, cy, ax, ay, px, py)
    inner = torch.minimum(d20, d21)
    d2 = torch.minimum(inner, d22)
    signed = torch.where(inside, -d2, d2)
    in_radius = inside | (signed < blur_radius)

    # dS/d(d^2) = -+ sigmoid(-signed/sigma)/sigma inside / outside the face
    g = 1.0 / (1.0 + torch.exp(signed / sigma)) / sigma * A
    g = torch.where(in_radius, torch.where(inside, -g, g), torch.zeros_like(g))
    # min-of-3 routing as jnp.minimum's VJP: ties split 50/50 per level
    s_in = torch.where(inner < d22, 1.0, torch.where(inner == d22, 0.5, 0.0))
    s0 = s_in * torch.where(d20 < d21, 1.0, torch.where(d20 == d21, 0.5, 0.0))
    g0, g1, g2 = g * s0, g * (s_in - s0), g * (1.0 - s_in)
    # envelope theorem: dd^2/du = 2d(t - 1), dd^2/dv = -2td;
    # a = u(seg0), v(seg2); b = v(seg0), u(seg1); c = v(seg1), u(seg2)
    terms = (
        g0 * (dx0 * (t0 - 1.0)) - g2 * (t2 * dx2),
        g0 * (dy0 * (t0 - 1.0)) - g2 * (t2 * dy2),
        g1 * (dx1 * (t1 - 1.0)) - g0 * (t0 * dx0),
        g1 * (dy1 * (t1 - 1.0)) - g0 * (t0 * dy0),
        g2 * (dx2 * (t2 - 1.0)) - g1 * (t1 * dx1),
        g2 * (dy2 * (t2 - 1.0)) - g1 * (t1 * dy1),
    )
    return terms


@torch.no_grad()
def backward_plain(table, idx, dS, image_size, tile_h, tile_w, sigma,
                   blur_radius) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel: d(sum dS*S)/d(table).

    dS (B, H, W) is dL/dS. Returns (B, T, K, 9) rows [gax gay gbx gby gcx gcy
    0 0 0], hand-derived as rasterizer_tpu._soft_logterm_grad does (not by
    autograd), walked over the slots SLOT_CHUNK at a time like
    forward_plain, over the pairs inside `cull_windows` (the others are out
    of radius and add +0). The z columns and every slot past the bin's
    count are exactly 0. Sums run over the pixels in another order than the
    kernel's.
    """
    B, T, K, _ = table.shape
    P = tile_h * tile_w
    px, py = _bin_pixels(T, image_size, tile_h, tile_w, table.device)  # (T, P)
    A = _tile(dS.float(), image_size, tile_h, tile_w).reshape(B * T, P)
    valid_all = idx >= 0
    rows_table, rows_valid = table.reshape(B * T, K, 9), valid_all.reshape(B * T, K)
    windows = cull_windows(table, image_size, tile_h, tile_w, blur_radius,
                           True).reshape(B * T, K, 4)
    grad = table.new_zeros(B * T, K, 9)
    for group in _chunk_groups(valid_all, windows, rows_valid, SLOT_CHUNK, tile_h, tile_w):
        rows_of, slots, t, pixels, spans = _group_pairs(group, T)
        terms = _soft_grad_terms(rows_table[rows_of, slots], px[t, pixels], py[t, pixels],
                                 A[rows_of, pixels], sigma, blur_radius)
        for (k0, kc, rows, f, _, _, _), (a, b) in zip(group, spans):
            sums = []
            for v in terms:  # each summed over the pixels as a (1, R, P, kc) tensor
                full = table.new_zeros(len(rows) * P * kc)
                full[f] = v[a:b]
                sums.append(2.0 * full.view(1, len(rows), P, kc).sum(2))
            grad[rows, k0:k0 + kc, :6] = torch.stack(sums, dim=-1)[0]
    return grad.reshape(B, T, K, 9)


# ------------------------------------------------------------ CUDA kernels --

def _function(source, name, argtypes):
    """The C entry `name` of csrc/<source>, built at first use."""
    fn = getattr(load(source), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


# the C entries' arguments: acfm_raster_fwd(table, idx, counts, five outputs,
# B, T, K, image_size, tile_h, tile_w, sigma, blur_radius, soft, stream) and
# acfm_raster_bwd(table, counts, dS, grad, B, T, K, image_size, tile_h,
# tile_w, sigma, blur_radius, stream)
FWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
BWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


def fwd_entry():
    return _function("raster_fwd.cu", "acfm_raster_fwd", FWD_ARGTYPES)


def bwd_entry():
    return _function("raster_bwd.cu", "acfm_raster_bwd", BWD_ARGTYPES)


def launch_fwd(fn, table, idx, counts, out, image_size, tile_h, tile_w, sigma, blur_radius,
               soft):
    """One launch of a forward C entry `fn` (fwd_entry(), or another build's)
    on contiguous CUDA tensors: counts (B, T) int32 valid slots per bin, out
    the five (B, H, W) maps it writes. forward_cuda's launch; timing code
    calls it with counts and outputs made once."""
    B, T, K, _ = table.shape
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), idx.data_ptr(), counts.data_ptr(),
                 *(t.data_ptr() for t in out), B, T, K, image_size, tile_h,
                 tile_w, sigma, blur_radius, int(soft), stream)
    if err:
        raise RuntimeError(f"raster_fwd kernel launch failed: CUDA error {err}")


def launch_bwd(fn, table, counts, dS, grad, image_size, tile_h, tile_w, sigma, blur_radius):
    """One launch of a backward C entry `fn` (bwd_entry(), or another
    build's) on contiguous CUDA tensors, writing grad (B, T, K, 9).
    backward_cuda's launch; timing code calls it like launch_fwd."""
    B, T, K, _ = table.shape
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), counts.data_ptr(), dS.data_ptr(), grad.data_ptr(), B, T, K,
                 image_size, tile_h, tile_w, sigma, blur_radius, stream)
    if err:
        raise RuntimeError(f"raster_bwd kernel launch failed: CUDA error {err}")


def _check_bins(table, idx, image_size, tile_h, tile_w, what):
    if not (table.is_cuda and idx.is_cuda):
        raise ValueError(f"{what} takes CUDA tensors")
    if table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError(f"table f32 / idx int32 expected, got {table.dtype}/{idx.dtype}")
    B, T, K, row = table.shape
    if row != 9 or idx.shape != (B, T, K):
        raise ValueError(f"bad table {tuple(table.shape)} / idx {tuple(idx.shape)}")
    if image_size % tile_h or image_size % tile_w or \
            T != (image_size // tile_h) * (image_size // tile_w):
        raise ValueError(f"bins {tile_h}x{tile_w} x {T} do not tile {image_size}^2")


def forward_cuda(table, idx, image_size, tile_h, tile_w, sigma, blur_radius,
                 soft) -> BinnedFrags:
    """Launch csrc/raster_fwd.cu on the bin tables (CUDA tensors)."""
    _check_bins(table, idx, image_size, tile_h, tile_w, "forward_cuda")
    fn = fwd_entry()
    table = table.contiguous()
    idx = idx.contiguous()
    counts = (idx >= 0).sum(-1, dtype=torch.int32).contiguous()
    shape = (table.shape[0], image_size, image_size)
    out = BinnedFrags(
        S=torch.empty(shape, dtype=torch.float32, device=table.device),
        pix_to_face=torch.empty(shape, dtype=torch.int32, device=table.device),
        b0=torch.empty(shape, dtype=torch.float32, device=table.device),
        b1=torch.empty(shape, dtype=torch.float32, device=table.device),
        zbuf=torch.empty(shape, dtype=torch.float32, device=table.device),
    )
    launch_fwd(fn, table, idx, counts, out, image_size, tile_h, tile_w, sigma, blur_radius, soft)
    LAUNCHES["soft" if soft else "hard"] += 1
    return out


def backward_cuda(table, idx, dS, image_size, tile_h, tile_w, sigma,
                  blur_radius) -> torch.Tensor:
    """Launch csrc/raster_bwd.cu: backward_plain's function on CUDA tensors."""
    _check_bins(table, idx, image_size, tile_h, tile_w, "backward_cuda")
    B, T, K, _ = table.shape
    if not dS.is_cuda or tuple(dS.shape) != (B, image_size, image_size):
        raise ValueError(f"dS must be a CUDA (B, H, W) map, got {tuple(dS.shape)}")
    fn = bwd_entry()
    table = table.contiguous()
    dS = dS.float().contiguous()
    counts = (idx >= 0).sum(-1, dtype=torch.int32).contiguous()
    grad = torch.empty_like(table)
    launch_bwd(fn, table, counts, dS, grad, image_size, tile_h, tile_w, sigma, blur_radius)
    LAUNCHES["soft_bwd"] += 1
    return grad


class SoftRasterize(torch.autograd.Function):
    """Soft binned rasterization with `table` as its only differentiable
    input: apply(table, idx, image_size, tile_h, tile_w, sigma, blur_radius)
    -> the five BinnedFrags maps, of which only S carries a gradient.

    Forward and backward launch the kernels on CUDA tensors and run the
    plain versions on CPU tensors. The backward takes dL/dS (autograd has
    already applied mask = 1 - exp(S)) and returns d(table); autograd's
    backward of the gather in _face_tables scatters the rows to the faces
    and vertices.
    """

    @staticmethod
    def forward(ctx, table, idx, image_size, tile_h, tile_w, sigma, blur_radius):
        fwd = forward_cuda if table.is_cuda else forward_plain
        out = fwd(table, idx, image_size, tile_h, tile_w, sigma, blur_radius, True)
        ctx.save_for_backward(table, idx)
        ctx.raster = (image_size, tile_h, tile_w, sigma, blur_radius)
        ctx.mark_non_differentiable(*out[1:])
        return tuple(out)

    @staticmethod
    def backward(ctx, dS, *_):
        table, idx = ctx.saved_tensors
        bwd = backward_cuda if dS.is_cuda else backward_plain
        return (bwd(table, idx, dS, *ctx.raster),) + (None,) * 6


# ------------------------------------------------------------------ entry --

def bin_faces(verts, faces, image_size: int, K: int, blur_radius: float):
    """The bin pass: (table, idx, tile_h, tile_w) at capacity
    round_up(min(K, F), 64), for verts (B, V, 3) projected, faces (F, 3)."""
    K = _round_up(min(K, faces.shape[0]), K_CHUNK)
    th, tw = _pick_tiles(image_size)
    table, idx = _face_tables(verts.float(), faces, image_size, th, tw, K,
                              _margin(blur_radius))
    return table, idx, th, tw


def rasterize_binned(verts: torch.Tensor, faces: torch.Tensor, image_size: int,
                     K: int, sigma: float = SIGMA, blur_radius: float = BLUR_RADIUS,
                     soft: bool = True) -> BinnedFrags:
    """Bin, then rasterize. verts (B, V, 3) projected, faces (F, 3).

    Launches the CUDA kernels for a CUDA tensor and runs the plain versions
    for a CPU tensor. Soft mode gives S a gradient to the vertices
    (SoftRasterize); hard mode takes none (it detaches).
    """
    if not soft:
        verts = verts.detach()
    table, idx, th, tw = bin_faces(verts, faces, image_size, K, blur_radius)
    if soft:
        return BinnedFrags(*SoftRasterize.apply(table, idx, image_size, th, tw, sigma,
                                                blur_radius))
    fwd = forward_cuda if verts.is_cuda else forward_plain
    return fwd(table, idx, image_size, th, tw, sigma, blur_radius, False)
