"""Scenes and checks that hold the rasterizer's CUDA kernels to their plain
versions, and its face cull to `_face_geometry`.

chip_smoke.py, tests/test_torch_port_raster.py, tests/test_torch_port_kernels.py
and tools/torch_raster_tiling.py share them; the port's own paths do not
call them. Each check raises AssertionError on failure and returns a line
that states what it read.
"""
from __future__ import annotations

import numpy as np
import torch

from . import rasterizer_cuda as rc


def icosphere_scene(B, device="cpu", seed=0, subdivide=3):
    """The icosphere of `subdivide`, scaled by 0.7, under B seeded random
    weak-perspective cameras (scale 0.6-0.95, translation +-0.1): projected
    verts (B, V, 3) f32 and faces (F, 3) int64 on `device`."""
    from ..geometry import camera, icosphere

    v, f = icosphere.icosphere(subdivide)
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    cams = np.concatenate(
        [rng.uniform(0.6, 0.95, (B, 1)), rng.uniform(-0.1, 0.1, (B, 2)), q], 1
    ).astype(np.float32)
    verts = torch.tensor(v, dtype=torch.float32, device=device)[None].repeat(B, 1, 1) * 0.7
    proj = camera.orthographic_proj_withz(verts, torch.tensor(cams, device=device), offset_z=5.0)
    return proj, torch.tensor(f, dtype=torch.long, device=device)


def adversarial_scene(size, B=2, seed=0):
    """A projected scene (numpy) that attacks the kernels' face cull:
    verts (B, V, 3) f32, faces (F, 3) int64, and the ids of its degenerate
    faces. Per view, in front of 24 random background faces (z 2-4):
      * zero-area faces on a pixel-centre column, a pixel-centre row and a
        pixel-centre diagonal (every sub-area is exactly 0 at each pixel
        centre of the line, so `inside` holds along it far outside the
        face's box), z 1;
      * faces with a repeated vertex, and one with all three vertices on one
        pixel centre (each sub-area is then the rounding error of a product,
        of either sign, at every pixel), z 1;
      * slivers whose long edge lies on a row of pixel centres, with twice
        their area on a log grid from 1e-6 to 3e-2 NDC^2, so that some fall
        under the cull's area threshold and some just over it; each at its
        own depth (1.2 + 0.02 j), so that no two are within rounding of a
        z tie (XLA fuses the reference's depth with and without an FMA
        contraction in different places, which splits such ties)."""
    rng = np.random.default_rng(seed)
    n = size

    def centre(i):  # pixel centre i in NDC (exact in f32)
        return np.float32((2 * i + 1) / size - 1)

    views, faces, degenerate = [], [], []
    for _ in range(B):
        tris = []
        for _ in range(24):
            xy = rng.uniform(-0.9, 0.9, (3, 2))
            tris.append(np.concatenate([xy, rng.uniform(2.0, 4.0, (3, 1))], 1))
        c, r = rng.integers(2, n - 2, 2)
        r0, r1 = min(r, n - 4), min(r, n - 4) + 2
        c0 = min(c, n - 4)
        zero = [
            [(centre(c), centre(r0)), (centre(c), centre(r1)), (centre(c), centre(r0 + 1))],
            [(centre(c0), centre(r)), (centre(c0 + 2), centre(r)), (centre(c0 + 1), centre(r))],
            [(centre(c0), centre(r0)), (centre(c0 + 2), centre(r0 + 2)),
             (centre(c0 + 1), centre(r0 + 1))],
        ]
        v, w = rng.uniform(-0.8, 0.8, (2, 2))
        zero += [[v, v, w], [w, v, v], [(centre(c0), centre(r0))] * 3]
        for tri in zero:
            tris.append(np.concatenate([np.asarray(tri, np.float64), np.ones((3, 1))], 1))
        for j, area2 in enumerate(np.logspace(-6, -1.5, 24)):
            row = rng.integers(0, n)
            x0 = rng.uniform(-0.9, 0.2)
            length = rng.uniform(0.2, 0.7)
            a = (centre(int((x0 + 1) * n / 2)), centre(row))
            b = (centre(int((x0 + length + 1) * n / 2)), centre(row))
            h = area2 / max(b[0] - a[0], 1e-6)
            tip = ((a[0] + b[0]) / 2, centre(row) + h * rng.choice([-1.0, 1.0]))
            tris.append(np.concatenate([np.asarray([a, b, tip], np.float64),
                                        np.full((3, 1), 1.2 + 0.02 * j)], 1))
        degenerate = list(range(24, len(tris)))
        views.append(np.concatenate(tris, 0))
        faces = np.arange(3 * len(tris)).reshape(-1, 3)
    return np.stack(views).astype(np.float32), faces.astype(np.int64), np.asarray(degenerate)


def _require(cond, what):
    if not cond:
        raise AssertionError(what)


def check_forward(kern, plain, what, degenerate=None) -> tuple[dict, str]:
    """The forward kernel's BinnedFrags `kern` against forward_plain's
    `plain` on the same bins: pix_to_face equal on every pixel; barycentrics
    within 1e-4 and zbuf within 1e-5 wherever a face is hit; the mask
    exp(S) within 2e-4 (tests/test_rasterizer_tpu.py's tolerances). The two
    run the same f32 arithmetic with the same FMAs and walk the slots in the
    same order; S is summed in another order and the card's expf / log1pf
    are not PyTorch's. A double rounding in the plain version's emulated FMA
    could flip one pixel's `inside`, so the exact pix_to_face is a pin of
    this data, not a theorem. With `degenerate` (face ids), the plain
    version must show at least one of them. Returns the errors and the line
    that reports them."""
    agree = kern.pix_to_face == plain.pix_to_face
    n_bad = int((~agree).sum())
    hit = agree & (plain.pix_to_face >= 0)
    errs = {
        "p2f_disagree": n_bad,
        "bary": max((kern.b0 - plain.b0)[hit].abs().max().item(),
                    (kern.b1 - plain.b1)[hit].abs().max().item()),
        "zbuf": (kern.zbuf - plain.zbuf)[hit].abs().max().item(),
        "mask": (torch.exp(kern.S) - torch.exp(plain.S)).abs().max().item(),
    }
    extra = ""
    if degenerate is not None:
        n_deg = int(torch.isin(plain.pix_to_face, degenerate).sum())
        extra = f"; {n_deg} degenerate-face pixels"
        _require(n_deg > 0, f"{what}: no pixel shows a degenerate face")
    line = (f"{what}: p2f disagrees on {n_bad} of {agree.numel()} pixels, bary err "
            f"{errs['bary']:.3g}, zbuf err {errs['zbuf']:.3g}, mask err {errs['mask']:.3g}{extra}")
    _require(n_bad == 0, f"{line}: pix_to_face differs")
    _require(errs["bary"] <= 1e-4, f"{line}: barycentric error > 1e-4")
    _require(errs["zbuf"] <= 1e-5, f"{line}: zbuf error > 1e-5")
    _require(errs["mask"] <= 2e-4, f"{line}: mask error > 2e-4")
    return errs, line


def check_backward(table, idx, dS, size, th, tw, sigma, blur, what) -> tuple[float, str]:
    """backward_cuda against backward_plain on the same bins and dL/dS: the
    rows within vector relative error 1e-4 (they differ by summation order
    only), the z columns and the slots past each bin's count exactly 0.
    Returns the max abs error and the line that reports it."""
    kern = rc.backward_cuda(table, idx, dS, size, th, tw, sigma, blur)
    torch.cuda.synchronize()
    plain = rc.backward_plain(table, idx, dS, size, th, tw, sigma, blur)
    rel = (torch.linalg.vector_norm(kern - plain) / torch.linalg.vector_norm(plain)).item()
    err = (kern - plain).abs().max().item()
    nz_z = int(torch.count_nonzero(kern[..., 6:]))
    nz_bad = int(torch.count_nonzero(kern[idx < 0]))
    line = (f"{what} sigma {sigma:g} blur {blur:.4g}: rows rel err {rel:.3g}, max abs err "
            f"{err:.3g} (rows up to {plain.abs().max().item():.4g}); nonzero z entries {nz_z}, "
            f"nonzero invalid-slot entries {nz_bad}")
    _require(rel <= 1e-4, f"{line}: rows rel error > 1e-4")
    _require(nz_z == 0 and nz_bad == 0, f"{line}: z / invalid rows not 0")
    return err, line


def cull_census(table, idx, size, th, tw, sigma, blur, soft, chunk=32) -> dict:
    """Walks every valid (pixel, slot) pair of the bins in chunks of slots,
    through _face_geometry and rc.cull_windows:
      excluded_in_radius: pairs outside their window that are in radius
                          (must be 0: the cull changes no output bit);
      excluded:           pairs outside their window;
      in_radius:          pairs in radius (all inside their windows);
      pairs:              every valid pair of the bins;
      whole:              (B, T, K) bool, the valid slots whose window is
                          the whole bin."""
    win = rc.cull_windows(table, size, th, tw, blur, soft)
    T = table.shape[1]
    px, py = rc._bin_pixels(T, size, th, tw, table.device)
    px, py = px[None, :, :, None], py[None, :, :, None]
    p = torch.arange(th * tw, device=table.device)
    lx, ly = (p % tw)[None, None, :, None], (p // tw)[None, None, :, None]
    valid_all = idx >= 0
    bad = outside = in_radius = 0
    for k0 in range(0, int(valid_all.sum(-1).max()), chunk):
        c = table[:, :, None, k0:k0 + chunk, :]
        in_r = rc._face_geometry(c, px, py, sigma, blur, soft)[4]
        w = win[:, :, None, k0:k0 + chunk]
        in_win = ((lx >= w[..., 0]) & (lx <= w[..., 1]) & (ly >= w[..., 2])
                  & (ly <= w[..., 3]))
        valid = valid_all[:, :, None, k0:k0 + chunk]
        out = valid & ~in_win
        bad += int((in_r & out).sum())
        outside += int(out.sum())
        in_radius += int((in_r & valid).sum())
    whole = valid_all & (win[..., 0] == 0) & (win[..., 1] == tw - 1) & (win[..., 2] == 0) \
        & (win[..., 3] == th - 1)
    return {"excluded_in_radius": bad, "excluded": outside, "in_radius": in_radius,
            "pairs": int(valid_all.sum()) * th * tw, "whole": whole}
