"""Mesh rasterization: soft silhouettes, hard z-buffer, atlas texturing.

Counterpart of acfm_video_3d_reconstruction_tpu/ops/rasterizer.py, with the
same public functions and layouts: masks and pix_to_face (B, H, W),
images (B, H, W, 3), atlas (B, F, T, T, 3). Every function rasterizes
through the binned forward of ops/rasterizer_cuda.py, which is the CUDA
kernel on the card and its plain PyTorch version on the CPU.

Vertices arrive projected by geometry/camera.orthographic_proj_withz:
(x, y) in [-1, 1], x right, y down, z depth (smaller is closer). Pixel
(row i, col j) has its centre at x = (2j+1)/W - 1, y = (2i+1)/H - 1.

The visibility and atlas sampling here are the plain semantics that the
TPU package's MXU rewrites (visible_slots, sample_atlas_binned) are tested
to equal: a per-pixel scatter and a flat gather.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .rasterizer_cuda import BLUR_RADIUS, SIGMA, auto_K, rasterize_binned

DEFAULT_K = 192  # bin capacity at 256^2 and above (auto_K)


class Fragments(NamedTuple):
    """Hard-rasterization outputs, each with leading (B, H, W)."""

    pix_to_face: torch.Tensor  # int32, -1 = background
    bary: torch.Tensor         # (B, H, W, 3) clipped barycentrics of the front face
    zbuf: torch.Tensor         # depth of the front face (1e10 if none)
    mask: torch.Tensor         # 1.0 where a face covers the pixel


def _K(faces, image_size):
    return auto_K(faces.shape[0], image_size, DEFAULT_K)


def soft_silhouette(verts, faces, image_size: int, *, sigma: float = SIGMA,
                    blur_radius: float = BLUR_RADIUS):
    """(mask (B, H, W) in [0, 1], pix_to_face (B, H, W) int32)."""
    fr = rasterize_binned(verts, faces, image_size, _K(faces, image_size), sigma,
                          blur_radius, soft=True)
    return 1.0 - torch.exp(fr.S), fr.pix_to_face


def soft_silhouette_vis(verts, faces, image_size: int, num_verts: int, *,
                        sigma: float = SIGMA, blur_radius: float = BLUR_RADIUS):
    """Soft silhouette + pix_to_face + per-vertex visibility (B, V)."""
    mask, p2f = soft_silhouette(verts, faces, image_size, sigma=sigma,
                                blur_radius=blur_radius)
    return mask, p2f, visible_vertices(p2f, faces, num_verts)


def soft_silhouette_vis_tex(verts, faces, atlas, image_size: int, num_verts: int, *,
                            sigma: float = SIGMA, blur_radius: float = BLUR_RADIUS):
    """Soft silhouette, visibility and textured render from ONE rasterization.

    Returns (mask, pix_to_face, vis_verts, rgb (B, H, W, C), covered). The
    texture is sampled from the soft pass's own z-buffer with the geometry
    detached (the reference detaches pred_v for its texture pass).
    """
    fr = rasterize_binned(verts, faces, image_size, _K(faces, image_size), sigma,
                          blur_radius, soft=True)
    B = verts.shape[0]
    p2f = fr.pix_to_face
    bary = torch.stack([fr.b0, fr.b1, 1.0 - fr.b0 - fr.b1], dim=-1).detach()
    rgb, covered = sample_atlas(atlas, p2f.reshape(B, -1), bary.reshape(B, -1, 3))
    shape = (B, image_size, image_size)
    return (
        1.0 - torch.exp(fr.S), p2f, visible_vertices(p2f, faces, num_verts),
        rgb.reshape(*shape, -1), covered.to(verts.dtype).reshape(shape),
    )


def hard_rasterize(verts, faces, image_size: int) -> Fragments:
    """Hard (coverage-only) rasterization; no gradient to the vertices."""
    fr = rasterize_binned(verts, faces, image_size, _K(faces, image_size), SIGMA, 0.0,
                          soft=False)
    mask = (fr.pix_to_face >= 0).float()
    bary = torch.stack([fr.b0, fr.b1, 1.0 - fr.b0 - fr.b1], dim=-1) * mask[..., None]
    return Fragments(pix_to_face=fr.pix_to_face, bary=bary, zbuf=fr.zbuf, mask=mask)


def render_texture(verts, faces, atlas, image_size: int):
    """Textured render, all-ambient light, hard rasterization.

    Returns (rgb (B, H, W, C), sil (B, H, W), pix_to_face (B, H, W)). The
    vertices receive no gradient.
    """
    frags = hard_rasterize(verts, faces, image_size)
    B = verts.shape[0]
    rgb, covered = sample_atlas(atlas, frags.pix_to_face.reshape(B, -1),
                                frags.bary.reshape(B, -1, 3))
    shape = (B, image_size, image_size)
    return (rgb.reshape(*shape, -1), covered.to(verts.dtype).reshape(shape),
            frags.pix_to_face)


def hard_visibility(verts, faces, image_size: int, num_verts: int):
    """(B, V) 0/1 vertex visibility from a hard z-buffer."""
    frags = hard_rasterize(verts, faces, image_size)
    return visible_vertices(frags.pix_to_face, faces, num_verts)


def sample_atlas(atlas, pix_to_face, bary):
    """Nearest-cell sampling of a per-face texture atlas.

    atlas (B, F, T, T, C); pix_to_face (B, P) int; bary (B, P, 3). Atlas
    cell [int(w0*T), int(w1*T)] (PyTorch3D 0.3 TexturesAtlas indexing).
    Returns (rgb (B, P, C), covered (B, P) bool).
    """
    B, F, T, _, C = atlas.shape
    covered = pix_to_face >= 0
    f = torch.where(covered, pix_to_face, torch.zeros_like(pix_to_face)).long()
    i0 = torch.clamp((bary[..., 0] * T).to(torch.int64), 0, T - 1)
    i1 = torch.clamp((bary[..., 1] * T).to(torch.int64), 0, T - 1)
    flat = atlas.reshape(B, F * T * T, C)
    idx = (f * T + i0) * T + i1
    rgb = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
    rgb = torch.where(covered[..., None], rgb, torch.zeros_like(rgb))
    return rgb, covered


def visible_vertices(pix_to_face, faces, num_verts: int):
    """(B, V) float 0/1: a vertex is visible iff some pixel's front face
    contains it."""
    B = pix_to_face.shape[0]
    F = faces.shape[0]
    p2f = pix_to_face.reshape(B, -1).long()
    p2f = torch.where(p2f >= 0, p2f, torch.full_like(p2f, F))  # F = dump column
    vis_f = torch.zeros(B, F + 1, device=p2f.device)
    vis_f.scatter_(1, p2f, 1.0)
    vis_f = vis_f[:, :F]
    vis_v = torch.zeros(B, num_verts, device=p2f.device)
    f3 = faces.reshape(1, -1).long().expand(B, -1)
    return vis_v.scatter_reduce(1, f3, vis_f.repeat_interleave(3, dim=1), reduce="amax")
