"""Bilinear / nearest grid sampling.

Counterpart of acfm_video_3d_reconstruction_tpu/ops/grid_sample.py, which
was written to torch.nn.functional.grid_sample's semantics, so bilinear
sampling (zeros or border padding) is F.grid_sample itself. Nearest is the
exception: the JAX package rounds with floor(x + 0.5) (halves up), torch
rounds half to even, so that mode is written out here.

Layout: image (B, C, H, W); grid (B, ..., 2) with grid[..., 0] = x (width)
and grid[..., 1] = y (height), both in [-1, 1]; result (B, C, ...).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _unnormalize(coord: torch.Tensor, size: int, align_corners: bool) -> torch.Tensor:
    if align_corners:
        return (coord + 1.0) / 2.0 * (size - 1)
    return ((coord + 1.0) * size - 1.0) / 2.0


def _nearest(image, g, padding_mode, align_corners):
    """g (B, N, 2) -> (B, C, N), rounding halves up as the JAX package does."""
    B, C, H, W = image.shape
    ix = torch.floor(_unnormalize(g[..., 0], W, align_corners) + 0.5).long()
    iy = torch.floor(_unnormalize(g[..., 1], H, align_corners) + 0.5).long()
    inb = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    idx = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)  # (B, N)
    vals = torch.gather(image.reshape(B, C, H * W), 2, idx[:, None, :].expand(B, C, -1))
    if padding_mode == "zeros":
        vals = torch.where(inb[:, None, :], vals, torch.zeros_like(vals))
    return vals


def grid_sample(image: torch.Tensor, grid: torch.Tensor, *, mode: str = "bilinear",
                padding_mode: str = "zeros", align_corners: bool = False) -> torch.Tensor:
    """Sample `image` (B, C, H, W) at `grid` (B, ..., 2) -> (B, C, ...)."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unknown padding_mode {padding_mode}")
    B, C = image.shape[:2]
    out_shape = (B, C) + tuple(grid.shape[1:-1])
    g = grid.reshape(B, -1, 2)
    if mode == "nearest":
        out = _nearest(image, g, padding_mode, align_corners)
    elif mode == "bilinear":
        out = F.grid_sample(image, g[:, None], mode="bilinear", padding_mode=padding_mode,
                            align_corners=align_corners)
    else:
        raise ValueError(f"unknown mode {mode}")
    return out.reshape(out_shape)
