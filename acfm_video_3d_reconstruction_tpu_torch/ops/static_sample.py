"""Bilinear sampling at static coordinates.

Counterpart of acfm_video_3d_reconstruction_tpu/ops/static_sample.py. The
texture decoder samples its UV image at the template's fixed per-face
coordinates, so the four corner indices and bilinear weights are computed
once on the host (float64, the same tables as the JAX sampler) and the
forward is a gather plus a weighted corner sum. Its autograd backward is
an index_add into the image.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def bilinear_tables(coords_xy: np.ndarray, H: int, W: int):
    """coords (P, 2) (x, y) in [-1, 1], align_corners=True -> (idx4 (P, 4)
    int64 flat y*W+x, w4 (P, 4) float32), corners ordered
    [(0,0), (0,1), (1,0), (1,1)], edge-clamped."""
    coords = np.asarray(coords_xy, np.float64)
    gx = (coords[:, 0] + 1.0) / 2.0 * (W - 1)
    gy = (coords[:, 1] + 1.0) / 2.0 * (H - 1)
    x0 = np.clip(np.floor(gx), 0, W - 1)
    y0 = np.clip(np.floor(gy), 0, H - 1)
    fx = np.clip(gx - x0, 0.0, 1.0)
    fy = np.clip(gy - y0, 0.0, 1.0)
    w4 = np.stack(
        [(1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx), fy * fx], axis=1
    ).astype(np.float32)
    idx4 = np.stack(
        [np.clip(y0 + dy, 0, H - 1) * W + np.clip(x0 + dx, 0, W - 1)
         for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1))],
        axis=1,
    ).astype(np.int64)
    return idx4, w4


class StaticBilinear(nn.Module):
    """img (B, C, H, W) -> (B, P, C) sampled at fixed coordinates
    (grid_sample bilinear, align_corners=True)."""

    def __init__(self, coords_xy: np.ndarray, H: int, W: int):
        super().__init__()
        idx4, w4 = bilinear_tables(coords_xy, H, W)
        self.H, self.W = H, W
        self.register_buffer("idx4", torch.from_numpy(idx4.reshape(-1)), persistent=False)
        self.register_buffer("w4", torch.from_numpy(w4), persistent=False)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        B, C, H, W = img.shape
        if (H, W) != (self.H, self.W):
            raise ValueError(f"sampler built for {self.H}x{self.W}, got {H}x{W}")
        g = img.reshape(B, C, H * W).index_select(2, self.idx4)
        g = g.reshape(B, C, -1, 4) * self.w4.to(img.dtype)
        return g.sum(-1).transpose(1, 2)
