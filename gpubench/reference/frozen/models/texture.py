"""Texture predictor: UV colour image decoder + fixed spherical atlas sampler.

Counterpart of acfm_video_3d_reconstruction_tpu/models/texture.py:
res_feats (B, 256, s, s) -> width x2 -> residual conv stack with 5 bilinear
2x upsamples -> 3-channel UV image (H, 2H) -> bilinear samples at the
template's per-face uv_sampler -> (tanh+1)/2 atlas (B, F, T, T, 3); a
symmetric texture appends the mirrored last num_sym_faces.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.static_sample import StaticBilinear
from .nn_blocks import ResLayer2d, conv3x3, upsample2x

# (features, upsample after) per ResLayer2d, 4x8 -> 128x256 at 256^2
_PLAN = ((256, True), (256, False), (256, True), (128, True), (64, True),
         (32, True), (16, False))


class TexturePredictorUV(nn.Module):
    def __init__(self, uv_sampler: np.ndarray, res_side: int, num_sym_faces: int = -1):
        super().__init__()
        self.num_faces, self.tex_size = uv_sampler.shape[0], uv_sampler.shape[1]
        self.num_sym_faces = num_sym_faces
        self.res_side = res_side
        blocks, cin = [], 256
        for feats, _ in _PLAN:
            blocks.append(ResLayer2d(cin, feats))
            cin = feats
        self.blocks = nn.ModuleList(blocks)
        self.out_conv = conv3x3(16, 3)
        n_up = sum(up for _, up in _PLAN)
        H = res_side * 2 ** n_up
        self.sampler = StaticBilinear(
            np.asarray(uv_sampler, np.float32).reshape(-1, 2), H, 2 * H)

    def forward(self, res_feats: torch.Tensor) -> torch.Tensor:
        """res_feats (B, 256, s, s) -> atlas (B, F, T, T, 3)."""
        B, _, h, w = res_feats.shape
        x = F.interpolate(res_feats, size=(h, 2 * w), mode="bilinear", align_corners=False)
        for blk, (_, up) in zip(self.blocks, _PLAN):
            x = blk(x)
            if up:
                x = upsample2x(x)
        tex = self.sampler(self.out_conv(x))  # (B, F*T*T, 3)
        T = self.tex_size
        tex = (torch.tanh(tex.reshape(B, self.num_faces, T, T, 3)) + 1.0) / 2.0
        if self.num_sym_faces >= 0:
            tex = torch.cat([tex, tex[:, -self.num_sym_faces:]], dim=1)
        return tex
