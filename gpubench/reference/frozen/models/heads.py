"""Prediction heads: camera and handle offsets.

Counterpart of acfm_video_3d_reconstruction_tpu/models/heads.py, with the
same initialisers where they carry meaning: the handle head and the small
camera heads draw N(0, 1e-5) so the initial deformation vanishes, and the
quaternion bias starts at a small identity rotation.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

TINY_STD = 1e-5


class QuatPredictor(nn.Module):
    def __init__(self, nin: int = 200):
        super().__init__()
        self.fc = nn.Linear(nin, 4)

    def init_override(self, gen):
        with torch.no_grad():
            self.fc.bias.copy_(torch.tensor([1e-2, 0.0, 0.0, 0.0]))

    def forward(self, feat):
        q = self.fc(feat)
        sq = (q * q).sum(-1, keepdim=True)
        return q / torch.sqrt(torch.maximum(sq, sq.new_full((), 1e-24)))


class ScalePredictor(nn.Module):
    def __init__(self, nin: int = 200, scale_lr: float = 1.0, small_init: bool = False):
        super().__init__()
        self.fc = nn.Linear(nin, 1)
        self.scale_lr = scale_lr
        self.small_init = small_init

    def init_override(self, gen):
        if self.small_init:
            nn.init.normal_(self.fc.weight, 0.0, TINY_STD, generator=gen)

    def forward(self, feat):
        return F.relu(self.scale_lr * self.fc(feat) + 1.0) + 1e-12


class TransPredictor(nn.Module):
    def __init__(self, nin: int = 200, small_init: bool = False):
        super().__init__()
        self.fc = nn.Linear(nin, 2)
        self.small_init = small_init

    def init_override(self, gen):
        if self.small_init:
            nn.init.normal_(self.fc.weight, 0.0, TINY_STD, generator=gen)

    def forward(self, feat):
        return self.fc(feat)


class CameraPredictor(nn.Module):
    """res_feats (B, 256, s, s) -> 7-D camera [s, tx, ty, q].

    Full-extent valid conv to 200 channels + LeakyReLU(0.01), two residual
    FC blocks (LayerNorm'd, eps 1e-6 as flax, in the multiframe variant),
    then the scale / trans / quat heads.
    """

    def __init__(self, res_side: int, use_layernorm: bool = False,
                 scale_lr: float = 1.0, small_init: bool = False):
        super().__init__()
        self.conv_c = nn.Conv2d(256, 200, res_side)
        self.fc1 = nn.Linear(200, 200)
        self.fc2 = nn.Linear(200, 200)
        self.use_layernorm = use_layernorm
        if use_layernorm:
            self.ln1 = nn.LayerNorm(200, eps=1e-6)
            self.ln2 = nn.LayerNorm(200, eps=1e-6)
        self.scale = ScalePredictor(200, scale_lr, small_init)
        self.trans = TransPredictor(200, small_init)
        self.quat = QuatPredictor(200)

    def forward(self, res_feats):
        x = F.leaky_relu(self.conv_c(res_feats)[:, :, 0, 0], 0.01)
        for i in (1, 2):
            h = getattr(self, f"fc{i}")(x)
            if self.use_layernorm:
                h = getattr(self, f"ln{i}")(h)
            x = x + F.leaky_relu(h, 0.01)
        return torch.cat([self.scale(x), self.trans(x), self.quat(x)], dim=-1)


class TransformationPredictor(nn.Module):
    """Global code -> per-handle 3D offsets (B, num_lbs, 3), ~zero at init."""

    def __init__(self, nz_feat: int, num_lbs: int):
        super().__init__()
        self.num_lbs = num_lbs
        self.fc = nn.Linear(nz_feat, num_lbs * 3)

    def init_override(self, gen):
        nn.init.normal_(self.fc.weight, 0.0, TINY_STD, generator=gen)

    def forward(self, feat):
        return self.fc(feat).reshape(feat.shape[0], self.num_lbs, 3)
