"""LPIPS perceptual distance, AlexNet backbone, baseline variant.

Counterpart of acfm_video_3d_reconstruction_tpu/models/lpips.py: per-layer
unit-normalised feature differences squared, mean over channels (no
learned linear weights), bilinearly resized to the input size and summed
over layers. Inputs NHWC in [-1, 1].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# torchvision AlexNet feature extractor: (out_ch, kernel, stride, pad)
_ALEX_CONVS = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1),
               (256, 3, 1, 1))
_POOL_AFTER = (0, 1)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class AlexNetFeatures(nn.Module):
    def __init__(self):
        super().__init__()
        cin = 3
        for i, (ch, k, s, p) in enumerate(_ALEX_CONVS):
            self.add_module(f"conv{i}", nn.Conv2d(cin, ch, k, s, p))
            cin = ch

    def forward(self, x):
        feats = []
        for i in range(len(_ALEX_CONVS)):
            x = F.relu(getattr(self, f"conv{i}")(x))
            feats.append(x)
            if i in _POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
        return feats


def _unit_normalize(feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    # sqrt(max(sumsq, eps^2)) keeps the gradient finite at an all-zero
    # post-ReLU feature vector (0/0 otherwise); the forward equals the
    # reference's feat / (norm + eps) to within eps
    sq = (feat ** 2).sum(dim=1, keepdim=True)
    norm = torch.sqrt(torch.maximum(sq, sq.new_full((), eps * eps)))
    return feat / (norm + eps)


class LPIPS(nn.Module):
    """Spatial LPIPS map: (x, y) NHWC in [-1, 1] -> (B, H, W, 1).

    Frozen, as in the JAX package (its weights are not among the trained
    params): the parameters take no gradient, the inputs do."""

    def __init__(self):
        super().__init__()
        self.alex = AlexNetFeatures()
        self.requires_grad_(False)
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1), persistent=False)

    def forward(self, x, y):
        H, W = x.shape[1], x.shape[2]
        x = x.permute(0, 3, 1, 2)
        y = y.permute(0, 3, 1, 2)
        xs = self.alex((x - self.shift) / self.scale)
        ys = self.alex((y - self.shift) / self.scale)
        total = 0.0
        for fx, fy in zip(xs, ys):
            d = ((_unit_normalize(fx) - _unit_normalize(fy)) ** 2).mean(dim=1, keepdim=True)
            total = total + F.interpolate(d.float(), size=(H, W), mode="bilinear",
                                          align_corners=False)
        return total.permute(0, 2, 3, 1)


def perceptual_texture_loss(lpips: LPIPS, img_pred, img_gt, mask_gt, reduce: bool = True):
    """PerceptualTextureLoss_v2: images NHWC in [0, 1], mask (B, H, W)."""
    m = mask_gt[..., None]
    dist = lpips(2.0 * img_pred * m - 1.0, 2.0 * img_gt * m - 1.0) * m
    per = dist.mean(dim=(1, 2, 3))
    return per.mean() if reduce else per
