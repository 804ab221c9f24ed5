"""Flow evaluation losses (EPE family), NCHW.

Counterpart of acfm_video_3d_reconstruction_tpu/flow/losses.py (reference
MaskFlownet.py:660-707: EpeLoss, EpeLossWithMask, MultiscaleEpe). Flows are
(B, 2, H, W), masks (B, H, W).
"""
from __future__ import annotations

import torch

from . import ops


def epe_loss(pred: torch.Tensor, label: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Mean endpoint error per sample: (B,)."""
    err = torch.sqrt(((pred - label) ** 2).sum(1) + eps)
    return err.reshape(err.shape[0], -1).mean(-1)


def epe_loss_with_mask(pred: torch.Tensor, label: torch.Tensor, mask: torch.Tensor,
                       eps: float = 1e-8, q: float | None = None) -> torch.Tensor:
    """Masked EPE; q gives the reference's charbonnier-like |.|^q variant."""
    if q is not None:
        err = ((pred - label).abs().sum(1) + eps) ** q
    else:
        err = torch.sqrt(((pred - label) ** 2).sum(1) + eps)
    err = err * mask
    B = err.shape[0]
    return err.reshape(B, -1).sum(-1) / torch.clamp(mask.reshape(B, -1).sum(-1), min=1.0)


def multiscale_epe(flow: torch.Tensor, mask: torch.Tensor, predictions: list[torch.Tensor],
                   weights=(0.005, 0.01, 0.02, 0.08, 0.32), scales=(64, 32, 16, 8, 4),
                   match: str = "upsampling", eps: float = 1e-8,
                   q: float | None = None) -> torch.Tensor:
    """Weighted multi-scale EPE over the pyramid predictions [flow6..flow2]."""
    total = 0.0
    for p, w, s in zip(predictions, weights, scales):
        if match == "upsampling":
            up = ops.upsample2d_flow(p, s)
            total = total + epe_loss_with_mask(up, flow, mask, eps, q) * w
        else:
            down_f = ops.downsample2d_flow(flow, s) / s
            down_m = ops.downsample2d_flow(mask[:, None], s)[:, 0]
            total = total + epe_loss_with_mask(p / s, down_f, down_m, eps, q) * w
    return total
