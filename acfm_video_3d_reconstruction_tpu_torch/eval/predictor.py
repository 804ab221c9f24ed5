"""Monocular inference predictor.

Counterpart of acfm_video_3d_reconstruction_tpu/eval/predictor.py::
predict_monocular (the reference's MeshPredictor.predict). The TTO
evaluator is not ported yet.
"""
from __future__ import annotations

import torch

from ..train import monocular


def predict_monocular(mods: monocular.MonoModules, batch: dict) -> dict:
    """Full forward -> {lbs, mean_shape, faces, kp_pred, verts, cam_pred, mask_pred}."""
    with torch.inference_mode():
        _, aux = monocular.forward(mods, monocular.to_device_batch(mods, batch))
        model = mods.model
        return {
            "lbs": model.get_lbs(),
            "mean_shape": model.get_mean_shape().detach(),
            "faces": mods.template.faces,
            "kp_pred": aux["kp_pred"],
            "verts": aux["pred_v"],
            "cam_pred": aux["cam_pred"],
            "mask_pred": aux["mask_pred"],
        }
