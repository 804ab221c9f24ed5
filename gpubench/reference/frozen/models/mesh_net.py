"""MeshNet: the full ACFM model as one nn.Module.

Counterpart of acfm_video_3d_reconstruction_tpu/models/mesh_net.py. Owns
the learnable template `mean_v` (half mesh if symmetric), the LBS logits
and vert2kp logits (initialised from the Template), the ResNet encoder,
the handle-offset head, the camera regressor and the texture decoder.
Images enter NHWC as in the JAX package and run NCHW inside; the geometry
outputs (delta_v, cam_pred) are float32 whatever the conv compute type.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..deform.solve import lbs_from_logits
from ..geometry.symmetry import symmetrize
from .encoder import Encoder, res_feats_side
from .heads import CameraPredictor, TransformationPredictor
from .nn_blocks import init_weights
from .template import Template
from .texture import TexturePredictorUV


class MeshNet(nn.Module):
    def __init__(self, template: Template, img_size: int, nz_feat: int = 200,
                 predict_texture: bool = True, use_camera_layernorm: bool = False,
                 scale_lr: float = 1.0, small_camera_init: bool = False,
                 learnable_kp: bool = True):
        super().__init__()
        t = template
        self.template = t
        self.mean_v = nn.Parameter(torch.from_numpy(t.mean_v_init.copy()))
        self.lbs_logits = nn.Parameter(torch.from_numpy(t.lbs_logits.astype("float32")))
        if t.vert2kp_logits is None:
            self.vert2kp_logits = None
        elif learnable_kp:
            self.vert2kp_logits = nn.Parameter(
                torch.from_numpy(t.vert2kp_logits.astype("float32")))
        else:
            self.register_buffer("vert2kp_logits",
                                 torch.from_numpy(t.vert2kp_logits.astype("float32")))
        side = res_feats_side(img_size)
        self.encoder = Encoder(img_size, nz_feat)
        self.code_predictor = TransformationPredictor(nz_feat, t.num_lbs)
        self.camera_predictor = CameraPredictor(
            side, use_layernorm=use_camera_layernorm, scale_lr=scale_lr,
            small_init=small_camera_init,
        )
        self.texture_predictor = (
            TexturePredictorUV(t.uv_sampler, side, t.num_sym_faces)
            if predict_texture else None
        )

    def init_weights(self, gen: torch.Generator) -> None:
        """The JAX package's initialisers over the conv/FC nets (the
        template parameters keep their Template values)."""
        for m in (self.encoder, self.code_predictor, self.camera_predictor,
                  self.texture_predictor):
            if m is not None:
                init_weights(m, gen)

    def train(self, mode: bool = True) -> "MeshNet":
        """Train mode for the encoder and heads; the texture decoder stays in
        eval mode, with its stored BatchNorm statistics, as the JAX forward
        calls `model.textures(..., train=False)` while training. Its weights
        still get gradients."""
        super().train(mode)
        if self.texture_predictor is not None:
            self.texture_predictor.eval()
        return self

    # ---- template state ----
    def get_mean_shape(self) -> torch.Tensor:
        """Full (V, 3) mean shape, symmetrized if the template is."""
        if self.template.symmetric:
            return symmetrize(self.mean_v, self.template.num_sym)
        return self.mean_v

    def get_lbs(self) -> torch.Tensor:
        """(K, V) skinning matrix: softmax over vertices, transposed."""
        return lbs_from_logits(self.lbs_logits)

    def get_vert2kp(self) -> Optional[torch.Tensor]:
        if self.vert2kp_logits is None:
            return None
        return torch.softmax(self.vert2kp_logits, dim=1)

    def forward(self, img: torch.Tensor) -> dict:
        """img (B, H, W, 3) -> delta_v (B, K, 3), cam_pred (B, 7), img_feat,
        res_feats (B, 256, s, s)."""
        img_feat, res_feats = self.encoder(img.permute(0, 3, 1, 2))
        return {
            "img_feat": img_feat,
            "res_feats": res_feats,
            "delta_v": self.code_predictor(img_feat).float(),
            "cam_pred": self.camera_predictor(res_feats).float(),
        }

    def textures(self, res_feats: torch.Tensor) -> torch.Tensor:
        """(B, F, T, T, 3) float32 texture atlas from spatial features."""
        return self.texture_predictor(res_feats).float()
