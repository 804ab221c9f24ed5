"""Reference torch checkpoints -> the port's modules.

Counterpart of acfm_video_3d_reconstruction_tpu/models/torch_import.py,
which converts torchvision resnet18 / alexnet and reference MeshNet state
dicts into flax trees. The port's modules are torch modules laid out as the
reference's (OIHW conv weights, (out, in) linear weights, an NCHW flatten
before the encoder's first FC), so a conversion is only a map from the
reference's names to the port's; no tensor is transposed or permuted.
Every loader reads a local file with weights_only=True: a state dict, or
{"state_dict": ...} around one (as flow/infer.py::load_flow_checkpoint).
"""
from __future__ import annotations

import os
import re
from typing import Mapping

import torch
from torch import nn


def _resnet_key(key: str) -> str | None:
    """torchvision resnet18 name -> the port's ResNet18 name, or None for an
    entry the port does not keep (num_batches_tracked, the fc head)."""
    if key.endswith("num_batches_tracked") or key.startswith("fc."):
        return None
    m = re.match(r"layer(\d)\.(\d)\.(.*)$", key)
    if m is None:
        return key  # conv1.weight, bn1.*
    rest = m.group(3).replace("downsample.0.", "downsample_conv.")
    rest = rest.replace("downsample.1.", "downsample_bn.")
    return f"layer{m.group(1)}_{m.group(2)}.{rest}"


def convert_resnet18(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """torchvision resnet18 state dict -> entries of the port's
    models.encoder.ResNet18."""
    out = {}
    for k, v in state_dict.items():
        name = _resnet_key(k)
        if name is not None:
            out[name] = v
    return out


# the five convs of torchvision alexnet's .features
_ALEX_IDX = (0, 3, 6, 8, 10)


def convert_alexnet_features(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """torchvision alexnet state dict -> the port's LPIPS entries
    (alex.conv0 .. alex.conv4)."""
    return {f"alex.conv{i}.{leaf}": state_dict[f"features.{t}.{leaf}"]
            for i, t in enumerate(_ALEX_IDX) for leaf in ("weight", "bias")}


# texture_predictor.res_color_net slots holding a ResLayer_2d, in order
# (reference mesh_net.py:157-164); slot 12 is the output conv
_RES_SLOTS = (0, 2, 3, 5, 7, 9, 11)
_TEMPLATE = {"mean_v": "mean_v", "lbs": "lbs_logits", "vert2kp": "vert2kp_logits"}
_RENAMES = (
    (r"encoder\.enc_conv1\.0\.", "encoder.enc_conv1.conv."),
    (r"encoder\.enc_conv1\.1\.", "encoder.enc_conv1.bn."),
    (r"encoder\.enc_fc\.(\d)\.0\.", r"encoder.enc_fc.\1.fc."),
    (r"encoder\.enc_fc\.(\d)\.1\.", r"encoder.enc_fc.\1.bn."),
    (r"code_predictor\.transform_predictor\.final_layer_trans\.", "code_predictor.fc."),
    (r"camera_predictor\.conv_c\.0\.", "camera_predictor.conv_c."),
    (r"camera_predictor\.fc(\d)\.0\.", r"camera_predictor.fc\1."),
    (r"camera_predictor\.fc(\d)\.1\.", r"camera_predictor.ln\1."),
    (r"camera_predictor\.(quat|scale|trans)_predictor\.pred_layer\.",
     r"camera_predictor.\1.fc."),
    (r"texture_predictor\.res_color_net\.12\.", "texture_predictor.out_conv."),
)


def _meshnet_key(key: str) -> str | None:
    if key.endswith("num_batches_tracked"):
        return None
    if key in _TEMPLATE:
        return _TEMPLATE[key]
    pfx = "encoder.resnet_conv.resnet."
    if key.startswith(pfx):
        name = _resnet_key(key[len(pfx):])
        return None if name is None else "encoder.resnet." + name
    m = re.match(r"texture_predictor\.res_color_net\.(\d+)\.(.*)$", key)
    if m and int(m.group(1)) in _RES_SLOTS:
        return f"texture_predictor.blocks.{_RES_SLOTS.index(int(m.group(1)))}.{m.group(2)}"
    for pat, rep in _RENAMES:
        if re.match(pat, key):
            return re.sub(pat, rep, key, count=1)
    # CodePredictor's other heads (final_layer_angles, the quat/scale/trans
    # sub-predictors) are dead in the reference forward (mesh_net.py:255-265)
    return None


def convert_meshnet(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """A reference `pred_net_<epoch>.pth` MeshNet state dict (monocular
    mesh_net.py:294-470; the multiframe one adds LayerNorms in the camera
    FC blocks) -> entries of the port's models.mesh_net.MeshNet."""
    out = {}
    for k, v in state_dict.items():
        name = _meshnet_key(k)
        if name is not None:
            out[name] = v
    return out


def load_torch_state_dict(path: str) -> dict:
    """A state dict saved with torch.save (or {"state_dict": sd}), read with
    weights_only=True onto the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd.get("state_dict"), Mapping):
        sd = sd["state_dict"]
    return dict(sd)


def load_checked(module: nn.Module, entries: Mapping[str, torch.Tensor],
                 require_all: bool = False) -> None:
    """Copy `entries` into `module`: every entry must name one of the
    module's tensors with the same shape; with require_all every parameter
    and BatchNorm statistic of the module must be covered."""
    target = module.state_dict()
    for k, v in entries.items():
        if k not in target:
            raise KeyError(f"{k}: not in {type(module).__name__}")
        if tuple(v.shape) != tuple(target[k].shape):
            raise ValueError(f"shape mismatch at {k}: {tuple(v.shape)} vs "
                             f"{tuple(target[k].shape)}")
    if require_all:
        missing = [k for k in target
                   if k not in entries and not k.endswith("num_batches_tracked")]
        if missing:
            raise KeyError(f"not in the checkpoint: {missing}")
    module.load_state_dict(dict(entries), strict=False)


def load_reference_meshnet(model: nn.Module, path: str) -> None:
    """Load a reference `pred_net_*.pth` into a MeshNet (shape-checked: the
    template and config must match the checkpoint's: subdivide, num_lbs,
    num_kps, img_size, symmetry flags)."""
    load_checked(model, convert_meshnet(load_torch_state_dict(path)))


def maybe_load_pretrained_encoder(model: nn.Module, path: str | None) -> bool:
    """Load torchvision resnet18 weights into the MeshNet's encoder trunk if
    the file exists; returns whether it did."""
    if not path or not os.path.exists(path):
        return False
    load_checked(model.encoder.resnet, convert_resnet18(load_torch_state_dict(path)),
                 require_all=True)
    return True
