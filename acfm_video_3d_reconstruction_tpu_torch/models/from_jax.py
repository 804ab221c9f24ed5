"""Carry the JAX package's weights across to the port's modules.

Input: the flax trees `params`, `batch_stats` and `lpips_params` as nested
dicts of numpy arrays (the port does not import JAX). Output: state_dicts
for MeshNet and LPIPS, checked against the target module: every converted
entry must exist there with the same shape, and every parameter and
BatchNorm statistic of the module must be covered.

Conventions:
  conv kernel HWIO -> weight OIHW; dense kernel (in, out) -> weight (out, in)
  BatchNorm scale/bias -> weight/bias, mean/var -> running_mean/running_var
  the first encoder FC takes an NHWC flatten in flax and an NCHW flatten
  here, so its input columns are permuted
  flax auto-names map explicitly (_rename).

`convert` also holds a training step of the two against each other: the
JAX step's updated `params` / `batch_stats` pair, converted, is compared
with the port's `state_dict` after its own step from the same weights.
Adam's moments start at zero on both sides, so no optimizer state needs
carrying across.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}
_RESLAYER = {"Conv_0": "conv1", "Conv_1": "conv2", "BatchNorm_0": "bn1",
             "BatchNorm_1": "bn2"}
_BLOCK = {"Conv_0": "conv", "BatchNorm_0": "bn", "Dense_0": "fc"}


def _rename(parent: str, name: str) -> str:
    """flax module name -> the port's submodule name."""
    if name.startswith("FCBNLeaky_"):
        return name.split("_")[1]
    if name.startswith("ResLayer2d_"):
        return "blocks." + name.split("_")[1]
    if parent.startswith("ResLayer2d_"):
        return _RESLAYER[name]
    if parent == "texture_predictor" and name == "Conv_0":
        return "out_conv"
    return _BLOCK.get(name, name)


def _nchw_from_nhwc_rows(kernel: np.ndarray, channels: int) -> np.ndarray:
    """Dense kernel over an NHWC flatten (h*w*c, out) -> the same over an
    NCHW flatten (c*h*w, out)."""
    hw = kernel.shape[0] // channels
    side = int(round(hw ** 0.5))
    if side * side * channels != kernel.shape[0]:
        raise ValueError(f"non-square flatten input: {kernel.shape[0]} rows")
    return (kernel.reshape(side, side, channels, -1).transpose(2, 0, 1, 3)
            .reshape(kernel.shape))


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _torch_key(path: tuple) -> str:
    mods = [_rename(path[i - 1] if i else "", n) for i, n in enumerate(path[:-1])]
    leaf = path[-1]
    return ".".join(mods + [_LEAF.get(leaf, leaf) if mods else leaf])


def _leaf_value(path: tuple, arr: np.ndarray) -> np.ndarray:
    if path[-1] != "kernel":
        return arr
    if path[-3:-1] == ("FCBNLeaky_0", "Dense_0") and path[-4] == "enc_fc":
        arr = _nchw_from_nhwc_rows(arr, 256)
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    return arr.T


def convert(module: nn.Module, *trees: Mapping) -> dict:
    """flax trees (params, then collections like batch_stats) -> a full
    state_dict for `module`."""
    target = module.state_dict()
    out = dict(target)
    covered = set()
    for tree in trees:
        for path, arr in _flatten(tree):
            key = _torch_key(path)
            if key not in target:
                raise KeyError(f"{'/'.join(path)} -> {key}: not in {type(module).__name__}")
            val = torch.tensor(_leaf_value(path, arr))
            if tuple(val.shape) != tuple(target[key].shape):
                raise ValueError(f"{key}: shape {tuple(val.shape)} vs {tuple(target[key].shape)}")
            out[key] = val.to(target[key].dtype)
            covered.add(key)
    missing = [k for k in target if k not in covered and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"not covered by the flax trees: {missing}")
    return out


def load_jax_weights(mods, params: Mapping, batch_stats: Mapping,
                     lpips_params: Mapping) -> None:
    """Load the JAX package's monocular trees into a built MonoModules."""
    mods.model.load_state_dict(convert(mods.model, params, batch_stats))
    if mods.lpips is not None:
        mods.lpips.load_state_dict(convert(mods.lpips, lpips_params))
