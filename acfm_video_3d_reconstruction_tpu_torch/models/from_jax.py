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
`load_jax_multiframe` carries a JAX MFTrainState's model, LPIPS and
multiplex tables into the multiframe trainer's modules, and
`load_jax_optimizers` its two Adam states (moments and step count), so that
a state taken in the middle of a JAX run continues in the port.
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


def load_jax_multiframe(mods, params: Mapping, batch_stats: Mapping, lpips_params: Mapping,
                        multiplex: Mapping) -> None:
    """Load a JAX MFTrainState's trees into a built train/multiframe.py
    MFModules: the model and LPIPS as load_jax_weights does, and the
    multiplex tables from `multiplex` = {"cams", "probs", "deform",
    "deform_mirror"} (numpy arrays; deform entries None when the run trains
    none), checked against the port's tables entry for entry and shape for
    shape. The optimizers keep their state (Adam's moments start at zero
    on both sides)."""
    load_jax_weights(mods, params, batch_stats, lpips_params)
    target = mods.mpx.state_dict()
    given = {k: v for k, v in multiplex.items() if v is not None}
    if set(given) != set(target):
        raise KeyError(f"multiplex tables {sorted(given)} vs the port's {sorted(target)}")
    for k, arr in given.items():
        if tuple(np.shape(arr)) != tuple(target[k].shape):
            raise ValueError(f"multiplex {k}: shape {np.shape(arr)} vs {tuple(target[k].shape)}")
    mods.mpx.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in given.items()})


def convert_params(module: nn.Module, tree: Mapping) -> dict:
    """A flax params tree, or a tree of its layout such as Adam's moments
    of it, -> {parameter name: tensor} covering every parameter of
    `module`, shape for shape."""
    params = dict(module.named_parameters())
    out = {}
    for path, arr in _flatten(tree):
        key = _torch_key(path)
        if key not in params:
            raise KeyError(f"{'/'.join(path)} -> {key}: not a parameter of "
                           f"{type(module).__name__}")
        val = torch.tensor(_leaf_value(path, arr))
        if tuple(val.shape) != tuple(params[key].shape):
            raise ValueError(f"{key}: shape {tuple(val.shape)} vs {tuple(params[key].shape)}")
        out[key] = val
    missing = sorted(set(params) - set(out))
    if missing:
        raise KeyError(f"parameters not covered by the flax tree: {missing}")
    return out


def _load_adam(opt: torch.optim.Optimizer, moments: list, count: int) -> None:
    """Adam's state of each parameter of `opt`, in its order: `moments` a
    list of (mu, nu) numpy pairs and `count` optax's step count. torch
    counts the step before it corrects the bias, as optax counts count_inc,
    so step = count; count 0 leaves the optimizer without state, as torch
    builds it (its first step then makes the zero moments optax starts
    from), and needs no moments."""
    params = [p for group in opt.param_groups for p in group["params"]]
    opt.state.clear()
    if count == 0:
        return
    if len(moments) != len(params):
        raise ValueError(f"{len(moments)} moment pairs for {len(params)} parameters")
    for p, (mu, nu) in zip(params, moments):
        for what, arr in (("mu", mu), ("nu", nu)):
            if tuple(np.shape(arr)) != tuple(p.shape):
                raise ValueError(f"Adam {what}: shape {np.shape(arr)} vs {tuple(p.shape)}")
        opt.state[p] = {
            # a capturable Adam keeps its count on the parameter's device
            "step": torch.tensor(float(count), dtype=torch.float32,
                                 device=p.device if opt.defaults["capturable"] else None),
            "exp_avg": torch.tensor(np.asarray(mu), dtype=p.dtype, device=p.device),
            "exp_avg_sq": torch.tensor(np.asarray(nu), dtype=p.dtype, device=p.device),
        }


def load_jax_optimizers(mods, full: Mapping, warm: Mapping) -> None:
    """Load a JAX MFTrainState's two Adam states into a built
    train/multiframe.py MFModules' optimizers, so that the port's next step
    is the JAX step's. `full` = {"count", "mu", "nu"}, numpy, from optax's
    ScaleByAdamState of tx_full: mu and nu are trees {"params": the flax
    params layout, "mpx": {"cams"[, "deform", "deform_mirror"]}}. `warm` is
    the same for tx_warm, whose mu and nu are the camera table's arrays.
    At count 0 the moments (zeros) may be left out. Only the plain Adam
    (one parameter group) is carried."""
    if len(mods.opt.param_groups) != 1:
        raise ValueError("only a single-group optimizer_full is carried across")
    moments = []
    if int(full["count"]):
        conv = {what: convert_params(mods.model, full[what]["params"]) for what in ("mu", "nu")}
        for name, p in mods.model.named_parameters():
            if p.requires_grad:
                moments.append((conv["mu"][name].numpy(), conv["nu"][name].numpy()))
        for name, _ in mods.mpx.named_parameters():
            moments.append((full["mu"]["mpx"][name], full["nu"]["mpx"][name]))
    _load_adam(mods.opt, moments, int(full["count"]))
    _load_adam(mods.warm_opt, [(warm["mu"], warm["nu"])] if int(warm["count"]) else [],
               int(warm["count"]))


def maskflownet_from_jax(params: Mapping) -> dict:
    """The JAX package's MaskFlownet tree {"s": {name: {"w", "b"}}, "m": ...}
    (numpy arrays) -> a full state_dict of flow.maskflownet.MaskFlownet,
    stage 1 under 'MaskFlownet_S.'. Conv kernels HWIO -> OIHW; the upfeat
    deconv kernels (kh, kw, Cout, Cin) -> ConvTranspose2d (Cin, Cout, kh,
    kw), the same transpose (the inverse of flow/maskflownet.py:300-304).
    Checked against the module: same keys, same shapes."""
    from ..flow.maskflownet import MaskFlownet

    with torch.device("meta"):
        target = MaskFlownet().state_dict()
    out = {}
    for stage, prefix in (("s", "MaskFlownet_S."), ("m", "")):
        for name, p in params[stage].items():
            for leaf, arr in (("weight", np.asarray(p["w"]).transpose(3, 2, 0, 1)),
                              ("bias", np.asarray(p["b"]))):
                key = f"{prefix}{name}.{leaf}"
                if key not in target:
                    raise KeyError(f"{stage}/{name} -> {key}: not in MaskFlownet")
                if tuple(arr.shape) != tuple(target[key].shape):
                    raise ValueError(f"{key}: shape {arr.shape} vs {tuple(target[key].shape)}")
                out[key] = torch.tensor(np.ascontiguousarray(arr), dtype=torch.float32)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"not covered by the JAX tree: {missing}")
    return out
