"""Checkpoint save / resume with torch.save.

Counterpart of acfm_video_3d_reconstruction_tpu/train/checkpoints.py (orbax
there). A checkpoint is one file, `<checkpoint_dir>/<name>/pred_net_<label>.pth`,
holding what the JAX TrainState holds: {"model": the MeshNet state_dict
(parameters and BatchNorm statistics), "lpips": the LPIPS state_dict ({}
without texture), "optimizer": the Adam state_dict (moments and step count)
or None, "step": the train steps taken}. The multiframe trainer's file
(`save_multiframe`) holds what the JAX MFTrainState holds: the model, LPIPS,
"multiplex" (the tables and probs, train/multiframe.py::Multiplex),
"optimizer" (the full Adam), "warmup_optimizer" (the pose warm-up Adam) and
"step" (warm-up and train steps). The labels are JAX's (reference
train_utils.py:83-110): 'latest', '<epoch>', and 'warmup' /
'texture_warmup' for the multiframe trainer. Files load with
weights_only=True, as flow/infer.py::load_flow_checkpoint does.
"""
from __future__ import annotations

import os
from typing import Optional

import torch


def path(checkpoint_dir: str, name: str, label: str | int) -> str:
    return os.path.abspath(os.path.join(checkpoint_dir, name, f"pred_net_{label}.pth"))


def steps_taken(opt: Optional[torch.optim.Optimizer]) -> int:
    """The optimizer's step count (every Adam parameter steps together)."""
    if opt is None:
        return 0
    return max((int(s["step"]) for s in opt.state.values() if "step" in s), default=0)


def save(checkpoint_dir: str, name: str, label: str | int, mods,
         opt: Optional[torch.optim.Optimizer] = None) -> str:
    """Save the modules' state (and `opt`'s) under a reference-style label.
    Written to a temporary file first and renamed, so an interrupted save
    leaves the previous checkpoint whole."""
    return _write(checkpoint_dir, name, label, {
        "model": mods.model.state_dict(),
        "lpips": mods.lpips.state_dict() if mods.lpips is not None else {},
        "optimizer": opt.state_dict() if opt is not None else None,
        "step": steps_taken(opt),
    })


def save_multiframe(checkpoint_dir: str, name: str, label: str | int, mods) -> str:
    """Save a train/multiframe.py MFModules (model, LPIPS, multiplex tables,
    both optimizers, step) under a reference-style label."""
    return _write(checkpoint_dir, name, label, {
        "model": mods.model.state_dict(),
        "lpips": mods.lpips.state_dict() if mods.lpips is not None else {},
        "multiplex": mods.mpx.state_dict(),
        "optimizer": mods.opt.state_dict(),
        "warmup_optimizer": mods.warm_opt.state_dict(),
        "step": mods.step,
    })


def _write(checkpoint_dir: str, name: str, label: str | int, state: dict) -> str:
    out = path(checkpoint_dir, name, label)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    torch.save(state, out + ".tmp")
    os.replace(out + ".tmp", out)
    return out


def _graft(module: torch.nn.Module, saved: dict, what: str) -> None:
    """Non-strict load of `saved` into `module`, entry by entry."""
    loaded = {}
    for key, target in module.state_dict().items():
        src = saved.get(key)
        if src is None:
            print(f"[restore non-strict] missing in checkpoint: {what}.{key}")
        elif tuple(src.shape) != tuple(target.shape):
            print(f"[restore non-strict] shape mismatch at {what}.{key}: "
                  f"{tuple(src.shape)} vs {tuple(target.shape)}; keeping target")
        else:
            loaded[key] = src
    # load_state_dict copies into the module's own tensors: the values take
    # their dtype and device; entries the module lacks were never collected
    module.load_state_dict(loaded, strict=False)


def _optimizer_fits(opt: torch.optim.Optimizer, saved: Optional[dict]) -> bool:
    """Whether `saved` has one state per parameter of `opt`, shape for shape."""
    if saved is None:
        return False
    params = [p for g in opt.param_groups for p in g["params"]]
    ids = [i for g in saved["param_groups"] for i in g["params"]]
    if len(ids) != len(params):
        return False
    for i, p in zip(ids, params):
        for v in saved["state"].get(i, {}).values():
            if torch.is_tensor(v) and v.dim() and tuple(v.shape) != tuple(p.shape):
                return False
    return True


def _load_modules(mods, state: dict, strict: bool) -> None:
    if strict:
        mods.model.load_state_dict(state["model"])
        if mods.lpips is not None:
            mods.lpips.load_state_dict(state["lpips"])
        elif state["lpips"]:
            raise KeyError("checkpoint holds LPIPS weights; the modules have no LPIPS")
        return
    _graft(mods.model, state["model"], "model")
    if mods.lpips is not None:
        _graft(mods.lpips, state["lpips"], "lpips")


def _load_optimizer(opt: torch.optim.Optimizer, saved: Optional[dict], key: str,
                    strict: bool) -> None:
    if strict:
        if saved is None:
            raise KeyError(f"checkpoint holds no {key} state")
        opt.load_state_dict(saved)
    elif _optimizer_fits(opt, saved):
        opt.load_state_dict(saved)
    else:
        print(f"[restore non-strict] {key} state does not fit the optimizer; keeping target")


def restore(checkpoint_dir: str, name: str, label: str | int, mods,
            opt: Optional[torch.optim.Optimizer] = None, strict: bool = True) -> int:
    """Load a checkpoint into the modules (and `opt`) in place; returns the
    saved step count.

    strict=True requires the same entries and shapes everywhere (PyTorch's
    own load_state_dict checks). strict=False tolerates structure drift the
    way the reference's non-strict state-dict load does (train_utils.py:
    92-102): an entry missing from the checkpoint keeps the module's value
    and its name is printed, an entry the module lacks is dropped, a shape
    mismatch keeps the module's value with a warning, and an optimizer
    state that does not fit the optimizer's parameters is not loaded. Used
    by the eval CLI so a train/eval flag mismatch (e.g. --texture) degrades
    instead of crashing.
    """
    state = torch.load(path(checkpoint_dir, name, label), map_location="cpu",
                       weights_only=True)
    _load_modules(mods, state, strict)
    if opt is not None:
        _load_optimizer(opt, state["optimizer"], "optimizer", strict)
    return int(state["step"])


def restore_multiframe(checkpoint_dir: str, name: str, label: str | int, mods,
                       strict: bool = True) -> int:
    """Load a save_multiframe checkpoint into an MFModules in place (model,
    LPIPS, multiplex tables and probs, both optimizers, step); returns the
    step. strict=False has restore's non-strict semantics, entry by entry,
    the multiplex tables included (the multiframe driver's --load_warmup
    and num_pretrain_epochs resumes restore so, as the JAX driver does)."""
    state = torch.load(path(checkpoint_dir, name, label), map_location="cpu",
                       weights_only=True)
    _load_modules(mods, state, strict)
    if strict:
        mods.mpx.load_state_dict(state["multiplex"])
    else:
        _graft(mods.mpx, state.get("multiplex", {}), "multiplex")
    for opt, key in ((mods.opt, "optimizer"), (mods.warm_opt, "warmup_optimizer")):
        _load_optimizer(opt, state.get(key), key, strict)
    mods.step = int(state["step"])
    return mods.step


def exists(checkpoint_dir: str, name: str, label: str | int) -> bool:
    return os.path.isfile(path(checkpoint_dir, name, label))
