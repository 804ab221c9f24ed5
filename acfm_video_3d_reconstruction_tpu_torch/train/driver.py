"""Host-side training driver: the monocular epoch loop, checkpoints, logging.

Counterpart of acfm_video_3d_reconstruction_tpu/train/driver.py::
run_monocular_training (reference monocular train_utils.py:192-264). The
model, its BatchNorm statistics and the optimizer live in torch objects that
the step updates in place (train/monocular.py), so the loop passes batches,
not a state. The multiframe loop (run_multiframe_training) is not ported
yet.
"""
from __future__ import annotations

import math
import os
import os.path as osp
from typing import Optional

import torch

from .. import config as cfg_lib
from . import checkpoints, metrics_logger, prefetch
from . import monocular as mono


def _save_dir(cfg: cfg_lib.Config) -> str:
    return osp.join(cfg.train.checkpoint_dir, cfg.train.name)


def _nan_dump_dir() -> Optional[str]:
    """ACFM_NAN_DUMP_DIR: per-step non-finite-loss detection (debug aid).

    When set, every train step's total_loss is checked on the host (one sync
    per step, and a copy of the state before each step: a debugging cost,
    so env-gated); on the FIRST non-finite value the PRE-step state and the
    offending batch are saved (torch.save) to the directory and training
    aborts. The saved pair reproduces the bad gradient step offline."""
    return os.environ.get("ACFM_NAN_DUMP_DIR") or None


def _to_cpu(obj):
    """A copy of a nest of dicts, lists and tensors with every tensor on the CPU."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _snapshot(mods: mono.MonoModules, opt: torch.optim.Optimizer) -> dict:
    """The train state a step starts from, copied to the CPU."""
    return _to_cpu({"model": mods.model.state_dict(), "optimizer": opt.state_dict()})


def _check_finite_or_dump(dump_dir, epoch, step, prev_pair, metrics):
    tl = float(metrics["total_loss"])
    if math.isfinite(tl):
        return
    os.makedirs(dump_dir, exist_ok=True)
    path = f"{dump_dir}/nan_step_{step}.pt"
    state, batch = prev_pair if prev_pair is not None else (None, None)
    torch.save({"epoch": epoch, "step": step, "state": state, "batch": _to_cpu(batch),
                "metrics": _to_cpu(metrics)}, path)
    raise FloatingPointError(
        f"non-finite total_loss at epoch {epoch} step {step}; the "
        f"poisoning step's pre-step state + batch dumped to {path}"
    )


def run_monocular_training(
    cfg: cfg_lib.Config,
    template,
    loader,
    num_epochs: Optional[int] = None,
    log_every: int = 20,
    load_pretrained=None,
    load_lpips=None,
    vis_fn=None,
    device: str | torch.device = "cuda",
):
    """Monocular train loop (reference monocular train_utils.py:192-264).

    load_pretrained(model) / load_lpips(lpips): optional weight loaders
    applied to the freshly built MeshNet and LPIPS modules (ImageNet
    resnet18 encoder, monocular/nnutils/mesh_net.py:87-95; pretrained LPIPS
    AlexNet, loss_utils.py:361-363). num_pretrain_epochs > 0 resumes,
    strictly, from that epoch's checkpoint when it exists. Returns the
    modules and the optimizer.
    """
    tr = cfg.train
    mods = mono.build(cfg, template, seed=tr.seed, device=device)
    if vis_fn is None and tr.display_freq > 0:
        from . import visualize

        vis_fn = visualize.make_monocular_vis_fn(mods)
    if load_pretrained is not None:
        load_pretrained(mods.model)
    if load_lpips is not None:
        load_lpips(mods.lpips)
    step = mono.make_train_step(mods)
    opt = step.opt
    save_dir = _save_dir(cfg)
    logger = metrics_logger.MetricsLogger(save_dir)
    metrics_logger.dump_config(save_dir, cfg)

    if tr.num_pretrain_epochs > 0 and checkpoints.exists(
        tr.checkpoint_dir, tr.name, tr.num_pretrain_epochs
    ):
        checkpoints.restore(tr.checkpoint_dir, tr.name, tr.num_pretrain_epochs, mods, opt)

    def prep(batch):
        return prefetch.to_device(batch, mono.BATCH_KEYS, mods.device)

    nan_dump = _nan_dump_dir()
    prev_pair = None  # debug mode: the last step's (pre-step state, batch)
    total_steps = 0
    n_epochs = num_epochs if num_epochs is not None else tr.num_epochs
    for epoch in range(tr.num_pretrain_epochs, n_epochs):
        for db in prefetch.prefetch(loader, prep):
            pre = _snapshot(mods, opt) if nan_dump else None
            metrics = step(db)
            if nan_dump:
                # metrics NaN at step N => params were poisoned by the
                # UPDATE of step N-1 => culprit pair is prev_pair
                _check_finite_or_dump(nan_dump, epoch, total_steps + 1, prev_pair, metrics)
                prev_pair = (pre, db)
            total_steps += 1
            if total_steps % log_every == 0:
                logger.log(epoch, total_steps, metrics)
            if tr.save_latest_freq > 0 and total_steps % tr.save_latest_freq == 0:
                checkpoints.save(tr.checkpoint_dir, tr.name, "latest", mods, opt)
            if vis_fn is not None and tr.display_freq > 0 and total_steps % tr.display_freq == 0:
                vis_fn(save_dir, total_steps, db)
        if (epoch + 1) % tr.save_epoch_freq == 0:
            checkpoints.save(tr.checkpoint_dir, tr.name, "latest", mods, opt)
            checkpoints.save(tr.checkpoint_dir, tr.name, epoch + 1, mods, opt)
    checkpoints.save(tr.checkpoint_dir, tr.name, "latest", mods, opt)
    logger.close()
    return mods, opt
