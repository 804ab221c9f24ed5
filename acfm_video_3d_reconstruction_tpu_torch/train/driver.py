"""Host-side training drivers: epoch loops, phases, checkpoints, logging.

Counterpart of acfm_video_3d_reconstruction_tpu/train/driver.py
(reference monocular and multiframe train_utils.py train()). The models,
their BatchNorm statistics, the multiplex tables and the optimizers live in
torch objects that the steps update in place (train/monocular.py,
train/multiframe.py), so the loops pass batches, not a state.

Under a process group (parallel/mesh.py) every rank runs the same loader
with the same seed and keeps its block of each global batch, so the global
batches are the one-process run's; the steps reduce gradients, statistics,
write-backs and metrics over the ranks. The logger, the checkpoint saves
and the panels run on rank 0 only; every rank restores.
"""
from __future__ import annotations

import math
import os
import os.path as osp
from typing import Optional

import torch

from .. import config as cfg_lib
from ..parallel import mesh as pmesh
from . import checkpoints, metrics_logger, prefetch, schedules
from . import monocular as mono
from . import multiframe as mf


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


def _snapshot_mf(mods: mf.MFModules) -> dict:
    """The multiframe train state a step starts from, copied to the CPU."""
    return _to_cpu({"model": mods.model.state_dict(), "multiplex": mods.mpx.state_dict(),
                    "optimizer": mods.opt.state_dict(), "step": mods.step})


def _check_finite_or_dump(dump_dir, epoch, step, prev_pair, metrics):
    """Decides on the step's total_loss, a global mean under a process
    group, so every rank stops at the same step (each dumping its own
    state and block, `_rank<r>` in the name)."""
    tl = float(metrics["total_loss"])
    if math.isfinite(tl):
        return
    os.makedirs(dump_dir, exist_ok=True)
    suffix = f"_rank{pmesh.rank()}" if pmesh.world_size() > 1 else ""
    path = f"{dump_dir}/nan_step_{step}{suffix}.pt"
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
    main = pmesh.is_main()
    vis_fn = vis_fn if main else None
    mods = mono.build(cfg, template, seed=tr.seed, device=device)
    if vis_fn is None and tr.display_freq > 0 and main:
        from . import visualize

        vis_fn = visualize.make_monocular_vis_fn(mods)
    if load_pretrained is not None:
        load_pretrained(mods.model)
    if load_lpips is not None:
        load_lpips(mods.lpips)
    step = mono.make_train_step(mods)
    opt = step.opt
    save_dir = _save_dir(cfg)
    logger = metrics_logger.MetricsLogger(save_dir) if main else None
    if main:
        metrics_logger.dump_config(save_dir, cfg)

    def save(label):
        if main:
            checkpoints.save(tr.checkpoint_dir, tr.name, label, mods, opt)

    if tr.num_pretrain_epochs > 0 and checkpoints.exists(
        tr.checkpoint_dir, tr.name, tr.num_pretrain_epochs
    ):
        checkpoints.restore(tr.checkpoint_dir, tr.name, tr.num_pretrain_epochs, mods, opt)

    def prep(batch):
        return prefetch.to_device(pmesh.shard_batch(batch), mono.BATCH_KEYS, mods.device)

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
            if main and total_steps % log_every == 0:
                logger.log(epoch, total_steps, metrics)
            if tr.save_latest_freq > 0 and total_steps % tr.save_latest_freq == 0:
                save("latest")
            if vis_fn is not None and tr.display_freq > 0 and total_steps % tr.display_freq == 0:
                vis_fn(save_dir, total_steps, db)
        if (epoch + 1) % tr.save_epoch_freq == 0:
            save("latest")
            save(epoch + 1)
    save("latest")
    if main:
        logger.close()
    return mods, opt


def run_multiframe_training(
    cfg: cfg_lib.Config,
    template,
    loader,
    loader_noaug,
    num_frames_total: int,
    num_epochs: Optional[int] = None,
    init_camera_emb: bool = False,
    finetune_camera: bool = False,
    log_every: int = 20,
    flow_fn=None,
    load_pretrained=None,
    load_lpips=None,
    vis_fn=None,
    load_warmup: bool = False,
    device: str | torch.device = "cuda",
):
    """Multiframe phases: [init-camera-emb] -> pose warm-up -> texture
    warm-up -> main loop with the hypothesis-drop and finetune-camera
    schedules (reference multiframe train_utils.py:192-284).

    load_warmup: restore the 'texture_warmup' (or 'warmup') checkpoint
    non-strictly and skip the warm-up phases; num_pretrain_epochs > 0
    restores that epoch's checkpoint and resumes the main loop there.
    flow_fn: batch preprocessor attaching batch['optical_flows'] (the frozen
    MaskFlownet pass, flow/infer.py::make_flow_fn); required when the flow
    loss weight is nonzero. It runs on the prefetch thread after the upload,
    so its launches go to the same (default) stream as the steps', ahead of
    the step that reads the batch. load_pretrained(model) / load_lpips(lpips):
    optional weight loaders applied to the built modules. vis_fn(save_dir,
    step, batch): image panels every cfg.train.display_freq main-loop steps
    (train/visualize.py::make_multiframe_vis_fn when display_freq > 0 and
    none is given). Returns the modules.
    """
    tr = cfg.train
    mp = cfg.multiplex
    if cfg.mf_weights.of > 0 and flow_fn is None:
        raise ValueError(
            "of_loss_wt > 0 requires optical flow: pass flow_fn "
            "(e.g. flow.infer.make_flow_fn with --flow_checkpoint), or set "
            "of_loss_wt=0"
        )
    main = pmesh.is_main()
    vis_fn = vis_fn if main else None
    mods = mf.build(cfg, template, num_frames_total, seed=tr.seed,
                    steps_per_epoch=len(loader), device=device)
    if vis_fn is None and tr.display_freq > 0 and main:
        from . import visualize

        vis_fn = visualize.make_multiframe_vis_fn(mods)
    if load_pretrained is not None:
        load_pretrained(mods.model)
    if load_lpips is not None:
        load_lpips(mods.lpips)
    save_dir = _save_dir(cfg)
    logger = metrics_logger.MetricsLogger(save_dir) if main else None
    if main:
        metrics_logger.dump_config(save_dir, cfg)

    def prep(batch):
        db = mf.to_device_batch(mods, pmesh.shard_batch(batch))
        return flow_fn(db) if flow_fn is not None else db

    if init_camera_emb and loader_noaug is not None:
        for batch in loader_noaug:
            mf.init_camera_emb(mods, mf.to_device_batch(mods, pmesh.shard_batch(batch)))

    def save(label):
        if main:
            checkpoints.save_multiframe(tr.checkpoint_dir, tr.name, label, mods)

    skip_warmups = False
    if load_warmup:
        for label in ("texture_warmup", "warmup"):
            if checkpoints.exists(tr.checkpoint_dir, tr.name, label):
                checkpoints.restore_multiframe(tr.checkpoint_dir, tr.name, label, mods,
                                               strict=False)
                skip_warmups = True
                print(f"resumed from '{label}' checkpoint; skipping warmups")
                break
        else:
            print("warning: --load_warmup set but no warmup checkpoint found")
    if tr.num_pretrain_epochs > 0 and checkpoints.exists(
        tr.checkpoint_dir, tr.name, tr.num_pretrain_epochs
    ):
        checkpoints.restore_multiframe(tr.checkpoint_dir, tr.name, tr.num_pretrain_epochs,
                                       mods, strict=False)
        skip_warmups = True
        print(f"resumed from epoch {tr.num_pretrain_epochs}")

    total_steps = 0
    if tr.warmup and not skip_warmups:
        warm_step = mf.make_warmup_step(mods)
        for _ in range(tr.num_reps):
            for db in prefetch.prefetch(loader, prep):
                wm = warm_step(db)
                total_steps += 1
                if main and total_steps % log_every == 0:
                    logger.log(-1, total_steps, wm)
        save("warmup")

    if tr.texture_warmup and not skip_warmups:
        tex_k = 1 if tr.use_gtpose else mp.num_guesses
        tex_step = mf.make_train_step(mods, k=tex_k, drop_deform=True,
                                      use_gtpose=tr.use_gtpose)
        for db in prefetch.prefetch(loader, prep):
            for _ in range(tr.tex_num_reps):
                tex_step(db)
                total_steps += 1
        save("texture_warmup")

    nan_dump = _nan_dump_dir()
    prev_pair = None  # debug mode: the last step's (pre-step state, batch)
    n_epochs = num_epochs if num_epochs is not None else tr.num_epochs
    for epoch in range(tr.num_pretrain_epochs, n_epochs):
        use_gt = schedules.use_gtpose_at(epoch, tr.use_gtpose, finetune_camera)
        # the GT-pose projection path is single-hypothesis
        k = 1 if use_gt else schedules.num_guesses_at(
            epoch, mp.num_guesses, mp.drop_hypothesis, use_gt)
        step = mf.make_train_step(mods, k=k, drop_deform=True, use_gtpose=use_gt)
        for db in prefetch.prefetch(loader, prep):
            pre = _snapshot_mf(mods) if nan_dump else None
            metrics = step(db)
            if nan_dump:
                # metrics NaN at step N => params were poisoned by the
                # UPDATE of step N-1 => culprit pair is prev_pair
                _check_finite_or_dump(nan_dump, epoch, total_steps + 1, prev_pair, metrics)
                prev_pair = (pre, db)
            total_steps += 1
            if main and total_steps % log_every == 0:
                logger.log(epoch, total_steps, metrics)
            if tr.save_latest_freq > 0 and total_steps % tr.save_latest_freq == 0:
                save("latest")
            if vis_fn is not None and tr.display_freq > 0 and total_steps % tr.display_freq == 0:
                vis_fn(save_dir, total_steps, db)
        if (epoch + 1) % tr.save_epoch_freq == 0:
            save("latest")
            save(epoch + 1)
    save("latest")
    if main:
        logger.close()
    return mods
