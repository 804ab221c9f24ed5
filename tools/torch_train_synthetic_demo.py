"""Synthetic convergence demo of the PyTorch port: train the monocular model
on the self-consistent synthetic dataset and report mask IoU / PCK before
and after.

Counterpart of tools/train_synthetic_demo.py (the JAX package's demo), with
its configuration, loss weights, learning rate, cosine schedule and step
count. The data has a known optimum (the template rendered under known
cameras and deformations), so this is a fixed-seed convergence check.

    python3 tools/torch_train_synthetic_demo.py [--steps 800] [--out FILE]
        [--device cuda|cpu]

Runs on the card unless --device cpu. Prints the results as markdown, and
writes them to --out when given (never to DEMO_RESULTS.md, the JAX demo's
file). `run_demo` holds the logic; tests and chip_smoke.py call it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from acfm_video_3d_reconstruction_tpu_torch import config as cfg_lib  # noqa: E402
from acfm_video_3d_reconstruction_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticConfig,
    SyntheticDataset,
    preprocess_batch,
)
from acfm_video_3d_reconstruction_tpu_torch.eval import metrics as em  # noqa: E402
from acfm_video_3d_reconstruction_tpu_torch.models.template import build_template  # noqa: E402
from acfm_video_3d_reconstruction_tpu_torch.train import monocular  # noqa: E402

# the JAX demo's configuration (tools/train_synthetic_demo.py)
IMG = 128
BATCH = 8
NUM_BATCHES = 4          # the dataset: BATCH * NUM_BATCHES frames, clips of 1
SUBDIVIDE, NUM_LBS, TEX_SIZE, NUM_KPS, NZ_FEAT = 3, 12, 4, 8, 128
ANCHOR_SEED, DATA_SEED = 11, 3
LOG_EVERY = 50
# its argparse defaults; mask 5 balances the reference's kp 30 on this set
DEFAULTS = dict(steps=800, mask_wt=5.0, kp_wt=30.0, triangle_wt=3.0, rigid_wt=0.5,
                boundaries_wt=1.0, lr=3e-4)
COSINE_ALPHA = 0.01


def cosine_lr(lr: float, decay_steps: int, step: int) -> float:
    """optax.cosine_decay_schedule(lr, decay_steps, COSINE_ALPHA)(step): the
    rate of the update at 0-based `step`, a host float."""
    count = min(step, decay_steps)
    cos = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
    return lr * ((1.0 - COSINE_ALPHA) * cos + COSINE_ALPHA)


def num_verts(subdivide: int) -> int:
    """Vertices of the icosphere at `subdivide` (642 at 3)."""
    return 10 * 4 ** subdivide + 2


def demo_config(img: int, batch: int, nz_feat: int, num_lbs: int, num_kps: int,
                tex_size: int, dtype: str, lr: float, mask_wt: float, kp_wt: float,
                triangle_wt: float, rigid_wt: float, boundaries_wt: float) -> cfg_lib.Config:
    """The JAX demo's Config: texture on, no symmetry, GT cameras, the
    reference CUB weights with the demo's mask / kp / smoothness weights."""
    return cfg_lib.Config(
        model=dataclasses.replace(
            cfg_lib.ModelConfig(), img_size=img, nz_feat=nz_feat, num_lbs=num_lbs,
            num_kps=num_kps, tex_size=tex_size, texture=True, symmetric=False,
            symmetric_texture=False, dtype=dtype,
        ),
        mono_weights=dataclasses.replace(
            cfg_lib.MonocularLossWeights(), mask=mask_wt, kp=kp_wt, triangle=triangle_wt,
            rigid=rigid_wt, boundaries=boundaries_wt,
        ),
        train=dataclasses.replace(cfg_lib.TrainConfig(), batch_size=batch, use_gtpose=True,
                                  learning_rate=lr),
    )


def build_demo(img: int = IMG, batch: int = BATCH, *, subdivide: int = SUBDIVIDE,
               num_lbs: int = NUM_LBS, tex_size: int = TEX_SIZE, num_kps: int = NUM_KPS,
               nz_feat: int = NZ_FEAT, dtype: str = "bfloat16", lr: float = DEFAULTS["lr"],
               mask_wt: float = DEFAULTS["mask_wt"], kp_wt: float = DEFAULTS["kp_wt"],
               triangle_wt: float = DEFAULTS["triangle_wt"],
               rigid_wt: float = DEFAULTS["rigid_wt"],
               boundaries_wt: float = DEFAULTS["boundaries_wt"],
               device: str | torch.device = "cuda"):
    """The demo's modules, dataset and batches, as the JAX demo's main makes
    them: keypoint anchors shared by the dataset and the template's vert2kp
    init, the model from seed 0, NUM_BATCHES batches of `batch` frames (the
    first frame of each clip of 1), preprocessed on the host and uploaded
    once. Returns (mods, dataset, device batches)."""
    anchors = np.random.default_rng(ANCHOR_SEED).choice(num_verts(subdivide), num_kps,
                                                        replace=False)
    template = build_template(
        subdivide=subdivide, num_lbs=num_lbs, tex_size=tex_size, num_kps=num_kps,
        kp_vertex_ids=[np.asarray([a]) for a in anchors],
    )
    cfg = demo_config(img, batch, nz_feat, num_lbs, num_kps, tex_size, dtype, lr, mask_wt,
                      kp_wt, triangle_wt, rigid_wt, boundaries_wt)
    mods = monocular.build(cfg, template, 0, device)
    ds = SyntheticDataset(
        template,
        SyntheticConfig(num_frames_total=batch * NUM_BATCHES, clip_len=1, image_size=img,
                        num_kps=num_kps, seed=DATA_SEED, kp_vertex_ids=tuple(anchors)),
        device=device,
    )

    def batch_for(ids):
        b = preprocess_batch(ds.get_batch(np.asarray(ids)), img)
        out = {k: b[k][:, 0] for k in ("img", "mask", "kp", "sfm_pose")}
        out["edt"] = b["edt"]
        out["boundaries"] = b["boundaries"]
        return monocular.to_device_batch(mods, out)

    batches = [batch_for(range(i * batch, (i + 1) * batch)) for i in range(NUM_BATCHES)]
    return mods, ds, batches


def evaluate(eval_step, batches) -> dict:
    """BenchStats over the batches: mask IoU of the thresholded render,
    PCK of the keypoints projected with the GT cameras."""
    stats = em.BenchStats()
    for b in batches:
        aux = eval_step(b)
        mp = (aux["mask_pred"] > 0.5).float().cpu().numpy()
        iou = em.mask_iou(b["mask"].cpu().numpy(), mp)
        err, vis = em.kp_errors(aux["kp_pred"].cpu().numpy(), b["kp"].cpu().numpy())
        stats.update(iou, err, vis)
    return stats.results()


def run_demo(steps: int = DEFAULTS["steps"], img: int = IMG, batch: int = BATCH, *,
             device: str | torch.device = "cuda", init=None, **build_kw) -> dict:
    """Train `steps` steps and evaluate before and after.

    The learning rate follows cosine_lr over the `steps`, set on the
    optimizer as a host float before each step; the loop reads nothing
    back from the device: the metrics stay there until the loop ends.
    `init(mods)`, when given, runs after the build (the tests load the JAX
    package's weights with it). `build_kw` goes to build_demo.

    Returns a dict: before / after (BenchStats.results()), losses (every
    step's total loss), parts (the loss terms of every LOG_EVERY-th step),
    seconds and frames_per_s of the loop (host clock, ending in a
    synchronize on the card), lrs (the rate of every step), and mods,
    train_step, eval_step and batches for checks after the run."""
    device = torch.device(device)
    mods, _, batches = build_demo(img, batch, device=device, **build_kw)
    if init is not None:
        init(mods)
    train_step = monocular.make_train_step(mods)
    eval_step = monocular.make_eval_step(mods)
    before = evaluate(eval_step, batches)
    metrics, lrs = [], []
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for i in range(steps):
        lr = cosine_lr(mods.cfg.train.learning_rate, steps, i)
        for group in train_step.opt.param_groups:
            group["lr"] = lr
        lrs.append(lr)
        metrics.append(train_step(batches[i % len(batches)]))
    sync()
    seconds = time.perf_counter() - t0
    after = evaluate(eval_step, batches)
    parts = [{k: float(v) for k, v in m.items()
              if k in ("kp_loss", "mask_loss", "tri_loss", "rigid_loss", "edt_loss",
                       "bdt_loss", "tex_loss")} for m in metrics[::LOG_EVERY]]
    return {
        "before": before, "after": after,
        "losses": [float(m["total_loss"]) for m in metrics], "parts": parts,
        "seconds": seconds, "frames_per_s": steps * batch / seconds if steps else 0.0,
        "steps": steps, "lrs": lrs,
        "mods": mods, "train_step": train_step, "eval_step": eval_step, "batches": batches,
    }


def card_name(device: torch.device) -> str:
    """nvidia-smi's name and power limit of the card, or "the CPU"."""
    if device.type != "cuda":
        return "the CPU"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def report(res: dict, img: int, batch: int, where: str) -> str:
    b, a = res["before"], res["after"]
    steps, secs = res["steps"], res["seconds"]
    return (
        "# Synthetic convergence demo (tools/torch_train_synthetic_demo.py)\n\n"
        f"PyTorch port, monocular trainer, {steps} steps, batch {batch}, {img}^2, on {where}, "
        "self-consistent synthetic dataset (known GT cameras/deformations), fixed seeds.\n\n"
        "| metric | before | after |\n|---|---|---|\n"
        f"| mean mask IoU | {b['mean_iou']:.4f} | {a['mean_iou']:.4f} |\n"
        f"| PCK@0.1 | {b['pck_0.1']:.4f} | {a['pck_0.1']:.4f} |\n"
        f"| PCK@0.15 | {b['pck_0.15']:.4f} | {a['pck_0.15']:.4f} |\n\n"
        f"loss trajectory (every {LOG_EVERY} steps): "
        f"{json.dumps([round(x, 4) for x in res['losses'][::LOG_EVERY]])}\n\n"
        f"wall-clock: {secs:.1f}s for {steps} steps "
        f"({res['frames_per_s']:.1f} frames/s at {img}^2).\n"
    )


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=DEFAULTS["steps"])
    for name in ("mask_wt", "kp_wt", "triangle_wt", "rigid_wt", "boundaries_wt", "lr"):
        ap.add_argument(f"--{name}", type=float, default=DEFAULTS[name])
    ap.add_argument("--out", default=None, help="also write the results here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: no CUDA device (pass --device cpu)")
        # the solve's f32 normal equations (deform/solve.py)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    res = run_demo(args.steps, IMG, BATCH, device=device, mask_wt=args.mask_wt,
                   kp_wt=args.kp_wt, triangle_wt=args.triangle_wt, rigid_wt=args.rigid_wt,
                   boundaries_wt=args.boundaries_wt, lr=args.lr)
    for i, parts in zip(range(0, args.steps, LOG_EVERY), res["parts"]):
        print(f"step {i}: total_loss={res['losses'][i]:.4f} "
              + json.dumps({k: round(v, 4) for k, v in parts.items()}))
    text = report(res, IMG, BATCH, card_name(device))
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
