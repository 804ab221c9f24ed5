"""Monocular evaluation CLI (reference monocular/evaluate.py compatible).

Counterpart of acfm_video_3d_reconstruction_tpu/cli/monocular_evaluate.py:
the training CLI's flags plus its own, argparse in place of absl. Prints
`mean iou %.3g, pck.1 %.3g, pck.15 %.3g` over the chosen split.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

from ..data.cub import CUBDataset
from ..data.loader import DataLoader
from ..eval import metrics as eval_metrics
from ..train import checkpoints, monocular
from .monocular_main import add_flags, build_cfg, build_cub_template, check_device


def parse(argv=None) -> argparse.Namespace:
    ap = add_flags(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    ap.add_argument("--num_train_epoch", type=int, default=0,
                    help="checkpoint epoch to evaluate")
    ap.add_argument("--max_eval_iter", type=int, default=0, help="max eval batches (0 = all)")
    ap.add_argument("--padding_frac", type=float, default=0.05, help="bbox padding fraction")
    ap.add_argument("--save_visuals", type=int, default=0,
                    help="save PNG panels for first N batches")
    ap.add_argument("--results_dir", default="cachedir/evaluation", help="output dir")
    ap.add_argument(
        "--load_torch_checkpoint", default="",
        help="path to a reference pred_net_<epoch>.pth (torch MeshNet state dict, "
        "monocular/nnutils/train_utils.py:83-102); loaded instead of the port's "
        "checkpoint. Template/config flags must match the checkpoint's.")
    return ap.parse_args(argv)


def evaluate(cfg, template, dataset, args) -> eval_metrics.BenchStats:
    """The evaluation of `main` on a built dataset: restores the model,
    runs the eval step over the loader and prints the reference-format
    line; returns the accumulated stats."""
    device = check_device(args)
    # The reference evaluator always projects through the PREDICTED camera
    # (monocular/nnutils/predictor.py:110-159 uses cam_pred; evaluate.py has
    # no gtpose path), regardless of the training-time --use_gtpose flag.
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, use_gtpose=False))
    mods = monocular.build(cfg, template, seed=0, device=device)
    label = args.num_train_epoch if args.num_train_epoch > 0 else "latest"
    if args.load_torch_checkpoint:
        from ..models.torch_import import load_reference_meshnet

        load_reference_meshnet(mods.model, args.load_torch_checkpoint)
        print(f"loaded torch checkpoint {args.load_torch_checkpoint}")
    elif checkpoints.exists(args.checkpoint_dir, args.name, label):
        checkpoints.restore(args.checkpoint_dir, args.name, label, mods, strict=False)
    else:
        print(f"warning: checkpoint {label} not found; evaluating random init")

    loader = DataLoader(dataset, args.batch_size, shuffle=False, drop_last=True)
    ev = monocular.make_eval_step(mods)
    stats = eval_metrics.BenchStats()
    for i, batch in enumerate(loader):
        if args.max_eval_iter > 0 and i >= args.max_eval_iter:
            break
        if i % 100 == 0:
            print(f"{i}/{len(loader)} evaluation iterations.")
        aux = ev(batch)
        mask_pred = aux["mask_pred"].float().cpu().numpy()
        kp_pred = aux["kp_pred"].float().cpu().numpy()
        iou = eval_metrics.mask_iou(batch["mask"], (mask_pred > 0.5).astype(np.float32))
        err, vis = eval_metrics.kp_errors(kp_pred, batch["kp"], args.padding_frac)
        stats.update(iou, err, vis)
        if args.save_visuals > 0 and i < args.save_visuals:
            # save_current_visuals parity (reference test_utils.py)
            from ..train.visualize import render_row
            from ..utils import vis as vis_utils

            panel = render_row(batch["img"], batch["mask"], mask_pred, kp_pred=kp_pred)
            out = args.results_dir or "cachedir/evaluation"
            os.makedirs(out, exist_ok=True)
            vis_utils.save_image(os.path.join(out, f"eval_batch_{i:04d}.png"), panel)
    stats.print_reference_format()
    return stats


def main(argv=None) -> eval_metrics.BenchStats:
    args = parse(argv)
    cfg = build_cfg(args)
    template = build_cub_template(cfg, args)
    dataset = CUBDataset(
        args.cub_dir, args.cub_cache_dir, split=args.split,
        img_size=args.img_size, jitter_frac=0.0,
    )
    return evaluate(cfg, template, dataset, args)


if __name__ == "__main__":
    main(sys.argv[1:])
