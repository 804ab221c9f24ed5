"""Multiframe evaluation CLI (reference multiframe/benchmark/evaluate.py compatible).

Counterpart of acfm_video_3d_reconstruction_tpu/cli/multiframe_evaluate.py:
the training CLI's flags plus its own, argparse in place of absl, plus
--device (default cuda; --device cpu runs the kernels' plain versions on
the CPU). Sequential two-frame clips of the chosen split; the predicted,
the argmax-multiplex (--use_argmax_camera, train split) or the GT camera
(--use_gt_camera, optionally --gauge_align); optional test-time
optimization (--optimize, with the frozen flow net when the flow loss is
on); IoU on frame 0 and pixel-unit PCK. Prints `mean iou %.3g, pck.1 %.3g,
pck.15 %.3g` and writes results.npz (and results.mat with --save_mat) to
--results_dir.

Usage:
  python -m acfm_video_3d_reconstruction_tpu_torch.cli.multiframe_evaluate \\
      --name horse_net --category horse --root_dir <TigDog_pkls> \\
      --optimize --flow_checkpoint weights/maskflownet.pth
"""
from __future__ import annotations

import os
import os.path as osp
import sys
from types import SimpleNamespace

import numpy as np
import torch

from ..data import tigdog as tig
from ..data.loader import DataLoader
from ..deform.solve import screened_poisson_solve
from ..eval import metrics as eval_metrics
from ..eval import predictor
from ..geometry import camera as cam_utils
from ..geometry.mesh_ops import cot_laplacian
from ..ops import rasterizer as ras
from ..train import checkpoints
from ..train import multiframe as mf
from ..train.monocular import normalize_imagenet
from . import multiframe_main
from .monocular_main import check_device

# (name, default, help): the JAX evaluate CLI's own flags (multiframe_evaluate.py:29-56)
_EVAL_FLAGS = [
    ("num_train_epoch", 0, "checkpoint epoch"),
    ("optimize", False, "test-time optimization"),
    ("optimize_camera", False, "TTO over camera too"),
    ("num_optim_iter", 100, "TTO iterations"),
    ("use_argmax_camera", False, "argmax multiplex camera (train split)"),
    ("split", "test", "dataset split to evaluate"),
    ("results_dir", "cachedir/evaluation", "output dir"),
    ("save_visuals", 0, "save PNG panels for first N batches"),
    ("save_mat", False, "also save results.mat (scipy.io.savemat of the bench stats, drop-in "
     "for the reference's sio.savemat: benchmark/evaluate.py:225)"),
    ("use_gt_camera", False, "DIAGNOSTIC (no reference analog): project through the loader's GT "
     "sfm_pose camera instead of the predicted one"),
    ("gauge_align", False, "with --use_gt_camera: Kabsch-align the learned mean shape to the GT "
     "template and compose the similarity correction into the GT cameras"),
]


def parse(argv=None):
    return multiframe_main.parse(argv, extra=_EVAL_FLAGS, description=__doc__.splitlines()[0])


def default_opts() -> dict:
    """Flag defaults as a plain dict (for tests / programmatic use)."""
    return vars(parse([]))


@torch.no_grad()
def forward_batch(mods: mf.MFModules, imgs: torch.Tensor):
    """The encoder in eval mode on (BT, S, S, 3) frames, the cot Laplacian of
    the mean shape and the solve: (out, mean_shape, lbs, vert2kp, pred_v)."""
    model = mods.model
    model.eval()
    out = model(normalize_imagenet(imgs))
    mean_shape = model.get_mean_shape()
    lbs = model.get_lbs()
    pred_v = screened_poisson_solve(mean_shape, lbs, out["delta_v"],
                                    cot_laplacian(mean_shape, mods.cot))
    return out, mean_shape, lbs, model.get_vert2kp(), pred_v


def evaluate(o: dict) -> eval_metrics.BenchStats:
    """The evaluation of `main` from an options dict (default_opts() plus
    changes); prints the reference-format line, saves the results and
    returns the stats."""
    if o["gauge_align"] and not o["use_gt_camera"]:
        raise ValueError("--gauge_align only applies to the GT-camera diagnostic; pass "
                         "--use_gt_camera with it (alone it would do nothing)")
    device = check_device(SimpleNamespace(device=o.get("device", "cuda")))
    if device.type == "cuda":
        # the solve and the TTO's factor need full-f32 matmuls (deform/solve.py)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = multiframe_main.build_cfg(o)
    template = multiframe_main.build_mf_template(cfg)
    cat = o["category"]
    video_ds = tig.VideoPklDataset(o["root_dir"], cat, split=o["split"], num_kps=o["num_kps"])
    # the train split reuses the training cache, so frames_idx matches the
    # multiplex rows (reference benchmark/evaluate.py:77-103)
    tmp_dir = o["tmp_dir"] if o["split"] == "train" else o["tmp_dir"] + "_" + o["split"]
    n_frames, s2v, spv = tig.explode_to_frames(video_ds, tmp_dir, cat, o["num_training_frames"])
    dataset = tig.MultiFrameDataset(
        tmp_dir=tmp_dir, category=cat, sample_to_vid=s2v, samples_per_vid=spv,
        num_frames=o["num_frames"], img_size=o["img_size"], mirror=False, transforms=False,
        sequential=True, tight_bboxes=o["tight_bboxes"],
        remove_neck_kp=cat in ("horse", "tiger"))
    loader = DataLoader(dataset, o["batch_size"], shuffle=False, drop_last=True)

    mods = mf.build(cfg, template, n_frames, seed=0, device=device)
    label = o["num_train_epoch"] if o["num_train_epoch"] > 0 else "latest"
    if checkpoints.exists(o["checkpoint_dir"], o["name"], label):
        checkpoints.restore_multiframe(o["checkpoint_dir"], o["name"], label, mods, strict=False)
    else:
        print(f"warning: checkpoint {label} not found; evaluating random init")

    S, T = cfg.model.img_size, o["num_frames"]
    tto_fn = flow_fn = None
    if o["optimize"]:
        tto_fn = predictor.make_tto_step_fn(
            mods, predictor.TTOConfig(num_iter=o["num_optim_iter"],
                                      optimize_camera=o["optimize_camera"],
                                      of_wt=o["of_loss_wt"]),
            num_frames=T)
        if T > 1 and o["of_loss_wt"] > 0:
            # the flow term: the frozen MaskFlownet on each batch
            # (reference multiframe/nnutils/predictor.py:195-225)
            flow_fn = multiframe_main.make_flow_fn_from_opts(o, S, device)

    gauge_corr = None
    if o["use_gt_camera"] and o["gauge_align"]:
        # batch-invariant: the similarity once, the camera composition per batch
        with torch.no_grad():
            gauge_corr = predictor.gauge_correction(
                torch.as_tensor(template.verts, dtype=torch.float32, device=device),
                mods.model.get_mean_shape())

    stats = eval_metrics.BenchStats()
    for i, batch in enumerate(loader):
        db = mf.to_device_batch(mods, batch)
        out, mean_shape, lbs, vert2kp, pred_v = forward_batch(mods, db["img"].reshape(-1, S, S, 3))
        cam_pred = out["cam_pred"]
        if o["use_gt_camera"]:
            cam_pred = db["sfm_pose"].reshape(-1, 7)
            if gauge_corr is not None:
                cam_pred = predictor.apply_gauge_correction(cam_pred, gauge_corr)
        elif o["use_argmax_camera"]:
            cam_pred = predictor.argmax_multiplex_camera(
                mods.mpx.state(), db["frames_idx"], scale_lr_decay=o["scale_lr_decay"])
        if tto_fn is not None:
            if flow_fn is not None:
                db = flow_fn(db)
            pred_v, cam_pred, _ = tto_fn(mean_shape, lbs, out["delta_v"], cam_pred, db)

        with torch.no_grad():
            proj_v = cam_utils.orthographic_proj_withz(pred_v, cam_pred, offset_z=0.0)
            mask_pred, _ = ras.soft_silhouette(proj_v, mods.faces, S)
            kp_pred = cam_utils.project_points(torch.einsum("kv,bvc->bkc", vert2kp, pred_v),
                                               cam_pred)
        mask_pred = mask_pred.cpu().numpy().reshape(batch["mask"].shape)
        kp_pred = kp_pred.cpu().numpy().reshape(batch["kp"].shape[:-1] + (2,))
        # frame-0 metrics (benchmark/evaluate.py:132-161)
        iou = eval_metrics.mask_iou(batch["mask"][:, 0],
                                    (mask_pred[:, 0] > 0.5).astype(np.float32))
        err, vis = eval_metrics.kp_errors_pixel(kp_pred[:, 0], batch["kp"][:, 0], S)
        stats.update(iou, err, vis)
        # the frame-0 camera that projected (after TTO when on): npz only,
        # not in the reference-parity .mat
        stats.add_extra("cams", cam_pred.cpu().numpy().reshape(-1, T, 7)[:, 0])
        stats.add_extra("kp_pred", kp_pred[:, 0])
        if o["save_visuals"] > 0 and i < o["save_visuals"]:
            from ..train.visualize import render_row
            from ..utils import vis as vis_utils

            panel = render_row(np.asarray(batch["img"]).reshape(-1, S, S, 3),
                               np.asarray(batch["mask"]).reshape(-1, S, S),
                               mask_pred.reshape(-1, S, S))
            os.makedirs(o["results_dir"], exist_ok=True)
            vis_utils.save_image(osp.join(o["results_dir"], f"eval_batch_{i:04d}.png"), panel)
        if i % 20 == 0:
            print(f"batch {i}/{len(loader)}")

    stats.print_reference_format()
    stats.save(o["results_dir"], save_mat=o["save_mat"])
    return stats


def main(argv=None) -> eval_metrics.BenchStats:
    return evaluate(vars(parse(argv)))


if __name__ == "__main__":
    main(sys.argv[1:])
