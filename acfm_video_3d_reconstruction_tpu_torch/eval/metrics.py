"""Evaluation metrics: mask IoU and keypoint PCK.

A copy of acfm_video_3d_reconstruction_tpu/eval/metrics.py (numpy only).
Parity target: reference monocular/evaluate.py:38-104 (ShapeTester.evaluate
+ aggregation) and multiframe/benchmark/evaluate.py:132-161 (pixel-unit
PCK, IoU on frame 0).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BenchStats:
    """Accumulates per-batch eval outputs; reports reference-format numbers."""

    ious: list = dataclasses.field(default_factory=list)
    kp_errs: list = dataclasses.field(default_factory=list)
    kp_vis: list = dataclasses.field(default_factory=list)
    extras: dict = dataclasses.field(default_factory=dict)

    def update(self, iou: np.ndarray, kp_err: np.ndarray, kp_vis: np.ndarray):
        self.ious.append(np.asarray(iou))
        self.kp_errs.append(np.asarray(kp_err))
        self.kp_vis.append(np.asarray(kp_vis))

    def results(self) -> dict:
        ious = np.concatenate(self.ious, axis=0)
        kp_errs = np.concatenate(self.kp_errs, axis=0)
        kp_vis = np.concatenate(self.kp_vis, axis=0)
        # NOTE: kp_errs must already be in normalized units where the
        # 0.1 / 0.15 thresholds apply directly — kp_errors() returns
        # [-1,1]-frame units (monocular evaluator) and kp_errors_pixel()
        # pre-divides pixel error by img_size (multiframe evaluator, whose
        # reference thresholds are 0.1*img_size in raw pixels). Never pass
        # raw pixel errors here.
        n_vis = kp_vis.sum(axis=0)
        n_correct1 = ((kp_errs < 0.1) * kp_vis).sum(axis=0)
        n_correct15 = ((kp_errs < 0.15) * kp_vis).sum(axis=0)
        # Reference parity: delete keypoint columns that are never visible
        # in the eval set before averaging (multiframe/benchmark/
        # evaluate.py:236-243 "remove non visible kps to avoid NaNs") —
        # zero-filling them would deflate PCK.
        keep = n_vis > 0
        n_vis = n_vis[keep]
        pck1 = (n_correct1[keep] / n_vis).mean() if keep.any() else 0.0
        pck15 = (n_correct15[keep] / n_vis).mean() if keep.any() else 0.0
        return {
            "mean_iou": float(ious.mean()),
            "pck_0.1": float(pck1),
            "pck_0.15": float(pck15),
        }

    def add_extra(self, name: str, value: np.ndarray) -> None:
        """Attach a per-batch diagnostic array (e.g. predicted cameras);
        concatenated into results.npz but kept OUT of results.mat, whose
        keys match the reference's bench_stats exactly."""
        self.extras.setdefault(name, []).append(np.asarray(value))

    def arrays(self) -> dict:
        """Concatenated per-sample arrays (the reference's bench_stats dict:
        multiframe/benchmark/evaluate.py:218-222)."""
        return {
            "ious": np.concatenate(self.ious, 0),
            "kp_errs": np.concatenate(self.kp_errs, 0),
            "kp_vis": np.concatenate(self.kp_vis, 0),
        }

    def save(self, results_dir: str, save_mat: bool = False) -> None:
        """Save results.npz (+ optional results.mat for drop-in parity with
        the reference's sio.savemat, benchmark/evaluate.py:225)."""
        import os

        os.makedirs(results_dir, exist_ok=True)
        arrays = self.arrays()
        extras = {k: np.concatenate(v, 0) for k, v in self.extras.items()}
        np.savez(os.path.join(results_dir, "results.npz"), **arrays, **extras)
        if save_mat:
            import scipy.io as sio

            sio.savemat(os.path.join(results_dir, "results.mat"), arrays)

    def print_reference_format(self):
        r = self.results()
        print(
            "mean iou %.3g, pck.1 %.3g, pck.15 %.3g"
            % (r["mean_iou"], r["pck_0.1"], r["pck_0.15"])
        )


def mask_iou(mask_gt: np.ndarray, mask_pred: np.ndarray) -> np.ndarray:
    """Hard IoU per sample; masks (B, H, W) (pred thresholded by caller)."""
    g = np.asarray(mask_gt).reshape(len(mask_gt), -1)
    p = np.asarray(mask_pred).reshape(len(mask_pred), -1)
    inter = (g * p).sum(1)
    union = (g + p - g * p).sum(1)
    return inter / np.maximum(union, 1e-9)


def kp_errors(
    kp_pred: np.ndarray, kp_gt: np.ndarray, padding_frac: float = 0.05
) -> tuple[np.ndarray, np.ndarray]:
    """Normalized keypoint error + visibility.

    err = ||pred - gt||_2 * (1 + 2*pf) / 2 (the [-1,1] frame spans
    (1+2pf)*max_bbox_dim image pixels: monocular/evaluate.py:53-68).
    """
    kp_gt = np.asarray(kp_gt)
    vis = kp_gt[..., 2]
    err = np.linalg.norm(np.asarray(kp_pred) - kp_gt[..., :2], axis=-1)
    return err * (1.0 + 2.0 * padding_frac) / 2.0, vis


def kp_errors_pixel(
    kp_pred: np.ndarray, kp_gt: np.ndarray, img_size: int
) -> tuple[np.ndarray, np.ndarray]:
    """Pixel-unit kp error for the multiframe benchmark: thresholds compare
    against 0.1 * img_size (benchmark/evaluate.py:132-161)."""
    vis = np.asarray(kp_gt)[..., 2]
    pred_px = (np.asarray(kp_pred) + 1.0) * img_size / 2.0
    gt_px = (np.asarray(kp_gt)[..., :2] + 1.0) * img_size / 2.0
    err = np.linalg.norm(pred_px - gt_px, axis=-1) / img_size
    return err, vis
