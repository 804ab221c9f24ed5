"""Synthetic self-consistent dataset for tests, benchmarks and the demo.

Counterpart of acfm_video_3d_reconstruction_tpu/data/synthetic.py. Renders
the category template itself under random known cameras and deformations
through the port's own rasterizer, yielding batches with the reference
dataset dict contract: {img, mask, kp, sfm_pose, frames_idx, mirror_flag,
transforms, optical_flows}. A model trained on this data has a known global
optimum, which makes it a fixed-seed convergence check.

The cameras, deformations and keypoint anchors are drawn from the same
numpy streams in the same order as the JAX package's, so they are
bit-equal to its. The renders run on the dataset's device (the card unless
the caller passes device="cpu"): the solve, the projection and one soft
rasterization of all frames, which on the card is one launch of the soft
forward kernel. What the dataset keeps is numpy. The JAX package's
`face_chunk` argument of the render has no counterpart: the port always
bins (ops/rasterizer.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..deform.solve import lbs_from_logits, screened_poisson_solve
from ..geometry import camera as cam_utils
from ..models.template import Template
from ..ops import rasterizer as ras
from . import image_utils


@dataclasses.dataclass
class SyntheticConfig:
    num_frames_total: int = 32   # dataset size (frames)
    clip_len: int = 2            # frames per sample (multiframe T)
    image_size: int = 64
    num_kps: int = 4
    seed: int = 0
    offset_z: float = 5.0
    # keypoint anchor vertex ids; None -> random choice. Pass the same ids
    # to build_template(kp_vertex_ids=...) so vert2kp starts from a sane
    # assignment like the reference's kp-dictionary init
    # (monocular/nnutils/mesh_net.py:354-397).
    kp_vertex_ids: tuple | None = None


class SyntheticDataset:
    """Deterministic synthetic video dataset over a template."""

    def __init__(self, template: Template, cfg: SyntheticConfig,
                 device: str | torch.device = "cuda"):
        self.template = template
        self.cfg = cfg
        self.device = torch.device(device)
        rng = np.random.default_rng(cfg.seed)
        N = cfg.num_frames_total
        # Ground-truth cameras: mild rotations about y + jittered scale/trans.
        ang = rng.uniform(-0.6, 0.6, N)
        self.gt_cams = np.zeros((N, 7), np.float32)
        self.gt_cams[:, 0] = rng.uniform(0.7, 0.9, N)
        self.gt_cams[:, 1:3] = rng.uniform(-0.1, 0.1, (N, 2))
        self.gt_cams[:, 3] = np.cos(ang / 2)
        self.gt_cams[:, 5] = np.sin(ang / 2)
        # Per-frame small handle offsets (smooth over time).
        K = template.num_lbs
        base = rng.normal(size=(N // cfg.clip_len + 1, K, 3)) * 0.05
        self.gt_deform = np.repeat(base, cfg.clip_len, axis=0)[:N].astype(np.float32)
        # keypoint anchor vertices
        if cfg.kp_vertex_ids is not None:
            self.kp_verts = np.asarray(cfg.kp_vertex_ids)
        else:
            self.kp_verts = rng.choice(
                template.num_verts, cfg.num_kps, replace=False
            )
        self._render_all()

    def project(self):
        """On the dataset's device: (the frames' meshes projected with the GT
        cameras (N, V, 3), faces (F, 3), the meshes (N, V, 3)), the template
        deformed by the GT handle offsets through lbs_from_logits and the
        screened-Poisson solve."""
        t, dev = self.template, self.device

        def f32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

        with torch.no_grad():
            A = lbs_from_logits(f32(t.lbs_logits))
            pred_v = screened_poisson_solve(f32(t.verts), A, f32(self.gt_deform),
                                            f32(t.uniform_L))
            proj = cam_utils.orthographic_proj_withz(pred_v, f32(self.gt_cams),
                                                     offset_z=self.cfg.offset_z)
        return proj, torch.as_tensor(t.faces, dtype=torch.long, device=dev), pred_v

    def render(self):
        """(soft masks (N, H, W), 2-D keypoints (N, K, 2)) of every frame, on
        the dataset's device: one soft rasterization of all N frames."""
        proj, faces, pred_v = self.project()
        with torch.no_grad():
            mask, _ = ras.soft_silhouette(proj, faces, self.cfg.image_size)
            kp_idx = torch.as_tensor(self.kp_verts, dtype=torch.long, device=self.device)
            cams = torch.as_tensor(self.gt_cams, device=self.device)
            kp2d = cam_utils.project_points(pred_v[:, kp_idx], cams)
        return mask, kp2d

    def _render_all(self):
        mask, kp2d = self.render()
        self.masks = (mask > 0.5).to(torch.float32).cpu().numpy()
        kp2d = kp2d.cpu().numpy()
        vis = np.ones((*kp2d.shape[:2], 1), np.float32)
        self.kps = np.concatenate([kp2d, vis], axis=-1).astype(np.float32)
        # images: mask-colored RGB with a gradient (texture learning signal)
        H = self.cfg.image_size
        gx = np.linspace(0, 1, H, dtype=np.float32)
        img = np.stack(
            [
                self.masks * gx[None, None, :],
                self.masks * gx[None, :, None],
                self.masks * 0.5,
            ],
            axis=-1,
        )
        self.imgs = img.astype(np.float32)

    def __len__(self):
        return self.cfg.num_frames_total // self.cfg.clip_len

    def get_batch(self, sample_ids: np.ndarray) -> dict:
        """Batch of clips: dict with (B, T, ...) arrays, reference contract."""
        cfg = self.cfg
        T = cfg.clip_len
        frame_idx = np.stack(
            [np.arange(s * T, (s + 1) * T) for s in np.asarray(sample_ids)]
        )
        B = frame_idx.shape[0]
        flat = frame_idx.reshape(-1)
        imgs = self.imgs[flat].reshape(B, T, cfg.image_size, cfg.image_size, 3)
        masks = self.masks[flat].reshape(B, T, cfg.image_size, cfg.image_size)
        kps = self.kps[flat].reshape(B, T, cfg.num_kps, 3)
        cams = self.gt_cams[flat].reshape(B, T, 7)
        flows = self._flows(frame_idx)
        return {
            "img": imgs,
            "mask": masks,
            "kp": kps,
            "sfm_pose": cams,
            "frames_idx": frame_idx.astype(np.int32),
            "mirror_flag": np.zeros((B, T), np.int32),
            "transforms": np.tile(
                np.asarray([1.0, 0, 0, 0], np.float32), (B, T, 1)
            ),
            "optical_flows": flows,
        }

    def _flows(self, frame_idx: np.ndarray) -> np.ndarray:
        """Constant GT flow per clip from known camera/deform motion.

        Layout matches flow.infer.clip_flows: slot t holds flow(t -> t+1),
        last slot zero. The trainer shifts it so the loss compares
        proj_t - proj_{t+1} (sampled at frame t+1) against it; this provides
        the mean vertex motion in pixels as a constant field inside the
        frame-(t+1) mask.
        """
        cfg = self.cfg
        B, T = frame_idx.shape
        H = cfg.image_size
        flows = np.zeros((B, T, H, H, 2), np.float32)
        for b in range(B):
            for t in range(T - 1):
                i0, i1 = frame_idx[b, t], frame_idx[b, t + 1]
                k0, k1 = self.kps[i0, :, :2], self.kps[i1, :, :2]
                motion_px = (k0 - k1).mean(0) * H / 2.0
                flows[b, t, :, :, :] = motion_px[None, None]
                flows[b, t] *= self.masks[i1][..., None]
        return flows


def preprocess_batch(batch: dict, image_size: int) -> dict:
    """Add DT / barrier-DT / boundary-point arrays (host-side).

    Mirrors the reference set_input CPU work (multiframe/main.py:364-377).
    """
    masks = np.asarray(batch["mask"])
    B, T = masks.shape[:2]
    flat = masks.reshape(B * T, *masks.shape[2:])
    edts = np.stack([image_utils.compute_dt(m, norm=False) for m in flat])
    bdts = np.stack([image_utils.compute_dt_barrier(m) for m in flat])
    bounds = image_utils.compute_boundaries(flat)
    out = dict(batch)
    out["edt"] = edts.astype(np.float32)
    out["bdt"] = bdts.astype(np.float32)
    out["boundaries"] = bounds
    return out
