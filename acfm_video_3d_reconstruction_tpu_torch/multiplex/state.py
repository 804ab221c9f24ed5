"""Camera-multiplex hypothesis state on torch tensors.

Counterpart of acfm_video_3d_reconstruction_tpu/multiplex/state.py
(reference multiframe/nnutils/mesh_net.py:404-451): per-frame embedding
tables of `num_guesses` camera hypotheses (7-D quaternion mode or 6-D
az-el mode), the per-frame hypothesis probabilities, and per-frame
deformation embeddings (plus a mirrored variant), as dense arrays
  cams   (G, N_frames, C)   raw embeddings (C = 7 or 6)
  probs  (N_frames, G)      soft-min hypothesis weights (no gradient)
  deform / deform_mirror (N_frames, K*3)
gathered per batch with frame indices. The initial tables come from the
same seeded numpy draws as the JAX package's, so they are equal bit for
bit. The trainer (train/multiframe.py) holds the trainable tables as
parameters and passes them in; these functions only read and write
tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..geometry import camera as cam_utils
from ..parallel import mesh as pmesh


@dataclasses.dataclass
class MultiplexState:
    cams: torch.Tensor                     # (G, N, C)
    probs: torch.Tensor                    # (N, G)
    deform: Optional[torch.Tensor]         # (N, K*3) or None
    deform_mirror: Optional[torch.Tensor]  # (N, K*3) or None

    @property
    def num_guesses(self) -> int:
        return self.cams.shape[0]


def _state(cams, probs, deform, with_deform) -> MultiplexState:
    d = torch.from_numpy(deform) if with_deform else None
    return MultiplexState(cams=torch.from_numpy(cams), probs=torch.from_numpy(probs),
                          deform=d, deform_mirror=d.clone() if with_deform else None)


def init_quat_multiplex(num_frames: int, num_guesses: int, num_lbs: int, seed: int = 0,
                        with_deform: bool = True) -> MultiplexState:
    """Quaternion-mode init: hypotheses spread over 360° about +y
    (reference mesh_net.py:423-446: identity quat rotated by
    linspace(0, 360, G) about y, +0.1 uniform noise; trans ~ U(-.05, .05)
    shared per table; scale raw 0; probs 1)."""
    rng = np.random.default_rng(seed)
    angles = np.linspace(0.0, 2.0 * np.pi, num_guesses)
    cams = np.zeros((num_guesses, num_frames, 7), np.float32)
    for g in range(num_guesses):
        q = np.array([np.cos(angles[g] / 2.0), 0.0, np.sin(angles[g] / 2.0), 0.0], np.float32)
        cams[g, :, 1] = rng.uniform(-0.05, 0.05)
        cams[g, :, 2] = rng.uniform(-0.05, 0.05)
        cams[g, :, 3:] = q[None] + 0.1 * rng.random((num_frames, 4)).astype(np.float32)
    probs = np.ones((num_frames, num_guesses), np.float32)
    deform = np.zeros((num_frames, num_lbs * 3), np.float32)
    return _state(cams, probs, deform, with_deform)


def init_az_el_multiplex(num_frames: int, num_guesses: int, num_lbs: int,
                         with_deform: bool = True) -> MultiplexState:
    """Az-el mode init: azimuth raw value spread over [0, 1] per hypothesis
    (reference mesh_net.py:406-416)."""
    az = np.arange(num_guesses) / max(num_guesses - 1, 1)
    cams = np.zeros((num_guesses, num_frames, 6), np.float32)
    cams[:, :, 3] = az[:, None]
    probs = np.ones((num_frames, num_guesses), np.float32)
    deform = np.zeros((num_frames, num_lbs * 3), np.float32)
    return _state(cams, probs, deform, with_deform)


def gather_cameras(state: MultiplexState, frame_idx: torch.Tensor, *, az_el: bool = False,
                   scale_lr_decay: float = 0.05, scale_bias: float = 1.0,
                   euler_ranges: tuple[float, float, float] = (30.0, 60.0, 60.0)
                   ) -> torch.Tensor:
    """Decode per-frame hypothesis cameras: frame_idx (B, T) -> (G, B*T, 7)."""
    raw = state.cams[:, frame_idx.reshape(-1).long(), :]
    if az_el:
        return cam_utils.decode_az_el_camera(
            raw, scale_lr_decay=scale_lr_decay, scale_bias=scale_bias,
            az_range_deg=euler_ranges[0], el_range_deg=euler_ranges[1],
            cyc_range_deg=euler_ranges[2])
    return cam_utils.decode_quat_camera(raw, scale_lr_decay=scale_lr_decay)


def gather_probs(state: MultiplexState, frame_idx: torch.Tensor) -> torch.Tensor:
    """(B, T) -> (BT, G) stored hypothesis probabilities."""
    return state.probs[frame_idx.reshape(-1).long()]


def gather_deforms(state: MultiplexState, frame_idx: torch.Tensor, mirror_flag: torch.Tensor,
                   num_lbs: int, deform_lr: float = 100.0) -> torch.Tensor:
    """Per-frame optimized handle offsets, mirror-aware (reference
    multiframe/main.py:531-539). Returns (BT, K, 3)."""
    flat = frame_idx.reshape(-1).long()
    d = state.deform[flat].reshape(-1, num_lbs, 3)
    dm = state.deform_mirror[flat].reshape(-1, num_lbs, 3)
    m = mirror_flag.reshape(-1, 1, 1).to(d.dtype)
    return ((1.0 - m) * d + m * dm) * deform_lr


def topk_hypotheses(state: MultiplexState, frame_idx: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (k, BT) of the k most probable hypotheses per frame
    (reference multiframe/main.py:541-548, hypothesis dropping).

    A stable descending sort, so equal probabilities (every frame starts at
    1 for all hypotheses) keep the lower index first, as jax.lax.top_k
    orders ties; torch.topk promises no order there."""
    probs = gather_probs(state, frame_idx)  # (BT, G)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]
    return idx.T.contiguous()


def select_hypotheses(arr: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Gather arr (G, BT, ...) at sel (k, BT) -> (k, BT, ...)."""
    idx = sel.long().reshape(sel.shape + (1,) * (arr.ndim - 2))
    return torch.take_along_dim(arr, idx, dim=0)


def gather_frame_rows(flat: torch.Tensor, rows: torch.Tensor):
    """Under a process group, every rank's (frame ids (n,), rows (n, C))
    brought together in rank order, which is the global batch's (B, T)
    order (parallel/mesh.py::shard_batch keeps contiguous blocks); without
    one, the inputs. One all_reduce of (n, 1 + C) f64, exact for f32 rows
    and frame ids below 2^53."""
    if not pmesh.active():
        return flat, rows
    both = pmesh.gather_rows(torch.cat([flat[:, None].double(), rows.double()], 1))
    return both[:, 0].long(), both[:, 1:].to(rows.dtype)


def scatter_probs(state: MultiplexState, frame_idx: torch.Tensor, sel: torch.Tensor,
                  new_probs: torch.Tensor) -> MultiplexState:
    """Write the soft-min probabilities back for the selected hypotheses:
    frame_idx (B, T); sel (k, BT) hypothesis ids; new_probs (k, BT).
    Non-selected hypotheses get 0 (reference multiframe/main.py:737-742).

    A frame that appears twice in the batch (two clips of one video sharing
    it) takes the row of its LAST occurrence in (B, T) order: every
    occurrence is given that row before the write, so the write's order
    cannot matter (the JAX package's `.at[flat].set` leaves the winner
    undefined). Under a process group the rule holds over the global batch:
    every rank writes every rank's rows (gather_frame_rows). `state.probs`
    is written in place and returned in `state`.
    """
    flat = frame_idx.reshape(-1).long()
    rows = new_probs.new_zeros((flat.shape[0], state.num_guesses))
    rows.scatter_(1, sel.long().T, new_probs.detach().T)
    flat, rows = gather_frame_rows(flat, rows)
    n = flat.shape[0]
    same = flat[:, None] == flat[None, :]
    last = torch.where(same, torch.arange(n, device=flat.device), -1).amax(1)
    with torch.no_grad():
        state.probs[flat] = rows[last].to(state.probs.dtype)
    return state
