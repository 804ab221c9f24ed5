"""Weak-perspective (scaled orthographic) camera model on torch tensors.

Counterpart of acfm_video_3d_reconstruction_tpu/geometry/camera.py. A
camera is a 7-vector [scale, tx, ty, qw, qx, qy, qz]. Projected (x, y) live
in [-1, 1] with x right and y down; z is depth, smaller is closer.
"""
from __future__ import annotations

import torch

from . import quaternion as quat


def orthographic_proj_withz(X: torch.Tensor, cam: torch.Tensor,
                            offset_z: float = 0.0) -> torch.Tensor:
    """x, y = scale * R(q) X + t;  z = scale * (R(q) X)_z + offset_z."""
    X_rot = quat.quat_rotate(X, cam[..., 3:7])
    scale = cam[..., 0][..., None, None]
    trans = cam[..., 1:3][..., None, :]
    proj = scale * X_rot
    return torch.cat([proj[..., :2] + trans, proj[..., 2:3] + offset_z], dim=-1)


def project_points(X: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) points -> (..., N, 2) in [-1, 1]."""
    return orthographic_proj_withz(X, cam)[..., :2]


def mirror_camera(cam: torch.Tensor, mirror_flag: torch.Tensor) -> torch.Tensor:
    """Transport a camera through a horizontal image flip.

    cam: (..., 7); mirror_flag: (...,) in {0, 1}. Where flagged:
    tx -> -tx, q -> quat(diag(-1,1,-1)) ⊗ standardize(q).
    """
    q_new = quat.mirror_quat(cam[..., 3:7])
    cam_new = torch.cat([cam[..., 0:1], -cam[..., 1:2], cam[..., 2:3], q_new], dim=-1)
    flag = mirror_flag[..., None].to(cam.dtype)
    return (1.0 - flag) * cam + flag * cam_new
