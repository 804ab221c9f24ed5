"""Weak-perspective (scaled orthographic) camera model on torch tensors.

Counterpart of acfm_video_3d_reconstruction_tpu/geometry/camera.py. A
camera is a 7-vector [scale, tx, ty, qw, qx, qy, qz]. Projected (x, y) live
in [-1, 1] with x right and y down; z is depth, smaller is closer.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import quaternion as quat


def orthographic_proj(X: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """Project points, dropping z. X: (..., N, 3), cam: (..., 7) -> (..., N, 2)."""
    return orthographic_proj_withz(X, cam)[..., :2]


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


def transform_camera(cam: torch.Tensor, transforms: torch.Tensor) -> torch.Tensor:
    """Transport a camera through a 2D affine augmentation.

    transforms: (..., 4) = [zoom, shift_x, shift_y, active_flag] in the
    normalized [-1, 1] image frame. Where active:
    scale *= zoom; tx = tx*zoom + shift_x; ty = ty*zoom + shift_y.
    """
    zoom = transforms[..., 0:1]
    cam_new = torch.cat([
        cam[..., 0:1] * zoom,
        cam[..., 1:2] * zoom + transforms[..., 1:2],
        cam[..., 2:3] * zoom + transforms[..., 2:3],
        cam[..., 3:7],
    ], dim=-1)
    flag = transforms[..., 3:4].to(cam.dtype)
    return (1.0 - flag) * cam + flag * cam_new


def decode_quat_camera(raw: torch.Tensor, scale_lr_decay: float = 0.05) -> torch.Tensor:
    """Decode a raw 7-D camera embedding (quaternion multiplex mode):
    scale = relu(scale_lr_decay * raw_s + 1) + 1e-12; q normalized."""
    scale = torch.relu(scale_lr_decay * raw[..., 0:1] + 1.0) + 1e-12
    return torch.cat([scale, raw[..., 1:3], quat.quat_normalize(raw[..., 3:7])], dim=-1)


def az_el_to_quat(angles: torch.Tensor, az_range_deg: float = 30.0,
                  el_range_deg: float = 60.0, cyc_range_deg: float = 60.0) -> torch.Tensor:
    """Azimuth/elevation/cyclo-rotation (..., 3) -> quaternion (..., 4).

    azimuth = az_range * a0 about +y; elev = pi - el_range * a1 about +x;
    cyc = cyc_range * a2 about +z; q = q_cyc ⊗ (q_el ⊗ q_az).
    """
    deg = math.pi / 180.0
    az = (az_range_deg * deg) * angles[..., 0]
    el = math.pi - (el_range_deg * deg) * angles[..., 1]
    cyc = (cyc_range_deg * deg) * angles[..., 2]
    eye = torch.eye(3, dtype=angles.dtype, device=angles.device)
    ex, ey, ez = (eye[i].expand(angles.shape[:-1] + (3,)) for i in range(3))
    q_az = quat.axis_angle_to_quat(ey, az)
    q_el = quat.axis_angle_to_quat(ex, el)
    q_cyc = quat.axis_angle_to_quat(ez, cyc)
    return quat.hamilton_product(q_cyc, quat.hamilton_product(q_el, q_az))


def az_el_quat_biases(num_guesses: int) -> torch.Tensor:
    """Per-hypothesis quaternion bias chain spreading az-el hypotheses:
    bias_0 = (0, 1, 0, 0) (180 deg about +x), bias_g = q_(pi/4 about +y) ⊗
    bias_{g-1}, composed in float64 on the host. Returns (G, 4) float32."""
    base_rot = np.array([np.cos(np.pi / 8), 0.0, np.sin(np.pi / 8), 0.0])
    biases = [np.array([0.0, 1.0, 0.0, 0.0])]
    for _ in range(1, num_guesses):
        w1, x1, y1, z1 = base_rot
        w2, x2, y2, z2 = biases[-1]
        biases.append(np.array([
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]))
    return torch.from_numpy(np.stack(biases).astype(np.float32))


def decode_az_el_camera(raw: torch.Tensor, scale_lr_decay: float = 0.05,
                        scale_bias: float = 1.0, az_range_deg: float = 30.0,
                        el_range_deg: float = 60.0, cyc_range_deg: float = 60.0,
                        quat_bias: torch.Tensor | None = None) -> torch.Tensor:
    """Decode a raw 6-D camera embedding [s, tx, ty, az, el, cyc] -> 7-D cam.

    quat_bias: optional (..., 4) per-hypothesis rotation bias composed as
    q = q_azel ⊗ bias.
    """
    scale = scale_lr_decay * raw[..., 0:1] + scale_bias
    q = az_el_to_quat(raw[..., 3:6], az_range_deg=az_range_deg,
                      el_range_deg=el_range_deg, cyc_range_deg=cyc_range_deg)
    if quat_bias is not None:
        q = quat.hamilton_product(q, quat_bias.to(q).expand_as(q))
    return torch.cat([scale, raw[..., 1:3], q], dim=-1)
