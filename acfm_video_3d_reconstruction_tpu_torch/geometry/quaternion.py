"""Quaternion utilities (w, x, y, z convention) on torch tensors.

Counterpart of acfm_video_3d_reconstruction_tpu/geometry/quaternion.py:
the functions the camera model and the camera loss need. All broadcast
over leading batch dims; quaternions live in the trailing axis of size 4.
"""
from __future__ import annotations

import torch


def hamilton_product(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """Hamilton product qa ⊗ qb. Shapes: (..., 4) x (..., 4) -> (..., 4)."""
    aw, ax, ay, az = qa.unbind(-1)
    bw, bx, by, bz = qb.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    """Conjugate: negate the vector part."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit-normalize along the last axis, finite gradient at q == 0."""
    sq = (q * q).sum(-1, keepdim=True)
    n = torch.sqrt(torch.maximum(sq, sq.new_tensor(eps * eps)))
    return q / n


def standardize_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Flip sign so the real part is non-negative (pytorch3d convention)."""
    return torch.where(q[..., :1] < 0, -q, q)


def quat_rotate(X: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotate points X (..., N, 3) by q (..., 4) as q ⊗ x ⊗ q*."""
    qn = q[..., None, :]
    Xq = torch.cat([torch.zeros_like(X[..., :1]), X], dim=-1)
    out = hamilton_product(qn, hamilton_product(Xq, quat_conj(qn)))
    return out[..., 1:]


def quat_geodesic_loss(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """1 - |(q1 ⊗ q2*)_w|, per pair. Shapes (..., 4) -> (...,)."""
    q_rel = hamilton_product(q1, quat_conj(q2))
    return 1.0 - torch.abs(q_rel[..., 0])


def mirror_quat(q: torch.Tensor) -> torch.Tensor:
    """Reflect a camera rotation for a horizontally-flipped image:
    q' = quat(diag(-1,1,-1)) ⊗ standardize(q), where the mirror quaternion
    is (0, 0, 1, 0)."""
    q = standardize_quaternion(q)
    mirror = q.new_tensor([0.0, 0.0, 1.0, 0.0]).expand_as(q)
    return hamilton_product(mirror, q)
