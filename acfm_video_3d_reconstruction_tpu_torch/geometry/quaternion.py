"""Quaternion utilities (w, x, y, z convention) on torch tensors.

Counterpart of acfm_video_3d_reconstruction_tpu/geometry/quaternion.py:
the functions the camera model, the camera decoders, the camera loss and
the gauge alignment need. All broadcast over leading batch dims;
quaternions live in the trailing axis of size 4.

No function here copies a host constant to the device (`new_tensor` of a
list blocks the host until the stream drains): constants are built with
`new_full` or by indexing, so the TTO loop, which projects through
quat_rotate several times an iteration, queues without waiting.
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
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit-normalize along the last axis, finite gradient at q == 0."""
    sq = (q * q).sum(-1, keepdim=True)
    n = torch.sqrt(torch.maximum(sq, sq.new_full((), eps * eps)))
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


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Axis (..., 3) (unit) + angle (...,) -> quaternion (..., 4)."""
    half = angle[..., None] / 2.0
    return torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)


def quat_geodesic_loss(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """1 - |(q1 ⊗ q2*)_w|, per pair. Shapes (..., 4) -> (...,)."""
    q_rel = hamilton_product(q1, quat_conj(q2))
    return 1.0 - torch.abs(q_rel[..., 0])


def mirror_quat(q: torch.Tensor) -> torch.Tensor:
    """Reflect a camera rotation for a horizontally-flipped image:
    q' = quat(diag(-1,1,-1)) ⊗ standardize(q), where the mirror quaternion
    is (0, 0, 1, 0)."""
    q = standardize_quaternion(q)
    mirror = torch.zeros_like(q)
    mirror[..., 2] = 1.0
    return hamilton_product(mirror, q)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4), w >= 0.

    Shepperd's selection without branches: four candidate (unnormalized)
    quaternions, one per dominant component, the one of the largest score
    taken (argmax keeps the first of equal scores, as jnp.argmax does, so
    the candidates keep the JAX package's order), then normalized and
    standardized.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11], dim=-1)
    scores = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 + m11 - m00 - m22, 1.0 + m22 - m00 - m11],
        dim=-1,
    )
    idx = torch.argmax(scores, dim=-1)
    cand = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 candidates, 4 components)
    q = torch.take_along_dim(cand, idx[..., None, None], dim=-2)[..., 0, :]
    return standardize_quaternion(quat_normalize(q))
