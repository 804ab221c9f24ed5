"""The loss terms of the monocular forward, on torch tensors.

Counterpart of the matching functions of
acfm_video_3d_reconstruction_tpu/losses/losses.py, with the same
`reduce=False` per-sample paths. Images NHWC or (B, H, W); masks
(B, H, W); keypoints (B, K, 3) = [x, y, vis] in [-1, 1]; cameras (B, 7).
"""
from __future__ import annotations

import torch

from ..geometry import quaternion as quat
from ..geometry.mesh_ops import safe_norm


def _reduce_tail(x: torch.Tensor, reduce: bool) -> torch.Tensor:
    v = x.reshape(x.shape[0], -1).mean(dim=1)
    return v.mean() if reduce else v


def iou(predict, target, eps: float = 1e-6, reduce: bool = True):
    """Soft IoU."""
    p = predict.reshape(predict.shape[0], -1)
    t = target.reshape(target.shape[0], -1)
    out = (p * t).sum(1) / ((p + t - p * t).sum(1) + eps)
    return out.mean() if reduce else out


def iou_loss(predict, target, reduce: bool = True):
    return 1.0 - iou(predict, target, reduce=reduce)


def edt_loss(mask_rendered, edt, reduce: bool = True):
    """Silhouette excess: GT-mask distance transform x rendered mask."""
    if edt.ndim == 4:
        edt = edt[:, 0]
    return _reduce_tail(edt * mask_rendered, reduce)


def boundaries_loss(proj_verts, boundaries, vis_verts, reduce: bool = True):
    """Each GT mask-boundary point should have a visible projected vertex
    nearby. proj_verts (B, V, 2); boundaries (B, N, 3) = [x, y, valid];
    vis_verts (B, V) 0/1."""
    bds_v = boundaries[..., :2]
    bds_m = boundaries[..., 2]
    d2 = (
        (bds_v ** 2).sum(-1)[..., None]
        - 2.0 * torch.einsum("bnc,bvc->bnv", bds_v, proj_verts)
        + (proj_verts ** 2).sum(-1)[:, None, :]
    )
    vis = vis_verts[:, None, :]
    d2 = (1.0 - vis) * 1000.0 + vis * d2
    loss = (d2.amin(dim=-1) * bds_m).mean(-1)
    return loss.mean() if reduce else loss


def kp_l2_loss(kp_pred, kp_gt, reduce: bool = True):
    """Visibility-masked L1 on projected keypoints."""
    vis = (kp_gt[..., 2] > 0).to(kp_pred.dtype)
    loss = torch.abs(kp_pred - kp_gt[..., :2]).sum(-1) * vis
    loss = loss.mean(-1) / (vis.mean(-1) + 1e-4)
    return loss.mean() if reduce else loss


def hinge(x, margin: float):
    # torch.maximum, not clamp: at x == margin it passes half the gradient,
    # as jnp.maximum's VJP does (clamp passes all of it)
    d = x - margin
    return torch.maximum(d, d.new_zeros(()))


def camera_loss(cam_pred, cam_gt, margin: float = 0.0):
    """Geodesic quaternion distance + L2 scale/trans, hinged."""
    rot_loss = hinge(quat.quat_geodesic_loss(cam_pred[:, 3:], cam_gt[:, 3:]), margin)
    st_loss = hinge(((cam_pred[:, :3] - cam_gt[:, :3]) ** 2).reshape(-1), margin)
    return rot_loss.mean() + st_loss.mean()


def locally_rigid_loss(verts, template_verts, edges):
    """Sum over edges of (len - template_len)^2, / B."""
    def length(v):
        return safe_norm(v[..., edges[:, 0], :] - v[..., edges[:, 1], :], dim=-1)

    return ((length(verts) - length(template_verts)) ** 2).sum() / verts.shape[0]


def deform_l2reg(V):
    """Mean L2 norm of per-handle offsets."""
    return safe_norm(V.reshape(-1, V.shape[-1]), dim=-1).mean()


def entropy_loss(A):
    """Row entropy of a (K, V) probability matrix."""
    return (-(A * torch.log(torch.maximum(A, A.new_tensor(1e-12)))).sum(dim=1)).mean()
