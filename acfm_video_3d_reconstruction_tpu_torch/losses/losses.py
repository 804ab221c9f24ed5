"""The loss terms of the monocular and multiframe forwards, on torch tensors.

Counterpart of the matching functions of
acfm_video_3d_reconstruction_tpu/losses/losses.py, with the same
`reduce=False` per-sample paths. Images NHWC or (B, H, W); masks
(B, H, W); keypoints (B, K, 3) = [x, y, vis] in [-1, 1]; cameras (B, 7).
"""
from __future__ import annotations

import torch

from ..geometry import camera as cam_utils
from ..geometry import quaternion as quat
from ..geometry.mesh_ops import safe_norm
from ..ops import rasterizer as ras
from ..ops.grid_sample import grid_sample


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


def l1_loss(predict, target, reduce: bool = True):
    """Per-sample-reducible L1 (loss_utils.py:72-77); the multiframe mask loss."""
    return _reduce_tail(torch.abs(predict - target), reduce)


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


def texture_cycle_loss(textures_colors, batch: int, num_frames: int):
    """Temporal texture consistency across the frames of a clip
    (multiframe/main.py:706-712): textures_colors (B*T, F, Ts, Ts, 3); the
    mean L2 norm of consecutive-frame texel differences (safe_norm: the
    frames' texels are equal at init)."""
    t_c = textures_colors.reshape(batch, num_frames, -1, 3).transpose(1, 2)
    return safe_norm(t_c[..., :-1, :] - t_c[..., 1:, :], dim=-1).mean()


def optical_flow_loss(verts_seq, cams_seq, flows, faces, image_size: int,
                      pix_to_face=None, reduce: bool = True, visible=None):
    """Temporal consistency between projected-vertex motion and sampled flow
    (reference loss_utils.py:419-474, as the JAX package computes it).

    verts_seq (B, T, V, 3) posed meshes; cams_seq (B*T, 7); flows
    (B, T, H, W, 2) in the loss layout (slot t holds flow t-1 -> t, slot 0
    zero), pixels; faces (F, 3). Visibility: `visible` (B*T, V) when the
    caller holds it, else from `pix_to_face` (B*T, H, W), else a hard
    rasterization. Returns (loss (B*(T-1),) or its sum, of_pred, vis_t,
    proj (B, T, V, 2), sampled_t): pred motion W/2 (p_t - p_{t+1}) in
    pixels, visibility = z-buffer visibility AND nonzero sampled flow at
    frames 1..T-1, per-frame loss sum_v |err| / H / (#vis + 1). The
    sampling positions and vis_t carry no gradient.
    """
    B, T, V, _ = verts_seq.shape
    H = W = image_size
    bt = B * T
    proj3 = cam_utils.orthographic_proj_withz(verts_seq.reshape(bt, V, 3), cams_seq)
    proj = proj3[..., :2]
    if visible is not None:
        vis = visible.reshape(B, T, V)
    elif pix_to_face is None:
        vis = ras.hard_visibility(proj3.detach(), faces, image_size, V).reshape(B, T, V)
    else:
        vis = ras.visible_vertices(pix_to_face.reshape(bt, -1), faces, V).reshape(B, T, V)
    sampled = grid_sample(flows.reshape(bt, H, W, 2).permute(0, 3, 1, 2), proj.detach(),
                          mode="nearest", align_corners=False)  # (BT, 2, V)
    sampled = sampled.permute(0, 2, 1).reshape(B, T, V, 2)
    proj_px = W * (proj.reshape(B, T, V, 2) + 1.0) / 2.0
    of_pred = proj_px[:, :-1] - proj_px[:, 1:]  # (B, T-1, V, 2) current - next
    nonzero = torch.abs(sampled).sum(-1) != 0
    vis_t = (nonzero & (vis > 0)).to(proj.dtype)[:, 1:].detach()
    sampled_t = vis_t[..., None] * sampled[:, 1:]
    of_pred = vis_t[..., None] * of_pred
    err = torch.abs(sampled_t - of_pred).sum(2)  # (B, T-1, 2) L1 over vertices
    loss = ((err[..., 0] + err[..., 1]) / H / (vis_t.sum(-1) + 1.0)).reshape(-1)
    if reduce:
        loss = loss.sum()
    return loss, of_pred, vis_t, proj.reshape(B, T, V, 2), sampled_t
