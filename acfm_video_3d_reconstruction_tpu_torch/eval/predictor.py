"""Inference predictor, test-time optimization (TTO) and the gauge helpers.

Counterpart of acfm_video_3d_reconstruction_tpu/eval/predictor.py
(reference monocular/nnutils/predictor.py:33-174, MeshPredictor.predict;
multiframe/nnutils/predictor.py:226-349, the argmax-multiplex camera and
the Adam(5e-3) refinement of delta_v_res, and optionally the camera,
against the mask, silhouette-consistency and optical-flow losses).

The TTO refiner factors the solve's system matrix once per call and
reuses the factor in every Adam step (the JAX package's structural choice;
the matrix is constant during TTO). It combines the silhouette-consistency
terms in the training order (edt_wt * edt + bdt_wt * bdt), as the JAX
package does; the reference's predictor.py:321 swaps the two weights.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from ..flow.infer import shift_flows_for_loss
from ..geometry import camera as cam_utils
from ..geometry import quaternion as quat
from ..geometry.mesh_ops import CotEdges, cot_laplacian
from ..losses import losses as L
from ..multiplex import state as mpx_lib
from ..ops import rasterizer as ras
from ..train import monocular
from ..train.multiframe import _dense_grads


@dataclasses.dataclass(frozen=True)
class TTOConfig:
    num_iter: int = 100
    lr: float = 5e-3
    optimize_camera: bool = False
    mask_wt: float = 1.0
    boundaries_wt: float = 1.0
    edt_wt: float = 0.1
    bdt_wt: float = 2.0
    of_wt: float = 1.0
    offset_z: float = 0.0


def predict_monocular(mods: monocular.MonoModules, batch: dict) -> dict:
    """Full forward -> {lbs, mean_shape, faces, kp_pred, verts, cam_pred, mask_pred}."""
    with torch.inference_mode():
        _, aux = monocular.forward(mods, monocular.to_device_batch(mods, batch))
        model = mods.model
        return {
            "lbs": model.get_lbs(),
            "mean_shape": model.get_mean_shape().detach(),
            "faces": mods.template.faces,
            "kp_pred": aux["kp_pred"],
            "verts": aux["pred_v"],
            "cam_pred": aux["cam_pred"],
            "mask_pred": aux["mask_pred"],
        }


@contextlib.contextmanager
def _full_f32():
    """f32 matmuls without TF32 within the block: the factor and the solves
    need them (deform/solve.py)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def make_tto_step_fn(mods, tto: TTOConfig, num_frames: int,
                     trace_vert2kp: Optional[torch.Tensor] = None):
    """Build the TTO refiner for `mods` (anything with .template, .cfg and
    .device, e.g. train/multiframe.py's MFModules).

    Returns refine(mean_shape, lbs, delta_v_res, cam_pred, batch) ->
    (pred_v (BT, V, 3), cam (BT, 7), final_loss). `batch` holds mask, edt
    and boundaries on the device (and optical_flows, clip_flows layout, for
    the flow term). The returned camera is the decoded one: with
    optimize_camera its quaternion is normalized (quat_rotate scales by
    |q|^2, so the raw Adam iterate would mis-scale every projection).

    With trace_vert2kp (the (num_kps, V) keypoint regressor) the return
    gains a 4th element, the per-iteration diagnostics {loss (N,), iou (N,
    BT), kp_pred (N, BT, K, 2), cam (N, BT, 7)}, kept on the device and
    stacked after the loop.

    The loop reads nothing back to the host: every iteration queues one
    soft rasterization, its backward, one hard rasterization (the flow
    term's visibility) and one Adam step behind the last.
    """
    t = mods.template
    device = torch.device(mods.device)
    faces = torch.as_tensor(t.faces, dtype=torch.long, device=device)
    cot = CotEdges(t.faces, t.num_verts, device)
    S = mods.cfg.model.img_size

    def refine(mean_shape, lbs, delta_v_res, cam_pred, batch):
        with _full_f32(), torch.enable_grad():
            return _refine(mean_shape, lbs, delta_v_res, cam_pred, batch)

    def _refine(mean_shape, lbs, delta_v_res, cam_pred, batch):
        BT = delta_v_res.shape[0]
        V = t.num_verts
        cam_pred = cam_pred.detach().float()
        mean_shape = mean_shape.detach().float()
        A = lbs.detach().float()
        with torch.no_grad():
            Lcot = cot_laplacian(mean_shape, cot)
            chol, _ = torch.linalg.cholesky_ex(Lcot.T @ Lcot + A.T @ A)
            rhs_common = Lcot.T @ (Lcot @ mean_shape)
            handle_base = (A @ mean_shape)[None]
        masks = batch["mask"].reshape(BT, S, S).float()
        edts = batch["edt"].reshape(BT, S, S).float()
        boundaries = batch["boundaries"].reshape(BT, -1, 3).float()
        flows_f = None
        if tto.of_wt > 0 and "optical_flows" in batch:
            B = BT // num_frames
            masks_of = masks.reshape(B, num_frames, S, S)
            flows_f = shift_flows_for_loss(batch["optical_flows"].float()) * masks_of[..., None]

        def solve(delta_res):
            target = handle_base + delta_res
            rhs = rhs_common[None] + torch.einsum("kv,bkc->bvc", A, target)
            sol = torch.cholesky_solve(rhs.permute(1, 0, 2).reshape(V, BT * 3), chol)
            return sol.reshape(V, BT, 3).permute(1, 0, 2)

        def decode_cam(cam):
            if cam is None:
                return cam_pred
            q = cam[..., 3:]
            # sqrt(max(|q|^2, 1e-24)), not F.normalize: a finite gradient at
            # q == 0 and the JAX package's epsilon
            sq = (q * q).sum(-1, keepdim=True)
            qn = torch.sqrt(torch.maximum(sq, sq.new_full((), 1e-24)))
            return torch.cat([cam[..., :3], q / qn], dim=-1)

        def loss_fn(delta_res, cam_raw):
            cam = decode_cam(cam_raw)
            pred_v = solve(delta_res)
            proj_v = cam_utils.orthographic_proj_withz(pred_v, cam, offset_z=tto.offset_z)
            mask_pred, _, vis = ras.soft_silhouette_vis(proj_v, faces, S, V)
            mask_loss = L.l1_loss(mask_pred, masks)
            pred_proj = cam_utils.project_points(pred_v, cam)
            edt = L.edt_loss(mask_pred, edts)
            bdt = L.boundaries_loss(pred_proj, boundaries, vis)
            total = tto.mask_wt * mask_loss + tto.boundaries_wt * (
                tto.edt_wt * edt + tto.bdt_wt * bdt)
            if flows_f is not None:
                verts_seq = pred_v.reshape(BT // num_frames, num_frames, V, 3)
                of_loss, *_ = L.optical_flow_loss(verts_seq, cam, flows_f, faces, S)
                total = total + tto.of_wt * of_loss
            if trace_vert2kp is None:
                return total, None
            with torch.no_grad():  # diagnostics: values only
                hard = (mask_pred > 0.5).float()
                inter = (hard * masks).sum((1, 2))
                union = torch.clamp_min((hard + masks - hard * masks).sum((1, 2)), 1e-9)
                kp_verts = torch.einsum("kv,bvc->bkc", trace_vert2kp, pred_v)
                aux = {"iou": inter / union, "kp_pred": cam_utils.project_points(kp_verts, cam),
                       "cam": cam.detach()}
            return total, aux

        delta = delta_v_res.detach().float().clone().requires_grad_(True)
        params = [delta]
        cam = None
        if tto.optimize_camera:
            cam = cam_pred.clone().requires_grad_(True)
            params.append(cam)
        # optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8) are torch's
        opt = torch.optim.Adam(params, lr=tto.lr)
        trace = []
        for _ in range(tto.num_iter):
            opt.zero_grad(set_to_none=True)
            total, aux = loss_fn(delta, cam)
            total.backward()
            _dense_grads(opt)
            opt.step()
            if aux is not None:
                trace.append(dict(aux, loss=total.detach()))
        with torch.no_grad():
            final_loss, _ = loss_fn(delta, cam)
            pred_v = solve(delta)
            cam_out = decode_cam(cam).detach()
        if trace_vert2kp is None:
            return pred_v, cam_out, final_loss
        keys = ("loss", "iou", "kp_pred", "cam")
        return pred_v, cam_out, final_loss, {
            k: torch.stack([it[k] for it in trace]) if trace else None for k in keys}

    return refine


def argmax_multiplex_camera(mpx: mpx_lib.MultiplexState, frames_idx: torch.Tensor,
                            scale_lr_decay: float = 0.05) -> torch.Tensor:
    """Best-hypothesis camera for train-split evaluation (reference
    predictor.py:239-252): the most probable hypothesis of each frame
    (topk_hypotheses' stable order: the lower index wins a tie), decoded.
    frames_idx (B, T) -> (B*T, 7)."""
    with torch.no_grad():
        sel = mpx_lib.topk_hypotheses(mpx, frames_idx, 1)  # (1, BT)
        raw = mpx_lib.select_hypotheses(mpx.cams[:, frames_idx.reshape(-1).long()], sel)[0]
        return cam_utils.decode_quat_camera(raw, scale_lr_decay=scale_lr_decay)


def similarity_kabsch(src: torch.Tensor, dst: torch.Tensor):
    """Similarity transform (s, R, c) minimizing ||s R src + c - dst||^2.

    src / dst: (N, 3) point sets in correspondence. Returns (s, R (3, 3),
    c (3,)) with det(R) = +1: a reflection is folded into the sign of the
    smallest singular vector (the diag(1, 1, d) fix of Umeyama / Kabsch).

    A diagnostic with no reference analog: the camera multiplex fixes shape
    and cameras only up to a global similarity, so the learned canonical
    frame drifts from the data generator's; this estimates that drift from
    the learned mean shape against the GT template.
    """
    src = torch.as_tensor(src, dtype=torch.float32)
    dst = torch.as_tensor(dst, dtype=torch.float32, device=src.device)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    X, Y = src - mu_s, dst - mu_d
    H = X.T @ Y
    U, S, Vt = torch.linalg.svd(H)
    d = torch.sign(torch.linalg.det(Vt.T @ U.T))
    signs = torch.stack([torch.ones_like(d), torch.ones_like(d), d])
    R = Vt.T @ torch.diag(signs) @ U.T
    s = (S * signs).sum() / torch.clamp_min((X * X).sum(), 1e-12)
    c = mu_d - s * (R @ mu_s)
    return s, R, c


def gauge_correction(template_verts, mean_shape):
    """The learned gauge's drift (s_d, q_d, c_d), once per model: both
    inputs are batch-invariant (the GT template and the learned mean
    shape), so an evaluation of many batches computes this once and applies
    only apply_gauge_correction per batch."""
    s_d, R_d, c_d = similarity_kabsch(template_verts, mean_shape)
    return s_d, quat.matrix_to_quat(R_d), c_d


def apply_gauge_correction(cams_gt: torch.Tensor, corr) -> torch.Tensor:
    """Compose a precomputed gauge correction into GT cameras (..., 7)."""
    s_d, q_d, c_d = corr
    q_corr = quat.quat_normalize(quat.hamilton_product(cams_gt[..., 3:7], quat.quat_conj(q_d)))
    scale = cams_gt[..., 0:1] / torch.clamp_min(s_d, 1e-12)
    rot_c = quat.quat_rotate(c_d[None, None, :], q_corr)[..., 0, :2]
    trans = cams_gt[..., 1:3] - scale * rot_c
    return torch.cat([scale, trans, q_corr], dim=-1)


def gauge_align_cameras(cams_gt: torch.Tensor, template_verts, mean_shape) -> torch.Tensor:
    """GT cameras corrected for the learned gauge (a diagnostic).

    The generator's GT cameras project GT-gauge points, x = s_g R(q_g) v +
    t_g. With the learned mean shape drifted by a similarity, mean_shape ~=
    s_d R_d template + c_d, projecting the LEARNED vertices in the GT image
    frame takes scale' = s_g / s_d, q' = q_g (x) conj(q_d) and t' = t_g -
    scale' (R(q') c_d)_xy. Without it the GT-camera column is no ceiling:
    the drift alone sinks it below the predicted camera's PCK.
    """
    return apply_gauge_correction(cams_gt, gauge_correction(template_verts, mean_shape))
