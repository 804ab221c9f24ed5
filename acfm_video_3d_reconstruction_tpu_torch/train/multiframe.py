"""Multiframe trainer: camera-multiplex video training (the flagship).

Counterpart of acfm_video_3d_reconstruction_tpu/train/multiframe.py
(reference multiframe/main.py ShapeTrainer, warmup :438-521 and forward
:523-765, with multiframe/nnutils/train_utils.py's init_camera_emb, pose
warm-up with Adam(1e-2) on the camera embeddings, and `optimizer_full`,
Adam over the model and the embedding tables).

One step renders all (hypotheses x batch x frames) meshes in one soft
rasterization, computes the per-(guess, frame) loss matrix, weighs it by
its soft-min over the hypotheses, writes the soft-min back as the frames'
hypothesis probabilities and takes one Adam step.

The state lives in torch objects that the steps update in place
(`MFModules`): the MeshNet and LPIPS modules, the multiplex tables
(`Multiplex`: cams and, with optimize_deform, deform / deform_mirror as
parameters, probs as a buffer), the full optimizer, the warm-up optimizer
and the step count. The hypothesis count k is a plain argument of each
step (the JAX package compiles one step per k).

Adam as optax runs it: optax updates every leaf of {"params", "mpx"} every
step, with a zero gradient where nothing reached it (the tables under
use_gtpose, the deform tables under drop_deform, unused parameters), so
all of them advance their step count together. torch's Adam skips a
parameter whose .grad is None and leaves its step behind, which would
change its later bias correction; the steps give every parameter of the
optimizer a dense zero gradient where backward left none (`_dense_grads`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from .. import config as cfg_lib
from ..deform.solve import screened_poisson_solve
from ..flow.infer import shift_flows_for_loss
from ..geometry import camera as cam_utils
from ..geometry.mesh_ops import CotEdges, cot_laplacian, cot_laplacian_smoothing
from ..losses import losses as L
from ..models.lpips import LPIPS, perceptual_texture_loss
from ..models.mesh_net import MeshNet
from ..models.nn_blocks import init_weights
from ..models.template import Template
from ..multiplex import state as mpx_lib
from ..ops import rasterizer as ras
from . import prefetch
from .monocular import normalize_imagenet

BATCH_KEYS = ("img", "mask", "kp", "sfm_pose", "frames_idx", "mirror_flag", "transforms",
              "edt", "boundaries")
INT_KEYS = ("frames_idx", "mirror_flag")


class Multiplex(nn.Module):
    """The multiplex tables of a MultiplexState as module state: `cams`
    (and `deform`, `deform_mirror` when present) are parameters, `probs` a
    buffer. state_dict keys: cams, probs[, deform, deform_mirror]."""

    def __init__(self, state: mpx_lib.MultiplexState):
        super().__init__()
        self.cams = nn.Parameter(state.cams)
        self.register_buffer("probs", state.probs)
        if state.deform is not None:
            self.deform = nn.Parameter(state.deform)
            self.deform_mirror = nn.Parameter(state.deform_mirror)
        else:
            self.deform = self.deform_mirror = None

    def state(self) -> mpx_lib.MultiplexState:
        return mpx_lib.MultiplexState(cams=self.cams, probs=self.probs, deform=self.deform,
                                      deform_mirror=self.deform_mirror)


@dataclasses.dataclass
class MFModules:
    model: MeshNet
    lpips: Optional[LPIPS]
    template: Template
    cfg: cfg_lib.Config
    device: torch.device
    faces: torch.Tensor   # (F, 3) int64
    edges: torch.Tensor   # (E, 2) int64
    cot: CotEdges         # the faces' cotangent assembly plan
    mpx: Multiplex
    opt: torch.optim.Adam        # optimizer_full: model + multiplex tables
    warm_opt: torch.optim.Adam   # pose warm-up: the camera table only
    steps_per_epoch: Optional[int] = None
    step: int = 0                # warm-up and train steps taken


def make_optimizer(cfg: cfg_lib.Config, model: MeshNet, mpx: Multiplex) -> torch.optim.Adam:
    """optimizer_full (reference train_utils.py:177-189): Adam with betas
    (beta1, 0.999), eps 1e-8 over every MeshNet parameter and the trainable
    multiplex tables. With separate_camera_opt the camera predictor's
    parameters form a second group at camera_learning_rate (optax's
    multi_transform with the "camera" label: every leaf under a key that
    names camera_predictor); each group keeps its rate as "base_lr", which
    multistep_lr scales (`_set_lr`)."""
    tr = cfg.train
    general, camera = [], []
    for name, p in model.named_parameters():
        if p.requires_grad:
            (camera if tr.separate_camera_opt and "camera_predictor" in name
             else general).append(p)
    general += [p for p in mpx.parameters()]
    groups = [{"params": general, "lr": tr.learning_rate, "base_lr": tr.learning_rate,
               "label": "general"}]
    if camera:
        groups.append({"params": camera, "lr": tr.camera_learning_rate,
                       "base_lr": tr.camera_learning_rate, "label": "camera"})
    return torch.optim.Adam(groups, betas=(tr.beta1, 0.999), eps=1e-8)


def build(cfg: cfg_lib.Config, template: Template, num_frames_total: int, seed: int = 0,
          steps_per_epoch: Optional[int] = None,
          device: str | torch.device = "cuda") -> MFModules:
    """The multiframe model (camera LayerNorm and small camera init), LPIPS
    when texture is on, the multiplex tables and both optimizers on
    `device`. Weights from the JAX package's initialisers drawn from a
    torch.Generator seeded by `seed`; the tables from the JAX package's
    seeded numpy init, bit for bit."""
    m, mp = cfg.model, cfg.multiplex
    device = torch.device(device)
    gen = torch.Generator().manual_seed(seed)
    model = MeshNet(template, img_size=m.img_size, nz_feat=m.nz_feat, predict_texture=m.texture,
                    use_camera_layernorm=True, scale_lr=m.scale_lr, small_camera_init=True,
                    learnable_kp=m.learnable_kp)
    model.init_weights(gen)
    lpips = None
    if m.texture:
        lpips = LPIPS()
        init_weights(lpips, gen)
        lpips = lpips.to(device).eval()
    # deform tables (and their Adam state) exist only when the run trains them
    init = mpx_lib.init_az_el_multiplex if mp.az_el_cam else mpx_lib.init_quat_multiplex
    mpx = Multiplex(init(num_frames_total, mp.num_guesses, m.num_lbs,
                         with_deform=mp.optimize_deform)).to(device)
    model = model.to(device).eval()
    return MFModules(
        model=model, lpips=lpips, template=template, cfg=cfg, device=device,
        faces=torch.as_tensor(template.faces, dtype=torch.long, device=device),
        edges=torch.as_tensor(template.edges, dtype=torch.long, device=device),
        cot=CotEdges(template.faces, template.num_verts, device),
        mpx=mpx, opt=make_optimizer(cfg, model, mpx),
        warm_opt=torch.optim.Adam([mpx.cams], lr=cfg.train.warmup_lr, betas=(0.9, 0.999),
                                  eps=1e-8),
        steps_per_epoch=steps_per_epoch,
    )


def to_device_batch(mods: MFModules, batch: dict) -> dict:
    """The batch's arrays as tensors on the modules' device (frames_idx and
    mirror_flag int64, the rest float32); optical_flows kept when present."""
    out = prefetch.to_device(batch, BATCH_KEYS, mods.device, int_keys=INT_KEYS)
    if "optical_flows" in batch:
        out["optical_flows"] = torch.as_tensor(batch["optical_flows"], dtype=torch.float32,
                                               device=mods.device)
    return out


# --------------------------------------------------------------------------
# camera decoding shared by warm-up and forward
# --------------------------------------------------------------------------

def decode_selected_cameras(mods: MFModules, cams_table: torch.Tensor,
                            mpx: mpx_lib.MultiplexState, batch: dict, k: int):
    """Top-k hypothesis selection + decode + mirror/affine transport.
    Returns (cam_pred (k, BT, 7), sel (k, BT)). (reference
    multiframe/main.py:541-582)"""
    mp = mods.cfg.multiplex
    frames_idx = batch["frames_idx"]
    flat = frames_idx.reshape(-1).long()
    G = cams_table.shape[0]
    raw = cams_table[:, flat, :]  # (G, BT, C)
    if k < G:
        sel = mpx_lib.topk_hypotheses(mpx, frames_idx, k)
        raw = mpx_lib.select_hypotheses(raw, sel)
    else:
        sel = torch.arange(G, device=flat.device)[:, None].expand(G, flat.shape[0])
    if mp.az_el_cam:
        quat_bias = None
        if mp.az_el_quat_bias:
            quat_bias = cam_utils.az_el_quat_biases(G).to(raw.device)[sel]
        cams = cam_utils.decode_az_el_camera(
            raw, scale_lr_decay=mp.scale_lr_decay, scale_bias=mp.scale_bias,
            az_range_deg=mp.az_euler_range, el_range_deg=mp.el_euler_range,
            cyc_range_deg=mp.cyc_euler_range, quat_bias=quat_bias)
    else:
        cams = cam_utils.decode_quat_camera(raw, scale_lr_decay=mp.scale_lr_decay)
    mirror = batch["mirror_flag"].reshape(-1).to(cams.dtype)
    cams = cam_utils.mirror_camera(cams, mirror[None].expand(cams.shape[:2]))
    transforms = batch["transforms"].reshape(1, -1, 4)
    cams = cam_utils.transform_camera(cams, transforms.expand(cams.shape[:2] + (4,)))
    return cams, sel


def _per_guess_losses(mods: MFModules, cam_pred, pred_v, atlas, batch: dict, vert2kp=None):
    """Render all (guess, frame) pairs and compute the loss matrix:
    cam_pred (k, BT, 7), pred_v (BT, V, 3), atlas (BT, F, T, T, 3) or None.
    Returns (loss_matrix (k, BT), metrics, extras)."""
    cfg = mods.cfg
    w = cfg.mf_weights
    t = mods.template
    img_size = cfg.model.img_size
    faces = mods.faces
    k, BT = cam_pred.shape[:2]
    B, T = batch["frames_idx"].shape

    imgs = batch["img"].reshape(BT, img_size, img_size, 3)
    masks = batch["mask"].reshape(BT, img_size, img_size)
    edts = batch["edt"].reshape(BT, img_size, img_size)
    boundaries = batch["boundaries"]
    if boundaries.ndim == 4:
        boundaries = boundaries.reshape(BT, *boundaries.shape[2:])

    # fuse the guesses into the batch: (k*BT, V, 3)
    verts_rep = pred_v.repeat(k, 1, 1)
    cams_flat = cam_pred.reshape(k * BT, 7)
    proj_v = cam_utils.orthographic_proj_withz(verts_rep, cams_flat, offset_z=0.0)
    textured = w.tex > 0 and atlas is not None
    if textured:
        # one rasterization serves mask + visibility + texture sampling
        atlas_rep = atlas.repeat(k, 1, 1, 1, 1)
        mask_pred, pix_to_face, vis_verts, tex_pred, _ = ras.soft_silhouette_vis_tex(
            proj_v, faces, atlas_rep, img_size, t.num_verts)
    else:
        mask_pred, pix_to_face, vis_verts = ras.soft_silhouette_vis(
            proj_v, faces, img_size, t.num_verts)

    masks_rep = masks.repeat(k, 1, 1)
    mask_loss = L.l1_loss(mask_pred, masks_rep, reduce=False).reshape(k, BT)
    pred_proj2d = cam_utils.project_points(verts_rep, cams_flat)
    edt = L.edt_loss(mask_pred, edts.repeat(k, 1, 1), reduce=False).reshape(k, BT)
    bdt = L.boundaries_loss(pred_proj2d, boundaries.repeat(k, 1, 1), vis_verts,
                            reduce=False).reshape(k, BT)
    sil_cons = w.edt * edt + w.bdt * bdt
    loss_matrix = w.mask * mask_loss + w.boundaries * sil_cons
    metrics = {"mask_loss": mask_loss, "edt_loss": edt, "bdt_loss": bdt, "sil_cons": sil_cons}
    extras = {"mask_pred": mask_pred, "pix_to_face": pix_to_face}

    if w.of > 0:
        # clip_flows layout (slot t = flow t->t+1) -> loss layout, masked
        # (reference multiframe/main.py:648: flip along T for T=2)
        masks_of = masks.reshape(B, T, img_size, img_size)
        flows_f = shift_flows_for_loss(batch["optical_flows"]) * masks_of[..., None]
        # visibility comes from the soft pass above, without a gradient
        of_loss, *_ = L.optical_flow_loss(
            verts_rep.reshape(k * B, T, t.num_verts, 3), cams_flat,
            flows_f.repeat(k, 1, 1, 1, 1), faces, img_size, reduce=False,
            visible=vis_verts.detach())  # (k*B*(T-1),)
        of_loss = of_loss.reshape(k, B, T - 1)
        # the reference repeats the per-clip loss over the T frames of the clip
        of_loss = (of_loss.mean(-1, keepdim=True) * (T - 1)).repeat_interleave(T, dim=-1)
        of_loss = of_loss.reshape(k, BT)
        loss_matrix = loss_matrix + w.of * of_loss
        metrics["of_loss"] = of_loss

    if textured:
        imgs_rep = imgs.repeat(k, 1, 1, 1)
        imgs_f = torch.flip(imgs_rep, dims=[2])
        cams_f = cam_utils.mirror_camera(cams_flat, cams_flat.new_ones(k * BT))
        masks_f = torch.flip(masks_rep, dims=[2])
        proj_v_f = cam_utils.orthographic_proj_withz(verts_rep.detach(), cams_f, offset_z=0.0)
        tex_pred_f, _, _ = ras.render_texture(proj_v_f, faces, atlas_rep, img_size)
        # one LPIPS pass over [orig; flip]
        per = perceptual_texture_loss(
            mods.lpips, torch.cat([tex_pred, tex_pred_f], 0), torch.cat([imgs_rep, imgs_f], 0),
            torch.cat([masks_rep, masks_f], 0), reduce=False)
        tex = 0.5 * (per[: k * BT] + per[k * BT:])
        mse = 0.5 * (((tex_pred - imgs_rep) * masks_rep[..., None]) ** 2
                     + ((tex_pred_f - imgs_f) * masks_f[..., None]) ** 2).mean(dim=(1, 2, 3))
        tex = (tex + mse).reshape(k, BT)
        loss_matrix = loss_matrix + w.tex * tex
        metrics["tex_loss"] = tex
        extras["tex_pred"] = tex_pred

    if w.kp > 0 and vert2kp is not None:
        # per-(guess, frame) keypoint loss (main.py:692-698, warm-up :503-516)
        kp_verts = torch.einsum("kv,bvc->bkc", vert2kp, pred_v)  # (BT, K_kp, 3)
        kp_proj = cam_utils.project_points(kp_verts.repeat(k, 1, 1), cams_flat)
        kp_loss = L.kp_l2_loss(kp_proj, batch["kp"].reshape(BT, -1, 3).repeat(k, 1, 1),
                               reduce=False).reshape(k, BT)
        loss_matrix = loss_matrix + w.kp * kp_loss
        metrics["kp_loss"] = kp_loss
    return loss_matrix, metrics, extras


def forward(mods: MFModules, batch: dict, *, k: int, train: bool, drop_deform: bool = False,
            detach_camera: bool = False, use_gtpose: bool = False):
    """Full multiframe forward (multiframe/main.py:523-765); returns
    (total_loss, aux) with aux's metrics, probs and sel (for the write-back),
    cam_sel, pred_v, mask_pred and the loss matrix.

    train=True puts the model in train mode (the texture decoder stays in
    eval mode: MeshNet.train). use_gtpose projects with the GT sfm cameras,
    carried through the affine augmentation (a deliberate deviation of the
    JAX package, kept), under a single hypothesis (the driver passes k=1).
    """
    cfg = mods.cfg
    mp = cfg.multiplex
    w = cfg.mf_weights
    t = mods.template
    model = mods.model
    img_size = cfg.model.img_size
    B, T = batch["frames_idx"].shape
    BT = B * T

    model.train(train)
    out = model(normalize_imagenet(batch["img"].reshape(BT, img_size, img_size, 3)))
    delta_v_res = out["delta_v"]       # (BT, K, 3)
    predicted_camera = out["cam_pred"]

    mpx = mods.mpx.state()
    cam_pred, sel = decode_selected_cameras(mods, mpx.cams, mpx, batch, k)
    if detach_camera:
        cam_pred = cam_pred.detach()
    if use_gtpose:
        # the mirror transport happened in the dataset; the affine one here
        gt_cams = cam_utils.transform_camera(batch["sfm_pose"].reshape(BT, 7),
                                             batch["transforms"].reshape(BT, 4))
        proj_cams = gt_cams[None].expand(k, BT, 7)
    else:
        proj_cams = cam_pred

    mean_shape = model.get_mean_shape()
    lbs = model.get_lbs()
    deforms = None
    if mp.optimize_deform:
        deforms = mpx_lib.gather_deforms(mpx, batch["frames_idx"], batch["mirror_flag"],
                                         t.num_lbs, deform_lr=mp.optimize_deform_lr)
    if drop_deform:
        delta = torch.zeros_like(delta_v_res)
    elif mp.optimize_deform:
        delta = deforms
    else:
        delta = delta_v_res

    # cot Laplacian of the current template (constant within the step)
    with torch.no_grad():
        Lcot = cot_laplacian(mean_shape, mods.cot)
    pred_v = screened_poisson_solve(mean_shape, lbs, delta, Lcot)  # (BT, V, 3)

    atlas = model.textures(out["res_feats"]) if cfg.model.texture else None
    vert2kp = model.get_vert2kp() if w.kp > 0 else None

    loss_matrix, per_guess_metrics, extras = _per_guess_losses(
        mods, proj_cams, pred_v, atlas, batch, vert2kp=vert2kp)

    # soft-min hypothesis weighting (main.py:736-746)
    probs = torch.softmax(-loss_matrix, dim=0).detach()
    total = (loss_matrix * probs).sum(0).mean()

    # priors (identical across guesses -> computed once)
    rigid_loss = L.locally_rigid_loss(pred_v, mean_shape[None].expand_as(pred_v), mods.edges)
    triangle_loss = cot_laplacian_smoothing(pred_v, mods.cot)
    handle_deform = L.deform_l2reg(delta_v_res)
    total = total + w.rigid * rigid_loss + w.triangle * triangle_loss
    total = total + w.handle_deform_reg * handle_deform

    metrics = {"total_loss": total, "rigid_loss": rigid_loss, "tri_loss": triangle_loss,
               "handle_deform": handle_deform}
    for name, mat in per_guess_metrics.items():
        metrics[name] = (probs * mat).sum(0).mean()

    if cfg.model.texture and atlas is not None:
        cycle = L.texture_cycle_loss(atlas, B, T)
        total = total + w.deform_reg * cycle
        metrics["cycle_loss"] = cycle

    # camera predictor distillation toward the argmax hypothesis (argmax
    # takes the first maximum, as jnp.argmax does)
    argmax = torch.argmax(probs, dim=0)  # (BT,)
    cam_sel = torch.take_along_dim(cam_pred, argmax[None, :, None], dim=0)[0]
    cam_loss = L.camera_loss(predicted_camera, cam_sel.detach(), 0.0)
    total = total + w.cam * cam_loss
    metrics["camera_loss"] = cam_loss

    if mp.optimize_deform and deforms is not None:
        deform_loss = ((delta_v_res - deforms.detach()) ** 2).mean()
        total = total + w.deform * deform_loss
        metrics["deform_loss"] = deform_loss

    metrics["total_loss"] = total
    aux = {"metrics": metrics, "probs": probs, "sel": sel, "cam_sel": cam_sel,
           "pred_v": pred_v, "mask_pred": extras["mask_pred"], "loss_matrix": loss_matrix}
    return total, aux


def warmup_forward(mods: MFModules, cams_table, mpx: mpx_lib.MultiplexState, mean_shape,
                   batch: dict, vert2kp=None):
    """Pose warm-up loss: the mean shape rendered under every hypothesis
    (reference multiframe/main.py:438-521). Returns (loss, probs (G, BT),
    loss_matrix (G, BT))."""
    G = cams_table.shape[0]
    BT = batch["frames_idx"].numel()
    cam_pred, _ = decode_selected_cameras(mods, cams_table, mpx, batch, k=G)
    pred_v = mean_shape[None].expand(BT, mods.template.num_verts, 3)
    loss_matrix, _, _ = _per_guess_losses(mods, cam_pred, pred_v, None, batch, vert2kp=vert2kp)
    probs = torch.softmax(-loss_matrix, dim=0).detach()
    return loss_matrix.mean(), probs, loss_matrix


# --------------------------------------------------------------------------
# steps
# --------------------------------------------------------------------------

def _dense_grads(opt: torch.optim.Optimizer) -> None:
    """A zero gradient for every parameter that backward did not reach, so
    that Adam steps it (and counts the step) as optax does."""
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def _set_lr(mods: MFModules) -> None:
    """multistep_lr: each group's rate is base_lr x gamma^(milestones passed),
    a milestone m passed from update m * steps_per_epoch on (0-based), as
    optax.piecewise_constant_schedule counts."""
    tr = mods.cfg.train
    if not tr.multistep_lr or not mods.steps_per_epoch:
        return
    done = max((int(s["step"]) for s in mods.opt.state.values() if "step" in s), default=0)
    n = sum(done >= int(m) * mods.steps_per_epoch for m in tr.lr_milestones)
    for group in mods.opt.param_groups:
        group["lr"] = group["base_lr"] * tr.lr_gamma ** n


def make_train_step(mods: MFModules, *, k: int, drop_deform: bool = True,
                    detach_camera: bool = False, use_gtpose: bool = False):
    """Main-loop step: train_step(batch) -> metrics (detached).

    One forward in train mode, backward, one step of mods.opt over the
    model and the multiplex tables, the probabilities written back for the
    selected hypotheses; everything updated in place on `mods`. `batch` is
    on the modules' device (to_device_batch), with optical_flows when the
    flow loss is on."""

    def train_step(batch: dict) -> dict:
        mods.opt.zero_grad(set_to_none=True)
        loss, aux = forward(mods, batch, k=k, train=True, drop_deform=drop_deform,
                            detach_camera=detach_camera, use_gtpose=use_gtpose)
        loss.backward()
        _dense_grads(mods.opt)
        _set_lr(mods)
        mods.opt.step()
        mpx_lib.scatter_probs(mods.mpx.state(), batch["frames_idx"], aux["sel"], aux["probs"])
        mods.step += 1
        return {name: v.detach() for name, v in aux["metrics"].items()}

    return train_step


def make_warmup_step(mods: MFModules):
    """Pose warm-up step: warmup_step(batch) -> {"warmup_loss"}; Adam
    (warmup_lr) on the camera table only, then the probabilities of every
    hypothesis written back."""

    def warmup_step(batch: dict) -> dict:
        model = mods.model
        with torch.no_grad():
            mean_shape = model.get_mean_shape()
            vert2kp = model.get_vert2kp() if mods.cfg.mf_weights.kp > 0 else None
        mods.warm_opt.zero_grad(set_to_none=True)
        mpx = mods.mpx.state()
        loss, probs, _ = warmup_forward(mods, mpx.cams, mpx, mean_shape, batch, vert2kp)
        loss.backward()
        mods.warm_opt.step()
        mods.mpx.cams.grad = None
        G, BT = probs.shape
        sel = torch.arange(G, device=probs.device)[:, None].expand(G, BT)
        mpx_lib.scatter_probs(mpx, batch["frames_idx"], sel, probs)
        mods.step += 1
        return {"warmup_loss": loss.detach()}

    return warmup_step


@torch.no_grad()
def init_camera_emb(mods: MFModules, batch: dict, scale_lr_decay: float = 0.05) -> None:
    """Write the (rescaled) GT sfm cameras into hypothesis table 0
    (reference multiframe/main.py:419-436 + train_utils init_camera_emb
    pass); applied per no-augmentation batch."""
    cams_gt = cam_utils.transform_camera(batch["sfm_pose"].reshape(-1, 7),
                                         batch["transforms"].reshape(-1, 4))
    rescaled = cams_gt.clone()
    rescaled[:, 0] = (torch.abs(cams_gt[:, 0]) - 1.0) / scale_lr_decay
    mods.mpx.cams[0, batch["frames_idx"].reshape(-1).long()] = rescaled
