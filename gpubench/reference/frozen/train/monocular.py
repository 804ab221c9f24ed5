"""Monocular model: build, forward, the train step and the eval step.

Counterpart of acfm_video_3d_reconstruction_tpu/train/monocular.py:
encoder -> handle offsets + camera -> screened-Poisson solve -> one soft
rasterization for mask, visibility and texture, one hard rasterization of
the mirrored view for its texture -> the loss stack (-> backward -> Adam).
The conv nets run under bf16 autocast when cfg.model.dtype is "bfloat16";
the geometry (solve, projection, rasterization) stays float32.

The model's parameters and BatchNorm statistics live in the modules
(`MonoModules.model`, `.lpips`), so the steps take only a batch; the aux
dict has the JAX forward's keys, "batch_stats" being the model's BatchNorm
buffers by name.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from .. import config as cfg_lib
from ..deform.solve import screened_poisson_solve
from ..geometry import camera as cam_utils
from ..geometry.mesh_ops import uniform_laplacian_smoothing
from ..losses import losses as L
from ..models.lpips import LPIPS, perceptual_texture_loss
from ..models.mesh_net import MeshNet
from ..models.nn_blocks import init_weights
from ..models.template import Template
from ..ops import rasterizer as ras
from ..parallel import mesh as pmesh

BATCH_KEYS = ("img", "mask", "kp", "sfm_pose", "edt", "boundaries")


@dataclasses.dataclass
class MonoModules:
    model: MeshNet
    lpips: Optional[LPIPS]
    template: Template
    cfg: cfg_lib.Config
    device: torch.device
    faces: torch.Tensor   # (F, 3) int64
    edges: torch.Tensor   # (E, 2) int64
    lap: torch.Tensor     # (V, V) uniform Laplacian


def build(cfg: cfg_lib.Config, template: Template, seed: int = 0,
          device: str | torch.device = "cuda") -> MonoModules:
    """Construct the model (and LPIPS when texture is on) with the JAX
    package's initialisers, drawn from a torch.Generator seeded by `seed`,
    in eval mode on `device`."""
    m = cfg.model
    device = torch.device(device)
    gen = torch.Generator().manual_seed(seed)
    model = MeshNet(
        template, img_size=m.img_size, nz_feat=m.nz_feat, predict_texture=m.texture,
        use_camera_layernorm=m.use_camera_layernorm, scale_lr=m.scale_lr,
        small_camera_init=m.small_camera_init, learnable_kp=m.learnable_kp,
    )
    model.init_weights(gen)
    lpips = None
    if m.texture:
        lpips = LPIPS()
        init_weights(lpips, gen)
        lpips = lpips.to(device).eval()
    return MonoModules(
        model=model.to(device).eval(), lpips=lpips, template=template, cfg=cfg,
        device=device,
        faces=torch.as_tensor(template.faces, dtype=torch.long, device=device),
        edges=torch.as_tensor(template.edges, dtype=torch.long, device=device),
        lap=torch.as_tensor(template.uniform_L, dtype=torch.float32, device=device),
    )


def _autocast(mods: MonoModules):
    if mods.cfg.model.dtype == "bfloat16":
        return torch.autocast(device_type=mods.device.type, dtype=torch.bfloat16)
    return contextlib.nullcontext()


def _device_vector(like: torch.Tensor, values) -> torch.Tensor:
    """`values` as a 1-D tensor of like's dtype, filled on like's device
    (`new_tensor` would copy it from the host and wait for the stream)."""
    return torch.stack([like.new_full((), v) for v in values])


def normalize_imagenet(img: torch.Tensor) -> torch.Tensor:
    mean = _device_vector(img, cfg_lib.IMAGENET_MEAN)
    std = _device_vector(img, cfg_lib.IMAGENET_STD)
    return (img - mean) / std


def mirror_batch(imgs, cams, mask_pred, masks):
    """Horizontal flip of images/masks + camera transport."""
    cams_f = cam_utils.mirror_camera(cams, torch.ones(cams.shape[:-1], dtype=cams.dtype,
                                                      device=cams.device))
    return (torch.flip(imgs, dims=[2]), cams_f, torch.flip(mask_pred, dims=[2]),
            torch.flip(masks, dims=[2]))


def to_device_batch(mods: MonoModules, batch: dict) -> dict:
    """The batch's arrays as float32 tensors on the modules' device."""
    return {k: torch.as_tensor(batch[k], dtype=torch.float32, device=mods.device)
            for k in BATCH_KEYS}


def forward(mods: MonoModules, batch: dict, train: bool = False):
    """Full monocular forward; returns (total_loss, aux).

    train=True puts the model in train mode (MeshNet.train: the encoder's
    BatchNorms normalise with batch statistics and update their running
    buffers in place, the texture decoder keeps its stored ones), as the
    JAX forward(train=True) does; train=False is eval mode throughout.
    """
    cfg, t, model = mods.cfg, mods.template, mods.model
    model.train(train)
    w = cfg.mono_weights
    img_size = cfg.model.img_size
    faces = mods.faces

    imgs = batch["img"]              # (B, H, W, 3) in [0, 1]
    masks = batch["mask"]            # (B, H, W)
    kps = batch["kp"]                # (B, K, 3)
    cams_gt = batch["sfm_pose"]      # (B, 7)
    edts = batch["edt"]              # (B, H, W)
    boundaries = batch["boundaries"]  # (B, N, 3)

    with _autocast(mods):
        out = model(normalize_imagenet(imgs))
    delta_v, cam_pred = out["delta_v"], out["cam_pred"]

    mean_shape = model.get_mean_shape()
    lbs = model.get_lbs()
    vert2kp = model.get_vert2kp()
    pred_v = screened_poisson_solve(mean_shape, lbs, delta_v, mods.lap)
    mean_v = mean_shape[None].expand_as(pred_v)

    proj_cam = cams_gt if cfg.train.use_gtpose else cam_pred
    kp_pred = cam_utils.project_points(torch.einsum("kv,bvc->bkc", vert2kp, pred_v), proj_cam)
    proj_v = cam_utils.orthographic_proj_withz(pred_v, proj_cam, offset_z=cfg.train.offset_z)

    if cfg.model.texture:
        with _autocast(mods):
            atlas = model.textures(out["res_feats"])
        mask_pred, _, vis_verts, tex_pred, _ = ras.soft_silhouette_vis_tex(
            proj_v, faces, atlas, img_size, t.num_verts)
    else:
        mask_pred, _, vis_verts = ras.soft_silhouette_vis(
            proj_v, faces, img_size, t.num_verts)

    metrics = {}
    kp_loss = L.kp_l2_loss(kp_pred, kps)
    mask_loss = L.iou_loss(mask_pred, masks)
    cam_loss = L.camera_loss(cam_pred, cams_gt, 0.0)
    total = w.kp * kp_loss + w.mask * mask_loss + w.cam * cam_loss
    metrics.update(kp_loss=kp_loss, mask_loss=mask_loss, cam_loss=cam_loss)

    if cfg.model.texture:
        imgs_f, cam_f, _, masks_f = mirror_batch(imgs, proj_cam, mask_pred, masks)
        proj_v_f = cam_utils.orthographic_proj_withz(
            pred_v.detach(), cam_f, offset_z=cfg.train.offset_z)
        tex_pred_f, _, _ = ras.render_texture(proj_v_f, faces, atlas, img_size)
        # one LPIPS pass over [orig; flip]
        with _autocast(mods):
            tex_loss = perceptual_texture_loss(
                mods.lpips,
                torch.cat([tex_pred, tex_pred_f], 0),
                torch.cat([imgs, imgs_f], 0),
                torch.cat([masks, masks_f], 0),
            ).float()
        m, m_f = masks[..., None], masks_f[..., None]
        tex_l1 = 0.5 * (((tex_pred * m - imgs * m) ** 2).mean()
                        + ((tex_pred_f * m_f - imgs_f * m_f) ** 2).mean())
        tex_loss = tex_loss + tex_l1
        total = total + w.tex * tex_loss
        metrics.update(tex_loss=tex_loss)

    # silhouette consistency
    edt_loss = L.edt_loss(mask_pred, edts)
    bdt_loss = L.boundaries_loss(cam_utils.project_points(pred_v, proj_cam), boundaries,
                                 vis_verts)
    sil_cons = w.edt * edt_loss + w.bdt * bdt_loss
    total = total + w.boundaries * sil_cons
    metrics.update(edt_loss=edt_loss, bdt_loss=bdt_loss, sil_cons=sil_cons)

    # priors
    rigid_loss = L.locally_rigid_loss(pred_v, mean_v, mods.edges)
    triangle_loss = uniform_laplacian_smoothing(pred_v, mods.lap)
    vert2kp_loss = L.entropy_loss(vert2kp)
    deform_reg = L.deform_l2reg(delta_v)
    total = total + w.vert2kp * vert2kp_loss + w.rigid * rigid_loss + w.triangle * triangle_loss
    metrics.update(rigid_loss=rigid_loss, tri_loss=triangle_loss, vert2kp_loss=vert2kp_loss,
                   deform_reg=deform_reg, total_loss=total)

    aux = {
        "metrics": metrics,
        # updated in place in train mode, as they were in eval mode
        "batch_stats": {k: v for k, v in model.named_buffers()
                        if k.endswith(("running_mean", "running_var"))},
        "mask_pred": mask_pred,
        "kp_pred": kp_pred,
        "pred_v": pred_v,
        "cam_pred": cam_pred,
    }
    return total, aux


def build_optimizer(mods: MonoModules) -> torch.optim.Adam:
    """torch.optim.Adam over every MeshNet parameter (mean_v, lbs_logits and
    vert2kp_logits too, as JAX differentiates all of `params`) with
    cfg.train.learning_rate, betas (cfg.train.beta1, 0.999) and eps 1e-8:
    optax.adam with eps_root 0. LPIPS is frozen."""
    tc = mods.cfg.train
    return torch.optim.Adam(mods.model.parameters(), lr=tc.learning_rate,
                            betas=(tc.beta1, 0.999), eps=1e-8)


def make_train_step(mods: MonoModules, opt: Optional[torch.optim.Optimizer] = None):
    """train_step(batch) -> metrics, the JAX make_train_step's step.

    One forward in train mode, backward, and one step of `opt`
    (build_optimizer(mods) when None). Where JAX returns a new TrainState,
    this updates the modules' parameters, BatchNorm statistics and the
    optimizer state in place; the optimizer is `train_step.opt`, so that
    train/checkpoints.py can save and restore its moments and step count.
    The metrics are those of the forward before the update, detached.
    Under a process group (parallel/mesh.py) `batch` is this rank's block of
    the global batch: the gradients are averaged over the ranks before the
    update and the metrics are the global means.
    """
    opt = build_optimizer(mods) if opt is None else opt

    def train_step(batch: dict) -> dict:
        opt.zero_grad(set_to_none=True)
        loss, aux = forward(mods, to_device_batch(mods, batch), train=True)
        loss.backward()
        if pmesh.active():
            pmesh.all_reduce_grads([p for g in opt.param_groups for p in g["params"]])
        opt.step()
        return pmesh.reduce_metrics({k: v.detach() for k, v in aux["metrics"].items()})

    train_step.opt = opt
    return train_step


def make_eval_step(mods: MonoModules):
    """eval_step(batch) -> aux, under torch.inference_mode()."""

    def eval_step(batch: dict) -> dict:
        with torch.inference_mode():
            _, aux = forward(mods, to_device_batch(mods, batch))
        return aux

    return eval_step
