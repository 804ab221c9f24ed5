"""The monocular reference: the predictor's answers worked out again in
plain PyTorch, float32 at the configuration's precision (cuDNN
convolutions in TF32, as the monocular CLI leaves them).

From the configuration, the seed and the raw data set alone: the CUB
requests (the frozen data layer), the template (the frozen builder over
the data set's SfM mean shape), the weights (harness/weights.py) and the
frozen monocular forward with the plain rasterizer.
"""
from __future__ import annotations

import dataclasses
import types

import torch

from ..harness import compare as C
from ..harness import weights as W
from ..harness.data import cub
from .common import count_flops, data_seed, precision, solve_flops, weight_seed
from .frozen import config as cfg_lib
from .frozen.data.cub import CUBDataset, load_sfm_mean_shape
from .frozen.models.lpips import LPIPS
from .frozen.models.mesh_net import MeshNet
from .frozen.models.template import build_template
from .frozen.train import monocular as mono


def options(cell) -> types.SimpleNamespace:
    """The flags the configuration states, with the data set's directory as
    both the CUB dir and its cache dir."""
    d = cub(cell.config["dataset"])
    return types.SimpleNamespace(**dict(cell.config["cli"], cub_dir=d, cub_cache_dir=d))


def build_cfg(a) -> cfg_lib.Config:
    """The monocular CLI's build_cfg (cli/monocular_main.py) over the frozen
    config."""
    return cfg_lib.Config(
        model=dataclasses.replace(
            cfg_lib.ModelConfig(), img_size=a.img_size, nz_feat=a.nz_feat, tex_size=a.tex_size,
            num_lbs=a.num_lbs, num_kps=a.num_kps, texture=a.texture, symmetric=a.symmetric,
            symmetric_texture=a.symmetric, mesh_path=None, kp_dict_path=None),
        mono_weights=dataclasses.replace(
            cfg_lib.MonocularLossWeights(), kp=a.kp_loss_wt, mask=a.mask_loss_wt,
            cam=a.cam_loss_wt, boundaries=a.boundaries_reg_wt, edt=a.edt_reg_wt,
            bdt=a.bdt_reg_wt, tex=a.tex_loss_wt, rigid=a.rigid_wt,
            triangle=a.triangle_reg_wt, deform_reg=a.deform_reg_wt, vert2kp=a.vert2kp_loss_wt,
            tex_dt=a.tex_dt_loss_wt, entropy_lbs=a.entropy_lbs_loss_wt),
        train=dataclasses.replace(
            cfg_lib.TrainConfig(), batch_size=a.batch_size, learning_rate=a.learning_rate,
            use_gtpose=a.use_gtpose),
    )


def build_template_of(cfg: cfg_lib.Config, a):
    """The monocular CLI's build_cub_template: the icosphere with the SfM
    mean shape's keypoints."""
    m = cfg.model
    S, _ = load_sfm_mean_shape(a.cub_cache_dir, a.split)
    return build_template(None, None, subdivide=m.subdivide, num_lbs=m.num_lbs,
                          tex_size=m.tex_size, symmetric=m.symmetric,
                          symmetric_texture=m.symmetric_texture, num_kps=m.num_kps,
                          kp_vertex_ids=None, sfm_kp_points=S)


def net_leaves(cell) -> dict:
    a = options(cell)
    cfg = build_cfg(a)
    template = build_template_of(cfg, a)
    m = cfg.model
    with torch.device("meta"):
        model = MeshNet(template, img_size=m.img_size, nz_feat=m.nz_feat,
                        predict_texture=m.texture, use_camera_layernorm=m.use_camera_layernorm,
                        scale_lr=m.scale_lr, small_camera_init=m.small_camera_init,
                        learnable_kp=m.learnable_kp)
        lp = LPIPS()
    return {"meshnet": W.leaves_of(model), "lpips": W.leaves_of(lp)}


def weights_of(cell, seed: int, device, nets=("meshnet", "lpips")) -> dict:
    leaves = net_leaves(cell)
    rules = cell.config["weights"]
    order = ("meshnet", "lpips")
    return {net: W.make_weights({net: (leaves[net], rules[net])},
                                weight_seed(seed, order.index(net)), device)[net] for net in nets}


def dataset(cell, seed: int, split: str = "train", mirror: bool = True) -> CUBDataset:
    a = options(cell)
    return CUBDataset(a.cub_dir, a.cub_cache_dir, split=split, img_size=a.img_size,
                      seed=data_seed(seed), mirror=mirror)


def build_mods(cell, seed: int, device, dtype: str = "float32"):
    a = options(cell)
    cfg = build_cfg(a)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype=dtype))
    mods = mono.build(cfg, build_template_of(cfg, a), seed=cfg.train.seed, device=device)
    w = weights_of(cell, seed, device)
    W.load_into(mods.model, w["meshnet"])
    W.load_into(mods.lpips, w["lpips"])
    return mods


def net_flops(cell, device) -> tuple:
    """(MeshNet with its texture decoder, LPIPS) operations of one image,
    counted by hooks on the reference's modules."""
    a = options(cell)
    cfg = build_cfg(a)
    template = build_template_of(cfg, a)
    S = a.img_size
    dev = torch.device(device)
    model = MeshNet(template, img_size=S, nz_feat=a.nz_feat, predict_texture=True).to(dev).eval()
    img = torch.zeros(1, S, S, 3, device=dev)

    def mesh_call():
        out = model(img)
        model.textures(out["res_feats"])

    mesh = count_flops(model, mesh_call)
    lp = LPIPS().to(dev).eval()
    return mesh, count_flops(lp, lambda: lp(img, img)), template.num_verts


# --------------------------------------------------------------------------
# single-image prediction
# --------------------------------------------------------------------------

def request_batch(ds, index: int) -> dict:
    """One request as the program's loader prepares a batch of one: the
    image decoded, cropped and resized (data/cub.py), its mask geometry."""
    from .frozen.data.loader import add_mask_geometry, collate

    return add_mask_geometry(collate([ds[int(index)]]))


def predict_answer(out: dict) -> dict:
    return {k: out[k] for k in ("verts", "cam_pred", "kp_pred", "mask_pred")}


def run_predict_reference(cell, seed: int, device, indices, control: str | None = None) -> dict:
    """The reference's answers to the requests of `indices` (test-split
    images), one at a time. control: None or "bf16"."""
    from .frozen.eval import predictor

    ds = dataset(cell, seed, split="test", mirror=False)
    answers = []
    with precision(cell.config["precision"]):
        mods = build_mods(cell, seed, device, "bfloat16" if control == "bf16" else "float32")
        for i in indices:
            answers.append(predict_answer(predictor.predict_monocular(
                mods, request_batch(ds, int(i) % len(ds)))))
    return {"answers": answers}


def predict_numbers(prog: dict, ref: dict) -> dict:
    """The worst over the compared requests: the vertices (vector
    relative), the camera, the keypoints and the mask (largest absolute)."""
    out = {"verts": 0.0, "cam": 0.0, "kp": 0.0, "mask": 0.0}
    for pa, ra in zip(prog["answers"], ref["answers"]):
        out["verts"] = max(out["verts"], C.vector_rel(pa["verts"], ra["verts"]))
        out["cam"] = max(out["cam"], C.max_abs(pa["cam_pred"], ra["cam_pred"]))
        out["kp"] = max(out["kp"], C.max_abs(pa["kp_pred"], ra["kp_pred"]))
        out["mask"] = max(out["mask"], C.max_abs(pa["mask_pred"], ra["mask_pred"]))
    if len(prog["answers"]) != len(ref["answers"]) or not ref["answers"]:
        out = {k: float("inf") for k in out}
    return out


def compare_predict(cell, seed: int, device, cap) -> dict:
    ref = run_predict_reference(cell, seed, device, cap["indices"])
    return predict_numbers(cap, ref)


def control_predict(cell, seed: int, device, kind: str) -> dict:
    idx = list(range(cell.traffic["control_requests"]))
    return predict_numbers(run_predict_reference(cell, seed, device, idx, kind),
                           run_predict_reference(cell, seed, device, idx))


def predict_flops(cell, device) -> float:
    """One request: MeshNet and its texture decoder over one image, forward;
    the solve."""
    mesh, _, V = net_flops(cell, device)
    return float(mesh + solve_flops(V, 3))
