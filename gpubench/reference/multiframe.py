"""The multiframe training reference: the first steps of the timed path
worked out again in plain PyTorch, f32 with TF32 off (the configuration's
precision).

From the configuration, the seed and the raw data set alone it builds the
same data (the frozen data layer with the run's seeds: the same clips, the
same augmentation), the same weights (harness/weights.py), the multiplex
tables (the frozen init), the flows (the frozen MaskFlownet with the plain
cost volume) and runs the frozen multiframe step (plain rasterizer) for as
many steps as the program's capture holds. `compare` gives the numbers
that decide `correct`; `control` runs the same in another precision, or
with a fault planted, in the program's place.
"""
from __future__ import annotations

import torch

from ..harness import compare as C
from ..harness import weights as W
from ..harness.bench import log
from ..harness.data import tigdog
from .common import (TF32_ALL, count_flops, data_seed, loader_seed, precision,  # noqa: F401
                     set_precision, solve_flops, weight_seed)
from .frozen import config as cfg_lib
from .frozen.data import tigdog as tig
from .frozen.data.loader import DataLoader
from .frozen.flow import infer as flow_infer
from .frozen.flow import maskflownet as mfn
from .frozen.models.lpips import LPIPS
from .frozen.models.mesh_net import MeshNet
from .frozen.models.template import build_template
from .frozen.train import multiframe as mf
from .frozen.train import prefetch


def build_cfg(o: dict) -> cfg_lib.Config:
    """The multiframe CLI's build_cfg (cli/multiframe_main.py) over the
    frozen config."""
    import dataclasses

    return cfg_lib.Config(
        model=dataclasses.replace(
            cfg_lib.ModelConfig(), img_size=o["img_size"], nz_feat=o["nz_feat"],
            num_lbs=o["num_lbs"], subdivide=o["subdivide"], num_kps=o["num_kps"],
            texture=o["texture"], symmetric=False, symmetric_texture=False, mesh_path=None,
            kp_dict_path=None, scale_mesh=o["scale_mesh"]),
        mf_weights=dataclasses.replace(
            cfg_lib.MultiframeLossWeights(), kp=o["kp_loss_wt"], of=o["of_loss_wt"],
            mask=o["mask_loss_wt"], boundaries=o["boundaries_reg_wt"], edt=o["edt_reg_wt"],
            bdt=o["bdt_reg_wt"], rigid=o["rigid_wt"], triangle=o["triangle_reg_wt"],
            tex=o["tex_loss_wt"], cam=o["cam_loss_wt"], deform_reg=o["deform_reg_wt"],
            deform=o["deform_loss_wt"], handle_deform_reg=o["handle_deform_reg_wt"]),
        multiplex=dataclasses.replace(
            cfg_lib.MultiplexConfig(), num_guesses=o["num_guesses"], az_el_cam=o["az_el_cam"],
            az_el_quat_bias=o["az_el_quat_bias"], optimize_deform=o["optimize_deform"],
            optimize_deform_lr=o["optimize_deform_lr"], drop_hypothesis=o["drop_hypothesis"],
            scale_lr_decay=o["scale_lr_decay"], scale_bias=o["scale_bias"],
            az_euler_range=o["az_euler_range"], el_euler_range=o["el_euler_range"],
            cyc_euler_range=o["cyc_euler_range"]),
        train=dataclasses.replace(
            cfg_lib.TrainConfig(), batch_size=o["batch_size"], num_frames=o["num_frames"],
            learning_rate=o["learning_rate"], warmup_lr=o["warmup_lr"],
            use_gtpose=o["use_gtpose"], multistep_lr=o["multistep_lr"],
            separate_camera_opt=o["separate_camera_opt"],
            camera_learning_rate=o["camera_learning_rate"], offset_z=0.0),
    )


def build_template_of(cfg: cfg_lib.Config):
    m = cfg.model
    return build_template(None, None, subdivide=m.subdivide, num_lbs=m.num_lbs,
                          tex_size=m.tex_size, symmetric=False, symmetric_texture=False,
                          num_kps=m.num_kps, kp_vertex_ids=None, scale_mesh=m.scale_mesh)


def dataset_kwargs(o: dict, s2v: dict, spv: dict) -> dict:
    """The clip dataset's arguments as the multiframe CLI's `train` makes
    them (TigDog categories: the dataset's own bboxes and crop, no neck)."""
    is_tigdog = o["category"] in ("horse", "tiger")
    return dict(tmp_dir=o["tmp_dir"], category=o["category"], sample_to_vid=s2v,
                samples_per_vid=spv, num_frames=o["num_frames"], img_size=o["img_size"],
                tight_bboxes=o["tight_bboxes"] or not is_tigdog,
                v2_crop=o["v2_crop"] or not is_tigdog, padding_frac=o["padding_frac"],
                remove_neck_kp=is_tigdog)


def options(cell) -> dict:
    """The flags the configuration states (the CLI's defaults it lists)."""
    o = dict(cell.config["cli"])
    o.update(tigdog(cell.config["dataset"]))
    return o


def net_leaves(cell) -> dict:
    """(name, shape) of every parameter of the three nets, from the
    reference's own modules built without storage."""
    cfg = build_cfg(options(cell))
    template = build_template_of(cfg)
    with torch.device("meta"):
        model = MeshNet(template, img_size=cfg.model.img_size, nz_feat=cfg.model.nz_feat,
                        predict_texture=cfg.model.texture, use_camera_layernorm=True,
                        scale_lr=cfg.model.scale_lr, small_camera_init=True,
                        learnable_kp=cfg.model.learnable_kp)
        lp = LPIPS()
        flow = mfn.MaskFlownet()
    return {"meshnet": W.leaves_of(model), "lpips": W.leaves_of(lp),
            "flow": [(n, tuple(t.shape)) for n, t in flow.state_dict().items()]}


def weights_of(cell, seed: int, device, nets=("meshnet", "lpips", "flow")) -> dict:
    leaves = net_leaves(cell)
    rules = cell.config["weights"]
    order = ("meshnet", "lpips", "flow")
    return {net: W.make_weights({net: (leaves[net], rules[net])}, weight_seed(seed, order.index(net)),
                                device)[net] for net in nets}


def flow_weights(config_cell, seed: int, device) -> dict:
    return weights_of(config_cell, seed, device, nets=("flow",))["flow"]


def batches(cell, seed: int, n: int) -> tuple:
    """The first `n` batches of the run's loader, on the host, and the
    number of frames."""
    o = options(cell)
    tr = cell.traffic
    n_frames, s2v, spv = tig.explode_to_frames(
        tig.VideoPklDataset(o["root_dir"], o["category"], split="train", num_kps=o["num_kps"]),
        o["tmp_dir"], o["category"], o["num_training_frames"], write=False)
    ds = tig.MultiFrameDataset(mirror=o["mirror"], transforms=tr["augment"],
                               seed=data_seed(seed), **dataset_kwargs(o, s2v, spv))
    loader = DataLoader(ds, o["batch_size"], shuffle=tr["shuffle"], seed=loader_seed(seed))
    out = []
    for b in loader:
        out.append(b)
        if len(out) == n:
            break
    return out, n_frames, len(loader)


def build_mods(cell, seed: int, device, n_frames: int, steps_per_epoch: int, dtype=None):
    o = options(cell)
    cfg = build_cfg(o)
    template = build_template_of(cfg)
    mods = mf.build(cfg, template, n_frames, seed=cfg.train.seed,
                    steps_per_epoch=steps_per_epoch, device=device)
    w = weights_of(cell, seed, device, nets=("meshnet", "lpips"))
    W.load_into(mods.model, w["meshnet"])
    W.load_into(mods.lpips, w["lpips"])
    return mods


def run_reference(cell, seed: int, device, n: int, control: str | None = None) -> dict:
    """The reference's first `n` steps. control: None (f32, TF32 off),
    "tf32" (the same in TF32), "half_batch" (the first half of every batch's
    clips, the mean over them)."""
    host, n_frames, spe = batches(cell, seed, n)
    with precision(TF32_ALL if control == "tf32" else cell.config["precision"]):
        net = mfn.build(flow_weights(cell, seed, device), device)
        o = options(cell)
        flow_fn = flow_infer.make_flow_fn(net, o["img_size"], tuple(cell.config["flow_net_hw"]))
        dev = []
        for b in host:
            db = prefetch.to_device(b, mf.BATCH_KEYS, torch.device(device), int_keys=mf.INT_KEYS)
            if control == "half_batch":
                B, T = db["frames_idx"].shape
                db = {k: v[:(B // 2) * (T if v.shape[0] == B * T != B else 1)]
                      for k, v in db.items()}
            dev.append(flow_fn(db))
        del net
        mods = build_mods(cell, seed, device, n_frames, spe)
        k = mods.cfg.multiplex.num_guesses
        step = mf.make_train_step(mods, k=k, drop_deform=True)
        params = {f"model.{a}": p for a, p in mods.model.named_parameters()}
        params.update({f"mpx.{a}": p for a, p in mods.mpx.named_parameters()})
        p0 = {a: p.detach().clone() for a, p in params.items()}
        losses, m1, probs1 = [], None, None
        for i, db in enumerate(dev):
            metrics = step(db)
            losses.append(float(metrics["total_loss"]))
            if i == 0:
                m1 = {a: mods.opt.state[p]["exp_avg"].detach().clone()
                      for a, p in params.items() if p in mods.opt.state}
                probs1 = mods.mpx.probs.detach().clone()
        pn = {a: p.detach().clone() for a, p in params.items()}
    beta1 = mods.cfg.train.beta1
    return {"batches": host, "flows": [d["optical_flows"] for d in dev], "losses": losses,
            "grad1": {a: v / (1 - beta1) for a, v in m1.items()}, "probs1": probs1, "p0": p0,
            "pn": pn, "beta1": beta1}


def numbers(prog: dict, ref: dict) -> dict:
    """The compared numbers of a multiframe capture against the reference."""
    keys = C.moved_keys(ref["grad1"])
    data = 0.0
    if prog.get("batches") is not None:
        for pb, rb in zip(prog["batches"], ref["batches"]):
            for k in mf.BATCH_KEYS:
                data = max(data, C.max_abs(torch.as_tensor(pb[k]).cpu().double(),
                                           torch.as_tensor(rb[k]).double()))
    flow = max(C.vector_rel(pf, rf) for pf, rf in zip(prog["flows"], ref["flows"]))
    loss1 = C.rel(prog["losses"][0], ref["losses"][0])
    return {
        "data": data,
        "flow": flow,
        "loss1": loss1,
        "probs1": C.max_abs(prog["probs1"], ref["probs1"]),
        "grad1": C.norm_gap(prog["grad1"], ref["grad1"], what="grad1"),
        "change": C.change_gap(prog["p0"], prog["pn"], ref["p0"], ref["pn"], keys),
        "start": C.start_gap(prog["p0"], ref["p0"]),
    }


def from_capture(cap, beta1: float = 0.9) -> dict:
    """The program's side of `numbers` from a train_loop.Capture."""
    return {
        "batches": [{k: v.detach().cpu() for k, v in b.items()} for b in cap.batches],
        "flows": [b["optical_flows"] for b in cap.batches],
        "losses": [float(m["total_loss"]) for m in cap.metrics],
        "grad1": {a: v / (1 - beta1) for a, v in cap.m1.items()},
        "probs1": cap.after1["probs"],
        "p0": cap.p0,
        "pn": cap.pn,
    }


def compare(cell, seed: int, device, cap) -> dict:
    """The numbers of the program's capture against the reference."""
    ref = run_reference(cell, seed, device, cap.n)
    return numbers(from_capture(cap, ref["beta1"]), ref)


def control(cell, seed: int, device, kind: str) -> dict:
    """The numbers of the reference run as `kind` (run_reference's control)
    in the program's place, against the reference."""
    n = cell.traffic["capture_steps"]
    ref = run_reference(cell, seed, device, n)
    other = run_reference(cell, seed, device, n, control=kind)
    other["batches"] = None
    return numbers(other, ref)


def step_flops(cell, device) -> float:
    """The work of one multiframe train step at the cell's shapes: MeshNet
    (and its texture decoder) over the B*T frames, trained (3x forward);
    LPIPS over the 2*k*B*T rendered and mirrored images, frozen with
    gradients through it (2x); the flow net over the B*(T-1) pairs,
    forward only; the solve; the cost volumes (kernels/correlation.py). The
    convolutions and linear layers are counted by hooks on the reference's
    modules at batch 1, times the batch."""
    from ..harness.bench import GPUBENCH, load_module
    import os

    o = options(cell)
    cfg = build_cfg(o)
    template = build_template_of(cfg)
    S, B, T = o["img_size"], o["batch_size"], o["num_frames"]
    k = o["num_guesses"]
    dev = torch.device(device)
    model = MeshNet(template, img_size=S, nz_feat=o["nz_feat"], predict_texture=True,
                    use_camera_layernorm=True, small_camera_init=True).to(dev).eval()
    img = torch.zeros(1, S, S, 3, device=dev)

    def mesh_call():
        out = model(img)
        model.textures(out["res_feats"])

    mesh = count_flops(model, mesh_call)
    lp = LPIPS().to(dev).eval()
    lpips = count_flops(lp, lambda: lp(img, img))
    net = mfn.MaskFlownet().to(dev).eval()
    pair = torch.zeros(1, S, S, 3, device=dev)
    flow = count_flops(net, lambda: flow_infer.predict_pair_flow(
        net, pair, pair, S, tuple(cell.config["flow_net_hw"])))
    corr = load_module(os.path.join(GPUBENCH, "kernels", "correlation.py"))
    pairs = B * (T - 1)
    total = (3 * mesh * B * T + 2 * lpips * 2 * k * B * T + flow * pairs
             + solve_flops(template.num_verts, 3 * B * T)
             + corr.ops_per_pass(cell.config) * pairs)
    return float(total)
