"""The reference of the camera-multiplex recipe for horses without keypoints
(upstream docs/setup_video.md, "Train horses w/o keypoints"): the first
steps of the timed path worked out again in plain PyTorch, f32 with TF32
off, as reference/multiframe.py does for the CLI's defaults.

What differs from that reference: the data are the TigDog-format tree and
a YouTube-VIS-format tree of mask-only clips, mixed as the CLI's
--expand_ytvis mixes them (TigDog first); the step keeps the k hypotheses
that the recipe's drop schedule gives the traffic's epoch; and the
multiplex starts from a state drawn from the seed (`write_multiplex`), as a
run that reached that epoch has one. The frozen modules (az-el decode,
top-k, the deformation tables) are the same files.
"""
from __future__ import annotations

import os

import torch

from ..harness import weights as W
from ..harness.data import _make
from . import multiframe as base
from .common import (TF32_ALL, count_flops, data_seed, loader_seed, precision, solve_flops,
                     weight_seed)
from .frozen.data import tigdog as tig
from .frozen.data.loader import DataLoader
from .frozen.flow import infer as flow_infer
from .frozen.flow import maskflownet as mfn
from .frozen.models.lpips import LPIPS
from .frozen.models.mesh_net import MeshNet
from .frozen.train import multiframe as mf
from .frozen.train import prefetch


def hypotheses_at(epoch: int, num_guesses: int, drop: bool) -> int:
    """The hypotheses a main-loop step of `epoch` keeps per frame: the
    recipe's drop schedule (upstream train_utils.py, the docs' "all -> 4 ->
    2"), every one up to epoch 20, then 4, then 2 after epoch 100."""
    if not drop or epoch <= 20:
        return num_guesses
    return min(4 if epoch <= 100 else 2, num_guesses)


def mixed(spec: dict) -> dict:
    """The TigDog-format tree (`videos` x `frames` at `raw`), the
    YouTube-VIS-format tree (`yt_videos` x `yt_frames` at `yt_raw`) and the
    per-frame cache of their concatenation, made once per checkout:
    {"root_dir", "root_dir_yt", "tmp_dir", "category"}."""
    from ..harness.fixtures.tigdog_fixture import write_tigdog_tree
    from ..harness.fixtures.ytvis_fixture import write_ytvis_tree

    cat = spec["category"]

    def paths(d):
        return {"root_dir": os.path.join(d, "videos"), "root_dir_yt": os.path.join(d, "videos_yt"),
                "tmp_dir": os.path.join(d, "frames"), "category": cat}

    def build(tmp):
        p = paths(tmp)
        write_tigdog_tree(p["root_dir"], cat, spec["videos"], spec["frames"], tuple(spec["raw"]),
                          spec["seed"])
        write_ytvis_tree(p["root_dir_yt"], cat, spec["yt_videos"], spec["yt_frames"],
                         tuple(spec["yt_raw"]), spec["yt_seed"])
        tig.explode_to_frames(video_dataset(p, spec["num_kps"]), p["tmp_dir"], cat,
                              max(spec["frames"], spec["yt_frames"]))

    return paths(_make(spec, build))


def video_dataset(o: dict, num_kps: int):
    """TigDog's train split, then every YouTube-VIS clip (split "all")."""
    cat = o["category"]
    return tig.ConcatDataset([tig.VideoPklDataset(o["root_dir"], cat, split="train",
                                                  num_kps=num_kps),
                              tig.YTVISPklDataset(o["root_dir_yt"], cat, num_kps=num_kps)])


def options(cell) -> dict:
    o = dict(cell.config["cli"])
    o.update(mixed(cell.config["dataset"]))
    return o


def num_hypotheses(cell) -> int:
    """k at the traffic's epoch."""
    o = cell.config["cli"]
    return hypotheses_at(cell.traffic["start_epoch"], o["num_guesses"],
                         o["drop_hypothesis"] and not o["use_gtpose"])


def multiplex_seed(seed: int) -> int:
    """The drawn multiplex state's generator seed (the weights take
    seed * 8 + 0..2)."""
    return int(seed) * 8 + 3


@torch.no_grad()
def write_multiplex(mpx, cell, seed: int) -> None:
    """The multiplex state of a run at the traffic's epoch, drawn from the
    seed on the tables' device: every frame's probabilities a softmax over
    the hypotheses of `probs_logit_std` x N(0, 1), and the camera table the
    program's initial one plus `cams_spread` x N(0, 1) per column. The
    deformation tables keep their zeros. Written in place into `mpx` (the
    program's or the reference's Multiplex module)."""
    st = cell.config["multiplex_state"]
    G, N, C = mpx.cams.shape
    gen = torch.Generator(device=mpx.cams.device).manual_seed(multiplex_seed(seed))
    noise = torch.randn(G, N, C, generator=gen, device=mpx.cams.device)
    logits = torch.randn(N, G, generator=gen, device=mpx.cams.device)
    spread = torch.tensor(st["cams_spread"], dtype=noise.dtype, device=noise.device)
    mpx.cams.add_(noise * spread)
    mpx.probs.copy_(torch.softmax(st["probs_logit_std"] * logits, dim=1))


def net_leaves(cell) -> dict:
    """(name, shape) of every parameter of the three nets (reference/
    multiframe.py's, on this configuration's options)."""
    cfg = base.build_cfg(options(cell))
    template = base.build_template_of(cfg)
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
    return {net: W.make_weights({net: (leaves[net], rules[net])},
                                weight_seed(seed, order.index(net)), device)[net]
            for net in nets}


def flow_weights(cell, seed: int, device) -> dict:
    return weights_of(cell, seed, device, nets=("flow",))["flow"]


def batches(cell, seed: int, n: int) -> tuple:
    """The first `n` batches of the run's loader, on the host, the number of
    frames and the batches of an epoch."""
    o = options(cell)
    tr = cell.traffic
    n_frames, s2v, spv = tig.explode_to_frames(
        video_dataset(o, o["num_kps"]), o["tmp_dir"], o["category"], o["num_training_frames"],
        write=False)
    ds = tig.MultiFrameDataset(mirror=o["mirror"], transforms=tr["augment"],
                               seed=data_seed(seed), **base.dataset_kwargs(o, s2v, spv))
    loader = DataLoader(ds, o["batch_size"], shuffle=tr["shuffle"], seed=loader_seed(seed))
    out = []
    for b in loader:
        out.append(b)
        if len(out) == n:
            break
    return out, n_frames, len(loader)


def run_reference(cell, seed: int, device, n: int, control: str | None = None) -> dict:
    """The reference's first `n` steps at k = num_hypotheses(cell) from the
    drawn multiplex state. control: None (f32, TF32 off), "tf32" (the same
    in TF32), "half_batch" (the first half of every batch's clips)."""
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
        cfg = base.build_cfg(o)
        mods = mf.build(cfg, base.build_template_of(cfg), n_frames, seed=cfg.train.seed,
                        steps_per_epoch=spe, device=device)
        w = weights_of(cell, seed, device, nets=("meshnet", "lpips"))
        W.load_into(mods.model, w["meshnet"])
        W.load_into(mods.lpips, w["lpips"])
        write_multiplex(mods.mpx, cell, seed)
        step = mf.make_train_step(mods, k=num_hypotheses(cell), drop_deform=True)
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


def compare(cell, seed: int, device, cap) -> dict:
    """The numbers of the program's capture against the reference."""
    ref = run_reference(cell, seed, device, cap.n)
    return base.numbers(base.from_capture(cap, ref["beta1"]), ref)


def control(cell, seed: int, device, kind: str) -> dict:
    """The numbers of the reference run as `kind` in the program's place."""
    n = cell.traffic["capture_steps"]
    ref = run_reference(cell, seed, device, n)
    other = run_reference(cell, seed, device, n, control=kind)
    other["batches"] = None
    return base.numbers(other, ref)


def step_flops(cell, device) -> float:
    """reference/multiframe.py::step_flops at the k hypotheses the step
    keeps: MeshNet (and its texture decoder) over the B*T frames, trained
    (3x forward); LPIPS over the 2*k*B*T rendered and mirrored images,
    frozen with gradients through it (2x); the flow net over the B*(T-1)
    pairs, forward only; the solve; the cost volumes."""
    from ..harness.bench import GPUBENCH, load_module

    o = options(cell)
    cfg = base.build_cfg(o)
    template = base.build_template_of(cfg)
    S, B, T = o["img_size"], o["batch_size"], o["num_frames"]
    k = num_hypotheses(cell)
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
    flow = count_flops(net, lambda: flow_infer.predict_pair_flow(
        net, img, img, S, tuple(cell.config["flow_net_hw"])))
    corr = load_module(os.path.join(GPUBENCH, "kernels", "correlation.py"))
    pairs = B * (T - 1)
    total = (3 * mesh * B * T + 2 * lpips * 2 * k * B * T + flow * pairs
             + solve_flops(template.num_verts, 3 * B * T)
             + corr.ops_per_pass(cell.config) * pairs)
    return float(total)
