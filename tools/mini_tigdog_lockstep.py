"""The mini-TigDog run of the JAX package, held snapshot by snapshot against the PyTorch port.

    env JAX_PLATFORMS=cpu python tools/mini_tigdog_lockstep.py dump DIR
        [--img 64] [--videos 24] [--epochs 40] [--reps 2] [--at 1,2,5,...]
    python3 tools/mini_tigdog_lockstep.py hold DIR [--device cpu|cuda]
        [--steps [--spread N]] [--epoch_from LABELS --threads N,M] [--eval]
        [--free kernels|plain|both]
    python3 tools/mini_tigdog_lockstep.py pack DIR --to DEST --labels init
        [--img 64] [--videos 24]
    python3 tools/mini_tigdog_lockstep.py batches DIR --to F.npz [--against G.npz]
    python3 tools/mini_tigdog_lockstep.py trap DIR [--img 64] [--seed N] --device cuda

`dump` (JAX, on the CPU) generates the JAX tool's tree
(tools/mini_tigdog_parity.py, its constants scaled by --img / --videos as
its main scales them) under DIR/root and trains the JAX CLI's `train` with
that tool's options (tools/torch_mini_tigdog_parity.py::train_opts, the
port tool's copy of them) at log_every 1. It writes DIR/snap_<label>.pkl,
numpy only, at these points: `init` (after the init_camera_emb pass),
`warm<r>` (after warm-up rep r) and `epoch<e>` (after main-loop epoch e,
for e in --at and the last epoch). Each holds the state (params,
batch_stats, the camera table and probabilities, both Adam states, the
step count), the next step's batch, k, loss matrix, metrics and the state
after it. DIR/meta.json holds the options, the steps per epoch, the
loader's and the dataset's numpy generator states at the start of every
pass over the loader (pass 0 is warm-up rep 1), the frame indices of every
step; JAX's evaluate CLI on the final checkpoint for EVAL_COLUMNS leaves
DIR/eval_<column>.npz. DIR/metrics.jsonl is the JAX run's log.

`hold` (the port; imports no JAX; on the CPU or the card) reads DIR:
  --steps   3a: from each snapshot one step on its next batch (the pose
            warm-up step or the main-loop step at its k), against JAX's:
            loss matrix, metrics and probabilities rtol 1e-3, the gradients
            (from Adam's first moments, g = (mu' - b1 mu) / (1 - b1)) and
            Adam's update at the step tests' bounds
            (tests/test_torch_port_multiframe.py), the BatchNorm running
            statistics and the camera table after the step; --spread N
            adds the port's own spread (port_spread: the step at N CPU
            threads, and with the solve's output moved by PERTURB).
  --epoch_from  3b: from each named snapshot one pass over the loader (a
            warm-up rep or a main-loop epoch) through the port's steps, the
            loader and the dataset seeded with JAX's generator states (the
            frame indices checked against JAX's), per --threads count; per
            step the loss terms against JAX's metrics.jsonl, at the end the
            multiplex report (tools/torch_mini_tigdog_parity.py) against
            JAX's next snapshot, and each thread count against the first.
  --eval    3c: JAX's final state as a port checkpoint through the port's
            evaluate CLI for EVAL_COLUMNS against JAX's results: IoU within
            1e-3, PCK within one keypoint's share, cameras within 1e-4
            (tests/test_torch_port_multiframe_evaluate.py's bounds).
  --free    the port's whole run from JAX's init through its CLI (hold_free).
It prints one JSON line per check and writes DIR/hold_<device>[_free_*].json;
exit 1 when a bound of 3a or 3c fails (3b has no bound: free runs part at
rounding level, so it is read against the port's own spread).

`pack` copies what `hold --free` needs into DEST, small enough for the
card's machine; `batches` compares two hosts' loader batches; `trap`
trains the port tool's run with a check of every gradient before Adam's
update and the solve's Cholesky recorded per step (nan_trap).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import os.path as osp
import pickle
import shutil
import sys
import time

import numpy as np

TOOLS = osp.dirname(osp.abspath(__file__))
REPO = osp.dirname(TOOLS)
sys.path.insert(0, REPO)
sys.path.insert(0, TOOLS)

EVAL_COLUMNS = ("after", "train_argmax", "gtcam_al")
AT = (1, 2, 5, 6, 10, 11, 20, 21, 30, 31, 39)
B1 = 0.9  # the Adams' beta1 at the tool's options (train.beta1, optax's default for warm-up)
# the loss terms read off the mask (tests/test_torch_port_multiframe.py)
MASK_TERMS = ("mask_loss", "edt_loss", "bdt_loss", "sil_cons", "total_loss", "warmup_loss",
              "kp_loss")


def _labels(n_reps: int, epochs: int, at) -> list:
    return (["init"] + [f"warm{r}" for r in range(1, n_reps + 1)]
            + [f"epoch{e}" for e in sorted(set(at) | {epochs}) if 1 <= e <= epochs])


def _pass_of(label: str, n_reps: int) -> int:
    """The loader pass that follows snapshot `label` (0 = warm-up rep 1)."""
    if label == "init":
        return 0
    if label.startswith("warm"):
        return int(label[4:])
    return n_reps + int(label[5:])


def _label_after(steps: int, spe: int, n_reps: int, labels) -> str | None:
    """The snapshot label after `steps` steps in all, if one is taken there."""
    if steps % spe:
        return None
    p = steps // spe
    label = f"warm{p}" if p <= n_reps else f"epoch{p - n_reps}"
    return label if label in labels else None


# --------------------------------------------------------------------------
# dump (JAX)
# --------------------------------------------------------------------------

def _jax_adam(opt_state) -> dict:
    """optax's ScaleByAdamState inside an Adam chain's state, as numpy."""
    import jax

    for part in opt_state:
        if hasattr(part, "mu") and hasattr(part, "nu"):
            return {"count": int(part.count), "mu": jax.tree_util.tree_map(np.asarray, part.mu),
                    "nu": jax.tree_util.tree_map(np.asarray, part.nu)}
    raise ValueError("no ScaleByAdamState in the optimizer state (only plain Adam is dumped)")


def _jax_state(state) -> dict:
    import jax

    tree = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731
    mpx = state.multiplex
    if mpx.deform is not None:
        raise ValueError("the dump carries no deform tables (the tool's runs train none)")
    return {"params": tree(state.params), "batch_stats": tree(state.batch_stats),
            "cams": np.asarray(mpx.cams), "probs": np.asarray(mpx.probs),
            "full": _jax_adam(state.opt_state), "warm": _jax_adam(state.warmup_opt_state),
            "step": int(state.step)}


def _gen_state(rng) -> dict:
    return rng.bit_generator.state


# model options a test shrinks (the evaluate CLI must rebuild the same model)
SHAPE_OPTS = ("subdivide", "nz_feat", "num_kps", "kp_dict")


def static_meta(out, img, videos, epochs, reps, at, overrides=None) -> dict:
    """What the dump fixes before training: the JAX tool's constants scaled
    by img / videos as its main scales them (set on its module, which
    imports numpy only), the training options (tools/
    torch_mini_tigdog_parity.py::train_opts, the port tool's copy of the
    JAX tool's, at log_every 1) for the tree DIR/root with `overrides` on
    top, and the labels. eval_extra: the evaluate flags of the overridden
    SHAPE_OPTS."""
    import mini_tigdog_parity as jt
    import torch_mini_tigdog_parity as tt

    if videos:
        jt.N_VIDEOS = videos
    if img:
        jt.RAW = round(img * jt.RAW / jt.IMG)
        jt.IMG = img
    tt.IMG = jt.IMG
    o = tt.train_opts(osp.join(out, "root"), epochs)
    o.pop("device")
    o.update(img_size=jt.IMG, num_reps=reps, log_every=1, save_epoch_freq=max(epochs, 1),
             save_latest_freq=0, **(overrides or {}))
    extra = [f for k in SHAPE_OPTS if k in (overrides or {}) for f in (f"--{k}", str(o[k]))]
    return {"opts": o, "img": jt.IMG, "raw": jt.RAW, "videos": jt.N_VIDEOS, "epochs": epochs,
            "reps": reps, "labels": _labels(reps, epochs, at), "eval_extra": extra}


def jax_evaluate(o: dict, extra: list) -> None:
    """The JAX package's evaluate CLI in this process (absl flags parsed,
    then unparsed), with the port tool's evaluate arguments (tools/
    torch_mini_tigdog_parity.py::eval_argv, the JAX tool's run_eval
    arguments) less --device; writes o's tmp_dir/eval/results.npz."""
    from absl import flags

    import torch_mini_tigdog_parity as tt
    from acfm_video_3d_reconstruction_tpu.cli import multiframe_evaluate as jeval

    argv = tt.eval_argv(dict(o, device="cpu"), extra)
    i = argv.index("--device")
    del argv[i:i + 2]
    flags.FLAGS(["multiframe_evaluate"] + argv)
    try:
        jeval.main(None)
    finally:
        flags.FLAGS.unparse_flags()


def dump(out, img, videos, epochs, reps, at, skip_gen=False, overrides=None):
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["ACFM_FORCE_CPU"] = "1"
    os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", osp.join(out, "jax_cache"))
    import jax

    import mini_tigdog_parity as jt
    import torch_mini_tigdog_parity as tt
    from acfm_video_3d_reconstruction_tpu.cli import multiframe_main as jcli
    from acfm_video_3d_reconstruction_tpu.models import build_template
    from acfm_video_3d_reconstruction_tpu.train import driver as jdriver
    from acfm_video_3d_reconstruction_tpu.train import multiframe as jmf

    meta = static_meta(out, img, videos, epochs, reps, at, overrides)
    o, labels = meta["opts"], meta["labels"]
    os.makedirs(out, exist_ok=True)
    if not skip_gen:
        jt.generate(o["root_dir"], build_template(
            subdivide=3, num_lbs=jt.NUM_LBS, tex_size=2, num_kps=jt.NUM_KPS,
            kp_vertex_ids=[np.asarray([a]) for a in jt.ANCHORS]))
    meta.update(passes=[], frames=[], cpu_count=os.cpu_count())
    rec = {"steps": 0, "pending": None, "lm": None, "spe": None}

    def write(label, pre, batch, k, kind, after, metrics, lm):
        with open(osp.join(out, f"snap_{label}.pkl"), "wb") as fh:
            pickle.dump({"label": label, "state": pre, "batch": batch, "k": k, "kind": kind,
                         "after": after, "metrics": metrics, "loss_matrix": lm}, fh)
        print(f"[dump] snapshot {label} at step {pre['step']}", flush=True)

    def wrap(step, k, kind):
        def run(state, batch):
            if rec["steps"] == 0 and rec["pending"] is None:
                rec["pending"] = ("init", _jax_state(state))
            nb = None
            if rec["pending"] is not None:
                nb = jax.tree_util.tree_map(np.asarray, batch)
            meta["frames"].append(np.asarray(batch["frames_idx"]).tolist())
            new, metrics = step(state, batch)
            rec["steps"] += 1
            if rec["pending"] is not None:
                label, pre = rec["pending"]
                write(label, pre, nb, k, kind, _jax_state(new),
                      {n: float(v) for n, v in metrics.items()}, rec["lm"])
                rec["pending"] = None
            label = _label_after(rec["steps"], rec["spe"], reps, labels)
            if label is not None:
                rec["pending"] = (label, _jax_state(new))
            return new, metrics
        return run

    real_warm, real_train = jmf.make_warmup_step, jmf.make_train_step
    real_run, real_pgl = jdriver.run_multiframe_training, jmf._per_guess_losses

    def make_warm(mods, tx, **kw):
        return wrap(real_warm(mods, tx, **kw), mods.cfg.multiplex.num_guesses, "warm")

    def make_train(mods, tx, **kw):
        return wrap(real_train(mods, tx, **kw), kw["k"], "train")

    def pgl(*a, **kw):
        res = real_pgl(*a, **kw)
        jax.debug.callback(lambda lm: rec.__setitem__("lm", np.asarray(lm)), res[0])
        return res

    def run_training(cfg, template, loader, *a, **kw):
        rec["spe"] = len(loader)
        meta["steps_per_epoch"] = len(loader)
        real_indices = loader._epoch_indices

        def epoch_indices():
            meta["passes"].append({"loader": _gen_state(loader.rng),
                                   "dataset": _gen_state(loader.dataset.rng)})
            return real_indices()

        loader._epoch_indices = epoch_indices
        return real_run(cfg, template, loader, *a, **kw)

    jmf.make_warmup_step, jmf.make_train_step = make_warm, make_train
    jdriver.run_multiframe_training, jmf._per_guess_losses = run_training, pgl
    t0 = time.perf_counter()
    try:
        _, state = jcli.train(o)
    finally:
        jmf.make_warmup_step, jmf.make_train_step = real_warm, real_train
        jdriver.run_multiframe_training, jmf._per_guess_losses = real_run, real_pgl
    meta["train_seconds"] = time.perf_counter() - t0
    if rec["pending"] is not None:
        label, pre = rec["pending"]
        write(label, pre, None, None, None, None, None, None)
    meta["n_frames"] = int(np.asarray(state.multiplex.probs).shape[0])
    shutil.copy(osp.join(o["checkpoint_dir"], o["name"], "metrics.jsonl"),
                osp.join(out, "metrics.jsonl"))

    # JAX's evaluate CLI on the final checkpoint, per column
    t0 = time.perf_counter()
    for key in EVAL_COLUMNS:
        jax_evaluate(o, tt.plan_flags(key, 60) + meta["eval_extra"])
        shutil.copy(osp.join(o["tmp_dir"], "eval", "results.npz"),
                    osp.join(out, f"eval_{key}.npz"))
    meta["eval_seconds"] = time.perf_counter() - t0
    with open(osp.join(out, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    print(f"[dump] {len(labels)} snapshots, {rec['steps']} steps, train "
          f"{meta['train_seconds']:.1f} s, evaluate {meta['eval_seconds']:.1f} s", flush=True)
    return meta


# --------------------------------------------------------------------------
# hold (the port)
# --------------------------------------------------------------------------

def _load(out, label):
    """Snapshot `label`: DIR/snap_<label>.pkl, or its state alone
    (DIR/state_<label>.pkl, `pack`'s file) where only that was copied."""
    name = osp.join(out, f"snap_{label}.pkl")
    if not osp.exists(name):
        with open(osp.join(out, f"state_{label}.pkl"), "rb") as fh:
            return {"label": label, "state": pickle.load(fh), "batch": None}
    with open(name, "rb") as fh:
        return pickle.load(fh)


def pack(out, dest, labels, fixed) -> None:
    """What `hold --free` needs, in DEST, small enough to copy to the card's
    machine: DEST/state_<label>.pkl (snapshot `label`'s state alone; the
    init's Adams have not stepped, so it is the weights and tables), the
    tree's clips (DEST/root/horse), JAX's log so far (DEST/metrics.jsonl)
    and DIR/meta.json, or while the dump still runs the part of it that is
    fixed before training (the options, the labels, the steps per epoch
    and the frame count, read off the tree by the port's loader)."""
    os.makedirs(dest, exist_ok=True)
    for label in labels:
        st = dict(_load(out, label)["state"])
        for opt in ("full", "warm"):
            if st[opt]["count"] == 0:
                st[opt] = {"count": 0}
        with open(osp.join(dest, f"state_{label}.pkl"), "wb") as fh:
            pickle.dump(st, fh)
    if osp.isdir(osp.join(dest, "root", "horse")):
        shutil.rmtree(osp.join(dest, "root", "horse"))
    shutil.copytree(osp.join(out, "root", "horse"), osp.join(dest, "root", "horse"))
    log = osp.join(out, "metrics.jsonl")
    if not osp.exists(log):
        log = osp.join(out, "root", "snapshots", "mini_tigdog", "metrics.jsonl")
    shutil.copy(log, osp.join(dest, "metrics.jsonl"))
    if osp.exists(osp.join(out, "meta.json")):
        shutil.copy(osp.join(out, "meta.json"), osp.join(dest, "meta.json"))
    else:
        meta = static_meta(out, *fixed)
        meta["steps_per_epoch"] = meta["n_frames"] = None
        _, loader, _ = build_port(meta, dest, "cpu")
        meta.update(steps_per_epoch=len(loader), n_frames=loader.dataset.num_samples)
        with open(osp.join(dest, "meta.json"), "w") as fh:
            json.dump(meta, fh)
    print(f"packed {labels} of {out} into {dest}", flush=True)


def build_port(meta, out, device):
    """The port's multiframe modules for the dump's options and its shuffled
    loader, as multiframe_main.train builds them, over the tree DIR/root;
    the port writes its own frame cache (DIR/port_cache) when there is none,
    so that holds started together after a first one share it. Returns
    (mods, loader, the options)."""
    from acfm_video_3d_reconstruction_tpu_torch.cli import multiframe_main as mm
    from acfm_video_3d_reconstruction_tpu_torch.data import tigdog as tig
    from acfm_video_3d_reconstruction_tpu_torch.data.loader import DataLoader
    from acfm_video_3d_reconstruction_tpu_torch.train import multiframe as mf

    o = dict(meta["opts"], device=str(device), root_dir=osp.join(out, "root"),
             tmp_dir=osp.join(out, "port_cache"), checkpoint_dir=osp.join(out, "port_snapshots"))
    cfg = mm.build_cfg(o)
    template = mm.build_mf_template(cfg)
    n_frames, s2v, spv = tig.explode_to_frames(
        mm.build_video_dataset(o), o["tmp_dir"], o["category"], o["num_training_frames"],
        write=not osp.isdir(osp.join(o["tmp_dir"], o["category"])))
    mk = dict(tmp_dir=o["tmp_dir"], category=o["category"], sample_to_vid=s2v,
              samples_per_vid=spv, num_frames=o["num_frames"], img_size=o["img_size"],
              tight_bboxes=o["tight_bboxes"], v2_crop=o["v2_crop"],
              padding_frac=o["padding_frac"], remove_neck_kp=True)
    loader = DataLoader(tig.MultiFrameDataset(mirror=o["mirror"], transforms=True, **mk),
                        o["batch_size"], shuffle=True)
    if meta["steps_per_epoch"] is not None and (len(loader) != meta["steps_per_epoch"]
                                                or n_frames != meta["n_frames"]):
        raise ValueError(f"port loader {len(loader)} steps, {n_frames} frames vs the dump's "
                         f"{meta['steps_per_epoch']}, {meta['n_frames']}")
    mods = mf.build(cfg, template, n_frames, steps_per_epoch=len(loader), device=device)
    return mods, loader, o


def load_state(mods, st: dict) -> None:
    """A dumped JAX state into the port's modules (weights, tables, both
    Adams, the step count)."""
    from acfm_video_3d_reconstruction_tpu_torch.models import from_jax

    from_jax.load_jax_multiframe(mods, st["params"], st["batch_stats"], {},
                                 {"cams": st["cams"], "probs": st["probs"]})
    from_jax.load_jax_optimizers(mods, st["full"], st["warm"])
    mods.step = st["step"]


@contextlib.contextmanager
def loss_matrix_spy(captured: dict):
    """The port's _per_guess_losses reports its last loss matrix."""
    from acfm_video_3d_reconstruction_tpu_torch.train import multiframe as mf

    real = mf._per_guess_losses

    def spy(*a, **kw):
        res = real(*a, **kw)
        captured["lm"] = res[0].detach().cpu().numpy()
        return res

    mf._per_guess_losses = spy
    try:
        yield
    finally:
        mf._per_guess_losses = real


def _t(a):
    import torch

    return torch.tensor(np.asarray(a))


def _jax_named(mods, st: dict, what: str) -> dict:
    """A dumped state's parameters (what="params") or the full Adam's first
    moment (what="mu"; zeros before its first step) by the port's parameter
    names, the camera table under "mpx.cams"."""
    from acfm_video_3d_reconstruction_tpu_torch.models import from_jax

    if what == "mu" and st["full"]["count"] == 0:
        out = {n: 0 * p.detach().cpu() for n, p in mods.model.named_parameters()}
        out["mpx.cams"] = _t(np.zeros_like(st["cams"]))
        return out
    tree = st["params"] if what == "params" else st["full"]["mu"]["params"]
    out = from_jax.convert_params(mods.model, tree)
    out["mpx.cams"] = _t(st["cams"] if what == "params" else st["full"]["mu"]["mpx"]["cams"])
    return out


def _port_named(mods, what: str) -> dict:
    """The port's parameters (what="params") or its full Adam's first
    moments (what="mu"), named as _jax_named names them."""
    named = dict(mods.model.named_parameters())
    named["mpx.cams"] = mods.mpx.cams
    if what == "params":
        return {n: p.detach().cpu().clone() for n, p in named.items()}
    return {n: mods.opt.state[p]["exp_avg"].detach().cpu().clone() for n, p in named.items()}


def _rel(a, b) -> float:
    import torch

    return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30)).item()


def grad_bound(name: str) -> float:
    """tests/test_torch_port_train.py::_grad_bound, and 0.05 for the camera
    table (through the mask): through the mask 0.05; the camera head
    (cam_loss only) 2e-3; vert2kp_logits 1e-4."""
    if name.startswith("camera_predictor."):
        return 2e-3
    if name == "vert2kp_logits":
        return 1e-4
    return 0.05


# the step tests' parameters that no term reaches but through f32 noise
# (tests/test_torch_port_train.py::BN_FED_BIASES; lbs_logits at zero handle
# offsets): held below 1e-5 of the gradient of their weight / of mean_v
NOISE_ONLY = {"encoder.enc_conv1.conv.bias": "encoder.enc_conv1.conv.weight",
              "encoder.enc_fc.0.fc.bias": "encoder.enc_fc.0.fc.weight",
              "encoder.enc_fc.1.fc.bias": "encoder.enc_fc.1.fc.weight",
              "lbs_logits": "mean_v"}


def _metric_ok(name: str, got: float, want: float):
    """(within the step tests' tolerance, relative error) of one metric."""
    err = abs(got - want)
    if name in MASK_TERMS:
        return err <= 1e-3 * abs(want), err / max(abs(want), 1e-30)
    if name == "rigid_loss":  # pred_v = mean_v under drop_deform: f32 noise
        return err <= 1e-8, err
    return err <= 1e-5 + 1e-4 * abs(want), err / max(abs(want), 1e-30)


def _update_check(pairs, lr: float, first: bool, out: dict, fails: list) -> None:
    """Adam's update. At the optimizer's first step as the step tests hold
    it (sign-like there): where both gradients exceed 1e-6 with one sign
    the updates agree to 1.1% of lr; the undecided elements at most 3e-3 of
    those with |g_jax| > 1e-6. At a later step an element's update is
    mu / sqrt(nu) of moments that both sides share plus this step's
    gradient, and where the old first moment and the gradient nearly cancel
    it turns on the gradient's rounding; so each tensor's update is held as
    its gradient is, in vector relative error, at the gradient's bound
    (pairs: (g_port, g_jax, update_port, update_jax, bound)). The largest
    element difference over lr is reported either way."""
    n_big = n_und = 0
    worst, worst_rel = 0.0, 0.0
    for g_t, g_j, d_t, d_j, bound in pairs:
        big = g_j.abs() > 1e-6
        decided = big & (g_t.abs() > 1e-6) & (g_t.sign() == g_j.sign())
        n_big += int(big.sum())
        n_und += int((big & ~decided).sum())
        if decided.any():
            worst = max(worst, float((d_t[decided] - d_j[decided]).abs().max()))
        if not first and d_j.any() and bound < float("inf"):
            rel = _rel(d_t, d_j)
            worst_rel = max(worst_rel, rel)
            if rel > bound:
                fails.append(f"update rel {rel:.3g} > {bound}")
    out["update_worst_over_lr"] = worst / lr
    out["update_worst_rel"] = worst_rel
    out["undecided"] = [n_und, n_big]
    if first and worst > 0.011 * lr:
        fails.append(f"update {worst / lr:.3g} x lr")
    if first and n_und > 3e-3 * max(n_big, 1):
        fails.append(f"undecided {n_und} of {n_big}")


def hold_step(mods, snap: dict) -> dict:
    """3a: one step of the port from the snapshot's state on its next batch
    against JAX's step. Returns the errors and `fails`, the checks beyond
    their bounds."""
    import torch

    from acfm_video_3d_reconstruction_tpu_torch.models import from_jax
    from acfm_video_3d_reconstruction_tpu_torch.train import multiframe as mf

    st, after = snap["state"], snap["after"]
    load_state(mods, st)
    batch = mf.to_device_batch(mods, snap["batch"])
    captured, fails = {}, []
    with loss_matrix_spy(captured):
        if snap["kind"] == "warm":
            metrics = mf.make_warmup_step(mods)(batch)
        else:
            metrics = mf.make_train_step(mods, k=snap["k"])(batch)
    out = {"label": snap["label"], "kind": snap["kind"], "k": snap["k"], "step": st["step"]}
    lm_t, lm_j = captured["lm"], snap["loss_matrix"]
    out["loss_matrix_rel"] = float(np.max(np.abs(lm_t - lm_j) / np.abs(lm_j)))
    if out["loss_matrix_rel"] > 1e-3:
        fails.append(f"loss matrix {out['loss_matrix_rel']:.3g}")
    out["metrics_rel"] = {}
    for name, want in snap["metrics"].items():
        ok, err = _metric_ok(name, float(metrics[name]), want)
        out["metrics_rel"][name] = err
        if not ok:
            fails.append(f"metric {name}: {float(metrics[name])} vs {want}")
    probs_t = mods.mpx.probs.detach().cpu().numpy()
    out["probs_rel"] = float(np.max(np.abs(probs_t - after["probs"])
                                    / np.maximum(np.abs(after["probs"]), 1e-7)))
    if not np.allclose(probs_t, after["probs"], rtol=1e-3, atol=1e-7):
        fails.append(f"probs {out['probs_rel']:.3g}")
    cams0 = _t(st["cams"])
    if snap["kind"] == "warm":
        # the warm-up Adam over the camera table only; the model untouched
        lr = mods.cfg.train.warmup_lr
        mu0 = _t(st["warm"]["mu"]) if st["warm"]["count"] else 0 * cams0
        g_j = (_t(after["warm"]["mu"]) - B1 * mu0) / (1 - B1)
        g_t = (mods.warm_opt.state[mods.mpx.cams]["exp_avg"].cpu() - B1 * mu0) / (1 - B1)
        out["grad_rel"] = {"mpx.cams": _rel(g_t, g_j)}
        pairs = [(g_t, g_j, mods.mpx.cams.detach().cpu() - cams0, _t(after["cams"]) - cams0,
                  grad_bound("mpx.cams"))]
        first = st["warm"]["count"] == 0
    else:
        lr = mods.cfg.train.learning_rate
        mu0, mu1_j, mu1_t = (_jax_named(mods, st, "mu"), _jax_named(mods, after, "mu"),
                             _port_named(mods, "mu"))
        p0, p1_j, p1_t = (_jax_named(mods, st, "params"), _jax_named(mods, after, "params"),
                          _port_named(mods, "params"))
        g_j = {n: (mu1_j[n] - B1 * mu0[n]) / (1 - B1) for n in p0}
        g_t = {n: (mu1_t[n] - B1 * mu0[n]) / (1 - B1) for n in p0}
        out["grad_rel"], pairs = {}, []
        first = st["full"]["count"] == 0
        for n in p0:
            # a noise-only gradient's Adam update is noise too: not held
            pairs.append((g_t[n], g_j[n], p1_t[n] - p0[n], p1_j[n] - p0[n],
                          float("inf") if n in NOISE_ONLY else grad_bound(n)))
            if n in NOISE_ONLY:
                scale = torch.linalg.vector_norm(g_j[NOISE_ONLY[n]])
                if torch.linalg.vector_norm(g_t[n] - g_j[n]) > 1e-5 * scale:
                    fails.append(f"grad {n} above 1e-5 of {NOISE_ONLY[n]}'s")
                continue
            if not g_j[n].any():
                if g_t[n].any():
                    fails.append(f"grad {n}: JAX's is 0, the port's is not")
                continue
            out["grad_rel"][n] = _rel(g_t[n], g_j[n])
    for n, err in out["grad_rel"].items():
        if err > grad_bound(n):
            fails.append(f"grad {n}: {err:.3g}")
    _update_check(pairs, lr, first, out, fails)
    # the BatchNorm running statistics and the camera table after the step
    want = from_jax.convert(mods.model, after["params"], after["batch_stats"])
    got = mods.model.state_dict()
    bn = [k for k in got if k.endswith(("running_mean", "running_var"))]
    out["bn_rel"] = max(_rel(got[k].cpu(), want[k]) for k in bn)
    if out["bn_rel"] > 1e-4:
        fails.append(f"batch_stats {out['bn_rel']:.3g}")
    out["cams_after_rel"] = _rel(mods.mpx.cams.detach().cpu(), _t(after["cams"]))
    out["fails"] = fails
    return out


PERTURB = 1e-4  # port_spread: the solve's output moved by this much of its mean |value|


def port_spread(mods, snap: dict, threads: int) -> dict:
    """The port's own spread at one step: the step of hold_step from the
    snapshot's state at the current CPU thread count against the same step
    at `threads` (another summation order), and (main-loop steps) against
    the step with the solve's output moved by PERTURB of its mean |value|
    in three seeded random directions, about the f32 solve's own error at
    the late snapshots: the loss's discrete choices (a face or a keypoint
    on the other side of an edge) then turn as they may between two f32
    implementations. Compared as hold_step compares the port with JAX: the
    metrics' relative differences, and per tensor the gradients' (from the
    first moments) and the updates' vector relative differences, the
    largest over the variants. What a JAX-port difference beyond a step
    test's bound is read against."""
    import torch

    from acfm_video_3d_reconstruction_tpu_torch.train import multiframe as mf

    base = torch.get_num_threads()
    train = snap["kind"] != "warm"
    real_solve = mf.screened_poisson_solve

    def moved(seed):
        def solve(*a):
            out = real_solve(*a)
            g = torch.Generator().manual_seed(seed)
            noise = torch.randn(out.shape, generator=g).to(out.device)
            return out + PERTURB * out.detach().abs().mean() * noise
        return solve

    def run(n, solve):
        torch.set_num_threads(n)
        mf.screened_poisson_solve = solve
        try:
            load_state(mods, snap["state"])
            batch = mf.to_device_batch(mods, snap["batch"])
            m = (mf.make_train_step(mods, k=snap["k"]) if train
                 else mf.make_warmup_step(mods))(batch)
        finally:
            mf.screened_poisson_solve = real_solve
            torch.set_num_threads(base)
        return ({k: float(v) for k, v in m.items()}, _port_named(mods, "mu") if train else {},
                _port_named(mods, "params"))

    variants = [run(threads, real_solve)] + ([run(base, moved(s)) for s in (1, 2, 3)]
                                             if train else [])
    m0, mu_a, p0 = run(base, real_solve)
    start = _jax_named(mods, snap["state"], "params") if train else {}
    mu0 = _jax_named(mods, snap["state"], "mu") if train else {}
    g_a = {k: (mu_a[k] - B1 * mu0[k]) / (1 - B1) for k in mu0}
    out = {"threads": [base, threads], "perturb": PERTURB if train else None,
           "metrics_rel": {}, "grad_rel": {}, "update_rel": {}}

    def most(d, k, v):
        d[k] = max(d.get(k, 0.0), v)

    for m1, mu_b, p1 in variants:
        for k in m0:
            most(out["metrics_rel"], k, abs(m1[k] - m0[k]) / max(abs(m0[k]), 1e-30))
        for k in g_a:
            if g_a[k].any():
                most(out["grad_rel"], k, _rel((mu_b[k] - B1 * mu0[k]) / (1 - B1), g_a[k]))
        for k in start:
            if (p0[k] - start[k]).any():
                most(out["update_rel"], k, _rel(p1[k] - start[k], p0[k] - start[k]))
    return out


def jax_snapshot(mods, st: dict) -> dict:
    """tools/torch_mini_tigdog_parity.py::snapshot of a dumped JAX state."""
    from acfm_video_3d_reconstruction_tpu_torch.models import from_jax

    sd = from_jax.convert(mods.model, st["params"], st["batch_stats"])
    return {"cams": st["cams"], "probs": st["probs"], "mean_v": sd["mean_v"].numpy(),
            "bn": {k: v.numpy() for k, v in sd.items()
                   if k.endswith(("running_mean", "running_var"))}}


def hold_pass(mods, loader, meta: dict, out: str, label: str, threads: int) -> dict:
    """3b: from snapshot `label` one pass over the loader (a warm-up rep or
    a main-loop epoch) through the port's steps, on JAX's batch order.
    Returns the per-step loss terms against JAX's, and the multiplex report
    of the port and of JAX's snapshot after the pass (when one was taken)."""
    import torch

    import torch_mini_tigdog_parity as tt
    from acfm_video_3d_reconstruction_tpu_torch.train import multiframe as mf
    from acfm_video_3d_reconstruction_tpu_torch.train import schedules

    torch.set_num_threads(threads)
    reps, spe = meta["reps"], meta["steps_per_epoch"]
    load_state(mods, _load(out, label)["state"])
    start = tt.snapshot(mods)
    p = _pass_of(label, reps)
    loader.rng.bit_generator.state = meta["passes"][p]["loader"]
    loader.dataset.rng.bit_generator.state = meta["passes"][p]["dataset"]
    if p < reps:
        step = mf.make_warmup_step(mods)
    else:
        mp = mods.cfg.multiplex
        k = schedules.num_guesses_at(p - reps, mp.num_guesses, mp.drop_hypothesis, False)
        step = mf.make_train_step(mods, k=k, drop_deform=True)
    with open(osp.join(out, "metrics.jsonl")) as fh:
        jax_log = {r["step"]: r for r in map(json.loads, fh) if r}
    terms, frames_ok = [], True
    t0 = time.perf_counter()
    for i, batch in enumerate(loader):
        n = p * spe + i + 1  # JAX's step number
        frames_ok &= batch["frames_idx"].tolist() == meta["frames"][n - 1]
        m = step(mf.to_device_batch(mods, batch))
        terms.append({name: (float(v), jax_log[n][name]) for name, v in m.items()})
    secs = time.perf_counter() - t0
    res = {"label": label, "threads": threads, "pass": p, "frames_equal": bool(frames_ok),
           "seconds": secs, "terms": terms, "port": tt.multiplex_report(start, tt.snapshot(mods))}
    nxt = _label_after((p + 1) * spe, spe, reps, meta["labels"])
    if nxt is not None:
        res["next"] = nxt
        res["jax"] = tt.multiplex_report(start, jax_snapshot(mods, _load(out, nxt)["state"]))
    res["final"] = tt.snapshot(mods)
    return res


def _term_spread(a: dict, b: dict) -> dict:
    """Per loss term the largest relative difference over the pass's steps
    between the port runs a and b (and JAX where b is None)."""
    out = {}
    for i, sa in enumerate(a["terms"]):
        for name, (va, vj) in sa.items():
            vb = vj if b is None else b["terms"][i][name][0]
            rel = abs(va - vb) / max(abs(vb), 1e-30)
            out[name] = max(out.get(name, 0.0), rel)
    return out


def hold_eval(meta: dict, out: str, device) -> dict:
    """3c: JAX's final state, saved as the port's checkpoint, through the
    port's evaluate CLI per EVAL_COLUMNS, against JAX's evaluate CLI on its
    own checkpoint (the dump's eval_<column>.npz)."""
    from acfm_video_3d_reconstruction_tpu_torch.train import checkpoints

    mods, _, o = build_port(meta, out, device)
    load_state(mods, _load(out, f"epoch{meta['epochs']}")["state"])
    checkpoints.save_multiframe(o["checkpoint_dir"], o["name"], "latest", mods)
    del mods
    return _eval_columns(o, out, [], meta.get("eval_extra", []))


def _eval_columns(o: dict, out: str, fails: list, extra=()) -> dict:
    """The port's evaluate CLI on o's `latest` checkpoint per EVAL_COLUMNS
    (with the evaluate flags `extra`), against JAX's results
    (DIR/eval_<column>.npz)."""
    import torch_mini_tigdog_parity as tt
    from acfm_video_3d_reconstruction_tpu_torch.cli import multiframe_evaluate as mfe
    from acfm_video_3d_reconstruction_tpu_torch.eval import metrics as eval_metrics

    res = {}
    for key in EVAL_COLUMNS:
        stats = mfe.evaluate(tt.eval_opts(o, tt.plan_flags(key, 60) + list(extra)))
        got = np.load(osp.join(o["tmp_dir"], "eval", "results.npz"))
        if not osp.exists(osp.join(out, f"eval_{key}.npz")):  # the dump has not evaluated
            res[key] = {"port": stats.results()}
            print(json.dumps({"eval": key, **res[key]}), flush=True)
            continue
        want = np.load(osp.join(out, f"eval_{key}.npz"))
        stats_j = eval_metrics.BenchStats()
        stats_j.update(want["ious"], want["kp_errs"], want["kp_vis"])
        rj, rt = stats_j.results(), stats.results()
        n_vis = want["kp_vis"].sum(0)
        keep = n_vis > 0
        share = 1.0 / (n_vis[keep].min() * keep.sum())
        cams_rel = float(np.linalg.norm(got["cams"] - want["cams"])
                         / np.linalg.norm(want["cams"]))
        r = {"port": rt, "jax": rj, "kp_share": float(share), "cams_rel": cams_rel,
             "kp_vis_equal": bool(np.array_equal(got["kp_vis"], want["kp_vis"]))}
        if abs(rt["mean_iou"] - rj["mean_iou"]) > 1e-3:
            fails.append(f"{key} IoU {rt['mean_iou']} vs {rj['mean_iou']}")
        for k in ("pck_0.1", "pck_0.15"):
            if abs(rt[k] - rj[k]) > share + 1e-12:
                fails.append(f"{key} {k} {rt[k]} vs {rj[k]}")
        if cams_rel > 1e-4 or not r["kp_vis_equal"]:
            fails.append(f"{key} cameras rel {cams_rel:.3g}, kp_vis equal {r['kp_vis_equal']}")
        res[key] = r
        print(json.dumps({"eval": key, **r}), flush=True)
    return {"columns": res, "fails": fails}


def hold_free(meta: dict, out: str, device, plain: bool = False) -> dict:
    """The port's whole run from JAX's init snapshot through the port's CLI
    (multiframe_main.train, its driver loop, log_every 1): the build loads
    JAX's weights and tables, the init_camera_emb pass rewrites hypothesis
    0 as JAX's did, and the loader and dataset draw from seed 0 as JAX's
    do, so the batches are JAX's. At each snapshot label the multiplex
    report from the init (and JAX's where DIR holds that snapshot); then
    the port's evaluate CLI on the final checkpoint per EVAL_COLUMNS
    against JAX's. plain=True swaps the rasterizer kernels for their plain
    versions (the port's own spread on the card)."""
    import torch

    import torch_mini_tigdog_parity as tt
    from acfm_video_3d_reconstruction_tpu_torch.cli import multiframe_main as mm
    from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer_cuda as rc
    from acfm_video_3d_reconstruction_tpu_torch.train import multiframe as mf

    init = _load(out, "init")["state"]
    _, _, o = build_port(meta, out, device)
    o = dict(o, checkpoint_dir=osp.join(out, "port_free" + ("_plain" if plain else "")))
    spe, reps, labels = meta["steps_per_epoch"], meta["reps"], meta["labels"]
    rec = {"steps": 0, "reports": {}, "jax": {}}
    real = (mf.build, mf.make_warmup_step, mf.make_train_step, rc.forward_cuda,
            rc.backward_cuda)

    def build(*a, **kw):
        mods = real[0](*a, **kw)
        load_state(mods, init)
        rec["mods"] = mods
        return mods

    def counted(step):
        def run(batch):
            m = step(batch)
            rec["steps"] += 1
            label = _label_after(rec["steps"], spe, reps, labels)
            if label is not None:
                rec["reports"][label] = tt.multiplex_report(rec["start"],
                                                            tt.snapshot(rec["mods"]))
            return m
        return run

    def make_warm(mods):
        rec["start"] = tt.snapshot(mods)
        return counted(real[1](mods))

    def make_train(mods, **kw):
        return counted(real[2](mods, **kw))

    mf.build, mf.make_warmup_step, mf.make_train_step = build, make_warm, make_train
    if plain:
        rc.forward_cuda, rc.backward_cuda = rc.forward_plain, rc.backward_plain
    t0 = time.perf_counter()
    try:
        mm.train(dict(o, log_every=1))
        if device.type == "cuda":
            torch.cuda.synchronize()
    finally:
        (mf.build, mf.make_warmup_step, mf.make_train_step, rc.forward_cuda,
         rc.backward_cuda) = real
    secs = time.perf_counter() - t0
    start_j = None
    for label in labels:
        if osp.exists(osp.join(out, f"snap_{label}.pkl")):
            st = jax_snapshot(rec["mods"], _load(out, label)["state"])
            start_j = st if label == "init" else start_j
            if start_j is not None and label != "init":
                rec["jax"][label] = tt.multiplex_report(start_j, st)
    with open(osp.join(o["checkpoint_dir"], o["name"], "metrics.jsonl")) as fh:
        port_log = [json.loads(x) for x in fh if x.strip()]
    with open(osp.join(out, "metrics.jsonl")) as fh:
        jax_log = {r["step"]: r for r in map(json.loads, fh) if r}
    total = [(r["step"], r.get("total_loss", r.get("warmup_loss")),
              jax_log[r["step"]].get("total_loss", jax_log[r["step"]].get("warmup_loss")))
             for r in port_log if r["step"] in jax_log]
    res = {"plain": plain, "seconds": secs, "steps": rec["steps"], "reports": rec["reports"],
           "jax_reports": rec["jax"], "total_loss": total}
    print(json.dumps({"free_reports": rec["reports"]}), flush=True)
    del rec["mods"]
    res["eval"] = _eval_columns(o, out, [], meta.get("eval_extra", []))
    return res


def hold(args) -> int:
    import torch

    import torch_mini_tigdog_parity as tt

    out = args.dir
    with open(osp.join(out, "meta.json")) as fh:
        meta = json.load(fh)
    tt.IMG = meta["img"]
    device = torch.device(args.device)
    torch.set_num_threads(int(args.threads.split(",")[0]))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: no CUDA device (pass --device cpu)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    report = {"device": tt.card_name(device), "cpu_threads": torch.get_num_threads(),
              "steps": [], "passes": [], "eval": None}
    fails = []
    if args.steps:
        mods, _, _ = build_port(meta, out, device)
        for label in meta["labels"]:
            snap = _load(out, label)
            if snap["batch"] is None:
                continue
            r = hold_step(mods, snap)
            if args.spread:
                r["spread"] = port_spread(mods, snap, args.spread)
            print(json.dumps({"step_hold": r}), flush=True)
            report["steps"].append(r)
            fails += [f"{label}: {f}" for f in r["fails"]]
    for label in [x for x in args.epoch_from.split(",") if x]:
        mods, loader, _ = build_port(meta, out, device)
        runs = [hold_pass(mods, loader, meta, out, label, int(n))
                for n in args.threads.split(",")]
        for r in runs:
            r["vs_jax"] = _term_spread(r, None)
            r["vs_first"] = _term_spread(r, runs[0])
            r["vs_first_report"] = tt.multiplex_report(runs[0]["final"], r["final"])
        for r in runs:
            del r["terms"], r["final"]
            print(json.dumps({"pass_hold": r}), flush=True)
            report["passes"].append(r)
    if args.eval:
        report["eval"] = hold_eval(meta, out, device)
        fails += report["eval"]["fails"]
    for plain in {"": [], "kernels": [False], "plain": [True],
                  "both": [False, True]}[args.free]:
        r = hold_free(meta, out, device, plain)
        print(json.dumps({"free": {k: v for k, v in r.items() if k != "total_loss"}}),
              flush=True)
        report.setdefault("free", []).append(r)
    report["fails"] = fails
    name = f"hold_{device.type}" + (f"_free_{args.free}" if args.free else "")
    with open(osp.join(out, name + ".json"), "w") as fh:
        json.dump(report, fh)
    print(json.dumps({"fails": fails}), flush=True)
    return 1 if fails else 0


def batches(out, to, n, against=None) -> dict:
    """The first n batches of the port's shuffled loader over DIR/root (seed
    0, as the CLI draws them) into TO (npz, with the host's library
    versions); with `against`, another host's file, the largest difference
    per key. The data path reads the clips with numpy and resizes the crops
    with cv2 (data/image_utils.py), and the mask geometry comes from
    native/'s library where it loads, so two hosts' batches may differ."""
    import cv2
    import scipy

    from acfm_video_3d_reconstruction_tpu_torch.data import native

    with open(osp.join(out, "meta.json")) as fh:
        meta = json.load(fh)
    from acfm_video_3d_reconstruction_tpu_torch.data import tigdog as tig
    from acfm_video_3d_reconstruction_tpu_torch.data.loader import DataLoader

    _, loader, _ = build_port(meta, out, "cpu")
    ds = loader.dataset
    # the init_camera_emb pass's (and the evaluation's) path: no mirror, no
    # affine, so the crops are only resized
    noaug = DataLoader(tig.MultiFrameDataset(
        mirror=False, transforms=False, tmp_dir=ds.root.rsplit(os.sep, 1)[0],
        category=meta["opts"]["category"], sample_to_vid=ds.sample_to_vid,
        samples_per_vid=ds.samples_per_vid, num_frames=ds.num_frames, img_size=ds.img_size,
        padding_frac=0.0, remove_neck_kp=True), loader.batch_size, shuffle=False)
    arrays = {}
    for tag, ld in (("", loader), ("noaug/", noaug)):
        for i, b in enumerate(ld):
            if i == n:
                break
            arrays.update({f"{tag}{i}/{k}": np.asarray(v) for k, v in b.items()})
    versions = {"numpy": np.__version__, "cv2": cv2.__version__, "scipy": scipy.__version__,
                "native": native.available()}
    np.savez(to, versions=json.dumps(versions), **arrays)
    res = {"versions": versions}
    if against:
        other = np.load(against)
        res["against"] = json.loads(str(other["versions"]))
        res["max_abs"] = {k: float(np.abs(arrays[k].astype(np.float64)
                                          - other[k].astype(np.float64)).max())
                          for k in arrays if k in other.files}
        res["n_differ"] = {k: int((arrays[k] != other[k]).sum())
                           for k in arrays if k in other.files}
        res["mask_sums"] = {k: [float(arrays[k].sum()), float(other[k].sum())]
                            for k in arrays if k.endswith("/mask") and k in other.files}
    print(json.dumps(res), flush=True)
    return res


def nan_trap(root: str, img: int, videos: int, seed: int, device, epochs: int = 40) -> dict:
    """The port tool's training (tools/torch_mini_tigdog_parity.py: its
    tree, options and --seed) with a trap on every main-loop step, a
    debugging cost of a few host reads a step: before Adam's update every
    gradient must be finite. Per step it records the solve's Cholesky
    (cholesky_ex's info for the step's mean shape, and the least pivot
    over the largest), the mean shape's least face area and the largest
    |cot weight|. At the first non-finite gradient it stops and returns
    the step, the non-finite tensors, the step's loss terms and the last
    records; else the run's extremes."""
    import torch

    import torch_mini_tigdog_parity as tt
    from acfm_video_3d_reconstruction_tpu_torch.cli import multiframe_main as mm
    from acfm_video_3d_reconstruction_tpu_torch.geometry import mesh_ops
    from acfm_video_3d_reconstruction_tpu_torch.train import multiframe as mf

    if videos:
        tt.N_VIDEOS = videos
    if img:
        tt.RAW, tt.IMG = round(img * tt.RAW / tt.IMG), img
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    tt.generate(root, tt.build_template(), device)
    o = tt.train_opts(root, epochs, device=str(device))
    recs, found = [], {}
    real_build, real_solve = mf.build, mf.screened_poisson_solve

    def solve(mean_v, lbs, delta, L):
        with torch.no_grad():
            M = L.T @ L + lbs.T @ lbs
            chol = torch.linalg.cholesky_ex(M)
            piv = torch.diagonal(chol.L)
            faces = torch.as_tensor(mods_ref["mods"].template.faces, device=mean_v.device)
            fv = mean_v[faces]
            area = 0.5 * torch.linalg.vector_norm(
                torch.linalg.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0], dim=-1), dim=-1)
            W = mesh_ops.cot_laplacian_weights(mean_v, faces)
            recs.append({"info": int(chol.info), "pivot_ratio": float(piv.min() / piv.max()),
                         "min_area": float(area.min()), "max_cot": float(W.abs().max())})
        return real_solve(mean_v, lbs, delta, L)

    mods_ref = {}

    def build(*a, **kw):
        mods = real_build(*a, **kw)
        mods_ref["mods"] = mods
        real_step = mods.opt.step

        def checked_step(*sa, **skw):
            named = dict(mods.model.named_parameters())
            named["mpx.cams"] = mods.mpx.cams
            bad = sorted(n for n, p in named.items()
                         if p.grad is not None and not torch.isfinite(p.grad).all())
            if bad:
                found.update(step=mods.step, nonfinite_grads=bad, last=recs[-3:])
                raise FloatingPointError(f"non-finite gradients at step {mods.step}: {bad}")
            return real_step(*sa, **skw)

        mods.opt.step = checked_step
        return mods

    mf.build, mf.screened_poisson_solve = build, solve
    try:
        with tt.seeded(seed):
            mm.train(o)
    except FloatingPointError as e:
        found["error"] = str(e)
    finally:
        mf.build, mf.screened_poisson_solve = real_build, real_solve
    res = {"seed": seed, "img": tt.IMG, "videos": tt.N_VIDEOS, "steps": len(recs),
           "cholesky_failures": [i for i, r in enumerate(recs) if r["info"]],
           "least_pivot_ratio": min(r["pivot_ratio"] for r in recs),
           "least_area": min(r["min_area"] for r in recs),
           "largest_cot": max(r["max_cot"] for r in recs), **found}
    print(json.dumps({"nan_trap": res}), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("dump", "hold", "pack", "batches", "trap"))
    ap.add_argument("dir", help="where the dump writes and the hold reads")
    ap.add_argument("--img", type=int, default=64)
    ap.add_argument("--videos", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--reps", type=int, default=2, help="warm-up reps (the tool's 2)")
    ap.add_argument("--at", default=",".join(map(str, AT)),
                    help="main-loop epochs after which to snapshot (and the last)")
    ap.add_argument("--skip_gen", action="store_true", help="reuse DIR/root's tree")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--steps", action="store_true", help="3a: one step from each snapshot")
    ap.add_argument("--spread", type=int, default=0,
                    help="3a: also the port's step at this CPU thread count (port_spread)")
    ap.add_argument("--epoch_from", default="",
                    help="3b: comma-separated snapshot labels to run one loader pass from")
    ap.add_argument("--threads", default="1,2",
                    help="CPU threads: the first for every check, each for 3b's passes")
    ap.add_argument("--eval", action="store_true", help="3c: JAX's final state through the "
                    "port's evaluate CLI")
    ap.add_argument("--free", default="", choices=("", "kernels", "plain", "both"),
                    help="the port's whole run from JAX's init (hold_free), through the "
                    "rasterizer kernels, their plain versions, or both")
    ap.add_argument("--labels", default="init", help="pack: the snapshots to pack")
    ap.add_argument("--seed", type=int, default=0, help="trap: the parity tool's --seed")
    ap.add_argument("--to", default="", help="pack: the directory to pack into; batches: the "
                    "npz to write")
    ap.add_argument("--against", default="", help="batches: another host's npz to compare")
    args = ap.parse_args(argv)
    if args.mode == "dump":
        dump(args.dir, args.img, args.videos, args.epochs, args.reps,
             [int(x) for x in args.at.split(",") if x])
        return 0
    if args.mode == "trap":
        nan_trap(args.dir, args.img, args.videos, args.seed, args.device, args.epochs)
        return 0
    if args.mode == "batches":
        batches(args.dir, args.to, 3, args.against or None)
        return 0
    if args.mode == "pack":
        pack(args.dir, args.to, args.labels.split(","),
             (args.img, args.videos, args.epochs, args.reps,
              [int(x) for x in args.at.split(",") if x]))
        return 0
    return hold(args)


if __name__ == "__main__":
    sys.exit(main())
