"""The camera-multiplex recipe for horses without keypoints (upstream
docs/setup_video.md, "Train horses w/o keypoints"; the benchmark's
acfm-multiframe-horse-nokp) on the CPU at a small size.

The recipe's flags: 6 az-el hypotheses (azimuth over 360 degrees, scale
decay 0.1, bias 0.9), the top 4 kept after the first drop
(--drop_hypothesis), the per-frame deformation tables (--optimize_deform),
YouTube-VIS clips mixed in (--expand_ytvis), the scaled template
(--scale_mesh) and its loss weights. Here: 64^2, subdivide 1, 6 handles,
nz_feat 32, 2 clips x 2 frames, G = 6, k = 4.

* The benchmark's run of the cell (gpubench/entries/multiframe_train_nokp.py,
  the CLI's set-up and train/driver.py's loop from epoch 21) against its
  reference (gpubench/reference/multiframe_nokp.py, the frozen plain
  modules) over three steps, on seeded random weights and the drawn
  multiplex state, on a tiny mixed tree of the benchmark's fixtures: the
  data and the start exactly, every other number within 1e-4 (the
  benchmark's own test of the other cells holds them so).
* One train step of the recipe against the JAX package's (the drop path at
  k < G, the az-el decode, the deformation tables' gather and distillation
  term): tolerances of tests/test_torch_port_multiframe.py, reasoned there.
* The YouTube-VIS clips through the CLI's data set: squared x1 y1 x2 y2
  boxes and placeholder keypoints in the frame cache, zero keypoints in the
  batches, the JAX package's items bit for bit, and their count.
* The drawn probabilities make top-k differ across frames.
* The multiplex's spans and the traced counters: recorded under the
  profiler, nothing kept without it.
"""
import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_multiframe import (_batch, _jax_train_step, _jitted_flax_init, _rel,
                                        _tol, _tree, _wide_sigma_and_spies)
from test_torch_port_train import BN_FED_BIASES, _grad_bound
from torch.profiler import ProfilerActivity, profile

from acfm_video_3d_reconstruction_tpu import config as jcfg
from acfm_video_3d_reconstruction_tpu.data import tigdog as jtig
from acfm_video_3d_reconstruction_tpu.models import build_template as jbuild_template
from acfm_video_3d_reconstruction_tpu.train import multiframe as jmf
from acfm_video_3d_reconstruction_tpu_torch import config as tcfg
from acfm_video_3d_reconstruction_tpu_torch.cli import multiframe_main as cli
from acfm_video_3d_reconstruction_tpu_torch.data import image_utils
from acfm_video_3d_reconstruction_tpu_torch.data import native
from acfm_video_3d_reconstruction_tpu_torch.data import tigdog as ttig
from acfm_video_3d_reconstruction_tpu_torch.data.loader import DataLoader
from acfm_video_3d_reconstruction_tpu_torch.models import from_jax
from acfm_video_3d_reconstruction_tpu_torch.models import template as ttemplate
from acfm_video_3d_reconstruction_tpu_torch.multiplex import state as tmpx
from acfm_video_3d_reconstruction_tpu_torch.train import multiframe as tmf
from acfm_video_3d_reconstruction_tpu_torch.train import schedules as tsched
from acfm_video_3d_reconstruction_tpu_torch.utils import tracing
from gpubench import run as R
from gpubench.harness import bench
from gpubench.harness import data as gdata
from gpubench.reference import multiframe_nokp as ref
from gpubench.reference.frozen.train import multiframe as frozen_mf
from gpubench.tools.calibrate import shrink_cell

torch.set_num_threads(1)

CELL = "mf-train-nokp"
G, K, B, T, N_FRAMES = 6, 4, 2, 2, 8
TEMPLATE = dict(subdivide=1, num_lbs=6, tex_size=2, num_kps=0, scale_mesh=True)
# the recipe's multiplex and loss weights (docs/setup_video.md)
MULTIPLEX = dict(num_guesses=G, az_el_cam=True, drop_hypothesis=True, optimize_deform=True,
                 scale_lr_decay=0.1, scale_bias=0.9, az_euler_range=360.0)
WEIGHTS = dict(kp=0.0, of=0.1, mask=2.0, boundaries=1.0, bdt=0.1, edt=0.5, deform_reg=1e-4,
               rigid=10.0, cam=2.0, tex=1.0, triangle=0.01)
SMALL = {"cli": {"img_size": 64, "subdivide": 1, "num_lbs": 6, "nz_feat": 32, "batch_size": 2},
         "flow_net_hw": [64, 128],
         "dataset": {"videos": 2, "frames": 6, "raw": [120, 200], "yt_videos": 2,
                     "yt_frames": 6, "yt_raw": [144, 256]},
         "traffic": {"warm_steps": 4}}


def _small_cell() -> bench.Cell:
    cell = bench.Cell(CELL)
    shrink_cell(cell, SMALL)
    return cell


@pytest.fixture
def cache(monkeypatch, tmp_path):
    """The benchmark's data sets under tmp_path; the program's mask
    preprocessing on its numpy path, as the reference's (no native
    library in a fresh checkout)."""
    monkeypatch.setattr(gdata, "CACHE", str(tmp_path / "cache"))
    monkeypatch.setattr(native, "available", lambda: False)
    return tmp_path


@pytest.fixture(autouse=True)
def clean_record():
    tracing.reset()
    yield
    tracing.reset()


def _cpu_profiler():
    return profile(activities=[ProfilerActivity.CPU])


def test_benchmark_run_matches_its_reference_over_three_steps(cache):
    """The cell's run on the CPU (the program's plain kernels) against the
    reference: k = 4 of 6 from the drawn state, the mixed data equal, the
    start equal, flow, loss, probabilities, first gradient and the change
    after three steps within 1e-4, and the mix held (k·B·T views, a
    mask-only clip captured)."""
    result, checks = R.run_cell(_small_cell(), 2 ** 31 + 11, 2.0, False, torch.device("cpu"))
    numbers = {k: v for k, (v, _) in checks.items()}
    assert set(numbers) == {"data", "flow", "loss1", "probs1", "grad1", "change", "start", "mix"}
    assert result["correct"], numbers
    for k, v in numbers.items():
        assert v == 0.0 if k in ("data", "start", "mix") else v <= 1e-4, (k, v)


def test_the_reference_schedule_is_the_programs():
    """The reference's k (its own statement of the recipe's drop schedule)
    equals the program's train/schedules.py at every epoch, and the cell's
    epoch keeps 4 of 6."""
    for epoch in (0, 20, 21, 60, 100, 101, 199):
        for drop in (False, True):
            assert ref.hypotheses_at(epoch, G, drop) == tsched.num_guesses_at(epoch, G, drop,
                                                                              False)
    assert ref.num_hypotheses(bench.Cell(CELL)) == K


def _cfg(lib):
    return lib.Config(
        model=dataclasses.replace(
            lib.ModelConfig(), img_size=64, nz_feat=32, num_lbs=6, num_kps=0, tex_size=2,
            subdivide=1, texture=True, symmetric=False, symmetric_texture=False,
            scale_mesh=True),
        multiplex=dataclasses.replace(lib.MultiplexConfig(), **MULTIPLEX),
        train=dataclasses.replace(lib.TrainConfig(), batch_size=B, num_frames=T, offset_z=0.0,
                                  use_gtpose=False),
        mf_weights=dataclasses.replace(lib.MultiframeLossWeights(), **WEIGHTS),
    )


@pytest.fixture(scope="module")
def recipe_step():
    """One main-loop step of the recipe at k = 4 on both sides from one
    state: the JAX build's weights and an epoch-21-like multiplex (a
    seeded spread of the az-el table, distinct probabilities, and seeded
    deformation tables, so that the mirror-aware gather reaches the
    distillation term; a run's tables stay 0)."""
    with _jitted_flax_init():
        mods_j, (tx_full, _), state = jmf.build(_cfg(jcfg), jbuild_template(**TEMPLATE),
                                                N_FRAMES, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    mpx = state.multiplex
    cams = np.asarray(mpx.cams) + rng.normal(size=mpx.cams.shape) * [1.0, 0.05, 0.05, 0.05,
                                                                      0.1, 0.1]
    logits = rng.normal(size=(N_FRAMES, G)) * 2.0
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    deform = rng.normal(size=mpx.deform.shape) * 2e-3
    deform_m = rng.normal(size=mpx.deform.shape) * 2e-3
    tables = {k: v.astype(np.float32) for k, v in
              dict(cams=cams, probs=probs, deform=deform, deform_mirror=deform_m).items()}
    state = state.replace(multiplex=dataclasses.replace(
        mpx, **{k: jnp.asarray(v) for k, v in tables.items()}))
    batch = _batch(0)
    captured = {}
    with _wide_sigma_and_spies(captured):
        metrics_j, grads_j, new_j, probs_j, sel_j = _jax_train_step(mods_j, tx_full, K)(
            state, {key: jnp.asarray(v) for key, v in batch.items()})
        mods = tmf.build(_cfg(tcfg), ttemplate.build_template(**TEMPLATE), N_FRAMES,
                         device="cpu")
        from_jax.load_jax_multiframe(mods, _tree(state.params), _tree(state.batch_stats),
                                     _tree(state.lpips_params), tables)
        before = {key: v.detach().clone() for key, v in mods.model.state_dict().items()}
        tables0 = {n: p.detach().clone() for n, p in mods.mpx.named_parameters()}
        db = tmf.to_device_batch(mods, batch)
        sel_t = tmpx.topk_hypotheses(mods.mpx.state(), db["frames_idx"], K)
        metrics_t = tmf.make_train_step(mods, k=K)(db)
    bs = _tree(state.batch_stats)
    return {
        "metrics_j": metrics_j, "metrics_t": metrics_t, "captured": captured,
        "grad_j": from_jax.convert(mods.model, _tree(grads_j["params"]), bs),
        "grad_t": {key: p.grad for key, p in mods.model.named_parameters()},
        "after_j": from_jax.convert(mods.model, _tree(new_j["params"]), bs),
        "after_t": mods.model.state_dict(), "before": before,
        "params": [key for key, _ in mods.model.named_parameters()],
        "mpx_grad_j": {n: np.asarray(g) for n, g in grads_j["mpx"].items()},
        "mpx_grad_t": {n: p.grad for n, p in mods.mpx.named_parameters()},
        "mpx_after_t": {n: p.detach() for n, p in mods.mpx.named_parameters()},
        "mpx_after_j": {n: np.asarray(v) for n, v in new_j["mpx"].items()},
        "tables0": tables0, "probs_j": np.asarray(probs_j), "probs_t": mods.mpx.probs,
        "sel_j": np.asarray(sel_j), "sel_t": sel_t, "opt": mods.opt,
    }


@pytest.mark.heavy
def test_recipe_step_selects_the_jax_hypotheses(recipe_step):
    """k = 4 of 6 per frame, JAX's hypotheses in JAX's order, not the same
    set in every frame; the probabilities written back for them (rtol
    1e-3), 0 for the two dropped, every other row untouched."""
    s = recipe_step
    assert s["sel_t"].shape == (K, B * T)
    np.testing.assert_array_equal(s["sel_t"].numpy(), s["sel_j"])
    assert len({tuple(sorted(c)) for c in s["sel_j"].T.tolist()}) > 1
    np.testing.assert_allclose(s["probs_t"].numpy(), s["probs_j"], rtol=1e-3, atol=1e-7)
    rows = s["probs_t"][:B * T]
    assert torch.allclose(rows.sum(-1), torch.ones(B * T), atol=1e-5)
    assert ((rows > 0).sum(-1) == K).all()


@pytest.mark.heavy
def test_recipe_step_loss_matrix_and_metrics_match_jax(recipe_step):
    """The (k, BT) loss matrix and every metric, the deformation tables'
    distillation term (deform_loss) and the texture cycle among them."""
    s = recipe_step
    lm_j, lm_t = s["captured"]["lm_j"], s["captured"]["lm_t"]
    assert lm_t.shape == lm_j.shape == (K, B * T)
    np.testing.assert_allclose(lm_t.numpy(), lm_j, rtol=1e-3, atol=0)
    m_j, m_t = s["metrics_j"], s["metrics_t"]
    assert set(m_t) == set(m_j) and "deform_loss" in m_t and "cycle_loss" in m_t
    for name, want in m_j.items():
        np.testing.assert_allclose(m_t[name].item(), float(want), err_msg=name, **_tol(name))


@pytest.mark.heavy
def test_recipe_step_gradients_and_update_match_jax(recipe_step):
    """Every parameter's gradient as tests/test_torch_port_multiframe.py
    holds it; the az-el table's within 0.05 (through the mask); the
    deformation tables' 0 on both sides (the main loop drops the
    deformation and distils toward the detached tables), so Adam leaves
    them where they were; every parameter and table stepped once."""
    s = recipe_step
    for name in s["params"]:
        gt, gj = s["grad_t"][name], s["grad_j"][name]
        if name in BN_FED_BIASES:
            w = torch.linalg.vector_norm(s["grad_j"][name[:-4] + "weight"])
            assert torch.linalg.vector_norm(gt) <= 1e-5 * w, name
            continue
        if name == "lbs_logits":
            scale = torch.linalg.vector_norm(s["grad_j"]["mean_v"])
            assert torch.linalg.vector_norm(gt - gj) <= 1e-5 * scale
            continue
        if not gj.any():
            assert not gt.any(), name
            continue
        assert _rel(gt, gj) < _grad_bound(name), (name, _rel(gt, gj))
    assert set(s["mpx_grad_t"]) == set(s["mpx_grad_j"]) == {"cams", "deform", "deform_mirror"}
    assert _rel(s["mpx_grad_t"]["cams"], s["mpx_grad_j"]["cams"]) < 0.05
    lr = tcfg.TrainConfig().learning_rate
    for name in ("deform", "deform_mirror"):
        assert not s["mpx_grad_t"][name].any() and not s["mpx_grad_j"][name].any()
        assert torch.equal(s["mpx_after_t"][name], s["tables0"][name])
        np.testing.assert_array_equal(s["mpx_after_j"][name], s["tables0"][name].numpy())
    g_t, g_j = s["mpx_grad_t"]["cams"], torch.tensor(s["mpx_grad_j"]["cams"])
    decided = (g_j.abs() > 1e-6) & (g_t.abs() > 1e-6) & (torch.sign(g_t) == torch.sign(g_j))
    assert decided.any()
    d_t = s["mpx_after_t"]["cams"] - s["tables0"]["cams"]
    d_j = torch.tensor(s["mpx_after_j"]["cams"]) - s["tables0"]["cams"]
    torch.testing.assert_close(d_t[decided], d_j[decided], rtol=0, atol=0.011 * lr)
    opt = s["opt"]
    assert {int(st["step"]) for st in opt.state.values()} == {1}
    assert len(opt.state) == sum(len(g["params"]) for g in opt.param_groups)


def _tiny_mixed(cache) -> dict:
    """The benchmark's mixed tree at the small cell's size: 2 TigDog-format
    videos, then 2 YouTube-VIS-format clips, 6 frames each."""
    return ref.mixed(dict(bench.Cell(CELL).config["dataset"], **SMALL["dataset"]))


def test_youtube_vis_clips_reach_the_batches_mask_only(cache):
    """Through the CLI's build_video_dataset (--expand_ytvis): the clips of
    the YouTube-VIS tree follow the TigDog ones; their frames in the cache
    hold the xywh boxes turned into squared x1 y1 x2 y2 ones and zero
    keypoints, and every TigDog frame some visible keypoint; the clip
    dataset's items equal the JAX package's bit for bit; a loader's batches
    carry zero keypoints for exactly the YouTube-VIS clips, and the traced
    counter counts them."""
    paths = _tiny_mixed(cache)
    o = dict(cli.default_opts(), num_kps=19, expand_ytvis=True, **paths)
    video_ds = cli.build_video_dataset(o)
    assert isinstance(video_ds, ttig.ConcatDataset) and len(video_ds) == 4
    assert [type(d) for d in video_ds.datasets] == [ttig.VideoPklDataset,
                                                     ttig.YTVISPklDataset]
    assert [len(d) for d in video_ds.datasets] == [2, 2]
    n, s2v, spv = ttig.explode_to_frames(video_ds, o["tmp_dir"], "horse",
                                         o["num_training_frames"], write=False)
    assert n == 24
    yt_frames = set(spv[2]) | set(spv[3])
    for vid in (2, 3):
        with open(os.path.join(paths["root_dir_yt"], "horse",
                               f"ytvis_{vid - 2:03d}.pkl"), "rb") as f:
            raw = pickle.load(f)
        assert set(raw) == {"video", "segmentations", "bboxes"}
        for i, frame in enumerate(spv[vid]):
            with open(os.path.join(o["tmp_dir"], "horse", f"{frame}.pkl"), "rb") as f:
                s = pickle.load(f)
            x, y, w, h = raw["bboxes"][i]
            want = image_utils.square_bbox(np.array([x, y, x + w, y + h]))
            np.testing.assert_array_equal(s["bboxes"], want)
            assert s["bboxes"][2] - s["bboxes"][0] == s["bboxes"][3] - s["bboxes"][1]
            assert not s["landmarks"].any()
    for vid in (0, 1):
        for frame in spv[vid]:
            with open(os.path.join(o["tmp_dir"], "horse", f"{frame}.pkl"), "rb") as f:
                assert (pickle.load(f)["landmarks"][:, 2] > 0).any()
    kw = dict(tmp_dir=o["tmp_dir"], category="horse", sample_to_vid=s2v, samples_per_vid=spv,
              num_frames=2, img_size=64, seed=3)
    ds_t = ttig.MultiFrameDataset(**kw)
    ds_j = jtig.MultiFrameDataset(**kw)
    for i in range(n):
        a, b = ds_t[i], ds_j[i]
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    loader = DataLoader(ds_t, 2, shuffle=True, seed=4)
    mask_only = 0
    with _cpu_profiler():
        for batch in loader:
            for clip in range(2):
                yt = set(batch["frames_idx"][clip].tolist()) <= yt_frames
                mask_only += yt
                assert (not batch["kp"][clip].any()) == yt
    assert mask_only > 0
    assert tracing.counters()["data.mask_only_clips"] == mask_only


def test_drawn_probabilities_make_top_k_differ_across_frames():
    """The cell's drawn multiplex state, on the program's tables and on the
    reference's alike: every frame's row a distribution with no ties, the
    top 4 not the same set in every frame, the az-el table moved off its
    init in every column, the deformation tables left at 0."""
    cell = bench.Cell(CELL)
    n = 64
    cfg = _cfg(tcfg)
    init = tmpx.init_az_el_multiplex(n, G, 6, with_deform=True)
    prog = tmf.Multiplex(init)
    frozen = frozen_mf.Multiplex(frozen_mf.mpx_lib.init_az_el_multiplex(n, G, 6))
    for m in (prog, frozen):
        ref.write_multiplex(m, cell, 2 ** 33 + 5)
    for name, t in prog.state_dict().items():
        assert torch.equal(t, frozen.state_dict()[name]), name
    probs = prog.probs
    assert torch.allclose(probs.sum(1), torch.ones(n), atol=1e-6)
    assert all(len(set(row)) == G for row in probs.tolist())
    frames = torch.arange(n).reshape(-1, 2)
    sel = tmpx.topk_hypotheses(prog.state(), frames, K)
    assert len({tuple(sorted(c)) for c in sel.T.tolist()}) > 4
    moved = (prog.cams - tmpx.init_az_el_multiplex(n, G, 6).cams).abs()
    assert (moved.amax(dim=(0, 1)) > 0).all()
    assert not prog.deform.any() and not prog.deform_mirror.any()
    assert cfg.multiplex.num_guesses == G


def _small_mods():
    return tmf.build(_cfg(tcfg), ttemplate.build_template(**TEMPLATE), N_FRAMES, device="cpu")


def test_multiplex_spans_and_counters_under_the_profiler():
    """Two recipe steps at k = 4 under a CPU profiler: the spans
    multiplex.select (in train.forward) and multiplex.writeback (in
    train.optimizer) of each step's unit on the loop's thread, and
    k x B x T views a step in the traced counter."""
    mods = _small_mods()
    step = tmf.make_train_step(mods, k=K)
    batches = [tmf.to_device_batch(mods, _batch(s)) for s in range(2)]
    with _cpu_profiler():
        for db in batches:
            step(db)
    spans = tracing.record()
    names = {s.id: s.name for s in spans}
    for name, parent in (("multiplex.select", "train.forward"),
                         ("multiplex.writeback", "train.optimizer")):
        got = [s for s in spans if s.name == name]
        assert [s.unit for s in got] == [0, 1]
        assert {names[s.parent] for s in got} == {parent}
    assert tracing.counters()["multiplex.views"] == 2 * K * B * T


def test_multiplex_spans_and_counters_keep_nothing_off(monkeypatch):
    """Without a profiler the same step opens no span (utils/tracing.py's
    _Span, patched to raise, is never built) and keeps no traced count;
    the host counters count as ever (the step's `train.eager_calls`, from
    utils/graphs.py, among them)."""
    def refuse(*a, **k):
        raise AssertionError("a span opened with tracing off")

    mods = _small_mods()
    step = tmf.make_train_step(mods, k=K)
    db = tmf.to_device_batch(mods, _batch(0))
    monkeypatch.setattr(tracing, "_Span", refuse)
    assert not tracing.on()
    step(db)
    tracing.count_traced("data.mask_only_clips", 3)
    tracing.count("launch.soft")
    assert tracing.record() == []
    assert tracing.counters() == {"launch.soft": 1, "train.eager_calls": 1}
