"""The port's training driver layer against the JAX package, on the CPU:
checkpoints (round trip, the non-strict cases, a bit-identical resume), the
driver's NaN dump, the metrics logger, prefetch, the reference-checkpoint import, the monocular
driver loop and the evaluator from the same weights as JAX's, and both
monocular CLIs end to end on a CUB-format tree from tools/cub_fixture.py.
"""
import ast
import copy
import dataclasses
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch
from test_torch_import import (
    make_alexnet_state_dict,
    make_meshnet_state_dict,
    make_resnet18_state_dict,
)
from test_torch_port_slice import DEFAULT_TOL, METRIC_TOL

from acfm_video_3d_reconstruction_tpu import config as jcfg
from acfm_video_3d_reconstruction_tpu.data import cub as jcub
from acfm_video_3d_reconstruction_tpu.data import loader as jloader
from acfm_video_3d_reconstruction_tpu.eval import metrics as jmetrics
from acfm_video_3d_reconstruction_tpu.models import build_template as jbuild_template
from acfm_video_3d_reconstruction_tpu.models import torch_import as jimport
from acfm_video_3d_reconstruction_tpu.parallel import mesh as pmesh
from acfm_video_3d_reconstruction_tpu.train import driver as jdriver
from acfm_video_3d_reconstruction_tpu.train import monocular as jmono
from acfm_video_3d_reconstruction_tpu_torch import config as tcfg
from acfm_video_3d_reconstruction_tpu_torch.cli import monocular_evaluate, monocular_main
from acfm_video_3d_reconstruction_tpu_torch.data import cub as tcub
from acfm_video_3d_reconstruction_tpu_torch.data import loader as tloader
from acfm_video_3d_reconstruction_tpu_torch.geometry import icosphere
from acfm_video_3d_reconstruction_tpu_torch.models import encoder, from_jax, lpips, mesh_net
from acfm_video_3d_reconstruction_tpu_torch.models import template as ttemplate
from acfm_video_3d_reconstruction_tpu_torch.models import torch_import as timport
from acfm_video_3d_reconstruction_tpu_torch.train import checkpoints, metrics_logger, prefetch
from acfm_video_3d_reconstruction_tpu_torch.train import driver as tdriver
from acfm_video_3d_reconstruction_tpu_torch.train import monocular as tmono
from acfm_video_3d_reconstruction_tpu_torch.utils import obj_io
from tools.cub_fixture import write_cub_tree

torch.set_num_threads(1)

IMG = 64
SMALL = dict(subdivide=2, num_lbs=6, tex_size=2, num_kps=4)


def _cfg(lib, texture=True, num_kps=4, **train):
    return lib.Config(
        model=dataclasses.replace(
            lib.ModelConfig(), img_size=IMG, nz_feat=32, num_lbs=6, num_kps=num_kps,
            tex_size=2, subdivide=2, texture=texture, symmetric=False,
            symmetric_texture=False,
        ),
        train=dataclasses.replace(lib.TrainConfig(), batch_size=2, **train),
    )


def _batch(seed, num_kps=4):
    rng = np.random.default_rng(seed)
    return {
        "img": rng.random((2, IMG, IMG, 3), np.float32),
        "mask": (rng.random((2, IMG, IMG)) > 0.5).astype(np.float32),
        "kp": rng.uniform(-1, 1, (2, num_kps, 3)).astype(np.float32),
        "sfm_pose": np.tile(np.asarray([0.8, 0, 0, 1, 0, 0, 0], np.float32), (2, 1)),
        "edt": rng.random((2, IMG, IMG), np.float32),
        "boundaries": rng.uniform(-1, 1, (2, 50, 3)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def small_template():
    return ttemplate.build_template(**SMALL)


_BUILDS = {}


def _build(template, texture=True, seed=0):
    """A fresh copy of one build per (template, texture, seed): the seeded
    init takes seconds on the CPU, a copy milliseconds."""
    key = (id(template), texture, seed)
    if key not in _BUILDS:
        _BUILDS[key] = tmono.build(_cfg(tcfg, texture), template, seed=seed, device="cpu")
    return copy.deepcopy(_BUILDS[key])


def _assert_state_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _assert_opt_equal(sa: dict, sb: dict):
    assert sa["param_groups"] == sb["param_groups"]
    assert set(sa["state"]) == set(sb["state"])
    for i in sa["state"]:
        for k, v in sa["state"][i].items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


# ---------------------------------------------------------------- checkpoints

def test_checkpoint_round_trip(tmp_path, small_template):
    """Model, LPIPS, Adam moments and step count come back exactly (one Adam
    step on seeded gradients; test_resume_is_bit_identical trains)."""
    mods = _build(small_template)
    step = tmono.make_train_step(mods)
    gen = torch.Generator().manual_seed(0)
    for p in mods.model.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    step.opt.step()
    path = checkpoints.save(str(tmp_path), "exp", "latest", mods, step.opt)
    assert path.endswith(os.path.join("exp", "pred_net_latest.pth"))
    assert checkpoints.exists(str(tmp_path), "exp", "latest")
    assert not checkpoints.exists(str(tmp_path), "exp", 3)
    fresh = _build(small_template, seed=1)
    opt = tmono.build_optimizer(fresh)
    assert checkpoints.restore(str(tmp_path), "exp", "latest", fresh, opt) == 1
    _assert_state_equal(fresh.model.state_dict(), mods.model.state_dict())
    _assert_state_equal(fresh.lpips.state_dict(), mods.lpips.state_dict())
    _assert_opt_equal(opt.state_dict(), step.opt.state_dict())


def test_checkpoint_strict_restore_refuses_a_mismatch(tmp_path, small_template):
    mods = _build(small_template, texture=False)
    checkpoints.save(str(tmp_path), "exp", "latest", mods)
    with pytest.raises(RuntimeError):
        checkpoints.restore(str(tmp_path), "exp", "latest", _build(small_template))


@pytest.mark.parametrize("case", ["missing", "extra", "shape"])
def test_checkpoint_non_strict(tmp_path, small_template, case, capsys):
    """JAX's non-strict restore (train/checkpoints.py:32-98): an entry
    missing from the checkpoint keeps the target's value and is printed, an
    entry the target lacks is dropped, a shape mismatch keeps the target
    with a warning; every other entry is loaded."""
    src = _build(small_template, texture=case == "extra", seed=1)
    if case == "shape":
        src.model.camera_predictor.fc1.weight.data = torch.zeros(200, 100)
    checkpoints.save(str(tmp_path), "exp", 2, src)
    tgt = _build(small_template, texture=case == "missing", seed=2)
    before = {k: v.clone() for k, v in tgt.model.state_dict().items()}
    opt = tmono.build_optimizer(tgt)
    checkpoints.restore(str(tmp_path), "exp", 2, tgt, opt, strict=False)
    out = capsys.readouterr().out
    saved = src.model.state_dict()
    for k, v in tgt.model.state_dict().items():
        kept = (k not in saved or (case == "shape" and k == "camera_predictor.fc1.weight"))
        assert torch.equal(v, before[k] if kept else saved[k]), k
    if case == "missing":
        assert "[restore non-strict] missing in checkpoint: model.texture_predictor" in out
        assert "missing in checkpoint: lpips.alex.conv0.weight" in out
    elif case == "shape":
        assert ("shape mismatch at model.camera_predictor.fc1.weight: (200, 100) vs "
                "(200, 200); keeping target") in out
    else:
        assert "missing" not in out
    assert "optimizer state does not fit" in out  # saved without one


def test_resume_is_bit_identical(tmp_path, small_template):
    """2 steps, save, restore into a fresh build, 2 more: weights, Adam
    state and metrics equal to 4 uninterrupted steps (the saved run goes
    on for those)."""
    batches = [_batch(s) for s in range(4)]
    mods = _build(small_template)
    step = tmono.make_train_step(mods)
    want = [step(b) for b in batches[:2]]
    checkpoints.save(str(tmp_path), "exp", "latest", mods, step.opt)
    want += [step(b) for b in batches[2:]]

    resumed = _build(small_template, seed=1)
    step2 = tmono.make_train_step(resumed)
    assert checkpoints.restore(str(tmp_path), "exp", "latest", resumed, step2.opt) == 2
    got = want[:2] + [step2(b) for b in batches[2:]]

    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert torch.equal(g[k], w[k]), k
    _assert_state_equal(resumed.model.state_dict(), mods.model.state_dict())
    _assert_opt_equal(step2.opt.state_dict(), step.opt.state_dict())
    assert checkpoints.steps_taken(step2.opt) == 4


# -------------------------------------------------------------- the NaN dump

def test_nan_dump_holds_the_pre_step_state_and_batch(tmp_path, small_template, monkeypatch):
    """With ACFM_NAN_DUMP_DIR set, a NaN planted in the third batch's image
    makes step 3's total_loss non-finite: the loop stops before logging it
    and dumps nan_step_3.pt with step 2's pre-step state (the model and
    Adam state after one step, as a run of that one step gives them) and
    step 2's batch."""
    batches = [_batch(s) for s in range(3)]
    batches[2]["img"][0, 5, 7, 1] = np.nan
    dump_dir = tmp_path / "dump"
    monkeypatch.setenv("ACFM_NAN_DUMP_DIR", str(dump_dir))
    cfg = _cfg(tcfg, checkpoint_dir=str(tmp_path / "ck"), name="nan")
    with pytest.raises(FloatingPointError, match="epoch 0 step 3"):
        tdriver.run_monocular_training(cfg, small_template, batches, num_epochs=1,
                                       log_every=1, device="cpu")
    assert os.listdir(dump_dir) == ["nan_step_3.pt"]
    dump = torch.load(str(dump_dir / "nan_step_3.pt"), weights_only=True)
    assert (dump["epoch"], dump["step"]) == (0, 3)
    assert not torch.isfinite(dump["metrics"]["total_loss"])
    assert set(dump["batch"]) == set(tmono.BATCH_KEYS)
    for k in tmono.BATCH_KEYS:
        np.testing.assert_array_equal(dump["batch"][k].numpy(), batches[1][k], err_msg=k)
    with open(tmp_path / "ck" / "nan" / "metrics.jsonl") as fh:
        assert [json.loads(s)["step"] for s in fh] == [1, 2]

    ref = _build(small_template, seed=cfg.train.seed)
    step = tmono.make_train_step(ref)
    step(prefetch.to_device(batches[0], tmono.BATCH_KEYS, ref.device))
    _assert_state_equal(dump["state"]["model"], ref.model.state_dict())
    _assert_opt_equal(dump["state"]["optimizer"], step.opt.state_dict())


# --------------------------------------------------------------------- logger

def test_logger_records_and_smoothed_total(tmp_path):
    log = metrics_logger.MetricsLogger(str(tmp_path))
    log.log(0, 1, {"total_loss": torch.tensor(2.0), "kp_loss": 0.5}, echo=False)
    rec = log.log(1, 2, {"total_loss": torch.tensor(4.0)}, echo=False)
    log.close()
    lines = [json.loads(s) for s in open(tmp_path / "metrics.jsonl")]
    assert lines[-1] == rec
    assert set(lines[0]) == {"epoch", "step", "time_per_iter", "total_loss", "kp_loss",
                             "smoothed_total_loss"}
    assert (lines[0]["epoch"], lines[0]["step"], lines[0]["kp_loss"]) == (0, 1, 0.5)
    assert lines[0]["smoothed_total_loss"] == pytest.approx(0.02)
    assert lines[1]["smoothed_total_loss"] == pytest.approx(0.99 * 0.02 + 0.04)


def test_logger_fails_fast_on_non_finite(tmp_path):
    log = metrics_logger.MetricsLogger(str(tmp_path))
    with pytest.raises(FloatingPointError, match=r"\['mask_loss'\]"):
        log.log(3, 7, {"total_loss": 1.0, "mask_loss": torch.tensor(float("nan"))})
    log.close()
    rec = json.loads(open(tmp_path / "metrics.jsonl").read())
    assert rec["step"] == 7 and np.isnan(rec["mask_loss"])


def test_dump_config(tmp_path):
    metrics_logger.dump_config(str(tmp_path), _cfg(tcfg))
    opts = json.load(open(tmp_path / "opts.log"))
    assert opts["model"]["img_size"] == IMG and opts["train"]["batch_size"] == 2


# ------------------------------------------------------------------- prefetch

def test_prefetch_order_and_values():
    assert list(prefetch.prefetch(range(17), lambda x: x * 2, depth=3)) == [
        2 * x for x in range(17)]
    assert list(prefetch.prefetch([], lambda x: x)) == []
    with pytest.raises(ValueError):
        next(prefetch.prefetch(range(3), lambda x: x, depth=0))


@pytest.mark.parametrize("where", ["loader", "prep"])
def test_prefetch_propagates_exceptions(where):
    def loader():
        yield from range(3)
        if where == "loader":
            raise KeyError("boom")
        yield 3

    def prep(x):
        if where == "prep" and x == 3:
            raise KeyError("boom")
        return x

    got = []
    with pytest.raises(KeyError, match="boom"):
        for x in prefetch.prefetch(loader(), prep):
            got.append(x)
    assert got == [0, 1, 2]


def test_prefetch_early_break_stops_producer():
    """Closing the iterator after one batch ends the producer thread,
    joined by its own handle (taken inside prep, which runs on it)."""
    producers = set()

    def prep(x):
        producers.add(threading.current_thread())
        return x

    it = prefetch.prefetch(range(1000), prep, depth=2)
    assert next(it) == 0
    it.close()
    (t,) = producers
    assert t is not threading.current_thread()
    t.join(timeout=10)
    assert not t.is_alive()


def test_prefetch_to_device_on_cpu():
    b = _batch(0)
    out = prefetch.to_device(b, tmono.BATCH_KEYS, torch.device("cpu"))
    assert set(out) == set(tmono.BATCH_KEYS)
    for k in tmono.BATCH_KEYS:
        assert out[k].dtype == torch.float32 and out[k].device.type == "cpu"
        np.testing.assert_array_equal(out[k].numpy(), b[k])


# -------------------------------------------------------------- torch_import

def _tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _assert_modules_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        np.testing.assert_array_equal(sa[k].numpy(), sb[k].numpy(), err_msg=k)


def test_import_resnet18_matches_jax_route():
    """The torchvision state dict through JAX convert_resnet18 ->
    from_jax, and through the port's convert_resnet18 directly."""
    sd = make_resnet18_state_dict(np.random.default_rng(0))
    via_jax, direct = encoder.ResNet18(), encoder.ResNet18()
    via_jax.load_state_dict(from_jax.convert(via_jax, *jimport.convert_resnet18(_np(sd))))
    timport.load_checked(direct, timport.convert_resnet18(sd), require_all=True)
    _assert_modules_equal(direct, via_jax)


def test_import_alexnet_matches_jax_route():
    sd = make_alexnet_state_dict(np.random.default_rng(1))
    via_jax, direct = lpips.LPIPS(), lpips.LPIPS()
    via_jax.load_state_dict(
        from_jax.convert(via_jax, {"alex": jimport.convert_alexnet_features(_np(sd))}))
    timport.load_checked(direct, timport.convert_alexnet_features(sd), require_all=True)
    _assert_modules_equal(direct, via_jax)


@pytest.mark.parametrize("multiframe", [False, True])
def test_import_meshnet_matches_jax_route(multiframe, tmp_path):
    """A reference pred_net state dict (with the dead CodePredictor heads)
    through JAX convert_meshnet (NHWC-permuted FC rows) -> from_jax, and
    through the port's load_reference_meshnet from a file: equal."""
    template = ttemplate.build_template(subdivide=1, num_lbs=5, tex_size=2, num_kps=4)
    sd = make_meshnet_state_dict(np.random.default_rng(7), jbuild_template(
        subdivide=1, num_lbs=5, tex_size=2, num_kps=4), nz_feat=48, multiframe=multiframe)

    def net():
        return mesh_net.MeshNet(template, img_size=256, nz_feat=48,
                                use_camera_layernorm=multiframe)

    via_jax, direct = net(), net()
    via_jax.load_state_dict(from_jax.convert(via_jax, *jimport.convert_meshnet(_np(sd))))
    torch.save({"state_dict": sd}, str(tmp_path / "pred_net_10.pth"))
    timport.load_reference_meshnet(direct, str(tmp_path / "pred_net_10.pth"))
    _assert_modules_equal(direct, via_jax)


def test_pretrained_encoder_loader(tmp_path, small_template):
    sd = make_resnet18_state_dict(np.random.default_rng(2))
    torch.save(sd, str(tmp_path / "r18.pth"))
    model = _build(small_template, texture=False).model
    assert not timport.maybe_load_pretrained_encoder(model, str(tmp_path / "none.pth"))
    assert timport.maybe_load_pretrained_encoder(model, str(tmp_path / "r18.pth"))
    assert torch.equal(model.encoder.resnet.layer2_0.downsample_conv.weight,
                       sd["layer2.0.downsample.0.weight"])
    with pytest.raises(ValueError, match="shape mismatch"):
        timport.load_checked(model, {"mean_v": torch.zeros(3, 3)})


# ------------------------------------------------- driver and evaluator vs JAX

@pytest.fixture(scope="module")
def cub_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cub"))
    write_cub_tree(root, n_train=8, n_test=4, raw=(80, 120), seed=3)
    return root


@pytest.fixture(scope="module")
def jax_pair(cub_root):
    """Both packages' templates (icosphere, SfM mean-shape keypoints from the
    fixture) and the JAX init state (texture off, 15 keypoints)."""
    S, _ = jcub.load_sfm_mean_shape(cub_root)
    kw = dict(SMALL, num_kps=15, sfm_kp_points=S)
    template_j = jbuild_template(**kw)
    cfg_j = _cfg(jcfg, texture=False, num_kps=15)
    _, _, state = jmono.build(cfg_j, template_j, jax.random.PRNGKey(0))
    return template_j, ttemplate.build_template(**kw), state


@pytest.fixture()
def one_device_mesh(monkeypatch):
    """The JAX driver on a 1-device mesh (the tests' 8-device CPU mesh makes
    SPMD compiles take minutes), as tests/test_cli_multiframe_e2e.py does."""
    real = pmesh.make_mesh
    monkeypatch.setattr(pmesh, "make_mesh", lambda devices=None, axis_name="data": real(
        jax.devices()[:1], axis_name))


@pytest.mark.heavy
def test_driver_matches_jax(cub_root, jax_pair, tmp_path, one_device_mesh):
    """run_monocular_training on both sides from the same weights and the
    same batches (one epoch of the port's CUB loader, equal to JAX's by
    test_torch_port_data.py): the first metrics.jsonl record within
    tests/test_torch_port_slice.py's tolerances, every record finite, the
    same checkpoints written."""
    template_j, template_t, state = jax_pair
    ds = tcub.CUBDataset(cub_root, cub_root, img_size=IMG)
    batches = list(tloader.DataLoader(ds, batch_size=4, shuffle=True, seed=1))
    kw = dict(texture=False, num_kps=15, save_epoch_freq=1, name="run")
    cfg_j = _cfg(jcfg, checkpoint_dir=str(tmp_path / "j"), **kw)
    cfg_t = _cfg(tcfg, checkpoint_dir=str(tmp_path / "t"), **kw)

    jdriver.run_monocular_training(cfg_j, template_j, batches, num_epochs=1, log_every=1)

    def load_pretrained(model):
        model.load_state_dict(from_jax.convert(model, _tree(state.params),
                                               _tree(state.batch_stats)))

    mods, opt = tdriver.run_monocular_training(cfg_t, template_t, batches, num_epochs=1,
                                               log_every=1, load_pretrained=load_pretrained,
                                               device="cpu")
    rec_j, rec_t = ([json.loads(s) for s in open(tmp_path / side / "run" / "metrics.jsonl")]
                    for side in ("j", "t"))
    assert len(rec_j) == len(rec_t) == len(batches) == 2
    assert set(rec_j[0]) == set(rec_t[0])
    for name, want in rec_j[0].items():
        if name not in ("epoch", "step", "time_per_iter"):
            np.testing.assert_allclose(rec_t[0][name], want, err_msg=name,
                                       **METRIC_TOL.get(name, DEFAULT_TOL))
    assert all(np.isfinite(v) for r in rec_t for v in r.values())
    assert [(r["epoch"], r["step"]) for r in rec_t] == [(r["epoch"], r["step"]) for r in rec_j]
    assert checkpoints.steps_taken(opt) == 2
    for label in ("latest", 1):
        assert checkpoints.exists(str(tmp_path / "t"), "run", label)
    assert sorted(os.listdir(tmp_path / "t" / "run")) == [
        "metrics.jsonl", "opts.log", "pred_net_1.pth", "pred_net_latest.pth"]


@pytest.mark.heavy
def test_evaluator_matches_jax(cub_root, jax_pair, tmp_path):
    """The port's evaluate (restoring a checkpoint of the JAX init weights)
    against the JAX evaluator's loop body (cli/monocular_evaluate.py:64-96)
    on the test split: mean IoU within 1e-3 (a mask at atol 2e-4,
    thresholded at 0.5, may flip a few pixels), each PCK within one
    keypoint's share of the visible count."""
    template_j, template_t, state = jax_pair
    cfg_j = _cfg(jcfg, texture=False, num_kps=15, use_gtpose=False)
    mods_j, _, _ = jmono.build(cfg_j, template_j, jax.random.PRNGKey(0))
    ev = jmono.make_eval_step(mods_j)
    ds_j = jcub.CUBDataset(cub_root, cub_root, split="test", img_size=IMG, jitter_frac=0.0)
    stats_j = jmetrics.BenchStats()
    for batch in jloader.DataLoader(ds_j, 2, shuffle=False, drop_last=True):
        aux = ev(state, batch)
        mask_pred = (np.asarray(aux["mask_pred"]) > 0.5).astype(np.float32)
        err, vis = jmetrics.kp_errors(np.asarray(aux["kp_pred"]), batch["kp"], 0.05)
        stats_j.update(jmetrics.mask_iou(batch["mask"], mask_pred), err, vis)

    cfg_t = _cfg(tcfg, texture=False, num_kps=15)
    mods = tmono.build(cfg_t, template_t, device="cpu")
    from_jax.load_jax_weights(mods, _tree(state.params), _tree(state.batch_stats), {})
    checkpoints.save(str(tmp_path), "run", "latest", mods)
    args = monocular_evaluate.parse([
        "--checkpoint_dir", str(tmp_path), "--name", "run", "--batch_size", "2",
        "--device", "cpu"])
    ds = tcub.CUBDataset(cub_root, cub_root, split="test", img_size=IMG, jitter_frac=0.0)
    stats_t = monocular_evaluate.evaluate(cfg_t, template_t, ds, args)

    rj, rt = stats_j.results(), stats_t.results()
    assert abs(rt["mean_iou"] - rj["mean_iou"]) <= 1e-3
    n_vis = np.concatenate(stats_j.kp_vis).sum(0)
    keep = n_vis > 0
    share = 1.0 / (n_vis[keep].min() * keep.sum())
    for k in ("pck_0.1", "pck_0.15"):
        assert abs(rt[k] - rj[k]) <= share + 1e-12, (k, rt[k], rj[k], share)


# ------------------------------------------------------------------ the CLIs

def _jax_flags(*paths):
    """{name: default} of the flags.DEFINE_* calls in the JAX CLI sources."""
    out = {}
    for path in paths:
        for node in ast.walk(ast.parse(open(path).read())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr.startswith("DEFINE_")):
                out[ast.literal_eval(node.args[0])] = ast.literal_eval(node.args[1])
    return out


@pytest.mark.parametrize("cli", ["monocular_main", "monocular_evaluate"])
def test_cli_flags_match_jax(cli):
    """The port's CLIs take every flag of the JAX CLIs with the same
    default, plus --device (default cuda)."""
    jcli = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "acfm_video_3d_reconstruction_tpu", "cli")
    srcs = [os.path.join(jcli, "monocular_main.py")]
    if cli == "monocular_evaluate":
        srcs.append(os.path.join(jcli, "monocular_evaluate.py"))
    want = dict(_jax_flags(*srcs), device="cuda")
    got = vars({"monocular_main": monocular_main, "monocular_evaluate": monocular_evaluate}[
        cli].parse([]))
    assert got == want
    a = monocular_main.parse(["--texture=False", "--symmetric", "--use_gtpose=0"])
    assert (a.texture, a.symmetric, a.use_gtpose) == (False, True, False)

@pytest.mark.heavy
def test_clis_end_to_end_on_cpu(cub_root, tmp_path, capsys):
    """monocular_main trains one epoch without texture, with a visualization
    panel; monocular_evaluate (texture on) restores it non-strictly, saves a
    panel and prints the reference line. Both read their template mesh from
    an OBJ (--mesh_dir: a once-subdivided icosphere, 80 faces)."""
    mesh = str(tmp_path / "mesh.obj")
    obj_io.save_obj(mesh, *icosphere.icosphere(1))
    common = ["--cub_dir", cub_root, "--cub_cache_dir", cub_root, "--checkpoint_dir",
              str(tmp_path), "--name", "cli", "--img_size", str(IMG), "--batch_size", "4",
              "--nz_feat", "32", "--num_lbs", "6", "--tex_size", "2", "--mesh_dir", mesh,
              "--device", "cpu"]
    mods, opt = monocular_main.main(common + ["--num_epochs", "1", "--save_epoch_freq", "1",
                                              "--log_every", "1", "--texture=False",
                                              "--batch_size", "8", "--display_freq", "1"])
    assert mods.lpips is None and checkpoints.steps_taken(opt) == 1
    for f in ("metrics.jsonl", "opts.log", "pred_net_latest.pth", "pred_net_1.pth",
              "vis/step_0000001.png"):
        assert (tmp_path / "cli" / f).exists(), f
    capsys.readouterr()
    stats = monocular_evaluate.main(common + ["--split", "test", "--texture=True",
                                              "--num_train_epoch", "1", "--save_visuals", "1",
                                              "--results_dir", str(tmp_path / "eval")])
    assert (tmp_path / "eval" / "eval_batch_0000.png").exists()
    out = capsys.readouterr().out
    assert "[restore non-strict] missing in checkpoint: model.texture_predictor" in out
    assert "[restore non-strict] missing in checkpoint: lpips.alex.conv0.weight" in out
    r = stats.results()
    assert ("mean iou %.3g, pck.1 %.3g, pck.15 %.3g"
            % (r["mean_iou"], r["pck_0.1"], r["pck_0.15"])) in out.splitlines()
    if not torch.cuda.is_available():  # the default device is the card, no fallback
        with pytest.raises(SystemExit, match="no CUDA device"):
            monocular_main.main(common[:-2] + ["--num_epochs", "1"])
    with pytest.raises(SystemExit):
        monocular_main.parse(["--texture=maybe"])
