"""The multiframe trainer's host layers in the port against the JAX package,
on the CPU: the TigDog data path (video pkls, the frame cache, the
multi-frame clips with their mirror and affine augmentation, YTVIS / COCO,
the mixes), the driver loop and the CLI (cli/multiframe_main.py) against
the JAX CLI on one fixture tree from tools/tigdog_fixture.py, the CLI end to
end with the frozen flow net in the loop, and the port's sources importing
no JAX.
"""
import ast
import dataclasses
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_driver import _jax_flags
from test_torch_port_multiframe import _jitted_flax_init, _tol

from acfm_video_3d_reconstruction_tpu.cli import multiframe_main as jcli
from acfm_video_3d_reconstruction_tpu.data import loader as jloader
from acfm_video_3d_reconstruction_tpu.data import tigdog as jtig
from acfm_video_3d_reconstruction_tpu.parallel import mesh as pmesh
from acfm_video_3d_reconstruction_tpu.train import multiframe as jmf
from acfm_video_3d_reconstruction_tpu_torch.cli import multiframe_main as tcli
from acfm_video_3d_reconstruction_tpu_torch.data import loader as tloader
from acfm_video_3d_reconstruction_tpu_torch.data import tigdog as ttig
from acfm_video_3d_reconstruction_tpu_torch.models import from_jax
from acfm_video_3d_reconstruction_tpu_torch.train import checkpoints
from tools.tigdog_fixture import NUM_KPS, make_video, write_tigdog_tree

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAW = (96, 128)


@pytest.fixture(scope="module")
def pkl_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tigdog"))
    write_tigdog_tree(root, "horse", n_videos=2, n_frames=6, raw=RAW, seed=0)
    return root


def _tree_equal(a, b, what=""):
    assert set(a) == set(b), what
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k)
        np.testing.assert_array_equal(x, y, err_msg=f"{what} {k}")


# ------------------------------------------------------------------ fixture

def test_tigdog_fixture_tree(tmp_path):
    """One pkl per clip with the keys and layouts VideoPklDataset reads,
    reproducible from its seed; frames that move; boxes that hold their
    masks; keypoints on the blob with the neck visible."""
    paths = [write_tigdog_tree(str(tmp_path / d), "tiger", 2, 3, (60, 90), seed=5)
             for d in ("a", "b")]
    names = sorted(os.listdir(paths[0]))
    assert names == ["vid_000.pkl", "vid_001.pkl"] == sorted(os.listdir(paths[1]))
    for name in names:
        a, b = (pickle.load(open(os.path.join(p, name), "rb")) for p in paths)
        _tree_equal(a, b, name)
        assert a["video"].shape == (3, 60, 90, 3) and a["video"].dtype == np.uint8
        assert a["segmentations"].shape == (3, 60, 90)
        assert a["landmarks"].shape == (3, NUM_KPS, 3) and a["sfm_poses"].shape == (3, 7)
        assert not np.array_equal(a["video"][0], a["video"][1])
        for t in range(3):
            ys, xs = np.nonzero(a["segmentations"][t])
            x1, y1, x2, y2 = a["bboxes"][t]
            assert x1 <= xs.min() and y1 <= ys.min() and x2 >= xs.max() and y2 >= ys.max()
            vis = a["landmarks"][t, :, 2] > 0
            assert vis[-1] and 10 <= vis.sum() < NUM_KPS
            np.testing.assert_allclose(np.linalg.norm(a["sfm_poses"][t, 3:]), 1.0)


# -------------------------------------------------------------------- data

def test_video_datasets_and_frame_cache_match_jax(pkl_root, tmp_path):
    """VideoPklDataset and explode_to_frames: the same samples and the same
    per-frame cache files, bit for bit, and the same sample maps."""
    tds = ttig.VideoPklDataset(pkl_root, "horse", num_kps=NUM_KPS)
    jds = jtig.VideoPklDataset(pkl_root, "horse", num_kps=NUM_KPS)
    assert tds.paths == jds.paths and len(tds) == 2
    for i in range(len(tds)):
        _tree_equal(tds[i], jds[i], f"video {i}")
    got = ttig.explode_to_frames(tds, str(tmp_path / "t"), "horse", 4)
    want = jtig.explode_to_frames(jds, str(tmp_path / "j"), "horse", 4)
    assert got == want and got[0] == 10  # frames 0..4 of each clip (i >= 4 stops)
    for f in range(got[0]):
        a, b = (pickle.load(open(tmp_path / side / "horse" / f"{f}.pkl", "rb"))
                for side in ("t", "j"))
        _tree_equal(a, b, f"frame {f}")


def test_ytvis_coco_split_and_concat_match_jax(tmp_path):
    """YTVIS / COCO clips (xywh boxes squared, no landmarks or poses: the
    placeholders), the deterministic 14-video test split of TigDog, and
    ConcatDataset's indexing: all as JAX's."""
    rng = np.random.default_rng(1)
    yt = tmp_path / "yt" / "cow"
    yt.mkdir(parents=True)
    for i in range(2):
        v = make_video(rng, 2, (40, 56))
        bb = v["bboxes"].copy()
        bb[:, 2:] -= bb[:, :2]
        with open(yt / f"clip{i}.pkl", "wb") as f:
            pickle.dump({"video": v["video"], "segmentations": v["segmentations"],
                         "bboxes": bb}, f)
    for cls in ("YTVISPklDataset", "COCOPklDataset"):
        t = getattr(ttig, cls)(str(tmp_path / "yt"), "cow", num_kps=16)
        j = getattr(jtig, cls)(str(tmp_path / "yt"), "cow", num_kps=16)
        for i in range(2):
            _tree_equal(t[i], j[i], f"{cls} {i}")
    many = str(tmp_path / "many")
    write_tigdog_tree(many, "horse", 16, 1, (16, 24), seed=2)
    for split in ("train", "test", "all"):
        assert ttig.VideoPklDataset(many, "horse", split).paths == \
            jtig.VideoPklDataset(many, "horse", split).paths
    t = ttig.ConcatDataset([ttig.VideoPklDataset(many, "horse", "test"),
                            ttig.YTVISPklDataset(str(tmp_path / "yt"), "cow")])
    j = jtig.ConcatDataset([jtig.VideoPklDataset(many, "horse", "test"),
                            jtig.YTVISPklDataset(str(tmp_path / "yt"), "cow")])
    assert len(t) == len(j) == 16
    for i in (0, 13, 14, 15):
        _tree_equal(t[i], j[i], f"concat {i}")


@pytest.fixture(scope="module")
def frame_cache(pkl_root, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("cache"))
    ds = ttig.VideoPklDataset(pkl_root, "horse", num_kps=NUM_KPS)
    n, s2v, spv = ttig.explode_to_frames(ds, tmp, "horse", 50)
    return tmp, n, s2v, spv


@pytest.mark.parametrize("variant", ["augmented", "tight_v2", "no_aug", "sequential"])
def test_multiframe_dataset_batches_bit_equal(frame_cache, variant):
    """MultiFrameDataset (clip sampling in the +-3 window, crop, resize,
    clip-level mirror with the keypoint permutation and the camera's
    transport, cv2.warpAffine zoom/shift with its camera parameters) and the
    loader's batches with their edt / boundaries: JAX's, bit for bit, over
    two epochs of shuffled batches."""
    tmp, n, s2v, spv = frame_cache
    kw = dict(tmp_dir=tmp, category="horse", sample_to_vid=s2v, samples_per_vid=spv,
              num_frames=2, img_size=64, seed=3)
    kw.update({"augmented": {}, "no_aug": dict(mirror=False, transforms=False, padding_frac=0.0),
               "tight_v2": dict(tight_bboxes=True, v2_crop=True, remove_neck_kp=False),
               "sequential": dict(sequential=True, num_frames=3)}[variant])
    t, j = ttig.MultiFrameDataset(**kw), jtig.MultiFrameDataset(**kw)
    lt = tloader.DataLoader(t, 4, shuffle=True, seed=2)
    lj = jloader.DataLoader(j, 4, shuffle=True, seed=2)
    flips = 0
    for epoch in range(2):
        for bt, bj in zip(lt, lj, strict=True):
            _tree_equal(bt, bj, f"{variant} epoch {epoch}")
            flips += int(bt["mirror_flag"].sum())
    if variant == "augmented":
        assert flips > 0
        assert (bt["transforms"][..., 3] == 1).all()


# ------------------------------------------------------ the driver and CLI

def _opts(mod, pkl_root, tmp_path, side, **over):
    o = mod.default_opts()
    o.update(name="run", category="horse", root_dir=pkl_root, tmp_dir=str(tmp_path / side / "c"),
             checkpoint_dir=str(tmp_path / side / "s"), img_size=64, num_lbs=6, subdivide=1,
             num_kps=3, nz_feat=32, num_frames=2, num_guesses=2, batch_size=2, num_epochs=1,
             num_training_frames=50, texture=False, init_camera_emb=True, log_every=1,
             save_epoch_freq=1, flow_random_init=True, face_chunk=80)
    o.update(over)
    return o


def _fake_flow_fn(lib):
    """A fixed flow field in place of the frozen net, the same on both
    sides (the JAX CLI test's cheap_flow): slot 0 of every clip."""
    def make(o, img_size, device=None):
        def flow_fn(batch):
            batch = dict(batch)
            B, T = batch["img"].shape[:2]
            flows = np.zeros((B, T, img_size, img_size, 2), np.float32)
            yy, xx = np.mgrid[:img_size, :img_size] / img_size
            flows[:, :-1] = np.stack([1.5 + np.sin(4 * xx), -0.5 + yy], -1)
            batch["optical_flows"] = lib(flows)
            return batch
        return flow_fn
    return make


@pytest.fixture()
def one_device_mesh(monkeypatch):
    real = pmesh.make_mesh
    monkeypatch.setattr(pmesh, "make_mesh", lambda devices=None, axis_name="data": real(
        jax.devices()[:1], axis_name))


def _records(o):
    with open(os.path.join(o["checkpoint_dir"], o["name"], "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh if line.strip()]


@pytest.mark.heavy
def test_cli_first_record_matches_jax(pkl_root, tmp_path, monkeypatch, one_device_mesh):
    """Both CLIs' train() on one fixture tree with the same options (2
    hypotheses, batch 2 clips of 2 frames at 64^2, the camera-embedding init
    pass, mirror and affine augmentation, one epoch), the same flow field,
    and the port started from the JAX build's weights (its multiplex tables
    are JAX's already: the same seeded init): the first metrics.jsonl
    record within the step tests' tolerances, every record finite, the same
    (epoch, step) sequence and the same checkpoint labels."""
    built = {}
    real_build = jmf.build

    def recording_build(*a, **kw):
        with _jitted_flax_init():
            out = real_build(*a, **kw)
        built["state"] = jax.tree_util.tree_map(np.array, out[2])  # the steps donate it
        return out

    monkeypatch.setattr(jmf, "build", recording_build)
    monkeypatch.setattr(jcli, "make_flow_fn_from_opts", _fake_flow_fn(jnp.asarray))
    monkeypatch.setattr(tcli, "make_flow_fn_from_opts", _fake_flow_fn(torch.tensor))
    o_j = _opts(jcli, pkl_root, tmp_path, "j")
    jcli.train(o_j)
    state = built["state"]

    def load_pretrained(model):
        model.load_state_dict(from_jax.convert(model, jax.tree_util.tree_map(
            np.asarray, state.params), jax.tree_util.tree_map(np.asarray, state.batch_stats)))

    monkeypatch.setattr(tcli, "make_pretrained_loader", lambda o: load_pretrained)
    o_t = _opts(tcli, pkl_root, tmp_path, "t", device="cpu")
    mods = tcli.train(o_t)
    rec_j, rec_t = _records(o_j), _records(o_t)
    assert len(rec_t) == len(rec_j) == 6
    assert set(rec_t[0]) == set(rec_j[0])
    for name, want in rec_j[0].items():
        if name not in ("epoch", "step", "time_per_iter"):
            np.testing.assert_allclose(rec_t[0][name], want, err_msg=name, **_tol(name))
    assert rec_t[0]["of_loss"] > 0
    assert all(np.isfinite(v) for r in rec_t for v in r.values())
    assert [(r["epoch"], r["step"]) for r in rec_t] == [(r["epoch"], r["step"]) for r in rec_j]
    assert sorted(os.listdir(tmp_path / "t" / "s" / "run")) == [
        "metrics.jsonl", "opts.log", "pred_net_1.pth", "pred_net_latest.pth"]
    assert sorted(n for n in os.listdir(tmp_path / "j" / "s" / "run") if n.startswith("pred")) \
        == ["pred_net_1", "pred_net_latest"]
    assert mods.step == 6


@pytest.mark.heavy
def test_cli_end_to_end_on_cpu(pkl_root, tmp_path, capsys, monkeypatch):
    """`main` with the flags a user passes: the camera-embedding init, the
    pose warm-up, the texture warm-up, texture on and the frozen MaskFlownet
    (random weights, its input at 64x128 here instead of 384x768, as the JAX
    CLI test shrinks it) in the loop: warm-up and train records (the
    texture warm-up logs none, as JAX's), of_loss nonzero, the warmup /
    texture_warmup / latest / epoch checkpoints. Then --load_warmup with
    --use_gtpose: the texture_warmup checkpoint restored first, no warm-up
    rows, the single-hypothesis GT-pose phase trains. Then
    --num_pretrain_epochs 1: epoch 1's checkpoint restored and epoch 2
    trained."""
    from acfm_video_3d_reconstruction_tpu_torch.flow import infer

    monkeypatch.setattr(infer, "NET_H", 64)
    monkeypatch.setattr(infer, "NET_W", 128)
    common = ["--name", "cli", "--root_dir", pkl_root, "--tmp_dir", str(tmp_path / "cache"),
              "--checkpoint_dir", str(tmp_path / "snap"), "--img_size", "64", "--num_lbs", "6",
              "--subdivide", "1", "--nz_feat", "32", "--num_guesses", "2", "--batch_size", "2",
              "--num_training_frames", "1", "--log_every", "1", "--save_epoch_freq", "1",
              "--flow_random_init", "--device", "cpu"]
    o = {"checkpoint_dir": str(tmp_path / "snap"), "name": "cli"}
    metrics = os.path.join(o["checkpoint_dir"], "cli", "metrics.jsonl")
    mods = tcli.main(common + ["--num_epochs", "1", "--warmup", "--num_reps", "1",
                               "--init_camera_emb", "--texture_warmup", "--tex_num_reps", "1"])
    recs = _records(o)
    warm = [r for r in recs if "warmup_loss" in r]
    main_recs = [r for r in recs if "total_loss" in r]
    assert len(warm) == len(main_recs) == 2 and mods.step == 6
    assert [r["step"] for r in main_recs] == [5, 6]  # after the texture warm-up's 2
    assert all(r["of_loss"] > 0 and np.isfinite(r["total_loss"]) for r in main_recs)
    assert "tex_loss" in main_recs[0] and "cycle_loss" in main_recs[0]
    for label in ("warmup", "texture_warmup", "latest", 1):
        assert checkpoints.exists(o["checkpoint_dir"], "cli", label), label
    os.remove(metrics)
    capsys.readouterr()
    mods2 = tcli.main(common + ["--num_epochs", "1", "--warmup", "--load_warmup",
                                "--use_gtpose"])
    assert "resumed from 'texture_warmup' checkpoint; skipping warmups" in \
        capsys.readouterr().out
    recs = _records(o)
    assert len(recs) == 2 and not any("warmup_loss" in r for r in recs)
    assert mods2.step == 4 + 2  # the texture warm-up checkpoint's 4 steps, then 2 more
    os.remove(metrics)
    mods3 = tcli.main(common + ["--num_epochs", "2", "--num_pretrain_epochs", "1"])
    assert "resumed from epoch 1" in capsys.readouterr().out
    assert [(r["epoch"], r["step"]) for r in _records(o)] == [(1, 1), (1, 2)]
    assert mods3.step == 6 + 2
    assert checkpoints.exists(o["checkpoint_dir"], "cli", 2)


@pytest.mark.heavy
def test_driver_nan_dump(tmp_path, monkeypatch):
    """With ACFM_NAN_DUMP_DIR set, a NaN planted in the third batch's image
    stops the multiframe loop at step 3 and dumps step 2's pre-step state
    (model, tables, Adam) and batch (the monocular driver's rule)."""
    from test_torch_port_multiframe import G, N_FRAMES, TEMPLATE, _batch, _cfg

    from acfm_video_3d_reconstruction_tpu_torch import config as tcfg
    from acfm_video_3d_reconstruction_tpu_torch.models import template as ttemplate
    from acfm_video_3d_reconstruction_tpu_torch.train import driver as tdriver
    from acfm_video_3d_reconstruction_tpu_torch.train import multiframe as tmf

    batches = [{k: v for k, v in _batch(s).items() if k != "optical_flows"} for s in range(3)]
    batches[2]["img"][0, 1, 5, 7, 1] = np.nan
    flows = _batch(0)["optical_flows"]
    monkeypatch.setenv("ACFM_NAN_DUMP_DIR", str(tmp_path / "dump"))
    cfg = _cfg(tcfg)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_dir=str(tmp_path / "ck"), name="nan"))
    with pytest.raises(FloatingPointError, match="epoch 0 step 3"):
        tdriver.run_multiframe_training(
            cfg, ttemplate.build_template(**TEMPLATE), batches, None, N_FRAMES, num_epochs=1,
            log_every=1, flow_fn=lambda b: dict(b, optical_flows=torch.tensor(flows)),
            device="cpu")
    dump = torch.load(str(tmp_path / "dump" / "nan_step_3.pt"), weights_only=True)
    assert (dump["epoch"], dump["step"]) == (0, 3)
    assert dump["state"]["step"] == 1 and dump["state"]["multiplex"]["cams"].shape[0] == G
    np.testing.assert_array_equal(dump["batch"]["img"].numpy(), batches[1]["img"])
    assert dump["batch"]["frames_idx"].dtype == torch.int64
    assert set(dump["batch"]) == set(tmf.BATCH_KEYS) | {"optical_flows"}


def test_cli_flags_and_refusals(pkl_root, tmp_path):
    """The JAX CLI's flags with its defaults, plus --device (default cuda);
    the PASCAL / ImageNet mixes and the visualisation panels, not ported,
    refused with the missing module named; of_loss without a flow source
    refused as JAX refuses it; no card and no --device cpu, an exit."""
    want = dict(_jax_flags(os.path.join(ROOT, "acfm_video_3d_reconstruction_tpu", "cli",
                                        "multiframe_main.py")), device="cuda")
    assert tcli.default_opts() == want
    a = tcli.parse(["--warmup", "--texture=False", "--mirror=0", "--num_guesses", "4"])
    assert (a.warmup, a.texture, a.mirror, a.num_guesses) == (True, False, False, 4)
    o = _opts(tcli, pkl_root, tmp_path, "r", device="cpu")
    for flag, module in (("expand_pascal", "data/pascal.py"), ("expand_imgnet",
                                                               "data/objects.py")):
        with pytest.raises(NotImplementedError, match=module):
            tcli.train(dict(o, **{flag: True}))
    with pytest.raises(NotImplementedError, match="make_multiframe_vis_fn"):
        tcli.train(dict(o, display_freq=1))
    with pytest.raises(ValueError, match="flow_checkpoint"):
        tcli.train(dict(o, flow_random_init=False))
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            tcli.train(dict(o, device="cuda"))


_JAX_ROOTS = ("jax", "jaxlib", "flax", "optax", "orbax", "absl",
              "acfm_video_3d_reconstruction_tpu")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax():
    """No source of the port package, nor tools/tigdog_fixture.py nor
    chip_smoke.py, imports JAX, its libraries or the JAX package, at any
    depth of the code (test_torch_port_raster.py::test_port_imports_no_jax
    imports them all and checks what gets loaded)."""
    paths = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "tools", "tigdog_fixture.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "acfm_video_3d_reconstruction_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    bad = [(p, m) for p in paths for m in _imports(p) if m.split(".")[0] in _JAX_ROOTS]
    assert not bad, bad
    assert len(paths) > 60
