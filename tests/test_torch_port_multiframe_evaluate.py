"""The multiframe evaluate CLI and the visual panels of the port against the
JAX package, on the CPU: cli/multiframe_evaluate.py against the JAX CLI's
`main` on one tools/tigdog_fixture.py tree from the same flax weights (with
and without TTO), its flags, its refusal, utils/vis.py::VisRenderer against
JAX's, and train/visualize.py::make_multiframe_vis_fn through the training
CLI's --display_freq.

Config: 64^2, icosphere subdivide 1 (42 vertices), 6 handles, nz_feat 32,
2 hypotheses, batches of 2 clips of 2 frames, texture off, the fixture's 18
keypoints (a keypoint dictionary; the loader drops the neck of 19) on 2
clips of 6 frames, 4 of each cached (--num_training_frames 3): 4 batches.
Both CLIs see one fixed flow field in place of the frozen net (the CLI
tests' `_fake_flow_fn`).
"""
import os

import jax
import numpy as np
import pytest
import torch
from absl import flags
from test_torch_port_driver import _jax_flags
from test_torch_port_multiframe import _jitted_flax_init
from test_torch_port_multiframe_cli import _fake_flow_fn

from acfm_video_3d_reconstruction_tpu.cli import multiframe_evaluate as jeval
from acfm_video_3d_reconstruction_tpu.eval import metrics as jmetrics
from acfm_video_3d_reconstruction_tpu.geometry import icosphere as jico
from acfm_video_3d_reconstruction_tpu.train import multiframe as jmf
from acfm_video_3d_reconstruction_tpu.utils import vis as jvis
from acfm_video_3d_reconstruction_tpu_torch.cli import multiframe_evaluate as tevl
from acfm_video_3d_reconstruction_tpu_torch.cli import multiframe_main as tcli
from acfm_video_3d_reconstruction_tpu_torch.models import from_jax
from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer as tras
from acfm_video_3d_reconstruction_tpu_torch.train import checkpoints
from acfm_video_3d_reconstruction_tpu_torch.train import multiframe as tmf
from acfm_video_3d_reconstruction_tpu_torch.utils import vis as tvis
from tools.tigdog_fixture import write_kp_dict, write_tigdog_tree

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = flags.FLAGS


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tigdog")
    write_tigdog_tree(str(root / "pkls"), "horse", n_videos=2, n_frames=6, raw=(96, 128), seed=4)
    return {"root_dir": str(root / "pkls"),
            "kp_dict": write_kp_dict(str(root / "kp.pkl"), num_verts=42)}


def _argv(tree, tmp, side, extra, absl=False, train=False):
    """The flags both packages' CLIs take, for `side`'s own directories."""
    false = "false" if absl else "False"
    results = [] if train else ["--results_dir", str(tmp / side / "eval")]
    return results + [
        "--name", "ev", "--category", "horse", "--root_dir", tree["root_dir"],
        "--tmp_dir", str(tmp / side / "cache"), "--checkpoint_dir", str(tmp / side / "snap"),
        "--kp_dict", tree["kp_dict"], "--img_size", "64", "--num_lbs", "6", "--subdivide", "1",
        "--nz_feat", "32", "--num_guesses", "2", "--batch_size", "2",
        "--num_training_frames", "3", f"--texture={false}"] + extra


@pytest.fixture()
def run_jax(tmp_path, monkeypatch):
    """Run the JAX CLI's main with the given flags; returns the flax state
    it evaluated (its own seeded init: no JAX checkpoint exists)."""
    built = {}
    real_build = jmf.build

    def recording_build(*a, **kw):
        with _jitted_flax_init():
            out = real_build(*a, **kw)
        built["state"] = jax.tree_util.tree_map(np.asarray, out[2])
        return out

    monkeypatch.setattr(jmf, "build", recording_build)
    monkeypatch.setattr(jeval, "make_flow_fn_from_opts", _fake_flow_fn(jax.numpy.asarray))

    def run(argv):
        FLAGS(["multiframe_evaluate"] + argv)
        try:
            jeval.main(None)
        finally:
            FLAGS.unparse_flags()
        return built["state"]

    return run


def _port_checkpoint(o, state):
    """The JAX state as the port's `latest` checkpoint of run o["name"]."""
    cfg = tcli.build_cfg(o)
    mpx = state.multiplex
    mods = tmf.build(cfg, tcli.build_mf_template(cfg), mpx.cams.shape[1], device="cpu")
    from_jax.load_jax_multiframe(mods, state.params, state.batch_stats, state.lpips_params,
                                 {"cams": np.asarray(mpx.cams), "probs": np.asarray(mpx.probs),
                                  "deform": None, "deform_mirror": None})
    checkpoints.save_multiframe(o["checkpoint_dir"], o["name"], "latest", mods)


@pytest.mark.heavy
@pytest.mark.parametrize("mode", ["predicted", "tto"])
def test_evaluate_cli_matches_jax(tree, tmp_path, run_jax, monkeypatch, mode):
    """The port's evaluate against the JAX CLI's main from the same weights
    (the JAX build's, restored from a port checkpoint): without TTO, and
    with --optimize --num_optim_iter 2 (the flow term on). Mean IoU within
    1e-3 (a mask at atol 2e-4, thresholded at 0.5, may flip a few pixels),
    each PCK within one keypoint's share of the visible count, the same
    results.npz keys and shapes, the cameras within 1e-4 (vector relative
    error)."""
    extra = ["--optimize", "--num_optim_iter", "2"] if mode == "tto" else []
    state = run_jax(_argv(tree, tmp_path, "j", extra, absl=True))
    want = np.load(tmp_path / "j" / "eval" / "results.npz")
    monkeypatch.setattr(tcli, "make_flow_fn_from_opts", _fake_flow_fn(torch.tensor))
    o = vars(tevl.parse(_argv(tree, tmp_path, "t", extra + ["--device", "cpu"])))
    _port_checkpoint(o, state)
    stats = tevl.evaluate(o)
    got = np.load(tmp_path / "t" / "eval" / "results.npz")
    assert sorted(got.files) == sorted(want.files) == ["cams", "ious", "kp_errs", "kp_pred",
                                                       "kp_vis"]
    for k in got.files:
        assert got[k].shape == want[k].shape, k
    np.testing.assert_array_equal(got["kp_vis"], want["kp_vis"])
    stats_j = jmetrics.BenchStats()
    stats_j.update(want["ious"], want["kp_errs"], want["kp_vis"])
    rj, rt = stats_j.results(), stats.results()
    assert abs(rt["mean_iou"] - rj["mean_iou"]) <= 1e-3, (rt, rj)
    n_vis = want["kp_vis"].sum(0)
    keep = n_vis > 0
    share = 1.0 / (n_vis[keep].min() * keep.sum())
    for k in ("pck_0.1", "pck_0.15"):
        assert abs(rt[k] - rj[k]) <= share + 1e-12, (k, rt[k], rj[k], share)
    cams = got["cams"]
    assert np.linalg.norm(cams - want["cams"]) <= 1e-4 * np.linalg.norm(want["cams"])


def test_evaluate_flags_match_jax_and_refusals(tree, tmp_path):
    """The JAX evaluate CLI's flags (its own on top of the training CLI's)
    with their defaults, plus --device (default cuda); --gauge_align
    without --use_gt_camera refused as JAX refuses it; no card and no
    --device cpu, an exit."""
    jcli = os.path.join(ROOT, "acfm_video_3d_reconstruction_tpu", "cli")
    want = dict(_jax_flags(os.path.join(jcli, "multiframe_main.py"),
                           os.path.join(jcli, "multiframe_evaluate.py")), device="cuda")
    assert tevl.default_opts() == want
    a = tevl.parse(["--optimize", "--save_mat=True", "--num_optim_iter", "7"])
    assert (a.optimize, a.save_mat, a.num_optim_iter, a.optimize_camera) == (True, True, 7, False)
    o = vars(tevl.parse(_argv(tree, tmp_path, "r", ["--gauge_align", "--device", "cpu"])))
    with pytest.raises(ValueError, match="--use_gt_camera"):
        tevl.evaluate(o)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            tevl.evaluate(dict(o, gauge_align=False, device="cuda"))


@pytest.mark.parametrize("view", ["front", "diff_vp"])
def test_vis_renderer_matches_jax(view, monkeypatch):
    """VisRenderer (default blue texture, white background) and diff_vp
    (90 degrees about x) against JAX's on tests/test_vis_misc.py's scene:
    the uint8 images agree on >= 99.9% of the pixels (the port bins, JAX's
    CPU path is dense: a pixel on an edge may fall to the other face), and
    each render is one hard rasterization."""
    v, f = jico.icosphere(1)
    verts, cam = v * 0.5, np.asarray([0.9, 0, 0, 1, 0, 0, 0], np.float32)
    calls = []
    real = tras.rasterize_binned
    monkeypatch.setattr(tras, "rasterize_binned",
                        lambda *a, **k: calls.append(k.get("soft", True)) or real(*a, **k))
    size = 64
    rj, rt = jvis.VisRenderer(size, f), tvis.VisRenderer(size, f, device="cpu")
    if view == "front":
        got, want = rt(verts, cam), rj(verts, cam)
    else:
        got, want = rt.diff_vp(verts, cam), rj.diff_vp(verts, cam)
    assert calls == [False]
    assert got.shape == want.shape == (size, size, 3) and got.dtype == np.uint8
    same = (got == want).all(-1).mean()
    assert same >= 0.999, same
    assert (got == 255).all(-1).any() and (got[..., 2] > got[..., 0]).any()


@pytest.mark.heavy
def test_training_cli_display_freq_writes_panels(tree, tmp_path):
    """The multiframe training CLI with --display_freq 2: the driver's
    vis_fn hook (make_multiframe_vis_fn) writes vis/step_<n>.png every 2
    main-loop steps, each a (4 * 64, 3 * 64 + 2 * 64) RGB panel (render_row
    of 4 views beside the vertex scatter) whose predicted-mask column is
    not empty."""
    from PIL import Image

    tcli.main(_argv(tree, tmp_path, "v", [
        "--num_epochs", "1", "--of_loss_wt", "0", "--display_freq", "2", "--log_every", "10",
        "--device", "cpu"], train=True))
    out = tmp_path / "v" / "snap" / "ev" / "vis"
    names = sorted(os.listdir(out))
    assert names == ["step_0000002.png", "step_0000004.png"]
    img = np.asarray(Image.open(out / names[0]))
    assert img.shape == (4 * 64, 5 * 64, 3)
    assert img[:, 2 * 64:3 * 64].max() > 0
