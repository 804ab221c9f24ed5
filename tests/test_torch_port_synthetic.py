"""The port's synthetic data path and its convergence demo against the JAX
package's, on the CPU.

* data/synthetic.py: the ground-truth cameras, deformations and keypoint
  anchors bit-equal to JAX's (the same numpy draws in the same order); the
  solved meshes and the keypoints within 1e-5 on the CPU tests' template
  (subdivide 2) and within 1e-4 on the demo's (subdivide 3, 12 handles:
  the f32 normal equations of the solve, rounded in another order, the
  bound of tests/test_torch_port_slice.py); the masks equal on >= 99.9% of
  the pixels (JAX renders dense on the CPU, the port bins at K = F);
  get_batch and preprocess_batch bit-equal given the same renders; the
  flows within 1e-5 of the keypoints' motion scale.
* tools/torch_train_synthetic_demo.py: its constants and defaults equal
  tools/train_synthetic_demo.py's (read from that file's source, which
  parses argv when imported); its cosine rate equals optax's at every step
  within 1e-7; and 3 steps of run_demo from the JAX model's weights
  (models/from_jax.py) at 64^2, f32, against the same JAX calls the JAX
  demo's main makes: each step's loss from the same state rtol 1e-3, IoU
  before and after within 1e-3, PCK within one keypoint's share.
"""
import ast
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from acfm_video_3d_reconstruction_tpu import config as jcfg
from acfm_video_3d_reconstruction_tpu.data import synthetic as jsyn
from acfm_video_3d_reconstruction_tpu.deform import solve as jsolve
from acfm_video_3d_reconstruction_tpu.eval import metrics as jem
from acfm_video_3d_reconstruction_tpu.models import build_template as jbuild_template
from acfm_video_3d_reconstruction_tpu.train import monocular as jmono
from acfm_video_3d_reconstruction_tpu_torch.data import synthetic as tsyn
from acfm_video_3d_reconstruction_tpu_torch.deform import solve as tsolve
from acfm_video_3d_reconstruction_tpu_torch.models import from_jax
from acfm_video_3d_reconstruction_tpu_torch.models.template import build_template
from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer as tras
from acfm_video_3d_reconstruction_tpu_torch.train import monocular as tmono

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import torch_train_synthetic_demo as demo  # noqa: E402

torch.set_num_threads(1)

# (image size, template, bound on the solved meshes and keypoints)
SCENES = {
    "32_sub2": (32, dict(subdivide=2, num_lbs=6, tex_size=2, num_kps=4), 1e-5),
    "64_sub2": (64, dict(subdivide=2, num_lbs=6, tex_size=2, num_kps=4), 1e-5),
    "64_demo": (64, dict(subdivide=3, num_lbs=12, tex_size=4, num_kps=8), 1e-4),
}


@pytest.mark.parametrize("scene", list(SCENES))
def test_synthetic_dataset_matches_jax(scene):
    img, tkw, bound = SCENES[scene]
    cfg = dict(num_frames_total=12, clip_len=2, image_size=img, num_kps=tkw["num_kps"],
               seed=3)
    jt, tt = jbuild_template(**tkw), build_template(**tkw)
    j = jsyn.SyntheticDataset(jt, jsyn.SyntheticConfig(**cfg))
    t = tsyn.SyntheticDataset(tt, tsyn.SyntheticConfig(**cfg), device="cpu")
    for k in ("gt_cams", "gt_deform", "kp_verts"):
        a, b = getattr(t, k), getattr(j, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k

    # the solve the render runs, on the same template arrays
    pv_t = tsolve.screened_poisson_solve(
        torch.tensor(tt.verts, dtype=torch.float32),
        tsolve.lbs_from_logits(torch.tensor(tt.lbs_logits, dtype=torch.float32)),
        torch.tensor(t.gt_deform), torch.tensor(tt.uniform_L, dtype=torch.float32))
    pv_j = jsolve.screened_poisson_solve(
        jnp.asarray(jt.verts), jsolve.lbs_from_logits(jnp.asarray(jt.lbs_logits)),
        jnp.asarray(j.gt_deform), jnp.asarray(jt.uniform_L))
    np.testing.assert_allclose(pv_t.numpy(), np.asarray(pv_j), atol=bound, rtol=0)
    np.testing.assert_allclose(t.kps, j.kps, atol=bound, rtol=0)
    assert (t.masks == j.masks).mean() >= 0.999
    assert t.masks.shape == j.masks.shape and t.imgs.shape == j.imgs.shape

    # the host path from the same renders
    t.masks, t.kps, t.imgs = j.masks, j.kps, j.imgs
    ids = np.asarray([2, 0, 5])
    bt, bj = t.get_batch(ids), j.get_batch(ids)
    pt, pj = tsyn.preprocess_batch(bt, img), jsyn.preprocess_batch(bj, img)
    assert set(pt) == set(pj)
    for k in pt:
        assert pt[k].dtype == pj[k].dtype and np.array_equal(pt[k], pj[k]), k
    assert len(t) == len(j) == 6


def test_synthetic_flows_match_jax():
    """The constant per-clip flow from each side's own keypoints: within
    1e-5 of its scale (the keypoints' motion in pixels)."""
    tkw = SCENES["64_sub2"][1]
    cfg = dict(num_frames_total=12, clip_len=3, image_size=64, num_kps=4, seed=1)
    j = jsyn.SyntheticDataset(jbuild_template(**tkw), jsyn.SyntheticConfig(**cfg))
    t = tsyn.SyntheticDataset(build_template(**tkw), tsyn.SyntheticConfig(**cfg),
                              device="cpu")
    t.masks = j.masks
    ids = np.arange(4)
    ft, fj = t.get_batch(ids)["optical_flows"], j.get_batch(ids)["optical_flows"]
    scale = np.abs(fj).max()
    assert scale > 0.1
    np.testing.assert_allclose(ft, fj, atol=1e-5 * scale, rtol=0)
    assert (fj[:, -1] == 0).all() and (ft[:, -1] == 0).all()


def test_render_is_one_soft_rasterization(monkeypatch):
    """_render_all rasterizes all frames in one soft call at K = F (bins
    that hold every face below 256^2)."""
    calls = []
    real = tras.rasterize_binned

    def counting(verts, faces, image_size, K, *a, **kw):
        calls.append((verts.shape[0], image_size, K, kw.get("soft", True)))
        return real(verts, faces, image_size, K, *a, **kw)

    monkeypatch.setattr(tras, "rasterize_binned", counting)
    t = build_template(subdivide=2, num_lbs=6, tex_size=2, num_kps=4)
    tsyn.SyntheticDataset(t, tsyn.SyntheticConfig(num_frames_total=8, image_size=32),
                          device="cpu")
    assert calls == [(8, 32, t.num_faces, True)]


# ------------------------------------------------------------------ the demo

def _jax_demo_source():
    """The JAX demo's module-level constants, argparse defaults and the
    literal arguments of its calls, from its source."""
    tree = ast.parse(open(os.path.join(ROOT, "tools", "train_synthetic_demo.py")).read())
    consts, defaults, calls = {}, {}, {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    consts[tgt.id] = node.value.value
        if isinstance(node, ast.Call):
            name = node.func.attr if isinstance(node.func, ast.Attribute) else \
                getattr(node.func, "id", None)
            kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords
                  if isinstance(k.value, ast.Constant)}
            args = [ast.literal_eval(a) for a in node.args if isinstance(a, ast.Constant)]
            if name == "add_argument":
                defaults[args[0].lstrip("-")] = kw.get("default")
            else:
                calls.setdefault(name, []).append((args, kw))
    return consts, defaults, calls


def test_demo_constants_match_jax_tool():
    consts, defaults, calls = _jax_demo_source()
    assert (demo.IMG, demo.BATCH) == (consts["IMG"], consts["BATCH"])
    assert {k: defaults[k] for k in demo.DEFAULTS} == demo.DEFAULTS
    assert defaults["cosine"] is True and defaults["out"] == "DEMO_RESULTS.md"
    (_, bt), = calls["build_template"]
    assert bt == dict(subdivide=demo.SUBDIVIDE, num_lbs=demo.NUM_LBS, tex_size=demo.TEX_SIZE,
                      num_kps=demo.NUM_KPS)
    assert calls["default_rng"] == [([demo.ANCHOR_SEED], {})]
    assert calls["choice"] == [([demo.num_verts(demo.SUBDIVIDE), demo.NUM_KPS],
                                {"replace": False})]
    model_kw = [kw for _, kw in calls["replace"] if "nz_feat" in kw]
    assert model_kw == [dict(nz_feat=demo.NZ_FEAT, num_lbs=demo.NUM_LBS, num_kps=demo.NUM_KPS,
                             tex_size=demo.TEX_SIZE, texture=True, symmetric=False,
                             symmetric_texture=False, dtype="bfloat16")]
    assert [kw for _, kw in calls["replace"] if "use_gtpose" in kw] == [dict(use_gtpose=True)]
    (_, sc), = calls["SyntheticConfig"]
    assert sc == dict(clip_len=1, num_kps=demo.NUM_KPS, seed=demo.DATA_SEED)
    assert calls["cosine_decay_schedule"] == [([], dict(alpha=demo.COSINE_ALPHA))]
    assert calls["adam"] == [([], dict(b1=0.9, b2=0.999))]
    assert "BATCH * 4" in open(os.path.join(ROOT, "tools", "train_synthetic_demo.py")).read()
    assert demo.NUM_BATCHES == 4 and demo.LOG_EVERY == 50
    assert demo.parse([]).out is None  # stdout; never the JAX demo's file


def test_demo_cosine_rate_matches_optax():
    for lr, n in ((3e-4, 800), (1e-3, 3), (3e-4, 200)):
        sched = optax.cosine_decay_schedule(lr, n, alpha=0.01)
        for i in list(range(0, n + 5, max(1, n // 50))) + [n - 1, n, n + 1, 5 * n]:
            assert abs(demo.cosine_lr(lr, n, i) - float(sched(i))) <= 1e-7 * lr, (lr, n, i)


SMALL = dict(subdivide=2, num_lbs=6, tex_size=2, num_kps=4, nz_feat=32)
IMG, BATCH, STEPS = 64, 2, 3


def _jax_demo_run():
    """The JAX demo's main at SMALL, f32, STEPS steps: the same template,
    config, optax schedule, dataset and batches; returns the weights before
    each step and after the last, the batches, before / after and the
    per-step losses."""
    anchors = np.random.default_rng(demo.ANCHOR_SEED).choice(
        demo.num_verts(SMALL["subdivide"]), SMALL["num_kps"], replace=False)
    template = jbuild_template(
        subdivide=SMALL["subdivide"], num_lbs=SMALL["num_lbs"], tex_size=SMALL["tex_size"],
        num_kps=SMALL["num_kps"], kp_vertex_ids=[np.asarray([a]) for a in anchors])
    cfg = demo.demo_config(IMG, BATCH, SMALL["nz_feat"], SMALL["num_lbs"], SMALL["num_kps"],
                           SMALL["tex_size"], "float32", **{
                               k: demo.DEFAULTS[k] for k in ("lr", "mask_wt", "kp_wt",
                                                             "triangle_wt", "rigid_wt",
                                                             "boundaries_wt")})
    cfg = jcfg.Config(model=jcfg.ModelConfig(**vars(cfg.model)),
                      mono_weights=jcfg.MonocularLossWeights(**vars(cfg.mono_weights)),
                      train=jcfg.TrainConfig(**vars(cfg.train)))
    mods, tx, state = jmono.build(cfg, template, jax.random.PRNGKey(0))
    sched = optax.cosine_decay_schedule(demo.DEFAULTS["lr"], STEPS, alpha=0.01)
    tx = optax.adam(sched, b1=0.9, b2=0.999)
    state = state.replace(opt_state=tx.init(state.params))
    ds = jsyn.SyntheticDataset(template, jsyn.SyntheticConfig(
        num_frames_total=BATCH * 4, clip_len=1, image_size=IMG, num_kps=SMALL["num_kps"],
        seed=demo.DATA_SEED, kp_vertex_ids=tuple(anchors)))
    step = jmono.make_train_step(mods, tx, face_chunk=80)
    ev = jmono.make_eval_step(mods, face_chunk=80)

    def batch_for(ids):
        b = jsyn.preprocess_batch(ds.get_batch(np.asarray(ids)), IMG)
        out = {k: jnp.asarray(b[k][:, 0]) for k in ("img", "mask", "kp", "sfm_pose")}
        out["edt"] = jnp.asarray(b["edt"])
        out["boundaries"] = jnp.asarray(b["boundaries"])
        return out

    batches = [batch_for(range(i * BATCH, (i + 1) * BATCH)) for i in range(4)]

    def evaluate(state):
        stats = jem.BenchStats()
        for b in batches:
            aux = ev(state, b)
            mp = (np.asarray(aux["mask_pred"]) > 0.5).astype(np.float32)
            err, vis = jem.kp_errors(np.asarray(aux["kp_pred"]), np.asarray(b["kp"]))
            stats.update(jem.mask_iou(np.asarray(b["mask"]), mp), err, vis)
        return stats.results()

    def np_weights(state):
        return jax.tree_util.tree_map(
            np.asarray, (state.params, state.batch_stats, state.lpips_params))

    before = evaluate(state)
    losses, states = [], []
    for i in range(STEPS):
        states.append(np_weights(state))
        state, metrics = step(state, batches[i % len(batches)])
        losses.append(float(metrics["total_loss"]))
    states.append(np_weights(state))
    return states, batches, before, evaluate(state), losses


@pytest.mark.heavy
def test_run_demo_matches_jax_demo():
    """3 steps of run_demo from the JAX model's weights against
    the JAX demo's calls, both in f32 at 64^2.

    The batches: masks, images, edt and boundaries equal, keypoints within
    1e-5. The rates: optax's at every step within 1e-7 of lr. The losses:
    step 0 (the same weights) of the free run within rtol 1e-3; each later
    step from the same state (the JAX run's weights before that step,
    loaded into the port, its train-mode forward on that step's batch)
    within rtol 1e-3. A free run is not held past step 0: Adam's first
    steps are sign steps, so an element whose gradient sits at rounding
    level moves by +-lr on either side, and the next batch's loss moves
    with it (the port against itself with 1 and with 4 CPU threads: step
    2's loss 5.98 and 6.24). IoU before and after within 1e-3 (after: the
    JAX run's final weights in the port, and the free run), PCK within one
    keypoint's share (a mask at atol 2e-4 thresholded at 0.5 flips a few
    pixels; a keypoint on the PCK radius flips)."""
    states, jbatches, before_j, after_j, losses_j = _jax_demo_run()
    res = demo.run_demo(STEPS, IMG, BATCH, device="cpu", dtype="float32",
                        init=lambda mods: from_jax.load_jax_weights(mods, *states[0]),
                        **SMALL)
    for bt, bj in zip(res["batches"], jbatches, strict=True):
        for k in ("img", "mask", "edt", "boundaries", "sfm_pose"):
            np.testing.assert_array_equal(bt[k].numpy(), np.asarray(bj[k]), err_msg=k)
        np.testing.assert_allclose(bt["kp"].numpy(), np.asarray(bj["kp"]), atol=1e-5, rtol=0)
    sched = optax.cosine_decay_schedule(demo.DEFAULTS["lr"], STEPS, alpha=0.01)
    np.testing.assert_allclose(res["lrs"], [float(sched(i)) for i in range(STEPS)],
                               atol=1e-7 * demo.DEFAULTS["lr"], rtol=0)
    assert len(res["losses"]) == STEPS and np.isfinite(res["losses"]).all()
    np.testing.assert_allclose(res["losses"][0], losses_j[0], rtol=1e-3)

    mods, batches = res["mods"], res["batches"]
    for k in range(1, STEPS):
        from_jax.load_jax_weights(mods, *states[k])
        with torch.no_grad():
            loss, _ = tmono.forward(mods, batches[k % len(batches)], train=True)
        np.testing.assert_allclose(float(loss), losses_j[k], rtol=1e-3, err_msg=f"step {k}")
    from_jax.load_jax_weights(mods, *states[-1])
    after_same = demo.evaluate(tmono.make_eval_step(mods), batches)
    share = 1.0 / (BATCH * 4 * SMALL["num_kps"])
    for got, want in ((res["before"], before_j), (after_same, after_j),
                      (res["after"], after_j)):
        assert abs(got["mean_iou"] - want["mean_iou"]) <= 1e-3, (got, want)
        for key in ("pck_0.1", "pck_0.15"):
            assert abs(got[key] - want[key]) <= share + 1e-9, (key, got, want)
    assert res["frames_per_s"] > 0 and res["seconds"] > 0
    text = demo.report(res, IMG, BATCH, "the CPU")
    assert "on the CPU" in text and "TPU" not in text


def test_demo_main_writes_results(tmp_path, monkeypatch, capsys):
    """main on the CPU: the markdown on stdout and in --out, never the JAX
    demo's DEMO_RESULTS.md; no card and no --device cpu, an exit."""
    seen = {}
    real = demo.run_demo

    def small_run(steps, img, batch, **kw):
        seen.update(kw, steps=steps)
        return real(2, 64, 2, device="cpu", dtype="float32", **SMALL)

    monkeypatch.setattr(demo, "run_demo", small_run)
    out = tmp_path / "r.md"
    assert demo.main(["--steps", "5", "--device", "cpu", "--out", str(out)]) == 0
    text = out.read_text()
    assert "| mean mask IoU |" in text and "on the CPU" in text
    assert text in capsys.readouterr().out
    assert seen["steps"] == 5 and seen["mask_wt"] == 5.0 and seen["lr"] == 3e-4
    assert not os.path.exists(os.path.join(ROOT, "DEMO_RESULTS_TORCH.md"))
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            demo.main(["--steps", "1"])



def test_synthetic_render_is_the_port_rasterizer():
    """The dataset's masks are ops/rasterizer.py::soft_silhouette of the
    solved, projected meshes, thresholded at 0.5."""
    from acfm_video_3d_reconstruction_tpu_torch.geometry import camera as cam

    t = build_template(subdivide=2, num_lbs=6, tex_size=2, num_kps=4)
    ds = tsyn.SyntheticDataset(t, tsyn.SyntheticConfig(num_frames_total=4, image_size=32,
                                                       seed=2), device="cpu")
    with torch.no_grad():
        pv = tsolve.screened_poisson_solve(
            torch.tensor(t.verts, dtype=torch.float32),
            tsolve.lbs_from_logits(torch.tensor(t.lbs_logits, dtype=torch.float32)),
            torch.tensor(ds.gt_deform), torch.tensor(t.uniform_L, dtype=torch.float32))
        proj = cam.orthographic_proj_withz(pv, torch.tensor(ds.gt_cams), offset_z=5.0)
        mask, _ = tras.soft_silhouette(proj, torch.tensor(t.faces), 32)
    np.testing.assert_array_equal((mask > 0.5).float().numpy(), ds.masks)
