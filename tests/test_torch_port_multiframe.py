"""Multiframe camera-multiplex training of the port against the JAX package.

Config of tests/test_train_multiframe.py: 64^2, icosphere subdivide 1 (42
vertices, 80 faces), 6 handles, tex 2, nz_feat 32, texture on, f32, G=4
hypotheses, batch 2 clips of T=2 frames, 8 frames in the multiplex tables,
the flow loss on, no keypoints. Both sides start from one state: the JAX
MFTrainState of jmf.build (its flax init jitted here, for speed) carried
across by models/from_jax.py::load_jax_multiframe. The JAX side runs its
dense rasterizer, the port its binned plain versions (auto_K at 64^2 gives
the exact capacity). The steps run the soft silhouette at the
well-conditioned sigma / blur of tests/test_torch_port_train.py, where the
per-vertex gradient is comparable between two rasterizers.

Tolerances (tests/test_torch_port_train.py's, reasoned there): the loss
terms read off the mask rtol 1e-3, the network-only terms rtol 1e-4 /
atol 1e-5; each gradient tensor to _grad_bound (0.05 through the mask,
which the multiplex tables' gradient passes through too); Adam's first
step as there; the loss matrix and the probabilities rtol 1e-3 per entry
(means of the mask, and their softmax).
"""
import contextlib
import copy
import dataclasses
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_port_slice import DEFAULT_TOL
from test_torch_port_train import BN_FED_BIASES, _grad_bound

from acfm_video_3d_reconstruction_tpu import config as jcfg
from acfm_video_3d_reconstruction_tpu.geometry import camera as jcam
from acfm_video_3d_reconstruction_tpu.geometry import mesh_ops as jmesh
from acfm_video_3d_reconstruction_tpu.geometry import quaternion as jquat
from acfm_video_3d_reconstruction_tpu.losses import losses as jloss
from acfm_video_3d_reconstruction_tpu.models import build_template as jbuild_template
from acfm_video_3d_reconstruction_tpu.multiplex import state as jmpx
from acfm_video_3d_reconstruction_tpu.ops import rasterizer as jras
from acfm_video_3d_reconstruction_tpu.train import multiframe as jmf
from acfm_video_3d_reconstruction_tpu.train import schedules as jsched
from acfm_video_3d_reconstruction_tpu_torch import config as tcfg
from acfm_video_3d_reconstruction_tpu_torch.geometry import camera as tcam
from acfm_video_3d_reconstruction_tpu_torch.geometry import icosphere
from acfm_video_3d_reconstruction_tpu_torch.geometry import mesh_ops as tmesh
from acfm_video_3d_reconstruction_tpu_torch.geometry import quaternion as tquat
from acfm_video_3d_reconstruction_tpu_torch.losses import losses as tloss
from acfm_video_3d_reconstruction_tpu_torch.models import from_jax
from acfm_video_3d_reconstruction_tpu_torch.models import template as ttemplate
from acfm_video_3d_reconstruction_tpu_torch.multiplex import state as tmpx
from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer as tras
from acfm_video_3d_reconstruction_tpu_torch.train import checkpoints
from acfm_video_3d_reconstruction_tpu_torch.train import multiframe as tmf
from acfm_video_3d_reconstruction_tpu_torch.train import schedules as tsched

torch.set_num_threads(1)

IMG, G, B, T, N_FRAMES = 64, 4, 2, 2, 8
TEMPLATE = dict(subdivide=1, num_lbs=6, tex_size=2, num_kps=0)
SIGMA, BLUR = 5e-3, 6e-2
# read off the mask (its means, the flow visibility, the argmax hypothesis
# the camera term distils toward, the texture's nearest cells), and their sum
MASK_TERMS = ("mask_loss", "edt_loss", "bdt_loss", "sil_cons", "of_loss", "tex_loss",
              "total_loss", "warmup_loss")


def _tol(name):
    if name in MASK_TERMS:
        return dict(rtol=1e-3, atol=0)
    if name == "rigid_loss":  # pred_v = mean_v under drop_deform: f32 noise
        return dict(rtol=0, atol=1e-8)
    return DEFAULT_TOL


def _cfg(lib, **mp):
    return lib.Config(
        model=dataclasses.replace(
            lib.ModelConfig(), img_size=IMG, nz_feat=32, num_lbs=6, num_kps=0, tex_size=2,
            subdivide=1, texture=True, symmetric=False, symmetric_texture=False),
        multiplex=dataclasses.replace(lib.MultiplexConfig(), num_guesses=G, **mp),
        train=dataclasses.replace(lib.TrainConfig(), batch_size=B, num_frames=T, offset_z=0.0,
                                  use_gtpose=False),
        mf_weights=dataclasses.replace(lib.MultiframeLossWeights(), kp=0.0),
    )


def _tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _rel(a, b) -> float:
    a, b = torch.as_tensor(np.array(a)), torch.as_tensor(np.array(b))
    return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()


def _batch(seed: int, frames=((0, 1), (2, 3))) -> dict:
    """A clip batch: textured images, disc masks moving between the frames,
    a smooth flow field (nearest sampling of a smooth field moves little
    where two implementations round a position differently), random
    cameras, one clip mirrored, an active affine transform."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:IMG, :IMG] / IMG * 2 - 1
    img = rng.random((B, T, IMG, IMG, 3)).astype(np.float32) * 0.3
    mask = np.zeros((B, T, IMG, IMG), np.float32)
    for b in range(B):
        cx, cy, r = rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2), rng.uniform(0.4, 0.6)
        for t in range(T):
            mask[b, t] = ((xx - cx - 0.05 * t) ** 2 + (yy - cy) ** 2 <= r * r)
            img[b, t] += mask[b, t, ..., None] * rng.uniform(0.3, 0.7, 3)
    flow = np.stack([1.5 + np.sin(2 * xx + 1) + 0.5 * yy, -0.5 + np.cos(3 * yy) * 0.8], -1)
    flows = np.zeros((B, T, IMG, IMG, 2), np.float32)
    flows[:, :-1] = flow
    q = rng.normal(size=(B, T, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    poses = np.concatenate([rng.uniform(0.6, 0.9, (B, T, 1)), rng.uniform(-0.1, 0.1, (B, T, 2)),
                            q], -1).astype(np.float32)
    transforms = np.tile(np.asarray([1.02, 0.04, -0.03, 1.0], np.float32), (B, T, 1))
    transforms[0, :, 3] = 0.0
    bounds = rng.uniform(-0.8, 0.8, (B * T, 40, 3)).astype(np.float32)
    bounds[..., 2] = (rng.random((B * T, 40)) > 0.2)
    return {
        "img": np.clip(img, 0, 1), "mask": mask,
        "kp": np.zeros((B, T, 3, 3), np.float32), "sfm_pose": poses,
        "frames_idx": np.asarray(frames, np.int32),
        "mirror_flag": np.asarray([[0, 0], [1, 1]], np.int32), "transforms": transforms,
        "edt": rng.random((B * T, IMG, IMG)).astype(np.float32),
        "boundaries": bounds, "optical_flows": flows,
    }


@contextlib.contextmanager
def _jitted_flax_init():
    """flax Module.init under jax.jit: jmf.build's eager init of MeshNet and
    LPIPS takes ~45 s on the CPU, jitted ~15 s (other numbers; both sides
    start from whatever JAX built)."""
    real = fnn.Module.init

    def init(self, rngs, *args, method=None, **kw):
        return jax.jit(lambda r, *a: real(self, r, *a, method=method, **kw))(rngs, *args)

    fnn.Module.init = init
    try:
        yield
    finally:
        fnn.Module.init = real


# the camera multiplex of each step case: the quaternion table (the
# default), the az-el table, and the az-el table with the per-hypothesis
# pi/4 rotation biases
MULTIPLEX = {"quat": {}, "az_el": dict(az_el_cam=True),
             "az_el_bias": dict(az_el_cam=True, az_el_quat_bias=True)}


def _jax_build(**mp):
    with _jitted_flax_init():
        mods, (tx_full, tx_warm), state = jmf.build(
            _cfg(jcfg, **mp), jbuild_template(**TEMPLATE), N_FRAMES, jax.random.PRNGKey(0))
    return mods, tx_full, tx_warm, state


@pytest.fixture(scope="module")
def jax_build():
    return _jax_build()


@pytest.fixture(scope="module")
def jax_build_az_el():
    """The az-el build (a 6-wide camera table), built once: the rotation
    biases change only the cameras' decode, so the az_el_bias cases run it
    under their own config. The table is init_az_el_multiplex's plus a
    seeded spread of every column: the init alone (scale and translation
    0, elevation and cyclo-rotation 0) shows the symmetric mean shape in
    exact 180-degree views, whose z-buffers tie between faces at pixel
    centres, and the two solves' f32 roundings (1e-5 in pred_v) tip such
    ties into other vertex visibilities for the flow term; the spread also
    drives every input of the decode."""
    mods, tx_full, tx_warm, state = _jax_build(**MULTIPLEX["az_el"])
    cams = np.asarray(state.multiplex.cams)
    spread = np.random.default_rng(5).normal(size=cams.shape) * [1.0, 0.05, 0.05, 0.3, 0.3, 0.3]
    mpx = dataclasses.replace(state.multiplex, cams=jnp.asarray((cams + spread).astype(np.float32)))
    return mods, tx_full, tx_warm, state.replace(multiplex=mpx)


def _build_for(request, multiplex):
    """(mods, tx_full, tx_warm, state) of the JAX build for a MULTIPLEX key."""
    if multiplex == "quat":
        return request.getfixturevalue("jax_build")
    mods, tx_full, tx_warm, state = request.getfixturevalue("jax_build_az_el")
    cfg = _cfg(jcfg, **MULTIPLEX[multiplex])
    return dataclasses.replace(mods, cfg=cfg), tx_full, tx_warm, state


_PORT = {}


def _port(state, probs=None, multiplex="quat"):
    """A fresh port MFModules holding the JAX state (one build per
    MULTIPLEX key, deep-copied); `probs` replaces the probability table on
    both sides' terms."""
    if multiplex not in _PORT:
        _PORT[multiplex] = tmf.build(_cfg(tcfg, **MULTIPLEX[multiplex]),
                                     ttemplate.build_template(**TEMPLATE), N_FRAMES,
                                     device="cpu")
    mods = copy.deepcopy(_PORT[multiplex])
    mpx = state.multiplex
    from_jax.load_jax_multiframe(mods, _tree(state.params), _tree(state.batch_stats),
                                 _tree(state.lpips_params),
                                 {"cams": np.asarray(mpx.cams),
                                  "probs": np.asarray(mpx.probs if probs is None else probs),
                                  "deform": None, "deform_mirror": None})
    return mods


@contextlib.contextmanager
def _wide_sigma_and_spies(captured):
    """Both rasterizers' soft silhouettes at SIGMA / BLUR; both packages'
    _per_guess_losses report their loss matrix into `captured` (JAX through
    a debug callback, which runs inside jit and checkpoint)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jras, tras):
            for name in ("soft_silhouette_vis", "soft_silhouette_vis_tex"):
                mp.setattr(mod, name, functools.partial(getattr(mod, name), sigma=SIGMA,
                                                        blur_radius=BLUR))
        real_j, real_t = jmf._per_guess_losses, tmf._per_guess_losses

        def spy_j(*a, **kw):
            out = real_j(*a, **kw)
            jax.debug.callback(lambda lm: captured.__setitem__("lm_j", np.asarray(lm)), out[0])
            return out

        def spy_t(*a, **kw):
            out = real_t(*a, **kw)
            captured["lm_t"] = out[0].detach().clone()
            return out

        mp.setattr(jmf, "_per_guess_losses", spy_j)
        mp.setattr(tmf, "_per_guess_losses", spy_t)
        yield


def _jax_train_step(mods_j, tx, k, use_gtpose=False):
    """jmf.make_train_step's step, returning the gradients and aux too."""

    def step(state, batch):
        def loss_fn(tr):
            return jmf.forward(mods_j, tr["params"], state.batch_stats, tr["mpx"],
                               state.multiplex, state.lpips_params, batch, k=k, train=True,
                               drop_deform=True, use_gtpose=use_gtpose, face_chunk=80)

        tr = {"params": state.params, "mpx": jmf._trainable_mpx(state.multiplex)}
        (_, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(tr)
        updates, _ = tx.update(grads, state.opt_state, tr)
        new = optax.apply_updates(tr, updates)
        mpx = jmpx.scatter_probs(dataclasses.replace(state.multiplex, cams=new["mpx"]["cams"]),
                                 batch["frames_idx"], aux["sel"], aux["probs"])
        return aux["metrics"], grads, new, mpx.probs, aux["sel"]

    return jax.jit(step)


def _probs_with_ties(seed):
    """A probability table of distinct values and exact ties."""
    rng = np.random.default_rng(seed)
    p = rng.random((N_FRAMES, G)).astype(np.float32)
    p[1] = [0.3, 0.3, 0.1, 0.3]
    p[2] = [0.25, 0.25, 0.25, 0.25]
    return p


@pytest.fixture(scope="module", params=[("quat", G), ("quat", 2), ("az_el", G),
                                        ("az_el_bias", 2)],
                ids=["k=G", "k<G", "az_el-k=G", "az_el_bias-k<G"])
def one_step(request):
    """One train step on both sides from the same state: jax.grad of the
    JAX forward with optax's update and scatter_probs, and the port's
    make_train_step. At k < G the probability table holds distinct values
    and ties, so the top-k selection differs per frame. The az-el cases
    decode the 6-wide table (decode_selected_cameras' az-el branch), the
    last with the rotation biases gathered for the selected hypotheses."""
    multiplex, k = request.param
    mods_j, tx_full, _, state = _build_for(request, multiplex)
    probs = None
    if k < G:
        probs = _probs_with_ties(1)
        state = state.replace(multiplex=dataclasses.replace(state.multiplex,
                                                            probs=jnp.asarray(probs)))
    batch = _batch(0)
    captured = {}
    with _wide_sigma_and_spies(captured):
        metrics_j, grads_j, new_j, probs_j, sel_j = _jax_train_step(mods_j, tx_full, k)(
            state, {key: jnp.asarray(v) for key, v in batch.items()})
        mods = _port(state, probs, multiplex)
        before = {key: v.detach().clone() for key, v in mods.model.state_dict().items()}
        cams0 = mods.mpx.cams.detach().clone()
        metrics_t = tmf.make_train_step(mods, k=k)(tmf.to_device_batch(mods, batch))
    bs = _tree(state.batch_stats)
    return {
        "k": k, "metrics_j": metrics_j, "metrics_t": metrics_t, "captured": captured,
        "grad_j": from_jax.convert(mods.model, _tree(grads_j["params"]), bs),
        "grad_t": {key: p.grad for key, p in mods.model.named_parameters()},
        "after_j": from_jax.convert(mods.model, _tree(new_j["params"]), bs),
        "after_t": mods.model.state_dict(), "before": before,
        "params": [key for key, _ in mods.model.named_parameters()],
        "cams_grad_j": np.asarray(grads_j["mpx"]["cams"]), "cams_grad_t": mods.mpx.cams.grad,
        "cams_j": np.asarray(new_j["mpx"]["cams"]), "cams_t": mods.mpx.cams.detach(),
        "cams0": cams0, "probs_j": np.asarray(probs_j), "probs_t": mods.mpx.probs,
        "sel_j": np.asarray(sel_j), "opt": mods.opt,
    }


@pytest.mark.heavy
def test_train_step_loss_matrix_and_metrics_match_jax(one_step):
    s = one_step
    lm_j, lm_t = s["captured"]["lm_j"], s["captured"]["lm_t"]
    assert lm_t.shape == lm_j.shape == (s["k"], B * T)
    np.testing.assert_allclose(lm_t.numpy(), lm_j, rtol=1e-3, atol=0)
    m_j, m_t = s["metrics_j"], s["metrics_t"]
    assert set(m_t) == set(m_j)
    for name, want in m_j.items():
        np.testing.assert_allclose(m_t[name].item(), float(want), err_msg=name, **_tol(name))


@pytest.mark.heavy
def test_train_step_probs_written_back_match_jax(one_step):
    """The rows of the batch's frames hold the soft-min of the selected
    hypotheses and 0 elsewhere (rtol 1e-3); every other row is untouched."""
    s = one_step
    np.testing.assert_allclose(s["probs_t"].numpy(), s["probs_j"], rtol=1e-3, atol=1e-7)
    rows = s["probs_t"][:4]
    assert torch.allclose(rows.sum(-1), torch.ones(4), atol=1e-5)
    assert int((rows > 0).sum(-1).max()) == s["k"]


@pytest.mark.heavy
def test_train_step_gradients_match_jax(one_step):
    """Per parameter tensor, and for the camera table, the vector relative
    error of the gradient within _grad_bound (0.05 for the table: its
    gradient passes through the mask); the BatchNorm-fed biases below 1e-5
    of their weight's; a gradient that no term reaches (the handle head
    and the keypoint logits here) zero on both sides; the skinning logits,
    whose gradient is exactly 0 at zero handle offsets (drop_deform), f32
    noise below 1e-5 of mean_v's."""
    s = one_step
    worst = {}
    for name in s["params"]:
        gt, gj = s["grad_t"][name], s["grad_j"][name]
        assert gt is not None, name  # _dense_grads gave every parameter one
        if name in BN_FED_BIASES:
            w = torch.linalg.vector_norm(s["grad_j"][name[:-4] + "weight"])
            assert torch.linalg.vector_norm(gt) <= 1e-5 * w, name
            assert torch.linalg.vector_norm(gj) <= 1e-5 * w, name
            continue
        if name == "lbs_logits":
            scale = torch.linalg.vector_norm(s["grad_j"]["mean_v"])
            assert torch.linalg.vector_norm(gt - gj) <= 1e-5 * scale
            continue
        if not gj.any():
            assert not gt.any(), name
            continue
        worst[name] = _rel(gt, gj)
        assert worst[name] < _grad_bound(name), (name, worst[name])
    worst["mpx.cams"] = _rel(s["cams_grad_t"], s["cams_grad_j"])
    assert worst["mpx.cams"] < 0.05, worst["mpx.cams"]
    print("worst gradient rel error:", max(worst.items(), key=lambda kv: kv[1]))


@pytest.mark.heavy
def test_train_step_adam_update_matches_jax(one_step):
    """Adam's first step over the model and the camera table, as
    tests/test_torch_port_train.py holds it: where both gradients exceed
    1e-6 with one sign the updates agree to 1.1% of lr; the undecided
    elements at most 3e-3 of those with |g_jax| > 1e-6; an element whose
    gradient is 0 on both sides stays put on both."""
    s = one_step
    lr = tcfg.TrainConfig().learning_rate
    pairs = [(s["grad_t"][n], s["grad_j"][n], s["after_t"][n] - s["before"][n],
              s["after_j"][n] - s["before"][n]) for n in s["params"]]
    pairs.append((s["cams_grad_t"], torch.tensor(s["cams_grad_j"]), s["cams_t"] - s["cams0"],
                  torch.tensor(s["cams_j"]) - s["cams0"]))
    n_big = n_undecided = 0
    for g_t, g_j, d_t, d_j in pairs:
        big = g_j.abs() > 1e-6
        decided = big & (g_t.abs() > 1e-6) & (torch.sign(g_t) == torch.sign(g_j))
        n_big += int(big.sum())
        n_undecided += int((big & ~decided).sum())
        torch.testing.assert_close(d_t[decided], d_j[decided], rtol=0, atol=0.011 * lr)
        zero = (g_t == 0) & (g_j == 0)
        assert not d_t[zero].any() and not d_j[zero].any()
    assert n_big > 0
    assert n_undecided <= 3e-3 * n_big, (n_undecided, n_big)


@pytest.mark.heavy
def test_train_step_selects_the_jax_hypotheses(one_step):
    """At k < G the top-k selection (with exact ties in the table) is
    JAX's, hypothesis for hypothesis; every parameter stepped once."""
    s = one_step
    if s["k"] < G:
        sel_t = tmpx.topk_hypotheses(
            tmpx.MultiplexState(None, torch.tensor(_probs_with_ties(1)), None, None),
            torch.tensor([[0, 1], [2, 3]]), s["k"])
        np.testing.assert_array_equal(sel_t.numpy(), s["sel_j"])
    steps = {int(st["step"]) for st in s["opt"].state.values()}
    assert steps == {1}


@pytest.mark.heavy
def test_warmup_step_matches_jax(jax_build):
    """One pose warm-up step: the loss (rtol 1e-3), its loss matrix and the
    probabilities written for every hypothesis (rtol 1e-3), the camera
    table's gradient (vector rel 0.05, through the mask) and its Adam(1e-2)
    step (decided elements within 1.1% of the rate), the model untouched."""
    _check_warmup_step(jax_build)


@pytest.mark.heavy
@pytest.mark.parametrize("multiplex", ["az_el", "az_el_bias"])
def test_warmup_step_az_el_matches_jax(request, multiplex):
    """test_warmup_step_matches_jax's checks with the az-el camera table,
    without and with the rotation biases."""
    _check_warmup_step(_build_for(request, multiplex), multiplex)


def _check_warmup_step(build, multiplex="quat"):
    mods_j, _, tx_warm, state = build
    batch = _batch(2)
    jb = {key: jnp.asarray(v) for key, v in batch.items()}
    captured = {}
    with _wide_sigma_and_spies(captured):
        mean_shape = mods_j.model.apply({"params": state.params},
                                        method=mods_j.model.get_mean_shape)
        g_j = jax.jit(jax.grad(lambda c: jmf.warmup_forward(
            mods_j, c, state.multiplex, mean_shape, jb, 80)[0]))(state.multiplex.cams)
        new_j, wm_j = jmf.make_warmup_step(mods_j, tx_warm, face_chunk=80)(
            jax.tree_util.tree_map(jnp.array, state), jb)
        mods = _port(state, multiplex=multiplex)
        db = tmf.to_device_batch(mods, batch)
        mpx = mods.mpx.state()
        loss, _, _ = tmf.warmup_forward(mods, mpx.cams, mpx, mods.model.get_mean_shape().detach(),
                                        db)
        loss.backward()
        g_t = mods.mpx.cams.grad.clone()
        mods.mpx.cams.grad = None
        model0 = copy.deepcopy(mods.model.state_dict())
        cams0 = mods.mpx.cams.detach().clone()
        wm_t = tmf.make_warmup_step(mods)(db)
    np.testing.assert_allclose(wm_t["warmup_loss"].item(), float(wm_j["warmup_loss"]), rtol=1e-3)
    np.testing.assert_allclose(captured["lm_t"].numpy(), captured["lm_j"], rtol=1e-3)
    np.testing.assert_allclose(mods.mpx.probs.numpy(), np.asarray(new_j.multiplex.probs),
                               rtol=1e-3, atol=1e-7)
    g_j = torch.tensor(np.asarray(g_j))
    assert _rel(g_t, g_j) < 0.05
    d_t = mods.mpx.cams.detach() - cams0
    d_j = torch.tensor(np.asarray(new_j.multiplex.cams)) - cams0
    decided = (g_j.abs() > 1e-6) & (g_t.abs() > 1e-6) & (torch.sign(g_t) == torch.sign(g_j))
    assert int(decided.sum()) >= 0.99 * int((g_j.abs() > 1e-6).sum())
    lr = tcfg.TrainConfig().warmup_lr
    torch.testing.assert_close(d_t[decided], d_j[decided], rtol=0, atol=0.011 * lr)
    for key, v in mods.model.state_dict().items():
        assert torch.equal(v, model0[key]), key
    assert mods.step == 1


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_multiframe_meshnet_matches_jax(jax_build, train):
    """The multiframe build's MeshNet (camera LayerNorm, small camera init:
    branches the monocular model never takes) against flax in eval and in
    train mode (batch statistics; the texture decoder stays in eval mode on
    both sides): handle offsets, camera, texture atlas and the updated
    BatchNorm statistics, f32 nets summed in another order (rtol 1e-4 /
    atol 1e-5)."""
    mods_j, _, _, state = jax_build
    img = np.random.default_rng(16).random((4, IMG, IMG, 3)).astype(np.float32)
    model = mods_j.model
    variables = {"params": state.params, "batch_stats": state.batch_stats}

    def run(x):
        if train:
            out, upd = model.apply(variables, x, train=True, mutable=["batch_stats"])
        else:
            out, upd = model.apply(variables, x, train=False), {"batch_stats": state.batch_stats}
        atlas = model.apply(variables, out["res_feats"], train=False, method=model.textures)
        return out["delta_v"], out["cam_pred"], atlas, upd["batch_stats"]

    dv_j, cam_j, atlas_j, bs_j = jax.jit(run)(jnp.asarray(img))
    mods = _port(state)
    mods.model.train(train)
    with torch.no_grad():
        out = mods.model(torch.tensor(img))
        atlas_t = mods.model.textures(out["res_feats"])
    for got, want in ((out["delta_v"], dv_j), (out["cam_pred"], cam_j), (atlas_t, atlas_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **DEFAULT_TOL)
    bs = from_jax.convert(mods.model, _tree(state.params), _tree(bs_j))
    for name, v in mods.model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), bs[name].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=name)


def test_init_camera_emb_matches_jax(jax_build):
    """GT cameras through the affine transform, the scale rescaled, written
    into hypothesis 0 of the batch's frames: JAX's table to f32 rounding."""
    _, _, _, state = jax_build
    batch = _batch(3, frames=((4, 5), (6, 7)))
    want = jmf.init_camera_emb(state, {key: jnp.asarray(v) for key, v in batch.items()})
    mods = _port(state)
    tmf.init_camera_emb(mods, tmf.to_device_batch(mods, batch))
    np.testing.assert_allclose(mods.mpx.cams.detach().numpy(),
                               np.asarray(want.multiplex.cams), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ the optimizer

def _adam_switch(separate_camera_opt=False, multistep_lr=False):
    """A tiny model with a camera head and a camera table under both
    optimizers: the port's make_optimizer + _dense_grads + _set_lr, and
    optax (jmf.make_optimizer) over the same tree."""
    cfg_t = dataclasses.replace(_cfg(tcfg), train=dataclasses.replace(
        tcfg.TrainConfig(), separate_camera_opt=separate_camera_opt, multistep_lr=multistep_lr,
        lr_milestones=(1, 3), camera_learning_rate=3e-3, learning_rate=1e-3))
    cfg_j = dataclasses.replace(_cfg(jcfg), train=dataclasses.replace(
        jcfg.TrainConfig(), separate_camera_opt=separate_camera_opt, multistep_lr=multistep_lr,
        lr_milestones=(1, 3), camera_learning_rate=3e-3, learning_rate=1e-3))
    model = torch.nn.ModuleDict({"encoder": torch.nn.Linear(3, 2),
                                 "camera_predictor": torch.nn.Linear(2, 2)})
    mpx = tmf.Multiplex(tmpx.init_quat_multiplex(5, 3, 2, with_deform=False))
    mods = SimpleMods(cfg_t, tmf.make_optimizer(cfg_t, model, mpx), steps_per_epoch=1)
    tree = {"params": {name: {leaf: p.detach().numpy().copy() for leaf, p in m.named_parameters()}
                       for name, m in model.items()},
            "mpx": {"cams": mpx.cams.detach().numpy().copy()}}
    return mods, model, mpx, jmf.make_optimizer(cfg_j, steps_per_epoch=1), tree


@dataclasses.dataclass
class SimpleMods:
    cfg: object
    opt: torch.optim.Adam
    steps_per_epoch: int


@pytest.mark.parametrize("variant", ["plain", "separate_camera_opt", "multistep_lr"])
def test_adam_across_gtpose_switch_matches_optax(variant):
    """Two steps in which the camera table gets no gradient (use_gtpose:
    its .grad stays None on the port's side, optax sees zeros), then three
    in which everything does (the multiplex phase after finetune_camera's
    switch): torch's Adam with the steps' dense zero gradients and
    per-group rates equals optax's update leaf for leaf (rtol 1e-6), also
    with the camera head's own rate and the MultiStepLR milestones, and
    every parameter counts every step."""
    mods, model, mpx, tx, tree = _adam_switch(variant == "separate_camera_opt",
                                              variant == "multistep_lr")
    st = tx.init(tree)
    rng = np.random.default_rng(0)
    params = dict(model.named_parameters())
    for i in range(5):
        grads = {name: rng.normal(size=p.shape).astype(np.float32) for name, p in params.items()}
        cams_g = rng.normal(size=mpx.cams.shape).astype(np.float32) * (i >= 2)
        mods.opt.zero_grad(set_to_none=True)
        for name, p in params.items():
            p.grad = torch.tensor(grads[name])
        if i >= 2:
            mpx.cams.grad = torch.tensor(cams_g)
        tmf._dense_grads(mods.opt)
        tmf._set_lr(mods)
        mods.opt.step()
        g_tree = {"params": {n: {} for n in tree["params"]}, "mpx": {"cams": cams_g}}
        for name, g in grads.items():
            mod, leaf = name.split(".")
            g_tree["params"][mod][leaf] = g
        upd, st = tx.update(g_tree, st, tree)
        tree = optax.apply_updates(tree, upd)
        for name, p in params.items():
            mod, leaf = name.split(".")
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(tree["params"][mod][leaf]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"step {i} {name}")
        np.testing.assert_allclose(mpx.cams.detach().numpy(), np.asarray(tree["mpx"]["cams"]),
                                   rtol=1e-6, atol=1e-7, err_msg=f"step {i} cams")
    assert {int(s["step"]) for s in mods.opt.state.values()} == {5}
    if variant == "separate_camera_opt":
        assert [g["label"] for g in mods.opt.param_groups] == ["general", "camera"]


def test_steps_count_every_parameter_across_the_switch(jax_build):
    """The port's own steps: one under use_gtpose (k=1; the camera table and
    the unused heads get no gradient from backward), then one in the
    multiplex phase; Adam's step count is 2 for every parameter, and the
    table, untouched by the first step, moves in the second."""
    _, _, _, state = jax_build
    mods = _port(state)
    db = tmf.to_device_batch(mods, _batch(4))
    cams0 = mods.mpx.cams.detach().clone()
    tmf.make_train_step(mods, k=1, use_gtpose=True)(db)
    assert torch.equal(mods.mpx.cams.detach(), cams0)
    tmf.make_train_step(mods, k=G)(db)
    assert {int(s["step"]) for s in mods.opt.state.values()} == {2}
    assert not torch.equal(mods.mpx.cams.detach(), cams0)
    assert mods.step == 2


# --------------------------------------------------------------- checkpoints

def test_checkpoint_round_trip_and_resume(tmp_path, jax_build):
    """save_multiframe / restore_multiframe: a warm-up step and a train
    step, save, then a restore into a fresh build and two more steps give
    the weights, tables, both optimizers' states and metrics of four
    uninterrupted steps, bit for bit."""
    _, _, _, state = jax_build
    batches = [_batch(s, frames=f) for s, f in ((5, ((0, 1), (2, 3))), (6, ((4, 5), (6, 7))),
                                                (7, ((1, 2), (5, 6))), (8, ((0, 3), (4, 7))))]
    mods = _port(state)
    db = [tmf.to_device_batch(mods, b) for b in batches]
    tmf.make_warmup_step(mods)(db[0])
    tmf.make_train_step(mods, k=G)(db[1])
    checkpoints.save_multiframe(str(tmp_path), "exp", "warmup", mods)
    want = [tmf.make_train_step(mods, k=2)(b) for b in db[2:]]

    fresh = tmf.build(_cfg(tcfg), ttemplate.build_template(**TEMPLATE), N_FRAMES, seed=3,
                      device="cpu")
    assert checkpoints.restore_multiframe(str(tmp_path), "exp", "warmup", fresh) == 2
    got = [tmf.make_train_step(fresh, k=2)(b) for b in db[2:]]
    for g, w in zip(got, want):
        for key in w:
            assert torch.equal(g[key], w[key]), key
    for a, b in ((fresh.model, mods.model), (fresh.lpips, mods.lpips), (fresh.mpx, mods.mpx)):
        sb = b.state_dict()
        for key, v in a.state_dict().items():
            assert torch.equal(v, sb[key]), key
    for oa, ob in ((fresh.opt, mods.opt), (fresh.warm_opt, mods.warm_opt)):
        sa, sb = oa.state_dict(), ob.state_dict()
        assert sa["param_groups"] == sb["param_groups"]
        for i, st in sa["state"].items():
            for key, v in st.items():
                assert torch.equal(v, sb["state"][i][key]), (i, key)
    assert fresh.step == mods.step == 4


def test_checkpoint_non_strict_multiplex(tmp_path, jax_build, capsys):
    """A checkpoint of a run over another frame count (a warm-up step and a
    train step taken): the non-strict restore keeps the target's tables
    and both optimizers' states (shape mismatches, printed) and loads the
    model; the strict one refuses."""
    _, _, _, state = jax_build
    src = _port(state)
    db = tmf.to_device_batch(src, _batch(9))
    tmf.make_warmup_step(src)(db)
    tmf.make_train_step(src, k=G)(db)
    checkpoints.save_multiframe(str(tmp_path), "exp", "latest", src)
    tgt = tmf.build(_cfg(tcfg), ttemplate.build_template(**TEMPLATE), N_FRAMES + 2, seed=4,
                    device="cpu")
    cams0 = tgt.mpx.cams.detach().clone()
    with pytest.raises(RuntimeError):
        checkpoints.restore_multiframe(str(tmp_path), "exp", "latest", tgt)
    tgt = tmf.build(_cfg(tcfg), ttemplate.build_template(**TEMPLATE), N_FRAMES + 2, seed=4,
                    device="cpu")
    checkpoints.restore_multiframe(str(tmp_path), "exp", "latest", tgt, strict=False)
    out = capsys.readouterr().out
    assert "shape mismatch at multiplex.cams: (4, 8, 7) vs (4, 10, 7); keeping target" in out
    for key in ("optimizer", "warmup_optimizer"):
        assert f"[restore non-strict] {key} state does not fit the optimizer" in out
    assert not tgt.opt.state and not tgt.warm_opt.state
    assert torch.equal(tgt.mpx.cams.detach(), cams0)
    for key, v in src.model.state_dict().items():
        assert torch.equal(tgt.model.state_dict()[key], v), key


# ----------------------------------------------------------------- modules

def _rng_cams(rng, n, width):
    return rng.normal(size=(3, n, width)).astype(np.float32)


@pytest.mark.parametrize("case", ["quat", "az_el", "az_el_bias", "transform", "proj",
                                  "axis_angle", "biases"])
def test_camera_functions_match_jax(case):
    """The camera decoders and transports against JAX's (f32 arithmetic in
    the same order: rtol 1e-6 / atol 1e-6)."""
    rng = np.random.default_rng(10)
    if case == "quat":
        raw = _rng_cams(rng, 5, 7)
        got, want = tcam.decode_quat_camera(torch.tensor(raw), 0.05), \
            jcam.decode_quat_camera(jnp.asarray(raw), 0.05)
    elif case in ("az_el", "az_el_bias"):
        raw = _rng_cams(rng, 5, 6)
        bias = rng.normal(size=(3, 5, 4)).astype(np.float32) if case == "az_el_bias" else None
        kw = dict(scale_lr_decay=0.07, scale_bias=0.9, az_range_deg=40.0, el_range_deg=50.0,
                  cyc_range_deg=20.0)
        got = tcam.decode_az_el_camera(torch.tensor(raw), quat_bias=None if bias is None
                                       else torch.tensor(bias), **kw)
        want = jcam.decode_az_el_camera(jnp.asarray(raw), quat_bias=None if bias is None
                                        else jnp.asarray(bias), **kw)
    elif case == "transform":
        cam = _rng_cams(rng, 5, 7)
        tr = rng.normal(size=(3, 5, 4)).astype(np.float32)
        tr[..., 3] = rng.random((3, 5)) > 0.5
        got, want = tcam.transform_camera(torch.tensor(cam), torch.tensor(tr)), \
            jcam.transform_camera(jnp.asarray(cam), jnp.asarray(tr))
    elif case == "proj":
        X = rng.normal(size=(3, 10, 3)).astype(np.float32)
        cam = rng.normal(size=(3, 7)).astype(np.float32)
        got, want = tcam.orthographic_proj(torch.tensor(X), torch.tensor(cam)), \
            jcam.orthographic_proj(jnp.asarray(X), jnp.asarray(cam))
    elif case == "axis_angle":
        axis = rng.normal(size=(6, 3)).astype(np.float32)
        angle = rng.normal(size=(6,)).astype(np.float32)
        got, want = tquat.axis_angle_to_quat(torch.tensor(axis), torch.tensor(angle)), \
            jquat.axis_angle_to_quat(jnp.asarray(axis), jnp.asarray(angle))
    else:
        got, want = tcam.az_el_quat_biases(8), jcam.az_el_quat_biases(8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_az_el_quat_biases_on_is_built_once_and_bit_identical():
    """The per-(G, device) table the step gathers from: the same tensor on
    every call, bit-identical to az_el_quat_biases (its float64 chain stored
    in float32) and to the JAX package's."""
    a = tcam.az_el_quat_biases_on(6, torch.device("cpu"))
    assert tcam.az_el_quat_biases_on(6, torch.device("cpu")) is a
    assert torch.equal(a, tcam.az_el_quat_biases(6))
    np.testing.assert_array_equal(a.numpy(), np.asarray(jcam.az_el_quat_biases(6)))


def _cot_verts(batch=3, subdivide=1):
    verts, faces = icosphere.icosphere(subdivide)
    rng = np.random.default_rng(11)
    v = verts[None] * rng.uniform(0.8, 1.2, (batch, 1, 3)) + 0.03 * rng.normal(
        size=(batch,) + verts.shape)
    return v.astype(np.float32), faces.astype(np.int64)


def test_cot_laplacian_matches_jax():
    """W and L of a perturbed icosphere (dense f32, the corners' sums in
    another order: rtol 1e-5), W symmetric and identical on every call
    (a fixed gather, no scatter-add), and a CotEdges made once equal to
    the faces passed each time."""
    v, faces = _cot_verts()
    ce = tmesh.CotEdges(faces)
    for b in range(v.shape[0]):
        W_j = jmesh.cot_laplacian_weights(jnp.asarray(v[b]), jnp.asarray(faces))
        W_t = tmesh.cot_laplacian_weights(torch.tensor(v[b]), ce)
        np.testing.assert_allclose(W_t.numpy(), np.asarray(W_j), rtol=1e-5, atol=1e-6)
        assert torch.equal(W_t, W_t.T)
        assert torch.equal(W_t, tmesh.cot_laplacian_weights(torch.tensor(v[b]), faces))
        np.testing.assert_allclose(
            tmesh.cot_laplacian(torch.tensor(v[b]), ce).numpy(),
            np.asarray(jmesh.cot_laplacian(jnp.asarray(v[b]), jnp.asarray(faces))),
            rtol=1e-5, atol=1e-5)
    batched = tmesh.cot_laplacian_weights(torch.tensor(v), ce)
    assert torch.equal(batched[1], tmesh.cot_laplacian_weights(torch.tensor(v[1]), ce))


def test_cot_laplacian_smoothing_matches_jax():
    """Value and gradient (the weights held constant on both sides: no_grad
    vs stop_gradient), rtol 1e-5."""
    v, faces = _cot_verts()
    want, g_j = jax.value_and_grad(lambda x: jmesh.cot_laplacian_smoothing(
        x, jnp.asarray(faces)))(jnp.asarray(v))
    vt = torch.tensor(v, requires_grad=True)
    got = tmesh.cot_laplacian_smoothing(vt, tmesh.CotEdges(faces))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(g_j), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("which", ["l1", "texture_cycle"])
def test_l1_and_texture_cycle_losses_match_jax(which):
    rng = np.random.default_rng(12)
    if which == "l1":
        a, b = rng.random((2, 3, 5, 5)).astype(np.float32), rng.random((3, 5, 5))
        fj = lambda x: jloss.l1_loss(x, jnp.asarray(b, jnp.float32), reduce=False).sum()  # noqa: E731
        ft = lambda x: tloss.l1_loss(x, torch.tensor(b, dtype=torch.float32), reduce=False).sum()  # noqa: E731
        x = a[0]
    else:
        x = rng.random((4, 6, 2, 2, 3)).astype(np.float32)
        x[1] = x[0]  # the first clip's frames equal: the safe_norm point
        fj = lambda t: jloss.texture_cycle_loss(t, 2, 2)  # noqa: E731
        ft = lambda t: tloss.texture_cycle_loss(t, 2, 2)  # noqa: E731
    want, g_j = jax.value_and_grad(fj)(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = ft(xt)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("visibility", ["visible", "pix_to_face", "hard_raster"])
def test_optical_flow_loss_matches_jax(visibility):
    """optical_flow_loss on two clips of a moving icosphere over a smooth
    flow, with each of its three sources of visibility: the per-clip loss
    and its gradient to the vertices (the sampling positions and the
    visibility detached on both sides), rtol 1e-4; the visibility itself
    equal."""
    verts, faces = icosphere.icosphere(1)
    rng = np.random.default_rng(13)
    vs = (verts[None, None] * 0.6 + 0.02 * rng.normal(size=(2, 2) + verts.shape)).astype(
        np.float32)
    cams = np.tile(np.asarray([0.9, 0.05, -0.02, 0.9, 0.2, 0.3, 0.1], np.float32), (4, 1))
    cams[:, 3:] /= np.linalg.norm(cams[:, 3:], axis=-1, keepdims=True)
    yy, xx = np.mgrid[:IMG, :IMG] / IMG * 2 - 1
    flows = np.zeros((2, 2, IMG, IMG, 2), np.float32)
    flows[:, 1] = np.stack([1 + np.sin(2 * xx), np.cos(2 * yy) - 0.5], -1)
    kw_j, kw_t = {}, {}
    if visibility == "visible":
        vis = (rng.random((4, verts.shape[0])) > 0.3).astype(np.float32)
        kw_j["visible"], kw_t["visible"] = jnp.asarray(vis), torch.tensor(vis)
    elif visibility == "pix_to_face":
        proj = np.asarray(jcam.orthographic_proj_withz(jnp.asarray(vs.reshape(4, -1, 3)),
                                                       jnp.asarray(cams)))
        p2f = tras.hard_rasterize(torch.tensor(proj), torch.tensor(faces), IMG).pix_to_face
        kw_j["pix_to_face"], kw_t["pix_to_face"] = jnp.asarray(p2f.numpy()), p2f
    fj = lambda v: jloss.optical_flow_loss(  # noqa: E731
        v, jnp.asarray(cams), jnp.asarray(flows), jnp.asarray(faces), IMG, reduce=False,
        face_chunk=80, **kw_j)
    (loss_j, _, vis_j, _, _), vjp = jax.vjp(fj, jnp.asarray(vs))
    cot = rng.normal(size=loss_j.shape).astype(np.float32)
    (g_j,) = vjp((jnp.asarray(cot),) + tuple(jnp.zeros_like(x) for x in fj(jnp.asarray(vs))[1:]))
    vt = torch.tensor(vs, requires_grad=True)
    loss_t, _, vis_t, _, _ = tloss.optical_flow_loss(vt, torch.tensor(cams), torch.tensor(flows),
                                                     torch.tensor(faces), IMG, reduce=False,
                                                     **kw_t)
    (loss_t * torch.tensor(cot)).sum().backward()
    np.testing.assert_array_equal(vis_t.numpy(), np.asarray(vis_j))
    assert float(vis_t.sum()) > 0
    np.testing.assert_allclose(loss_t.detach().numpy(), np.asarray(loss_j), rtol=1e-4)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(g_j), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("mode", ["quat", "az_el"])
def test_multiplex_init_and_gathers_match_jax(mode):
    """The seeded inits are JAX's tables bit for bit; gather_cameras,
    gather_probs, gather_deforms and select_hypotheses agree (rtol 1e-6)."""
    if mode == "quat":
        j, t = jmpx.init_quat_multiplex(9, 5, 4, seed=3), tmpx.init_quat_multiplex(9, 5, 4, seed=3)
    else:
        j, t = jmpx.init_az_el_multiplex(9, 5, 4), tmpx.init_az_el_multiplex(9, 5, 4)
    for name in ("cams", "probs", "deform", "deform_mirror"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    rng = np.random.default_rng(14)
    d = rng.normal(size=(9, 12)).astype(np.float32)
    j = dataclasses.replace(j, deform=jnp.asarray(d), deform_mirror=jnp.asarray(d[::-1]))
    t = dataclasses.replace(t, deform=torch.tensor(d), deform_mirror=torch.tensor(d[::-1].copy()))
    frames = np.asarray([[0, 3], [8, 3]])
    mirror = np.asarray([[0, 0], [1, 1]])
    kw = dict(az_el=mode == "az_el", scale_lr_decay=0.06, scale_bias=0.8,
              euler_ranges=(20.0, 40.0, 50.0))
    np.testing.assert_allclose(tmpx.gather_cameras(t, torch.tensor(frames), **kw).numpy(),
                               np.asarray(jmpx.gather_cameras(j, jnp.asarray(frames), **kw)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tmpx.gather_probs(t, torch.tensor(frames)).numpy(),
                                  np.asarray(jmpx.gather_probs(j, jnp.asarray(frames))))
    np.testing.assert_allclose(
        tmpx.gather_deforms(t, torch.tensor(frames), torch.tensor(mirror), 4, 50.0).numpy(),
        np.asarray(jmpx.gather_deforms(j, jnp.asarray(frames), jnp.asarray(mirror), 4, 50.0)),
        rtol=1e-6)
    arr = rng.normal(size=(5, 4, 3)).astype(np.float32)
    sel = np.asarray([[4, 0, 1, 2], [0, 3, 3, 1]])
    np.testing.assert_array_equal(
        tmpx.select_hypotheses(torch.tensor(arr), torch.tensor(sel)).numpy(),
        np.asarray(jmpx.select_hypotheses(jnp.asarray(arr), jnp.asarray(sel))))


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_topk_hypotheses_ties_match_jax(k):
    """jax.lax.top_k orders equal probabilities lower index first; the
    port's stable sort does too (all ones, partial ties, distinct)."""
    probs = np.ones((6, 4), np.float32)
    probs[1] = [0.2, 0.5, 0.5, 0.1]
    probs[2] = [0.1, 0.2, 0.3, 0.4]
    probs[3] = [0.4, 0.4, 0.4, 0.9]
    probs[4] = [0.0, 0.0, 0.7, 0.0]
    frames = np.asarray([[0, 1, 2], [3, 4, 5]])
    j = jmpx.MultiplexState(jnp.zeros((4, 6, 7)), jnp.asarray(probs), None, None)
    t = tmpx.MultiplexState(torch.zeros(4, 6, 7), torch.tensor(probs), None, None)
    np.testing.assert_array_equal(tmpx.topk_hypotheses(t, torch.tensor(frames), k).numpy(),
                                  np.asarray(jmpx.topk_hypotheses(j, jnp.asarray(frames), k)))


def test_scatter_probs_matches_jax_and_repeats_take_the_last():
    """Without repeated frames the write is JAX's; a frame twice in the
    batch takes the row of its last occurrence in (B, T) order (JAX leaves
    that winner undefined), wherever each occurrence's row lands."""
    rng = np.random.default_rng(15)
    probs = rng.random((6, 4)).astype(np.float32)
    sel = np.asarray([[0, 3, 1, 2], [2, 0, 3, 1]])
    new = rng.random((2, 4)).astype(np.float32)
    frames = np.asarray([[0, 2], [5, 1]])
    j = jmpx.scatter_probs(jmpx.MultiplexState(jnp.zeros((4, 6, 7)), jnp.asarray(probs), None,
                                               None), jnp.asarray(frames), jnp.asarray(sel),
                           jnp.asarray(new))
    t = tmpx.scatter_probs(tmpx.MultiplexState(torch.zeros(4, 6, 7), torch.tensor(probs), None,
                                               None), torch.tensor(frames), torch.tensor(sel),
                           torch.tensor(new))
    np.testing.assert_array_equal(t.probs.numpy(), np.asarray(j.probs))
    rep = np.asarray([[3, 4], [3, 2]])  # frame 3 at positions 0 and 2
    t = tmpx.scatter_probs(tmpx.MultiplexState(torch.zeros(4, 6, 7), torch.tensor(probs), None,
                                               None), torch.tensor(rep), torch.tensor(sel), torch.tensor(new))
    last = np.zeros(4, np.float32)
    last[sel[:, 2]] = new[:, 2]
    np.testing.assert_array_equal(t.probs[3].numpy(), last)


def test_schedules_match_jax():
    for epoch in (0, 20, 21, 29, 30, 100, 101, 500):
        for base in (1, 2, 4, 8, 12):
            for drop in (False, True):
                for gt in (False, True):
                    assert tsched.num_guesses_at(epoch, base, drop, gt) == \
                        jsched.num_guesses_at(epoch, base, drop, gt)
        for gt in (False, True):
            for ft in (False, True):
                assert tsched.use_gtpose_at(epoch, gt, ft) == jsched.use_gtpose_at(epoch, gt, ft)
