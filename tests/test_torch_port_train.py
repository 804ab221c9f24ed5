"""Monocular training of the port against the JAX package.

Config of tests/test_torch_port_slice.py: 64^2, subdivide 2, 6 handles, 4
keypoints, tex 2, nz_feat 32, texture on, f32, batch 2, the synthetic
batch, the weights of the JAX init carried across by models/from_jax.py.
The JAX side runs the dense pure-JAX rasterizer and differentiates it by
autodiff; the port runs its binned plain forward and the hand-derived
backward_plain (what the CUDA kernels compute on the card). The pieces
the step's gradient passes through (BatchNorm in train mode, Adam, the
static sampler, the solve, the losses' non-smooth points, frozen LPIPS)
are each held against their JAX counterparts too.
"""
import dataclasses
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from acfm_video_3d_reconstruction_tpu import config as jcfg
from acfm_video_3d_reconstruction_tpu.data.synthetic import (
    SyntheticConfig,
    SyntheticDataset,
    preprocess_batch,
)
from acfm_video_3d_reconstruction_tpu.deform import solve as jsolve
from acfm_video_3d_reconstruction_tpu.geometry import mesh_ops as jmesh
from acfm_video_3d_reconstruction_tpu.losses import losses as jloss
from acfm_video_3d_reconstruction_tpu.models import build_template
from acfm_video_3d_reconstruction_tpu.models import lpips as jlpips
from acfm_video_3d_reconstruction_tpu.ops import rasterizer as jras
from acfm_video_3d_reconstruction_tpu.ops import static_sample as jstatic
from acfm_video_3d_reconstruction_tpu.train import monocular as jmono
from acfm_video_3d_reconstruction_tpu_torch import config as tcfg
from acfm_video_3d_reconstruction_tpu_torch.deform import solve as tsolve
from acfm_video_3d_reconstruction_tpu_torch.geometry import mesh_ops as tmesh
from acfm_video_3d_reconstruction_tpu_torch.losses import losses as tloss
from acfm_video_3d_reconstruction_tpu_torch.models import from_jax, nn_blocks
from acfm_video_3d_reconstruction_tpu_torch.models import lpips as tlpips
from acfm_video_3d_reconstruction_tpu_torch.models import template as ttemplate
from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer as tras
from acfm_video_3d_reconstruction_tpu_torch.ops.static_sample import StaticBilinear
from acfm_video_3d_reconstruction_tpu_torch.train import monocular as tmono

torch.set_num_threads(1)

IMG = 64
TEMPLATE = dict(subdivide=2, num_lbs=6, tex_size=2, num_kps=4)
# At the production sigma=1e-4 the per-vertex gradient is ill-conditioned
# (tests/test_rasterizer_tpu.py::TestBackwardParity); the parity step runs
# the soft silhouette at the well-conditioned sigma / blur of that test.
SIGMA, BLUR = 5e-3, 6e-2

# The loss terms take tests/test_torch_port_slice.py's tolerances, each
# reasoned there (the mask terms rtol 1e-3, pred_v-derived rigid_loss an
# absolute 1e-8, the network-only terms rtol 1e-4 / atol 1e-5).
METRIC_TOL = {
    "mask_loss": dict(rtol=1e-3, atol=0), "edt_loss": dict(rtol=1e-3, atol=0),
    "sil_cons": dict(rtol=1e-3, atol=0), "bdt_loss": dict(rtol=1e-3, atol=0),
    "tex_loss": dict(rtol=1e-3, atol=0), "rigid_loss": dict(rtol=0, atol=1e-8),
}
DEFAULT_TOL = dict(rtol=1e-4, atol=1e-5)


def _grad_bound(name: str) -> float:
    """Vector relative error allowed for one parameter tensor's gradient.

    * Through the mask (the encoder, the handle head, the template): 0.05,
      the JAX package's bound for its own two rasterizers' vertex gradient
      (tests/test_rasterizer_tpu.py::test_grad_matches_reference): at an
      edge-on face or a silhouette edge `inside` flips between two f32
      implementations and the slope's sign with it.
    * The texture decoder: 0.05 too. Its gradient does not pass through the
      mask, but its cotangent is read off the rasterizer's discrete outputs
      (pix_to_face, nearest atlas cells), which agree on > 99.9% of the
      pixels, not all; the decoder alone agrees to ~1e-6.
    * The camera head (use_gtpose: the camera only enters cam_loss): 2e-3,
      f32 nets summed in another order and fed by the train-mode encoder
      (measured 3e-4).
    * vert2kp_logits (keypoint and entropy terms of pred_v): 1e-4 (measured
      3e-6).
    """
    if name.startswith("camera_predictor."):
        return 2e-3
    if name == "vert2kp_logits":
        return 1e-4
    return 0.05


# A bias followed by a train-mode BatchNorm: the mean subtraction removes
# it, so its exact gradient is 0 and what both sides compute is f32 noise.
BN_FED_BIASES = ("encoder.enc_conv1.conv.bias", "encoder.enc_fc.0.fc.bias",
                 "encoder.enc_fc.1.fc.bias")


def _cfg(lib):
    return lib.Config(
        model=dataclasses.replace(
            lib.ModelConfig(), img_size=IMG, nz_feat=32, num_lbs=6, num_kps=4, tex_size=2,
            texture=True, symmetric=False, symmetric_texture=False,
        ),
        train=dataclasses.replace(lib.TrainConfig(), batch_size=2, use_gtpose=True),
    )


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b) -> float:
    a, b = torch.as_tensor(np.array(a)), torch.as_tensor(np.array(b))
    return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()


@pytest.fixture(scope="module")
def jax_side():
    template = build_template(**TEMPLATE)
    mods_j, tx, state = jmono.build(_cfg(jcfg), template, jax.random.PRNGKey(0))
    ds = SyntheticDataset(template, SyntheticConfig(num_frames_total=8, clip_len=1,
                                                    image_size=IMG, num_kps=4))
    b = preprocess_batch(ds.get_batch(np.asarray([0, 1])), IMG)
    batch = {k: np.asarray(b[k][:, 0]) for k in ("img", "mask", "kp", "sfm_pose")}
    batch["edt"] = np.asarray(b["edt"])
    batch["boundaries"] = np.asarray(b["boundaries"])
    return mods_j, tx, state, batch


def _port_mods(state):
    mods = tmono.build(_cfg(tcfg), ttemplate.build_template(**TEMPLATE), seed=0, device="cpu")
    from_jax.load_jax_weights(mods, _np_tree(state.params), _np_tree(state.batch_stats),
                              _np_tree(state.lpips_params))
    return mods


@pytest.fixture(scope="module")
def one_step(jax_side):
    """One train step on both sides from the same weights at SIGMA / BLUR:
    jax.grad of the JAX forward(train=True) with optax's update, and the
    port's make_train_step. The JAX trees come back in the port's names and
    layouts (from_jax.convert)."""
    mods_j, tx, state, batch = jax_side
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jras, "soft_silhouette_vis_tex", functools.partial(
            jras.soft_silhouette_vis_tex, sigma=SIGMA, blur_radius=BLUR))
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss_fn(params):
            return jmono.forward(mods_j, params, state.batch_stats, state.lpips_params,
                                 jbatch, train=True, face_chunk=80)

        (_, aux_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(state.params)
        updates, _ = tx.update(grads_j, tx.init(state.params), state.params)
        params_j = optax.apply_updates(state.params, updates)

    mods_t = _port_mods(state)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tras, "soft_silhouette_vis_tex", functools.partial(
            tras.soft_silhouette_vis_tex, sigma=SIGMA, blur_radius=BLUR))
        before = {k: v.detach().clone() for k, v in mods_t.model.state_dict().items()}
        metrics_t = tmono.make_train_step(mods_t)(batch)
    bs_j = _np_tree(aux_j["batch_stats"])
    return {
        "metrics_j": aux_j["metrics"], "metrics_t": metrics_t,
        "grad_j": from_jax.convert(mods_t.model, _np_tree(grads_j), bs_j),
        "after_j": from_jax.convert(mods_t.model, _np_tree(params_j), bs_j),
        # optimizer.step() leaves each parameter's .grad in place
        "grad_t": {k: p.grad for k, p in mods_t.model.named_parameters()},
        "before": before,
        "after_t": mods_t.model.state_dict(),
        "params": [k for k, _ in mods_t.model.named_parameters()],
    }


@pytest.mark.heavy
def test_train_step_loss_terms_match_jax(one_step):
    m_j, m_t = one_step["metrics_j"], one_step["metrics_t"]
    assert set(m_t) == set(m_j)
    for name, want in m_j.items():
        np.testing.assert_allclose(m_t[name].item(), float(want), err_msg=name,
                                   **METRIC_TOL.get(name, DEFAULT_TOL))


@pytest.mark.heavy
def test_train_step_gradients_match_jax(one_step):
    """Per parameter tensor, the vector relative error of the gradient
    within _grad_bound; a bias fed to a train-mode BatchNorm has a gradient
    below 1e-5 of its weight's on both sides (f32 noise of an exact 0)."""
    s = one_step
    assert set(s["params"]) <= set(s["grad_j"])
    worst = {}
    for name in s["params"]:
        gt, gj = s["grad_t"][name], s["grad_j"][name]
        assert gt is not None, name
        if name in BN_FED_BIASES:
            w = torch.linalg.vector_norm(s["grad_j"][name[:-4] + "weight"])
            assert torch.linalg.vector_norm(gt) <= 1e-5 * w, name
            assert torch.linalg.vector_norm(gj) <= 1e-5 * w, name
            continue
        if name == "lbs_logits":
            continue  # test_train_step_lbs_gradient_matches_jax
        rel = _rel(gt, gj)
        worst[name] = rel
        assert rel < _grad_bound(name), (name, rel)
    print("worst gradient rel error:", max(worst.items(), key=lambda kv: kv[1]))


@pytest.mark.heavy
def test_train_step_lbs_gradient_matches_jax(one_step):
    """The skinning logits' gradient is first order in the handle offsets,
    ~1e-5 at init (with zero offsets the solve returns mean_v whatever the
    weights), so it is a cancellation of O(adjoint) terms in the Cholesky
    VJP whose f32 rounding is ~1e-7 of the adjoint's scale, which mean_v's
    gradient gives: held to an absolute 1e-5 of that. The solve's gradient
    at non-zero offsets is held tightly by
    test_solve_gradient_matches_jax."""
    s = one_step
    scale = torch.linalg.vector_norm(s["grad_j"]["mean_v"])
    diff = torch.linalg.vector_norm(s["grad_t"]["lbs_logits"] - s["grad_j"]["lbs_logits"])
    assert diff <= 1e-5 * scale, (diff, scale)


@pytest.mark.heavy
def test_train_step_batch_stats_match_jax(one_step):
    """flax's update, running = 0.99 running + 0.01 batch, with the biased
    batch variance: the encoder's statistics move and agree with JAX's to
    the f32 rounding of the batch moments (atol 1e-6 on an update of
    0.01 x O(1)); the texture decoder ran in eval mode, so its statistics
    are untouched on both sides."""
    s = one_step
    moved = 0
    for name, got in s["after_t"].items():
        if not name.endswith(("running_mean", "running_var")):
            continue
        want = s["after_j"][name]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
        if name.startswith("texture_predictor."):
            assert torch.equal(got, s["before"][name]), name
        else:
            moved += not torch.equal(got, s["before"][name])
    assert moved > 0


@pytest.mark.heavy
def test_train_step_adam_update_matches_jax(one_step):
    """Adam's first step is -lr * g / (|g| + 1e-8): a sign step, within 1%
    of lr wherever |g| > 1e-6. Where both sides' |g| exceed that and the
    signs agree, the updates agree to 1% of lr plus rounding; the elements
    where a gradient sits below 1e-6 on one side or the signs differ are
    elements whose gradient rounding decides, and are held to 3e-3 of
    those with |g_jax| > 1e-6 (measured 9.7e-4)."""
    s = one_step
    lr = tcfg.TrainConfig().learning_rate
    n_big = n_undecided = 0
    for name in s["params"]:
        g_t, g_j = s["grad_t"][name], s["grad_j"][name]
        d_t = s["after_t"][name] - s["before"][name]
        d_j = s["after_j"][name] - s["before"][name]
        big = g_j.abs() > 1e-6
        decided = big & (g_t.abs() > 1e-6) & (torch.sign(g_t) == torch.sign(g_j))
        n_big += int(big.sum())
        n_undecided += int((big & ~decided).sum())
        torch.testing.assert_close(d_t[decided], d_j[decided], rtol=0, atol=0.011 * lr,
                                   msg=name)
    print(f"Adam: {n_undecided} of {n_big} elements with |g| > 1e-6 undecided")
    assert n_big > 0
    assert n_undecided <= 3e-3 * n_big, (n_undecided, n_big)


@pytest.mark.heavy
def test_eight_train_steps_decrease_loss(jax_side):
    """Eight port train steps at the production sigma: finite, falling
    total loss (as tests/test_train_monocular.py does for JAX)."""
    _, _, state, batch = jax_side
    step = tmono.make_train_step(_port_mods(state))
    losses = [float(step(batch)["total_loss"]) for _ in range(8)]
    assert np.all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses


def test_adam_matches_optax():
    """torch.optim.Adam(betas=(0.9, 0.999), eps=1e-8) against optax.adam
    over 3 steps of seeded gradients: the same update up to f32 rounding,
    an ulp of the parameter (rtol 1e-6)."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(64,)).astype(np.float32)
    grads = [rng.normal(size=(64,)).astype(np.float32) * s for s in (1.0, 1e-3, 10.0)]
    tx = optax.adam(1e-3, b1=0.9, b2=0.999)
    pj, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    pt = torch.nn.Parameter(torch.tensor(p0))
    opt = torch.optim.Adam([pt], lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, pj)
        pj = optax.apply_updates(pj, upd)
        pt.grad = torch.tensor(g)
        opt.step()
        np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["2d", "1d"])
def test_batchnorm_train_mode_matches_flax(kind):
    """The port's BatchNorm in train mode against flax
    nn.BatchNorm(use_running_average=False): outputs to f32 rounding, and
    running statistics updated with the biased variance at momentum 0.99
    (torch's own BatchNorm would take the unbiased one: off by a factor
    n/(n-1) in the variance's share, 1/7 at n=8)."""
    rng = np.random.default_rng(3)
    shape = (2, 6, 4, 5) if kind == "2d" else (8, 6)  # n = 40 / 8 per channel
    x = (rng.normal(size=shape) * 2.0 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.normal(size=6).astype(np.float32)
    mean0 = rng.normal(size=6).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    x_nhwc = np.moveaxis(x, 1, -1) if kind == "2d" else x
    bn = fnn.BatchNorm(use_running_average=False)
    y_j, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                         "batch_stats": {"mean": mean0, "var": var0}},
                        jnp.asarray(x_nhwc), mutable=["batch_stats"])
    mod = nn_blocks.BatchNorm2d(6) if kind == "2d" else nn_blocks.BatchNorm1d(6)
    with torch.no_grad():
        mod.weight.copy_(torch.tensor(scale))
        mod.bias.copy_(torch.tensor(bias))
        mod.running_mean.copy_(torch.tensor(mean0))
        mod.running_var.copy_(torch.tensor(var0))
    y_t = mod.train()(torch.tensor(x))
    if kind == "2d":
        y_t = y_t.permute(0, 2, 3, 1)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mod.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(mod.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), rtol=1e-6, atol=1e-7)


def test_static_sampler_gradient_matches_jax():
    """Autograd through the port's gather + weighted corner sum (an
    index_add into the image) against the JAX sampler's custom VJP, with
    repeated coordinates so that pixels collect many samples: the same
    sums in another order, rtol 1e-5."""
    rng = np.random.default_rng(5)
    H, W, C = 8, 16, 3
    coords = rng.uniform(-1, 1, (300, 2))
    coords = np.concatenate([coords, coords[:40], np.zeros((20, 2))])
    img = rng.normal(size=(2, H, W, C)).astype(np.float32)
    cot = rng.normal(size=(2, coords.shape[0], C)).astype(np.float32)
    fn = jstatic.make_static_bilinear(coords, H, W)
    g_j = jax.grad(lambda im: (fn(im) * cot).sum())(jnp.asarray(img))
    im_t = torch.tensor(img).permute(0, 3, 1, 2).requires_grad_(True)
    (StaticBilinear(coords, H, W)(im_t) * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(im_t.grad.permute(0, 2, 3, 1).numpy(), np.asarray(g_j),
                               rtol=1e-5, atol=1e-6)


def test_solve_gradient_matches_jax():
    """The screened-Poisson solve's gradient to mean_v, the skinning matrix
    and the handle offsets, torch's cholesky / cholesky_solve autograd
    against JAX's cho_factor / cho_solve, f32, at offsets of 0.05. The
    normal equations are formed in f32 on both sides and rounded in
    another order; the Laplacian's near-nullspace (min eigenvalue ~2e-3)
    amplifies that, which pred_v's atol 1e-4 in the slice test reflects:
    rel 1e-3 on each gradient."""
    t = ttemplate.build_template(**TEMPLATE)
    rng = np.random.default_rng(6)
    lbs = np.asarray(torch.softmax(torch.tensor(t.lbs_logits, dtype=torch.float32), 0).T)
    delta = (rng.normal(size=(2, t.num_lbs, 3)) * 0.05).astype(np.float32)
    cot = rng.normal(size=(2, t.num_verts, 3)).astype(np.float32)
    mean_v = np.asarray(t.mean_v_init, np.float32)
    L = np.asarray(t.uniform_L, np.float32)
    g_j = jax.grad(lambda m, a, d: (jsolve.screened_poisson_solve(m, a, d, jnp.asarray(L))
                                    * cot).sum(), argnums=(0, 1, 2))(
        jnp.asarray(mean_v), jnp.asarray(lbs), jnp.asarray(delta))
    args = [torch.tensor(a, requires_grad=True) for a in (mean_v, lbs, delta)]
    (tsolve.screened_poisson_solve(*args, torch.tensor(L)) * torch.tensor(cot)).sum().backward()
    for name, a, want in zip(("mean_v", "lbs", "delta"), args, g_j):
        rel = _rel(a.grad, want)
        assert rel < 1e-3, (name, rel)


_CAM = np.asarray([[0.8, 0.1, -0.1, 1.0, 0.0, 0.0, 0.0],
                   [0.7, 0.0, 0.2, 0.0, 1.0, 0.0, 0.0]], np.float32)


def _tie_cases():
    """(name, JAX fn, port fn, input) at the non-smooth point of each."""
    rng = np.random.default_rng(7)
    at_eps = np.zeros((4, 3), np.float32)
    at_eps[1, 0] = 1e-12  # sum of squares == eps^2 exactly in f32
    at_eps[2] = rng.normal(size=3)
    verts = rng.uniform(-1, 1, (2, 6, 2)).astype(np.float32)
    verts[:, 3] = verts[:, 2]  # duplicated vertices: amin ties
    bds = np.concatenate([verts[:, 2:4] + 0.0, np.ones((2, 2, 1), np.float32)], -1)
    vis = np.asarray([[1, 1, 1, 1, 0, 0], [0, 0, 0, 0, 0, 0]], np.float32)  # all-1000 ties
    probs = np.full((2, 4), 0.25, np.float32)
    probs[0] = [1e-12, 0.5, 0.25, 0.25]
    mask = rng.random((2, 5, 5)).astype(np.float32)
    edt = np.where(rng.random((2, 5, 5)) > 0.5, rng.random((2, 5, 5)), 0.0).astype(np.float32)
    return [
        ("safe_norm", lambda x: jmesh.safe_norm(x).sum(),
         lambda x: tmesh.safe_norm(x).sum(), at_eps),
        ("hinge", lambda x: jloss.hinge(x, 0.5).sum(), lambda x: tloss.hinge(x, 0.5).sum(),
         np.asarray([0.5, 0.2, 0.9], np.float32)),
        ("boundaries_amin", lambda v: jloss.boundaries_loss(v, jnp.asarray(bds),
                                                            jnp.asarray(vis)),
         lambda v: tloss.boundaries_loss(v, torch.tensor(bds), torch.tensor(vis)), verts),
        ("edt", lambda m: jloss.edt_loss(m, jnp.asarray(edt)),
         lambda m: tloss.edt_loss(m, torch.tensor(edt)), mask),
        ("entropy_clip", jloss.entropy_loss, tloss.entropy_loss, probs),
        ("camera_hinge_at_zero",
         lambda c: jloss.camera_loss(c, jnp.asarray(_CAM)), lambda c: tloss.camera_loss(
             c, torch.tensor(_CAM)), _CAM.copy()),
    ]


@pytest.mark.parametrize("case", _tie_cases(), ids=lambda c: c[0])
def test_loss_gradient_at_nonsmooth_point_matches_jax(case):
    """At ties (sum of squares == eps^2, hinge at its margin, equidistant
    and all-invisible vertices in boundaries_loss, a probability at the
    entropy's clip, a camera equal to the ground truth) the port's gradient
    is JAX's: jnp.maximum / jnp.clip / min-reductions split a tie's gradient
    evenly, and so do torch.maximum and amin (torch.clamp would pass all
    of it). Same arithmetic, rtol 1e-6."""
    _, fj, ft, x = case
    g_j = np.asarray(jax.grad(fj)(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    ft(xt).backward()
    np.testing.assert_allclose(xt.grad.numpy(), g_j, rtol=1e-6, atol=1e-12)


def test_lpips_is_frozen_and_passes_gradient_to_inputs():
    """LPIPS's weights take no gradient (the JAX step differentiates only
    `params`, not `lpips_params`); its inputs get JAX's gradient, rtol 1e-4
    (f32 convolutions summed in another order)."""
    rng = np.random.default_rng(8)
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    y = rng.random((2, 32, 32, 3)).astype(np.float32)
    m = (rng.random((2, 32, 32)) > 0.5).astype(np.float32)
    lp_j = jlpips.LPIPS()
    params = lp_j.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(y))["params"]
    g_j = jax.grad(lambda a: jlpips.perceptual_texture_loss(
        lambda p, q: lp_j.apply({"params": params}, p, q), a, jnp.asarray(y),
        jnp.asarray(m)))(jnp.asarray(x))
    lp_t = tlpips.LPIPS()
    lp_t.load_state_dict(from_jax.convert(lp_t, _np_tree(params)))
    assert not any(p.requires_grad for p in lp_t.parameters())
    xt = torch.tensor(x, requires_grad=True)
    tlpips.perceptual_texture_loss(lp_t, xt, torch.tensor(y), torch.tensor(m)).backward()
    assert _rel(xt.grad, g_j) < 1e-4
