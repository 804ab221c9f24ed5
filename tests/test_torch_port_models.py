"""The port's networks against the JAX package's, with the weights of a
jax.random.PRNGKey(0) init carried across by models/from_jax.py.

Both sides run float32 in eval mode. Tolerance rtol 1e-4 / atol 1e-5:
the same f32 arithmetic summed in another order by XLA and by PyTorch's
CPU kernels, over at most ~20 layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acfm_video_3d_reconstruction_tpu import config as jcfg
from acfm_video_3d_reconstruction_tpu.models import build_template
from acfm_video_3d_reconstruction_tpu.train import monocular as jmono
from acfm_video_3d_reconstruction_tpu_torch import config as tcfg
from acfm_video_3d_reconstruction_tpu_torch.models import from_jax
from acfm_video_3d_reconstruction_tpu_torch.models import template as ttemplate
from acfm_video_3d_reconstruction_tpu_torch.train import monocular as tmono

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _model_cfg(cfg_lib, img_size):
    return cfg_lib.Config(
        model=dataclasses.replace(
            cfg_lib.ModelConfig(), img_size=img_size, nz_feat=32, num_lbs=6, num_kps=4,
            tex_size=2, texture=True, symmetric=False, symmetric_texture=False,
        ),
    )


@pytest.fixture(scope="module", params=[64, 128], ids=["64px", "128px"])
def pair(request):
    """(JAX mods, JAX state, port mods with the same weights, img size).
    128px gives a 2x2 res_feats map, so the flatten permutation of the
    first encoder FC is exercised."""
    img = request.param
    kw = dict(subdivide=2, num_lbs=6, tex_size=2, num_kps=4)
    mods_j, _, state = jmono.build(_model_cfg(jcfg, img), build_template(**kw),
                                   jax.random.PRNGKey(0))
    mods_t = tmono.build(_model_cfg(tcfg, img), ttemplate.build_template(**kw),
                         seed=0, device="cpu")
    from_jax.load_jax_weights(mods_t, _np_tree(state.params), _np_tree(state.batch_stats),
                              _np_tree(state.lpips_params))
    return mods_j, state, mods_t, img


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(kw or TOL))


def test_meshnet_forward_matches(pair):
    """Encoder code, res_feats, handle offsets (TransformationPredictor)
    and the camera head."""
    mods_j, state, mods_t, img = pair
    x = np.random.default_rng(0).normal(size=(2, img, img, 3)).astype(np.float32)
    out_j = mods_j.model.apply({"params": state.params, "batch_stats": state.batch_stats},
                               jnp.asarray(x), train=False)
    with torch.no_grad():
        out_t = mods_t.model(torch.tensor(x))
    _close(out_t["img_feat"], out_j["img_feat"])
    _close(out_t["res_feats"].permute(0, 2, 3, 1), out_j["res_feats"])
    _close(out_t["delta_v"], out_j["delta_v"])
    _close(out_t["cam_pred"], out_j["cam_pred"])


def test_texture_decoder_matches(pair):
    """The UV decoder + static bilinear sampler from the same res_feats."""
    mods_j, state, mods_t, img = pair
    side = mods_t.model.texture_predictor.res_side
    res = np.random.default_rng(1).normal(size=(2, side, side, 256)).astype(np.float32)
    atlas_j = mods_j.model.apply({"params": state.params, "batch_stats": state.batch_stats},
                                 jnp.asarray(res), train=False, method=mods_j.model.textures)
    with torch.no_grad():
        atlas_t = mods_t.model.textures(torch.tensor(res).permute(0, 3, 1, 2))
    assert atlas_t.shape == atlas_j.shape
    _close(atlas_t, atlas_j)


def test_lpips_matches(pair):
    mods_j, state, mods_t, img = pair
    rng = np.random.default_rng(2)
    x, y = (rng.uniform(-1, 1, (2, img, img, 3)).astype(np.float32) for _ in range(2))
    d_j = mods_j.lpips.apply({"params": state.lpips_params}, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        d_t = mods_t.lpips(torch.tensor(x), torch.tensor(y))
    _close(d_t, d_j)


def test_template_state_matches(pair):
    mods_j, state, mods_t, _ = pair
    m = mods_j.model
    with torch.no_grad():
        for meth, got in ((m.get_mean_shape, mods_t.model.get_mean_shape()),
                          (m.get_lbs, mods_t.model.get_lbs()),
                          (m.get_vert2kp, mods_t.model.get_vert2kp())):
            want = m.apply({"params": state.params}, method=meth)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_conversion_checks_coverage(pair):
    """A tree that misses a parameter, or names one the module lacks, raises."""
    _, state, mods_t, _ = pair
    params = _np_tree(state.params)
    stats = _np_tree(state.batch_stats)
    short = dict(params)
    del short["lbs_logits"]
    with pytest.raises(KeyError):
        from_jax.convert(mods_t.model, short, stats)
    extra = dict(params, bogus=np.zeros(3, np.float32))
    with pytest.raises(KeyError):
        from_jax.convert(mods_t.model, extra, stats)


def test_fresh_init_follows_jax_initialisers():
    """The port's own seeded init: tiny handle head (std 1e-5), quaternion
    bias (1e-2, 0, 0, 0), N(0, 0.02) in ConvBNLeaky/FCBNLeaky, BN stats 0/1,
    and it is reproducible from the seed."""
    t = ttemplate.build_template(subdivide=1, num_lbs=4, tex_size=2, num_kps=3)
    cfg = _model_cfg(tcfg, 64)
    a = tmono.build(cfg, t, seed=3, device="cpu").model
    b = tmono.build(cfg, t, seed=3, device="cpu").model
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert a.code_predictor.fc.weight.std().item() < 5e-5
    torch.testing.assert_close(a.camera_predictor.quat.fc.bias,
                               torch.tensor([1e-2, 0.0, 0.0, 0.0]))
    assert 0.01 < a.encoder.enc_conv1.conv.weight.std().item() < 0.03
    bn = a.encoder.resnet.bn1
    assert torch.equal(bn.running_mean, torch.zeros(64))
    assert torch.equal(bn.running_var, torch.ones(64))
