"""The whole ported slice against the JAX package: make_eval_step and
predict_monocular at the config of tests/test_train_monocular.py (64^2,
subdivide 2, 6 handles, 4 keypoints, tex 2, nz_feat 32, texture on, f32),
with the weights of the JAX init carried across by models/from_jax.py.

The JAX side runs the dense pure-JAX rasterizer (CPU backend), the port
its binned plain version; at 64^2 auto_K gives the exact capacity, so no
bin drops a face and the two compute the same function.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acfm_video_3d_reconstruction_tpu import config as jcfg
from acfm_video_3d_reconstruction_tpu.data.synthetic import (
    SyntheticConfig,
    SyntheticDataset,
    preprocess_batch,
)
from acfm_video_3d_reconstruction_tpu.eval import predictor as jpred
from acfm_video_3d_reconstruction_tpu.models import build_template
from acfm_video_3d_reconstruction_tpu.train import monocular as jmono
from acfm_video_3d_reconstruction_tpu_torch import config as tcfg
from acfm_video_3d_reconstruction_tpu_torch.eval import predictor as tpred
from acfm_video_3d_reconstruction_tpu_torch.models import from_jax
from acfm_video_3d_reconstruction_tpu_torch.models import template as ttemplate
from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer_cuda as rc
from acfm_video_3d_reconstruction_tpu_torch.train import monocular as tmono

torch.set_num_threads(1)

IMG = 64
TEMPLATE = dict(subdivide=2, num_lbs=6, tex_size=2, num_kps=4)

# Tolerances, each with its reason:
#  * mask_pred, and the terms read off it (mask/edt/sil_cons/bdt): the
#    rasterizer's mask tolerance, atol 2e-4 (tests/test_rasterizer_tpu.py);
#    the mask terms are means of it, rtol 1e-3 covers that.
#  * pred_v / kp_pred: the f32 normal equations of the solve, rounded in
#    another order; the subdivide-2 system is well pinned, atol 1e-4.
#  * cam_pred and the network-only terms: f32 nets summed in another
#    order, rtol 1e-4 / atol 1e-5 (as tests/test_torch_port_models.py).
#  * tex_loss: the loosest by design, nearest-cell atlas lookups flip a
#    texel wherever a barycentric sits on a cell edge, rtol 1e-3.
#  * rigid_loss: ~1e-9 at init (deformation ~1e-6), pure rounding noise of
#    pred_v - mean_v, so an absolute bound, atol 1e-8.
METRIC_TOL = {
    "mask_loss": dict(rtol=1e-3, atol=0), "edt_loss": dict(rtol=1e-3, atol=0),
    "sil_cons": dict(rtol=1e-3, atol=0), "bdt_loss": dict(rtol=1e-3, atol=0),
    "tex_loss": dict(rtol=1e-3, atol=0), "rigid_loss": dict(rtol=0, atol=1e-8),
}
DEFAULT_TOL = dict(rtol=1e-4, atol=1e-5)


def _cfg(lib):
    return lib.Config(
        model=dataclasses.replace(
            lib.ModelConfig(), img_size=IMG, nz_feat=32, num_lbs=6, num_kps=4, tex_size=2,
            texture=True, symmetric=False, symmetric_texture=False,
        ),
        train=dataclasses.replace(lib.TrainConfig(), batch_size=2, use_gtpose=True),
    )


@pytest.fixture(scope="module")
def slice_pair():
    template = build_template(**TEMPLATE)
    mods_j, _, state = jmono.build(_cfg(jcfg), template, jax.random.PRNGKey(0))
    ds = SyntheticDataset(template, SyntheticConfig(num_frames_total=8, clip_len=1,
                                                    image_size=IMG, num_kps=4))
    b = preprocess_batch(ds.get_batch(np.asarray([0, 1])), IMG)
    batch = {k: np.asarray(b[k][:, 0]) for k in ("img", "mask", "kp", "sfm_pose")}
    batch["edt"] = np.asarray(b["edt"])
    batch["boundaries"] = np.asarray(b["boundaries"])

    mods_t = tmono.build(_cfg(tcfg), ttemplate.build_template(**TEMPLATE), seed=0,
                         device="cpu")
    tree = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731
    from_jax.load_jax_weights(mods_t, tree(state.params), tree(state.batch_stats),
                              tree(state.lpips_params))
    return mods_j, state, mods_t, batch


@pytest.mark.heavy
def test_eval_step_matches_jax(slice_pair):
    mods_j, state, mods_t, batch = slice_pair
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    aux_j = jmono.make_eval_step(mods_j, face_chunk=80)(state, jbatch)
    aux_t = tmono.make_eval_step(mods_t)(batch)

    assert set(aux_t) == set(aux_j)
    assert set(aux_t["metrics"]) == set(aux_j["metrics"])
    for name, want in aux_j["metrics"].items():
        got = aux_t["metrics"][name]
        np.testing.assert_allclose(got.item(), float(want), err_msg=name,
                                   **METRIC_TOL.get(name, DEFAULT_TOL))
    np.testing.assert_allclose(aux_t["mask_pred"].numpy(), np.asarray(aux_j["mask_pred"]),
                               atol=2e-4, rtol=0)
    for name in ("pred_v", "kp_pred"):
        np.testing.assert_allclose(aux_t[name].numpy(), np.asarray(aux_j[name]),
                                   atol=1e-4, rtol=0, err_msg=name)
    np.testing.assert_allclose(aux_t["cam_pred"].numpy(), np.asarray(aux_j["cam_pred"]),
                               **DEFAULT_TOL)


@pytest.mark.heavy
def test_predict_monocular_matches_jax(slice_pair):
    mods_j, state, mods_t, batch = slice_pair
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.jit(lambda s, b: jpred.predict_monocular(mods_j, s, b, face_chunk=80))(
        state, jbatch)
    got = tpred.predict_monocular(mods_t, batch)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["faces"], np.asarray(want["faces"]))
    np.testing.assert_array_equal(got["mean_shape"].numpy(), np.asarray(want["mean_shape"]))
    np.testing.assert_allclose(got["lbs"].numpy(), np.asarray(want["lbs"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(got["mask_pred"].numpy(), np.asarray(want["mask_pred"]),
                               atol=2e-4, rtol=0)
    for name in ("verts", "kp_pred"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), atol=1e-4,
                                   rtol=0, err_msg=name)
    np.testing.assert_allclose(got["cam_pred"].numpy(), np.asarray(want["cam_pred"]),
                               **DEFAULT_TOL)


@pytest.mark.heavy
def test_eval_step_on_cpu_launches_no_kernel(slice_pair):
    """On CPU tensors the eval step runs the plain rasterizer: no kernel
    launch is counted, and a second step gives the same outputs bit for
    bit."""
    _, _, mods_t, batch = slice_pair
    before = dict(rc.LAUNCHES)
    a = tmono.make_eval_step(mods_t)(batch)
    b = tmono.make_eval_step(mods_t)(batch)
    assert rc.LAUNCHES == before
    for name in ("mask_pred", "pred_v", "kp_pred", "cam_pred"):
        assert torch.equal(a[name], b[name]), name
