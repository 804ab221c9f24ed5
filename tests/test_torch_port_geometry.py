"""The port's geometry against the JAX package's: template arrays bit for
bit, cameras/quaternions, safe_norm's gradient, the screened-Poisson solve."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acfm_video_3d_reconstruction_tpu.deform import solve as jsolve
from acfm_video_3d_reconstruction_tpu.geometry import camera as jcam
from acfm_video_3d_reconstruction_tpu.geometry import mesh_ops as jmesh
from acfm_video_3d_reconstruction_tpu.geometry import quaternion as jquat
from acfm_video_3d_reconstruction_tpu.geometry import symmetry as jsym
from acfm_video_3d_reconstruction_tpu.models import template as jtemplate
from acfm_video_3d_reconstruction_tpu_torch.deform import solve as tsolve
from acfm_video_3d_reconstruction_tpu_torch.geometry import camera as tcam
from acfm_video_3d_reconstruction_tpu_torch.geometry import mesh_ops as tmesh
from acfm_video_3d_reconstruction_tpu_torch.geometry import quaternion as tquat
from acfm_video_3d_reconstruction_tpu_torch.geometry import symmetry as tsym
from acfm_video_3d_reconstruction_tpu_torch.models import template as ttemplate

torch.set_num_threads(1)

TEMPLATE_FIELDS = ("verts", "faces", "uniform_L", "edges", "edges2verts", "uv_sampler",
                   "lbs_logits", "handle_idx", "vert2kp_logits")


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(subdivide=2, num_lbs=6, tex_size=2, num_kps=4),
        dict(subdivide=3, num_lbs=16, tex_size=6, num_kps=15),
        dict(subdivide=2, num_lbs=8, tex_size=3, num_kps=5, symmetric=True,
             symmetric_texture=True),
    ],
    ids=["test-config", "bench-config", "symmetric"],
)
def test_template_arrays_bit_equal(kwargs):
    want = jtemplate.build_template(**kwargs)
    got = ttemplate.build_template(**kwargs)
    for name in TEMPLATE_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("num_learnable", "num_sym", "num_sym_faces", "num_tex_faces"):
        assert getattr(got, name) == getattr(want, name), name


def _cams(rng, B):
    q = rng.normal(size=(B, 4))
    q[0] = -q[0]  # one negative real part exercises standardize
    return np.concatenate(
        [rng.uniform(0.5, 1.0, (B, 1)), rng.uniform(-0.2, 0.2, (B, 2)), q], 1
    ).astype(np.float32)


def test_camera_and_quaternion_match():
    """f32 elementwise math on both sides: atol 1e-6."""
    rng = np.random.default_rng(0)
    B, N = 5, 40
    X = rng.normal(size=(B, N, 3)).astype(np.float32)
    cam = _cams(rng, B)
    q1 = rng.normal(size=(B, 4)).astype(np.float32)
    q2 = rng.normal(size=(B, 4)).astype(np.float32)
    flag = np.asarray([1, 0, 1, 1, 0], np.float32)
    pairs = [
        (jcam.orthographic_proj_withz(X, cam, offset_z=5.0),
         tcam.orthographic_proj_withz(torch.tensor(X), torch.tensor(cam), offset_z=5.0)),
        (jcam.project_points(X, cam), tcam.project_points(torch.tensor(X), torch.tensor(cam))),
        (jcam.mirror_camera(cam, flag),
         tcam.mirror_camera(torch.tensor(cam), torch.tensor(flag))),
        (jquat.hamilton_product(q1, q2),
         tquat.hamilton_product(torch.tensor(q1), torch.tensor(q2))),
        (jquat.quat_rotate(X, q1), tquat.quat_rotate(torch.tensor(X), torch.tensor(q1))),
        (jquat.quat_normalize(q1), tquat.quat_normalize(torch.tensor(q1))),
        (jquat.mirror_quat(q1), tquat.mirror_quat(torch.tensor(q1))),
        (jquat.quat_geodesic_loss(q1, q2),
         tquat.quat_geodesic_loss(torch.tensor(q1), torch.tensor(q2))),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_symmetrize_matches():
    rng = np.random.default_rng(1)
    v = rng.normal(size=(30, 3)).astype(np.float32)
    np.testing.assert_array_equal(tsym.symmetrize(torch.tensor(v), 12).numpy(),
                                  np.asarray(jsym.symmetrize(jnp.asarray(v), 12)))


def test_safe_norm_gradient_is_zero_at_zero():
    x = torch.zeros(4, 3, requires_grad=True)
    tmesh.safe_norm(x, dim=-1).sum().backward()
    assert torch.equal(x.grad, torch.zeros_like(x))
    y = torch.tensor([[3.0, 4.0, 0.0]], requires_grad=True)
    n = tmesh.safe_norm(y, dim=-1)
    n.sum().backward()
    assert n.item() == 5.0
    torch.testing.assert_close(y.grad, torch.tensor([[0.6, 0.8, 0.0]]))


def test_laplacian_smoothing_matches():
    t = ttemplate.build_template(subdivide=2, num_lbs=6, tex_size=2, num_kps=0)
    rng = np.random.default_rng(2)
    v = (t.verts[None] + 0.05 * rng.normal(size=(3,) + t.verts.shape)).astype(np.float32)
    want = jmesh.uniform_laplacian_smoothing(jnp.asarray(v), jnp.asarray(t.uniform_L))
    got = tmesh.uniform_laplacian_smoothing(torch.tensor(v), torch.tensor(t.uniform_L))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_screened_poisson_solve_matches():
    """Both solves are f32; the Laplacian near-nullspace (min eigenvalue
    ~2e-3) amplifies rounding of the normal equations, so atol 1e-3."""
    t = ttemplate.build_template(subdivide=3, num_lbs=16, tex_size=2, num_kps=0)
    rng = np.random.default_rng(3)
    delta = (0.05 * rng.normal(size=(4, 16, 3))).astype(np.float32)
    lbs_logits = t.lbs_logits + 0.1 * rng.normal(size=t.lbs_logits.shape).astype(np.float32)
    lbs_j = jsolve.lbs_from_logits(jnp.asarray(lbs_logits))
    want = jsolve.screened_poisson_solve(jnp.asarray(t.verts), lbs_j, jnp.asarray(delta),
                                         jnp.asarray(t.uniform_L))
    lbs_t = torch.softmax(torch.tensor(lbs_logits), dim=0).T
    got = tsolve.screened_poisson_solve(torch.tensor(t.verts), lbs_t, torch.tensor(delta),
                                        torch.tensor(t.uniform_L))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)
