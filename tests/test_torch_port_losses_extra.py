"""The rest of the port's loss and mesh functions against the JAX package's,
on the CPU, and the host-constant repairs of the monocular path.

* template_edge_loss, triangle_loss, texture_loss_l1, texture_dt_loss_v,
  texture_dt_loss, mask_dt_loss and boundaries_loss's k-nearest path
  (losses/losses.py), face_normals and
  edge_lengths (geometry/mesh_ops.py), lbs_from_logits (deform/solve.py):
  on tests/test_losses_deform.py's cases (the template itself, a planar
  pair, a collapsed edge, a degenerate dihedral) and on random inputs made
  with numpy from a seed. Values within rtol 1e-5 (f32 sums in another
  order; the bilinear lookups weigh their four texels in another order),
  gradients within vector relative error 1e-4, finite at the degenerate
  points as JAX's are.
* normalize_imagenet, the camera head's quaternion normalisation,
  LPIPS's unit normalisation, entropy_loss and symmetrize build their
  constants on the device now: each equals the formula with the uploaded
  constant bit for bit, and equals its JAX counterpart (rtol 1e-6); the
  solve factors without cholesky's host check, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acfm_video_3d_reconstruction_tpu import config as jcfg
from acfm_video_3d_reconstruction_tpu.deform import solve as jsolve
from acfm_video_3d_reconstruction_tpu.geometry import icosphere
from acfm_video_3d_reconstruction_tpu.geometry import mesh_ops as jmesh
from acfm_video_3d_reconstruction_tpu.geometry import symmetry as jsym
from acfm_video_3d_reconstruction_tpu.losses import losses as jloss
from acfm_video_3d_reconstruction_tpu.models import heads as jheads
from acfm_video_3d_reconstruction_tpu.models import lpips as jlpips
from acfm_video_3d_reconstruction_tpu.train import monocular as jmono
from acfm_video_3d_reconstruction_tpu_torch.deform import solve as tsolve
from acfm_video_3d_reconstruction_tpu_torch.geometry import mesh_ops as tmesh
from acfm_video_3d_reconstruction_tpu_torch.geometry import symmetry as tsym
from acfm_video_3d_reconstruction_tpu_torch.losses import losses as tloss
from acfm_video_3d_reconstruction_tpu_torch.models import heads as theads
from acfm_video_3d_reconstruction_tpu_torch.models import lpips as tlpips
from acfm_video_3d_reconstruction_tpu_torch.models.mesh_net import MeshNet
from acfm_video_3d_reconstruction_tpu_torch.models.template import build_template
from acfm_video_3d_reconstruction_tpu_torch.train import monocular as tmono

torch.set_num_threads(1)

VALUE_RTOL, GRAD_REL = 1e-5, 1e-4


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    nb = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / nb) if nb else float(np.linalg.norm(a))


def _check(tfn, jfn, diff, fixed, what):
    """tfn(*diff, *fixed) against jfn on the same numpy inputs: the value
    within VALUE_RTOL, the gradient of each `diff` input (for a seeded
    random cotangent of the output) within GRAD_REL (vector relative
    error), both gradients finite."""
    td = [torch.tensor(x, requires_grad=True) for x in diff]
    out_t = tfn(*td, *[torch.as_tensor(x) for x in fixed])
    w = np.random.default_rng(99).normal(size=out_t.shape).astype(np.float32)
    (out_t * torch.from_numpy(w)).sum().backward()
    jd = [jnp.asarray(x) for x in diff]

    def jsum(*d):
        return (jfn(*d, *[jnp.asarray(x) for x in fixed]) * jnp.asarray(w)).sum()

    out_j = jfn(*jd, *[jnp.asarray(x) for x in fixed])
    g_j = jax.grad(jsum, argnums=tuple(range(len(diff))))(*jd)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=VALUE_RTOL,
                               atol=1e-7, err_msg=what)
    for i, (a, b) in enumerate(zip(td, g_j)):
        g = a.grad.numpy()
        assert np.isfinite(g).all() and np.isfinite(np.asarray(b)).all(), what
        assert _rel(g, b) <= GRAD_REL, (what, i, _rel(g, b))


@pytest.fixture(scope="module")
def sphere():
    v, f = icosphere.icosphere(1)
    return (v.astype(np.float32), f, jmesh.compute_edges(f),
            jmesh.compute_edges2verts(f))


def test_template_edge_loss_matches_jax(sphere):
    """At the template (0), scaled, randomly moved, and at a collapsed edge
    (safe_norm's zero gradient)."""
    v, _, edges, _ = sphere
    rng = np.random.default_rng(0)
    batch = np.tile(v[None], (2, 1, 1))
    moved = (batch + 0.05 * rng.normal(size=batch.shape)).astype(np.float32)
    collapsed = batch.copy()
    collapsed[:, edges[0, 1]] = collapsed[:, edges[0, 0]]
    for name, x, tmpl in (("moved", moved, batch), ("scaled", 1.1 * batch, batch),
                          ("collapsed", collapsed, collapsed)):
        _check(tloss.template_edge_loss, jloss.template_edge_loss, [x, tmpl], [edges], name)
    # at the template, safe_norm's floor: 1e-12 / B
    assert float(tloss.template_edge_loss(torch.tensor(batch), torch.tensor(batch),
                                          torch.tensor(edges))) < 1e-6


def test_triangle_loss_matches_jax(sphere):
    """The sphere, a random mesh, a planar pair of triangles (0) and a
    degenerate dihedral (four coincident vertices)."""
    v, f, _, e2v = sphere
    rng = np.random.default_rng(1)
    moved = (v[None] + 0.03 * rng.normal(size=(3, *v.shape))).astype(np.float32)
    deg = v[None].copy()
    deg[:, e2v[0, 1:]] = deg[:, e2v[0, :1]]
    for name, x in (("sphere", v[None]), ("moved", moved), ("degenerate", deg)):
        _check(tloss.triangle_loss, jloss.triangle_loss, [x], [e2v], name)
    flat = np.asarray([[[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]]], np.float32)
    e2v_flat = jmesh.compute_edges2verts(np.asarray([[0, 1, 2], [1, 3, 2]]))
    _check(tloss.triangle_loss, jloss.triangle_loss, [flat], [e2v_flat], "flat")
    assert float(tloss.triangle_loss(torch.tensor(flat), torch.tensor(e2v_flat))) < 1e-6


def test_texture_l1_matches_jax():
    rng = np.random.default_rng(2)
    img_p, img_g = (rng.random((2, 16, 16, 3), np.float32) for _ in range(2))
    m_p, m_g = rng.random((2, 16, 16), np.float32), (rng.random((2, 16, 16)) > 0.5)
    _check(lambda ip, mp, ig, mg: tloss.texture_loss_l1(ip, ig, mp, mg),
           lambda ip, mp, ig, mg: jloss.texture_loss_l1(ip, ig, mp, mg), [img_p, m_p],
           [img_g, m_g.astype(np.float32)], "texture l1")


@pytest.mark.parametrize("k", [1, 3])
def test_boundaries_loss_topk_matches_jax(k):
    """The mean squared distance of each boundary point to its k nearest
    visible vertices (k = 1 is the trainers' path), reduced and per sample,
    with invisible vertices and invalid boundary points."""
    rng = np.random.default_rng(13)
    proj = rng.uniform(-1, 1, (2, 30, 2)).astype(np.float32)
    bds = np.concatenate([rng.uniform(-1, 1, (2, 25, 2)),
                          (rng.random((2, 25, 1)) > 0.2)], -1).astype(np.float32)
    vis = (rng.random((2, 30)) > 0.3).astype(np.float32)
    for reduce in (True, False):
        _check(lambda p, b, v: tloss.boundaries_loss(p, b, v, reduce=reduce, k=k),
               lambda p, b, v: jloss.boundaries_loss(p, b, v, reduce=reduce, k=k),
               [proj], [bds, vis], f"boundaries k={k} reduce={reduce}")


@pytest.mark.parametrize("layout", ["BHW", "B1HW"])
def test_dt_losses_match_jax(layout):
    """The distance-transform lookups (ops/grid_sample.py, bilinear,
    align_corners): per-vertex flow (reduced and per sample), the atlas
    flow (B, F, T, T, 2), and the projected vertices with border padding,
    points inside and outside [-1, 1]."""
    rng = np.random.default_rng(3)
    dt = rng.random((2, 20, 24), np.float32) * 5
    if layout == "B1HW":
        dt = dt[:, None]
    flow_v = rng.uniform(-0.95, 0.95, (2, 30, 2)).astype(np.float32)
    flow_a = rng.uniform(-0.95, 0.95, (2, 5, 3, 3, 2)).astype(np.float32)
    proj = rng.uniform(-1.4, 1.4, (2, 40, 2)).astype(np.float32)
    _check(tloss.texture_dt_loss_v, jloss.texture_dt_loss_v, [flow_v], [dt], "dt_v")
    _check(lambda f, d: tloss.texture_dt_loss_v(f, d, reduce=False),
           lambda f, d: jloss.texture_dt_loss_v(f, d, reduce=False), [flow_v], [dt], "dt_v B")
    _check(tloss.texture_dt_loss, jloss.texture_dt_loss, [flow_a], [dt], "dt atlas")
    _check(tloss.mask_dt_loss, jloss.mask_dt_loss, [proj], [dt], "mask dt")
    _check(tloss.texture_dt_loss_v, jloss.texture_dt_loss_v, [flow_v * 1.3], [dt], "zeros out")


def test_face_normals_and_edge_lengths_match_jax(sphere):
    """Batched and unbatched, and at a degenerate face / collapsed edge."""
    v, f, edges, _ = sphere
    rng = np.random.default_rng(4)
    moved = (v[None] + 0.05 * rng.normal(size=(2, *v.shape))).astype(np.float32)
    deg = v.copy()
    deg[f[0, 1]] = deg[f[0, 0]]
    for name, x in (("sphere", v), ("moved", moved), ("degenerate", deg)):
        _check(lambda a, b: tmesh.face_normals(a, b) * a.new_tensor([1.0, 2.0, 3.0]),
               lambda a, b: jmesh.face_normals(a, b) * jnp.asarray([1.0, 2.0, 3.0]),
               [x], [f], f"normals {name}")
        _check(tmesh.edge_lengths, jmesh.edge_lengths, [x], [edges], f"lengths {name}")
    n = tmesh.face_normals(torch.tensor(v), torch.tensor(f))
    np.testing.assert_allclose(n.norm(dim=-1).numpy(), 1.0, rtol=1e-6)


def test_lbs_from_logits_matches_jax():
    """The softmax over vertices, transposed; MeshNet.get_lbs is it."""
    logits = np.random.default_rng(5).normal(size=(42, 6)).astype(np.float32) * 3
    _check(tsolve.lbs_from_logits, jsolve.lbs_from_logits, [logits], [], "lbs")
    t = build_template(subdivide=1, num_lbs=6, tex_size=2, num_kps=0)
    model = MeshNet(t, img_size=64, nz_feat=16, predict_texture=False)
    assert torch.equal(model.get_lbs(), tsolve.lbs_from_logits(model.lbs_logits))


# ------------------------------------------- host constants built on the card

def test_normalize_imagenet_repaired():
    img = torch.from_numpy(np.random.default_rng(6).random((2, 8, 8, 3), np.float32))
    got = tmono.normalize_imagenet(img)
    old = (img - img.new_tensor(jcfg.IMAGENET_MEAN)) / img.new_tensor(jcfg.IMAGENET_STD)
    assert torch.equal(got, old)
    np.testing.assert_allclose(got.numpy(), np.asarray(jmono.normalize_imagenet(
        jnp.asarray(img.numpy()))), rtol=1e-6)


def test_quat_head_repaired():
    """The camera head's quaternion normalisation (floor 1e-24), at random
    features and at a zero output (the floor), against flax's head with the
    same weights."""
    rng = np.random.default_rng(7)
    head = theads.QuatPredictor(8)
    head.init_override(None)
    feat = rng.normal(size=(3, 8)).astype(np.float32)
    feat[2] = 0.0
    with torch.no_grad():
        head.fc.bias[:] = torch.tensor([1e-2, 0.0, 0.0, 0.0])
        head.fc.bias[0] = 0.0  # row 2 gives q = 0 exactly
    got = head(torch.from_numpy(feat))
    q = head.fc(torch.from_numpy(feat))
    sq = (q * q).sum(-1, keepdim=True)
    assert torch.equal(got, q / torch.sqrt(torch.maximum(sq, sq.new_tensor(1e-24))))
    params = {"params": {"Dense_0": {"kernel": jnp.asarray(head.fc.weight.detach().numpy().T),
                                     "bias": jnp.asarray(head.fc.bias.detach().numpy())}}}
    want = jheads.QuatPredictor().apply(params, jnp.asarray(feat))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_lpips_unit_normalize_repaired():
    feat = np.random.default_rng(8).random((2, 5, 4, 4), np.float32)
    feat[0, :, 0, 0] = 0.0  # an all-zero post-ReLU vector: the floor
    x = torch.from_numpy(feat)
    got = tlpips._unit_normalize(x)
    sq = (x ** 2).sum(dim=1, keepdim=True)
    old = x / (torch.sqrt(torch.maximum(sq, sq.new_tensor(1e-20))) + 1e-10)
    assert torch.equal(got, old)
    want = jlpips._unit_normalize(jnp.asarray(feat.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want), rtol=1e-6)


def test_entropy_loss_repaired():
    """Row entropy with probabilities at and below the 1e-12 floor."""
    A = np.random.default_rng(9).dirichlet(np.ones(20), size=4).astype(np.float32)
    A[0, :3] = 0.0
    A[1, 0] = 1e-14
    x = torch.from_numpy(A)
    old = (-(x * torch.log(torch.maximum(x, x.new_tensor(1e-12)))).sum(dim=1)).mean()
    assert torch.equal(tloss.entropy_loss(x), old)
    np.testing.assert_allclose(float(tloss.entropy_loss(x)),
                               float(jloss.entropy_loss(jnp.asarray(A))), rtol=1e-6)


def test_symmetrize_repaired():
    """x of the mirrored half negated by indexing: the same values and the
    same gradient as the (-1, 1, 1) factor, and JAX's."""
    v = np.random.default_rng(10).normal(size=(2, 9, 3)).astype(np.float32)
    a, b = torch.tensor(v, requires_grad=True), torch.tensor(v, requires_grad=True)
    got = tsym.symmetrize(a, 4)
    old = torch.cat([b, b.new_tensor([-1.0, 1.0, 1.0]) * b[..., -4:, :]], dim=-2)
    assert torch.equal(got, old)
    w = torch.from_numpy(np.random.default_rng(11).normal(size=got.shape).astype(np.float32))
    (got * w).sum().backward()
    (old * w).sum().backward()
    assert torch.equal(a.grad, b.grad)
    np.testing.assert_array_equal(got.detach().numpy(),
                                  np.asarray(jsym.symmetrize(jnp.asarray(v), 4)))



def test_solve_factor_repaired():
    """The solve factors with cholesky_ex (no host check of `info`): the
    same pred_v, bit for bit, as with cholesky, and JAX's within the solve's
    bound (tests/test_torch_port_slice.py, atol 1e-4)."""
    t = build_template(subdivide=2, num_lbs=6, tex_size=2, num_kps=0)
    rng = np.random.default_rng(12)
    mean_v = torch.tensor(t.verts, dtype=torch.float32)
    lbs = tsolve.lbs_from_logits(torch.tensor(t.lbs_logits, dtype=torch.float32))
    delta = torch.from_numpy(rng.normal(size=(3, 6, 3)).astype(np.float32) * 0.05)
    L = torch.tensor(t.uniform_L, dtype=torch.float32)
    got = tsolve.screened_poisson_solve(mean_v, lbs, delta, L)
    M = L.T @ L + lbs.T @ lbs
    rhs = (L.T @ (L @ mean_v))[None] + torch.einsum("kv,bkc->bvc", lbs, (lbs @ mean_v)[None] + delta)
    old = torch.cholesky_solve(rhs.permute(1, 0, 2).reshape(-1, 9), torch.linalg.cholesky(M))
    assert torch.equal(got, old.reshape(-1, 3, 3).permute(1, 0, 2))
    want = jsolve.screened_poisson_solve(jnp.asarray(t.verts), jnp.asarray(lbs.numpy()),
                                         jnp.asarray(delta.numpy()), jnp.asarray(t.uniform_L))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
