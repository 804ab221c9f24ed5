"""The port's rasterizer against the JAX package's.

Same scene as tests/test_rasterizer_tpu.py (icosphere(2), 32^2, two
cameras). The port's binning must give the TPU binning's idx tables
exactly; its plain soft/hard forward must meet that file's tolerances
against the Pallas kernel in interpret mode (mask atol 2e-4, pix_to_face
agreeing on > 99.9% of pixels, barycentrics atol 1e-4) and against the
dense pure-JAX reference. Its plain backward (backward_plain, through
the autograd Function) must meet that file's gradient bound against the
Pallas backward in interpret mode (rel < 1e-5 at sigma 5e-3) and agree
with autograd through the plain forward. The CUDA kernels' own tests are
in tests/test_torch_port_kernels.py.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acfm_video_3d_reconstruction_tpu.geometry import camera, icosphere
from acfm_video_3d_reconstruction_tpu.ops import rasterizer as jref
from acfm_video_3d_reconstruction_tpu.ops import rasterizer_tpu as jtpu
from acfm_video_3d_reconstruction_tpu_torch.ops import raster_checks as chk
from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer as ras
from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer_cuda as rc

torch.set_num_threads(1)

IMG = 32


@pytest.fixture(scope="module")
def scene():
    v, f = icosphere.icosphere(2)
    cams = jnp.asarray(
        [
            [0.9, 0.05, -0.05, 1.0, 0.0, 0.0, 0.0],
            [0.7, -0.1, 0.1, 0.9238795, 0.0, 0.3826834, 0.0],
        ]
    )
    proj = camera.orthographic_proj_withz(
        jnp.asarray(v, jnp.float32)[None].repeat(2, 0) * 0.7, cams, offset_z=5.0
    )
    return np.asarray(proj), np.asarray(f, np.int32)


def _t(x):
    return torch.tensor(np.asarray(x))


class TestBinning:
    @pytest.mark.parametrize("K", [320, 64])
    def test_face_tables_match_tpu_binning(self, scene, K):
        """Same idx (and face rows) as rasterizer_tpu._face_tables, at the
        exact capacity and at a K small enough that bins overflow."""
        proj, faces = scene
        th, tw = rc._pick_tiles(IMG)
        assert (th, tw) == jtpu._pick_tiles(IMG)
        margin = rc._margin(rc.BLUR_RADIUS)
        tab_j, idx_j = jtpu._face_tables(jnp.asarray(proj), jnp.asarray(faces), IMG,
                                         th, tw, K, margin)
        tab_t, idx_t = rc._face_tables(_t(proj), _t(faces), IMG, th, tw, K, margin)
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
        valid = np.asarray(idx_j) >= 0
        rows_j = np.swapaxes(np.asarray(tab_j), 2, 3)[..., :9]
        np.testing.assert_array_equal(tab_t.numpy()[valid], rows_j[valid])
        ovf_j = np.asarray(jtpu.bin_overflow_counts(jnp.asarray(proj), jnp.asarray(faces),
                                                    IMG, K, margin))
        ovf_t = rc.bin_overflow_counts(_t(proj), _t(faces), IMG, K, margin).numpy()
        np.testing.assert_array_equal(ovf_t, ovf_j)
        assert (ovf_t.max() > 0) == (K == 64)

    def test_overflow_counts_match_at_256(self):
        from acfm_video_3d_reconstruction_tpu_torch.geometry import camera as tcam

        v, f = icosphere.icosphere(3)
        rng = np.random.default_rng(0)
        q = rng.normal(size=(2, 4))
        cams = np.concatenate([rng.uniform(0.6, 0.9, (2, 1)), rng.uniform(-0.1, 0.1, (2, 2)),
                               q / np.linalg.norm(q, axis=1, keepdims=True)], 1)
        proj = tcam.orthographic_proj_withz(
            torch.tensor(v, dtype=torch.float32)[None].repeat(2, 1, 1) * 0.7,
            torch.tensor(cams, dtype=torch.float32), offset_z=5.0)
        faces, size = torch.tensor(f), 256
        for K in (8, 192):
            want = np.asarray(jtpu.bin_overflow_counts(jnp.asarray(proj.numpy()),
                                                       jnp.asarray(faces.numpy()), size, K))
            got = rc.bin_overflow_counts(proj, faces, size, K).numpy()
            np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("size", [8, 32, 64, 96, 128, 256, 512])
    def test_tiles_and_capacity_match(self, size):
        assert rc._pick_tiles(size) == jtpu._pick_tiles(size)
        for F in (80, 320, 1280):
            assert rc.auto_K(F, size, 192) == jtpu.auto_K(F, size, 192)


class TestPlainForward:
    def test_soft_matches_pallas_interpret(self, scene):
        proj, faces = scene
        mask_j, p2f_j, vis_j = jtpu.soft_silhouette_tpu(
            jnp.asarray(proj), jnp.asarray(faces), IMG, 320, interpret=True)
        mask_t, p2f_t, vis_t = ras.soft_silhouette_vis(_t(proj), _t(faces), IMG,
                                                       proj.shape[1])
        np.testing.assert_allclose(mask_t.numpy(), np.asarray(mask_j), atol=2e-4)
        assert (p2f_t.numpy() == np.asarray(p2f_j)).mean() > 0.999
        np.testing.assert_array_equal(vis_t.numpy(), np.asarray(vis_j))

    def test_hard_matches_pallas_interpret(self, scene):
        proj, faces = scene
        out_j = jtpu.hard_rasterize_tpu(jnp.asarray(proj), jnp.asarray(faces), IMG, 320,
                                        interpret=True)
        out_t = ras.hard_rasterize(_t(proj), _t(faces), IMG)
        p2f_j = np.asarray(out_j.pix_to_face)
        agree = out_t.pix_to_face.numpy() == p2f_j
        assert agree.mean() > 0.999
        both = agree & (p2f_j >= 0)
        np.testing.assert_allclose(out_t.bary.numpy()[both], np.asarray(out_j.bary)[both],
                                   atol=1e-4)
        np.testing.assert_allclose(out_t.zbuf.numpy()[both], np.asarray(out_j.zbuf)[both],
                                   atol=1e-5)
        np.testing.assert_array_equal(out_t.mask.numpy(), np.asarray(out_j.mask))

    def test_soft_matches_dense_reference(self, scene):
        proj, faces = scene
        mask_r, p2f_r = jref.soft_silhouette(jnp.asarray(proj), jnp.asarray(faces), IMG,
                                             face_chunk=80, impl="ref")
        mask_t, p2f_t = ras.soft_silhouette(_t(proj), _t(faces), IMG)
        np.testing.assert_allclose(mask_t.numpy(), np.asarray(mask_r), atol=2e-4)
        assert (p2f_t.numpy() == np.asarray(p2f_r)).mean() > 0.999

    def test_hard_matches_dense_reference(self, scene):
        proj, faces = scene
        fr = jref.hard_rasterize(jnp.asarray(proj), jnp.asarray(faces), IMG, face_chunk=80)
        p2f_r = np.asarray(fr.pix_to_face).reshape(2, IMG, IMG)
        out_t = ras.hard_rasterize(_t(proj), _t(faces), IMG)
        agree = out_t.pix_to_face.numpy() == p2f_r
        assert agree.mean() > 0.999
        both = agree & (p2f_r >= 0)
        np.testing.assert_allclose(out_t.bary.numpy()[both],
                                   np.asarray(fr.bary).reshape(2, IMG, IMG, 3)[both], atol=1e-4)

    def test_slot_chunk_equals_slot_by_slot(self, scene):
        """The chunked z-buffer equals the kernel's slot-by-slot strict <."""
        proj, faces = scene
        th, tw = rc._pick_tiles(IMG)
        tab, idx = rc._face_tables(_t(proj), _t(faces), IMG, th, tw, 320,
                                   rc._margin(rc.BLUR_RADIUS))
        for soft in (True, False):
            one = rc.forward_plain(tab, idx, IMG, th, tw, rc.SIGMA, rc.BLUR_RADIUS, soft, 1)
            many = rc.forward_plain(tab, idx, IMG, th, tw, rc.SIGMA, rc.BLUR_RADIUS, soft, 8)
            for name in ("pix_to_face", "b0", "b1", "zbuf"):
                np.testing.assert_array_equal(getattr(many, name).numpy(),
                                              getattr(one, name).numpy())
            # S is summed in another order: f32 rounding only
            np.testing.assert_allclose(many.S.numpy(), one.S.numpy(), rtol=1e-5, atol=1e-5)


def _icosahedron_scene():
    """tests/test_rasterizer_tpu.py::test_grad_exact_single_tile's scene:
    one 8x8 bin, 20 faces."""
    v, f = icosphere.icosahedron()
    proj = camera.orthographic_proj_withz(
        jnp.asarray(v, jnp.float32)[None] * 0.7,
        jnp.asarray([[0.9, 0.05, -0.05, 1.0, 0, 0, 0]]), offset_z=5.0)
    return np.asarray(proj), np.asarray(f, np.int32)


class TestPlainBackward:
    """backward_plain, the plain version of the backward kernel, reached
    through SoftRasterize's autograd on CPU tensors."""

    @pytest.mark.heavy
    @pytest.mark.parametrize("which", ["two_view_32px", "single_tile_8px"])
    def test_vertex_grad_matches_pallas_interpret(self, scene, which):
        """The port's per-vertex gradient of sum(w * mask) against jax.grad
        of rasterizer_tpu.soft_silhouette_tpu (its backward kernel in
        interpret mode) at sigma 5e-3 / blur 6e-2, the well-conditioned
        setting of tests/test_rasterizer_tpu.py::TestBackwardParity. That
        file bounds two rasterizers' gradients at rel < 0.05; these two run
        the same hand-derived VJP with the forward's FMAs and divides, so
        they differ in summation order only (measured 1.1e-7 two-view and
        7.3e-8 single-tile) and are held at rel < 1e-5, which a dropped tie
        split or a mis-weighted endpoint would break."""
        proj, faces = scene if which == "two_view_32px" else _icosahedron_scene()
        size, K = (IMG, 320) if which == "two_view_32px" else (8, 20)
        sigma, blur = 5e-3, 6e-2
        w = np.random.default_rng(0).random((proj.shape[0], size, size)).astype(np.float32)
        g_j = np.asarray(jax.grad(lambda p: (jtpu.soft_silhouette_tpu(
            p, jnp.asarray(faces), size, K, sigma, blur, interpret=True)[0] * w).sum())(
            jnp.asarray(proj)))
        p_t = _t(proj).requires_grad_(True)
        mask, _ = ras.soft_silhouette(p_t, _t(faces), size, sigma=sigma, blur_radius=blur)
        (mask * _t(w)).sum().backward()
        rel = np.linalg.norm(p_t.grad.numpy() - g_j) / np.linalg.norm(g_j)
        print(f"{which}: vertex gradient rel error vs the Pallas backward {rel:.3g}")
        assert rel < 1e-5, rel

    @pytest.mark.parametrize("sigma,blur", [(5e-3, 6e-2), (rc.SIGMA, rc.BLUR_RADIUS)],
                             ids=["sigma5e-3", "sigma1e-4"])
    def test_matches_autograd_through_forward_plain(self, scene, sigma, blur):
        """The hand-derived rows against torch autograd through forward_plain:
        the same f32 function, differentiated two ways (the envelope
        theorem drops t's quotient, whose term is 2d.e ~ rounding), also at
        the production sigma. Vector rel 1e-5 (measured ~2e-7)."""
        proj, faces = scene
        table, idx, th, tw = rc.bin_faces(_t(proj), _t(faces), IMG, 320, blur)
        dS = torch.tensor(np.random.default_rng(1).normal(size=(2, IMG, IMG)),
                          dtype=torch.float32)
        got = rc.backward_plain(table, idx, dS, IMG, th, tw, sigma, blur)
        tab = table.clone().requires_grad_(True)
        fr = rc.forward_plain(tab, idx, IMG, th, tw, sigma, blur, True)
        (fr.S * dS).sum().backward()
        rel = (torch.linalg.vector_norm(got - tab.grad) / torch.linalg.vector_norm(tab.grad))
        assert rel.item() < 1e-5, rel.item()

    @pytest.mark.parametrize("K", [320, 192])
    def test_z_columns_and_invalid_slots_are_exact_zeros(self, scene, K):
        """z never enters S, and a slot past the bin's count (which gathers
        face 0) must add nothing to face 0: both exactly 0, also where some
        bins overflow and others are part full (K=192)."""
        proj, faces = scene
        table, idx, th, tw = rc.bin_faces(_t(proj), _t(faces), IMG, K, rc.BLUR_RADIUS)
        dS = torch.tensor(np.random.default_rng(2).normal(size=(2, IMG, IMG)),
                          dtype=torch.float32)
        g = rc.backward_plain(table, idx, dS, IMG, th, tw, rc.SIGMA, rc.BLUR_RADIUS)
        assert (idx < 0).any() and (idx >= 0).any()
        assert torch.count_nonzero(g[..., 6:]) == 0
        assert torch.count_nonzero(g[idx < 0]) == 0
        assert torch.count_nonzero(g[idx >= 0][:, :6]) > 0


@pytest.mark.parametrize(
    "form", ["x*y-z*w", "a*b+c*d+e*f", "w-t*e", "x*x+y*y"],
)
def test_fma_forms_match_xla_cpu(form):
    """The JAX references are compiled by XLA, whose CPU backend contracts
    these products into FMAs; the port's rasterizer writes the same FMAs
    out (rc._fma), which is what makes its p2f agree with JAX's. Exact on
    20,000 random inputs."""
    rng = np.random.default_rng(4)
    a, b, c, d, e, f = (rng.uniform(-1, 1, 20000).astype(np.float32) for _ in range(6))
    ta, tb, tc, td, te, tf = (torch.tensor(v) for v in (a, b, c, d, e, f))
    jfn, want = {
        "x*y-z*w": (lambda a, b, c, d: a * b - c * d,
                    rc._fma(ta, tb, -(tc * td))),
        "a*b+c*d+e*f": (lambda a, b, c, d, e, f: a * b + c * d + e * f,
                        rc._fma(te, tf, rc._fma(ta, tb, tc * td))),
        "w-t*e": (lambda a, b, c: a - b * c, rc._fma(-tb, tc, ta)),
        "x*x+y*y": (lambda a, b: a * a + b * b, rc._fma(ta, ta, tb * tb)),
    }[form]
    n = jfn.__code__.co_argcount
    got = np.asarray(jax.jit(jfn)(*(a, b, c, d, e, f)[:n]))
    np.testing.assert_array_equal(want.numpy(), got)


class TestPublicFunctions:
    def test_soft_vis_tex_matches_jax(self, scene):
        proj, faces = scene
        rng = np.random.default_rng(0)
        atlas = rng.random((2, faces.shape[0], 3, 3, 3)).astype(np.float32)
        m_r, p_r, v_r, rgb_r, cov_r = jref.soft_silhouette_vis_tex(
            jnp.asarray(proj), jnp.asarray(faces), jnp.asarray(atlas), IMG, proj.shape[1],
            face_chunk=80, impl="ref")
        m_t, p_t, v_t, rgb_t, cov_t = ras.soft_silhouette_vis_tex(
            _t(proj), _t(faces), _t(atlas), IMG, proj.shape[1])
        np.testing.assert_allclose(m_t.numpy(), np.asarray(m_r), atol=2e-4)
        agree = p_t.numpy() == np.asarray(p_r)
        assert agree.mean() > 0.999
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_r))
        np.testing.assert_array_equal(cov_t.numpy(), np.asarray(cov_r))
        # nearest-cell lookups from barycentrics equal to ~1e-7: the same
        # texel wherever the front face agrees
        np.testing.assert_array_equal(rgb_t.numpy()[agree], np.asarray(rgb_r)[agree])

    def test_render_texture_matches_jax(self, scene):
        proj, faces = scene
        rng = np.random.default_rng(1)
        atlas = rng.random((2, faces.shape[0], 4, 4, 3)).astype(np.float32)
        rgb_r, sil_r, p_r = jref.render_texture(jnp.asarray(proj), jnp.asarray(faces),
                                                jnp.asarray(atlas), IMG, face_chunk=80,
                                                impl="ref")
        rgb_t, sil_t, p_t = ras.render_texture(_t(proj), _t(faces), _t(atlas), IMG)
        agree = p_t.numpy() == np.asarray(p_r)
        assert agree.mean() > 0.999
        np.testing.assert_array_equal(sil_t.numpy(), np.asarray(sil_r))
        np.testing.assert_array_equal(rgb_t.numpy()[agree], np.asarray(rgb_r)[agree])

    def test_hard_visibility_matches_jax(self, scene):
        proj, faces = scene
        want = jref.hard_visibility(jnp.asarray(proj), jnp.asarray(faces), IMG,
                                    proj.shape[1], face_chunk=80, impl="ref")
        got = ras.hard_visibility(_t(proj), _t(faces), IMG, proj.shape[1])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_sample_atlas_and_visible_vertices_match(self):
        rng = np.random.default_rng(2)
        B, F, T, P, V = 2, 50, 3, 200, 40
        atlas = rng.random((B, F, T, T, 3)).astype(np.float32)
        p2f = rng.integers(-1, F, (B, P)).astype(np.int32)
        bary = rng.dirichlet(np.ones(3), (B, P)).astype(np.float32)
        faces = rng.integers(0, V, (F, 3)).astype(np.int32)
        rgb_j, cov_j = jref.sample_atlas(jnp.asarray(atlas), jnp.asarray(p2f),
                                         jnp.asarray(bary))
        rgb_t, cov_t = ras.sample_atlas(_t(atlas), _t(p2f), _t(bary))
        np.testing.assert_array_equal(rgb_t.numpy(), np.asarray(rgb_j))
        np.testing.assert_array_equal(cov_t.numpy(), np.asarray(cov_j))
        vis_j = jref.visible_vertices(jnp.asarray(p2f), jnp.asarray(faces), V)
        vis_t = ras.visible_vertices(_t(p2f), _t(faces), V)
        np.testing.assert_array_equal(vis_t.numpy(), np.asarray(vis_j))


CULL_MODES = {"soft_sigma1e-4": (rc.SIGMA, rc.BLUR_RADIUS, True),
              "soft_sigma5e-3": (5e-3, 6e-2, True),
              "hard": (rc.SIGMA, rc.BLUR_RADIUS, False)}


def _cull_census(verts, faces, size, mode):
    """raster_checks.cull_census of verts, binned as the kernels' callers
    bin them, in one of CULL_MODES."""
    sigma, blur, soft = CULL_MODES[mode]
    K = rc.auto_K(faces.shape[0], size, 192)
    table, idx, th, tw = rc.bin_faces(verts, faces, size, K, blur)
    return chk.cull_census(table, idx, size, th, tw, sigma, blur, soft)


class TestCullWindows:
    """rc.cull_windows, the predicate both kernels cull with: every pair it
    excludes must have in_radius == False under _face_geometry, so that
    skipping it changes no output bit (csrc/raster_geometry.cuh)."""

    @pytest.mark.parametrize("mode", list(CULL_MODES))
    @pytest.mark.parametrize("size,subdivide", [(32, 2), (64, 3), (96, 2)])
    def test_icosphere_pairs_outside_windows_are_out_of_radius(self, size, subdivide, mode):
        verts, faces = chk.icosphere_scene(4, subdivide=subdivide)
        c = _cull_census(verts, faces, size, mode)
        assert c["excluded_in_radius"] == 0
        assert c["excluded"] > c["pairs"] // 2  # the cull does exclude most pairs

    @pytest.mark.parametrize("mode", list(CULL_MODES))
    @pytest.mark.parametrize("size", [32, 64])
    def test_adversarial_pairs_outside_windows_are_out_of_radius(self, size, mode):
        """Zero-area faces on pixel-centre lines, repeated vertices and
        slivers on both sides of the area threshold: the degenerate faces
        keep the whole bin, the slivers over the threshold are culled, and
        no excluded pair is in radius."""
        verts, faces, degenerate = chk.adversarial_scene(size)
        verts, faces = torch.from_numpy(verts), torch.from_numpy(faces)
        c = _cull_census(verts, faces, size, mode)
        whole = c["whole"]
        assert c["excluded_in_radius"] == 0
        assert c["excluded"] > 0
        sigma, blur, soft = CULL_MODES[mode]
        table, idx, th, tw = rc.bin_faces(verts, faces, size, 192, blur)
        deg = (idx >= 0) & torch.isin(idx, torch.from_numpy(degenerate).int())
        zero_area = deg & (idx % faces.shape[0] < 30)  # the six zero-area faces of a view
        assert bool(whole[zero_area].all())
        assert 0 < int((deg & whole).sum()) < int(deg.sum())  # slivers on both sides

    @pytest.mark.parametrize("soft", [True, False], ids=["soft", "hard"])
    def test_adversarial_forward_matches_pallas_interpret(self, soft):
        """forward_plain on the adversarial scene against the Pallas
        _run_fwd in interpret mode: the tolerances of
        test_soft_matches_pallas_interpret / test_hard_matches_pallas_interpret
        everywhere, and pix_to_face exactly equal wherever either side
        shows a degenerate face. The zero-area face on a pixel-centre
        column covers that column over its whole bin on both sides (rows
        far outside its box): the reference's own behaviour, which the
        cull's whole-bin rule keeps."""
        size = IMG
        verts, faces, degenerate = chk.adversarial_scene(size)
        blur = rc.BLUR_RADIUS if soft else 0.0
        out_j, _, idx_j, (layout, _) = jtpu._run_fwd(
            jnp.asarray(verts), jnp.asarray(faces, jnp.int32), size, 192, rc.SIGMA, blur, soft,
            True)
        S_j, slot_j, b0_j, b1_j, z_j = (np.asarray(jtpu._untile(x, size, layout)) for x in out_j)
        table, idx, th, tw = rc.bin_faces(_t(verts), _t(faces), size, 192, blur)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
        fr = rc.forward_plain(table, idx, size, th, tw, rc.SIGMA, blur, soft)
        slot_t = rc._tile(_t(slot_j), size, th, tw).long()
        p2f_j = torch.where(slot_t >= 0, torch.gather(idx, 2, slot_t.clamp(min=0)), -1)
        p2f_j = rc._untile(p2f_j, size, th, tw).numpy()
        p2f_t = fr.pix_to_face.numpy()
        agree = p2f_t == p2f_j
        assert agree.mean() > 0.999
        deg = np.isin(p2f_t, degenerate) | np.isin(p2f_j, degenerate)
        assert deg.sum() > 0
        np.testing.assert_array_equal(p2f_t[deg], p2f_j[deg])
        np.testing.assert_allclose(np.exp(fr.S.numpy()), np.exp(S_j), atol=2e-4, rtol=0)
        both = agree & (p2f_j >= 0)
        np.testing.assert_allclose(fr.b0.numpy()[both], b0_j[both], atol=1e-4)
        np.testing.assert_allclose(fr.b1.numpy()[both], b1_j[both], atol=1e-4)
        np.testing.assert_allclose(fr.zbuf.numpy()[both], z_j[both], atol=1e-5)
        # face 24 is the zero-area face on the pixel-centre column of view b
        for b in range(verts.shape[0]):
            x, y = verts[b, 72:75, 0], verts[b, 72:75, 1]
            col = int(round(((x[0] + 1) * size - 1) / 2))
            rows = np.arange(size)
            far = (np.abs(((y.min() + 1) * size - 1) / 2 - rows) > 2) & \
                (np.abs(((y.max() + 1) * size - 1) / 2 - rows) > 2)
            assert (p2f_j[b, far, col] == 24).any()
            np.testing.assert_array_equal(p2f_t[b, :, col], p2f_j[b, :, col])


def test_port_imports_no_jax():
    """Every module of the port, chip_smoke.py and the fixture writers of
    tools/ import without JAX, flax, orbax, absl or the JAX package;
    importing chip_smoke loads neither PIL nor cv2 (the data path imports
    them where it reads or resizes)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import chip_smoke\n"
        "import tools.tigdog_fixture, tools.cub_fixture\n"
        "host = [k for k in sys.modules if k.split('.')[0] in ('PIL', 'cv2')]\n"
        "assert not host, host\n"
        "import acfm_video_3d_reconstruction_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in\n"
        "       ('jax', 'flax', 'orbax', 'absl', 'acfm_video_3d_reconstruction_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
