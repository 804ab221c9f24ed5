"""The port's CUDA kernels (the binned rasterizer's forward and backward,
the flow net's cost volume) against their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_port_kernels.py

Tests marked `cuda` skip without a card (the kernels have no CPU mode).
"""
import numpy as np
import pytest
import torch

from acfm_video_3d_reconstruction_tpu_torch.flow import correlation_cuda as cc
from acfm_video_3d_reconstruction_tpu_torch.geometry import camera, icosphere
from acfm_video_3d_reconstruction_tpu_torch.ops import raster_checks as chk
from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer_cuda as rc
from test_torch_port_correlation import CORR_IDS, CORR_SHAPES

torch.set_num_threads(1)

IMG = 32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _bench_scene(B=4, size=256, seed=0, subdivide=3):
    """An icosphere under random seeded weak-perspective cameras."""
    v, f = icosphere.icosphere(subdivide)
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    cams = np.concatenate(
        [rng.uniform(0.6, 0.9, (B, 1)), rng.uniform(-0.1, 0.1, (B, 2)), q], 1
    ).astype(np.float32)
    proj = camera.orthographic_proj_withz(
        torch.from_numpy(v.astype(np.float32))[None].repeat(B, 1, 1) * 0.7,
        torch.from_numpy(cams), offset_z=5.0,
    )
    return proj, torch.from_numpy(f.astype(np.int64)), size


def _small_scene():
    v, f = icosphere.icosphere(2)
    proj = camera.orthographic_proj_withz(
        torch.tensor(v, dtype=torch.float32)[None] * 0.7,
        torch.tensor([[0.9, 0.05, -0.05, 1.0, 0.0, 0.0, 0.0]]), offset_z=5.0)
    return proj, torch.tensor(f)


class TestKernelWrapper:
    def test_cuda_launcher_refuses_cpu_tensors(self):
        proj, faces = _small_scene()
        th, tw = rc._pick_tiles(IMG)
        tab, idx = rc._face_tables(proj, faces, IMG, th, tw, 320, 0.1)
        with pytest.raises(ValueError):
            rc.forward_cuda(tab, idx, IMG, th, tw, rc.SIGMA, rc.BLUR_RADIUS, True)

    @pytest.mark.parametrize("soft", [True, False], ids=["soft", "hard"])
    def test_cpu_tensor_runs_plain_version(self, soft):
        """On a CPU tensor the entry runs the plain version of the bin
        tables, bit for bit, and launches no kernel."""
        proj, faces = _small_scene()
        blur = rc.BLUR_RADIUS if soft else 0.0
        before = dict(rc.LAUNCHES)
        got = rc.rasterize_binned(proj, faces, IMG, 320, blur_radius=blur, soft=soft)
        table, idx, th, tw = rc.bin_faces(proj, faces, IMG, 320, blur)
        want = rc.forward_plain(table, idx, IMG, th, tw, rc.SIGMA, blur, soft)
        assert rc.LAUNCHES == before
        for name, a, b in zip(want._fields, got, want):
            assert torch.equal(a, b), name

    @pytest.mark.cuda
    @pytest.mark.parametrize("soft", [True, False], ids=["soft", "hard"])
    @pytest.mark.parametrize("size,subdivide", [(256, 3), (64, 3), (96, 2), (32, 2), (8, 1)])
    def test_kernel_matches_plain(self, cuda_device, soft, size, subdivide):
        """The CUDA kernel against its plain version on the card: mask atol
        2e-4, pix_to_face > 99.9%, barycentrics atol 1e-4 and zbuf atol 1e-5
        where the faces agree. 256^2 is the main path; 64^2 with 1280 faces
        has the exact capacity K=1280 (bins longer than one shared-memory
        stage); 96^2, 32^2 and 8^2 give bins of 512 and 64 pixels."""
        proj, faces, size = _bench_scene(B=4, size=size, subdivide=subdivide)
        proj, faces = proj.to(cuda_device), faces.to(cuda_device)
        K = rc.auto_K(faces.shape[0], size, 192)
        blur = rc.BLUR_RADIUS if soft else 0.0
        before = dict(rc.LAUNCHES)
        kern = rc.rasterize_binned(proj, faces, size, K, blur_radius=blur, soft=soft)
        table, idx, th, tw = rc.bin_faces(proj, faces, size, K, blur)
        plain = rc.forward_plain(table, idx, size, th, tw, rc.SIGMA, blur, soft)
        torch.cuda.synchronize()
        mode = "soft" if soft else "hard"
        assert rc.LAUNCHES[mode] == before[mode] + 1
        agree = kern.pix_to_face == plain.pix_to_face
        assert agree.float().mean().item() > 0.999
        if soft:
            torch.testing.assert_close(1 - torch.exp(kern.S), 1 - torch.exp(plain.S),
                                       atol=2e-4, rtol=0)
        hit = agree & (plain.pix_to_face >= 0)
        torch.testing.assert_close(kern.b0[hit], plain.b0[hit], atol=1e-4, rtol=0)
        torch.testing.assert_close(kern.b1[hit], plain.b1[hit], atol=1e-4, rtol=0)
        torch.testing.assert_close(kern.zbuf[hit], plain.zbuf[hit], atol=1e-5, rtol=0)

    @pytest.mark.cuda
    @pytest.mark.parametrize("size,subdivide", [(256, 3), (64, 3), (96, 2), (32, 2), (8, 1)])
    def test_backward_kernel_matches_plain(self, cuda_device, size, subdivide):
        """The backward kernel against backward_plain on the card, at the
        forward test's sizes, for a seeded dL/dS: the same per-pair f32
        arithmetic summed over the pixels in another order, so the rows'
        vector relative error is summation rounding (<= 1e-4); the z
        columns and the slots past each bin's count are exactly 0."""
        proj, faces, size = _bench_scene(B=4, size=size, subdivide=subdivide)
        proj, faces = proj.to(cuda_device), faces.to(cuda_device)
        K = rc.auto_K(faces.shape[0], size, 192)
        dS = torch.from_numpy(np.random.default_rng(1).normal(
            size=(4, size, size)).astype(np.float32)).to(cuda_device)
        for sigma, blur in ((rc.SIGMA, rc.BLUR_RADIUS), (5e-3, 6e-2)):
            table, idx, th, tw = rc.bin_faces(proj, faces, size, K, blur)
            kern = rc.backward_cuda(table, idx, dS, size, th, tw, sigma, blur)
            plain = rc.backward_plain(table, idx, dS, size, th, tw, sigma, blur)
            torch.cuda.synchronize()
            rel = (torch.linalg.vector_norm(kern - plain) / torch.linalg.vector_norm(plain))
            assert rel.item() <= 1e-4, (sigma, rel.item())
            assert torch.count_nonzero(kern[..., 6:]) == 0
            assert torch.count_nonzero(kern[idx < 0]) == 0

    @pytest.mark.cuda
    @pytest.mark.parametrize("size", [32, 256])
    def test_adversarial_scene_matches_plain(self, cuda_device, size):
        """raster_checks.adversarial_scene (zero-area faces on pixel-centre
        lines, repeated vertices, slivers on both sides of the cull's area
        threshold): both forward modes within raster_checks.check_forward,
        pix_to_face equal on every pixel, degenerate faces' included (the
        cull keeps such faces' whole bin); the backward rows within relative
        error 1e-4 at both sigmas, z columns and invalid slots exactly 0."""
        verts, faces, degenerate = chk.adversarial_scene(size)
        verts, faces = torch.from_numpy(verts).to(cuda_device), torch.from_numpy(faces).to(
            cuda_device)
        degenerate = torch.from_numpy(degenerate).to(cuda_device, torch.int32)
        for soft in (True, False):
            blur = rc.BLUR_RADIUS if soft else 0.0
            table, idx, th, tw = rc.bin_faces(verts, faces, size, 192, blur)
            kern = rc.forward_cuda(table, idx, size, th, tw, rc.SIGMA, blur, soft)
            plain = rc.forward_plain(table, idx, size, th, tw, rc.SIGMA, blur, soft)
            chk.check_forward(kern, plain, f"adversarial {size}^2", degenerate)
        dS = torch.from_numpy(np.random.default_rng(5).normal(
            size=(verts.shape[0], size, size)).astype(np.float32)).to(cuda_device)
        for sigma, blur in ((rc.SIGMA, rc.BLUR_RADIUS), (5e-3, 6e-2)):
            table, idx, th, tw = rc.bin_faces(verts, faces, size, 192, blur)
            chk.check_backward(table, idx, dS, size, th, tw, sigma, blur, f"adversarial {size}^2")

    @pytest.mark.cuda
    def test_backward_counts_one_launch(self, cuda_device):
        """A vertex gradient through the soft rasterizer on the card runs
        one forward and one backward kernel, and gives finite gradients."""
        proj, faces, size = _bench_scene(B=2)
        proj = proj.to(cuda_device).requires_grad_(True)
        before = dict(rc.LAUNCHES)
        fr = rc.rasterize_binned(proj, faces.to(cuda_device), size, 192, soft=True)
        (1.0 - torch.exp(fr.S)).sum().backward()
        torch.cuda.synchronize()
        assert rc.LAUNCHES["soft"] == before["soft"] + 1
        assert rc.LAUNCHES["soft_bwd"] == before["soft_bwd"] + 1
        assert bool(torch.isfinite(proj.grad).all())
        assert proj.grad[..., :2].abs().sum() > 0


class TestCorrelationKernel:
    def test_correlation_cuda_refuses_cpu_tensors(self):
        f = torch.zeros(1, 4, 6, 8)
        with pytest.raises(ValueError):
            cc.correlation_cuda(f, f, 4)

    @pytest.mark.cuda
    @pytest.mark.parametrize("B,C,H,W,md", CORR_SHAPES, ids=CORR_IDS)
    def test_kernel_matches_plain(self, cuda_device, B, C, H, W, md):
        """The kernel against correlation_plain at the shapes of
        tests/test_torch_port_correlation.py (the trainer's pass, the flow
        CLI's at one pair, both templates, and ragged shapes),
        seeded N(0, 1) features: atol 1e-5 (the same f32 products, summed
        over the channels in another order); one launch per call, and a
        second launch on the same inputs gives the same bits (the fixed
        summation order)."""
        g = torch.Generator().manual_seed(md * 1000 + C)
        f1, f2 = (torch.randn(B, C, H, W, generator=g).to(cuda_device) for _ in range(2))
        before = dict(cc.LAUNCHES)
        kern = cc.correlation(f1, f2, md)
        torch.cuda.synchronize()
        assert cc.LAUNCHES[f"corr_md{md}"] == before[f"corr_md{md}"] + 1
        again = cc.correlation(f1, f2, md)
        torch.cuda.synchronize()
        assert torch.equal(kern, again)
        plain = cc.correlation_plain(f1, f2, md)
        assert kern.shape == (B, (2 * md + 1) ** 2, H, W)
        torch.testing.assert_close(kern, plain, atol=1e-5, rtol=0)

    @pytest.mark.cuda
    def test_kernel_takes_unaligned_views(self, cuda_device):
        """Contiguous inputs whose data starts 4 bytes past a 16-byte
        boundary (views one element into a buffer) take the scalar loads:
        still the plain version's result within 1e-5, at a tile shape."""
        n = 12 * 32 * 48 * 96
        flat = torch.randn(2 * n + 1, generator=torch.Generator().manual_seed(3)).to(cuda_device)
        f1, f2 = flat[1:n + 1].view(12, 32, 48, 96), flat[n + 1:].view(12, 32, 48, 96)
        assert f1.is_contiguous() and f1.data_ptr() % 16 == 4
        assert cc.launch_plan(12, 32, 48, 96, 4).template == "tile"
        kern = cc.correlation(f1, f2, 4)
        torch.testing.assert_close(kern, cc.correlation_plain(f1, f2, 4), atol=1e-5, rtol=0)
