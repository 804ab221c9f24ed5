"""The port's flow subsystem against the JAX package, on the CPU.

Same numpy-seeded inputs through the JAX function and its counterpart in
acfm_video_3d_reconstruction_tpu_torch/flow (NHWC there, NCHW here, so
every comparison permutes explicitly). On CPU tensors the port runs the
cost volume's plain version, `correlation_plain`; it is held against the
XLA `flow/ops.correlation` and against the Pallas `_kernel` of
`flow/correlation_pallas.py` run in interpret mode. The CUDA kernel itself
is tested on the card (tests/test_torch_port_kernels.py) and by
chip_smoke.py.

Tolerances: the primitives within atol 1e-5 (tests/test_flow.py's bound;
deform_conv3x3 2e-4, its bound there); the two-stage net, from the JAX
init carried across by models/from_jax.py, within a vector relative error
of 1e-3 per output (f32 convolutions summed in another order, through ~40
layers of random kaiming weights).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from acfm_video_3d_reconstruction_tpu.flow import correlation_pallas as jcp
from acfm_video_3d_reconstruction_tpu.flow import infer as jinfer
from acfm_video_3d_reconstruction_tpu.flow import losses as jlosses
from acfm_video_3d_reconstruction_tpu.flow import maskflownet as jmfn
from acfm_video_3d_reconstruction_tpu.flow import ops as jops
from acfm_video_3d_reconstruction_tpu.ops import grid_sample as jgs
from acfm_video_3d_reconstruction_tpu_torch.cli import flow_predict
from acfm_video_3d_reconstruction_tpu_torch.flow import correlation_cuda as cc
from acfm_video_3d_reconstruction_tpu_torch.flow import flowlib
from acfm_video_3d_reconstruction_tpu_torch.flow import infer as tinfer
from acfm_video_3d_reconstruction_tpu_torch.flow import losses as tlosses
from acfm_video_3d_reconstruction_tpu_torch.flow import maskflownet as tmfn
from acfm_video_3d_reconstruction_tpu_torch.flow import ops as tops
from acfm_video_3d_reconstruction_tpu_torch.models import from_jax
from acfm_video_3d_reconstruction_tpu_torch.ops import grid_sample as tgs

torch.set_num_threads(1)

NET_HW = (64, 128)
NET_REL = 1e-3


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ------------------------------------------------------------- cost volume --

def _pallas_correlation(f1, f2, md):
    """The Pallas kernel in interpret mode, built as correlation_pallas.py
    builds it (without its VMEM-budget fallback)."""
    B, H, W, C = f1.shape
    nd = (2 * md + 1) ** 2
    f2p = jnp.pad(f2, [(0, 0), (md, md), (md, md), (0, 0)])
    return pl.pallas_call(
        functools.partial(jcp._kernel, md),
        grid=(B,),
        in_specs=[
            pl.BlockSpec((1, H, W, C), lambda b: (b, 0, 0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, H + 2 * md, W + 2 * md, C), lambda b: (b, 0, 0, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, H, W, nd), lambda b: (b, 0, 0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((B, H, W, nd), f1.dtype),
        interpret=True,
    )(f1, f2p)


@pytest.mark.parametrize("md", [4, 2])
@pytest.mark.parametrize("C,H,W", [(8, 12, 24), (196, 6, 12)])
def test_correlation_plain_matches_xla_and_pallas(md, C, H, W):
    rng = np.random.default_rng(C + md)
    f1 = rng.normal(size=(2, H, W, C)).astype(np.float32)
    f2 = rng.normal(size=(2, H, W, C)).astype(np.float32)
    got = _nhwc(cc.correlation_plain(_nchw(f1), _nchw(f2), md))
    assert got.shape == (2, H, W, (2 * md + 1) ** 2)
    xla = np.asarray(jops.correlation(jnp.asarray(f1), jnp.asarray(f2), md))
    pallas = np.asarray(_pallas_correlation(jnp.asarray(f1), jnp.asarray(f2), md))
    np.testing.assert_allclose(got, xla, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=0)


def test_correlation_dispatch_on_cpu_runs_plain_version():
    rng = np.random.default_rng(7)
    f1, f2 = (torch.from_numpy(rng.normal(size=(1, 5, 4, 6)).astype(np.float32))
              for _ in range(2))
    before = dict(cc.LAUNCHES)
    assert torch.equal(tops.correlation(f1, f2, 2), cc.correlation_plain(f1, f2, 2))
    assert cc.LAUNCHES == before


def test_correlation_rejects_unsupported_inputs():
    f = torch.zeros(1, 2, 3, 4)
    with pytest.raises(ValueError):
        cc.correlation_plain(f, f, 5)
    with pytest.raises(ValueError):
        cc.correlation_plain(f, torch.zeros(1, 2, 3, 5), 2)


# -------------------------------------------------------------- primitives --

def _tie_grid(rng, H, W, align_corners, n):
    """(1, n, 2) grid whose first half unnormalizes exactly to x.5 / y.5
    pixel coordinates (H-1, W-1 powers of two with align_corners, H, W
    otherwise), the rest uniform in [-1.2, 1.2]."""
    def norm(pix, size):
        return 2.0 * (pix + 0.5) / size - 1.0 if not align_corners else 2.0 * pix / (size - 1) - 1.0

    k = n // 2
    ties = np.stack([norm(rng.integers(-1, W, k) + 0.5, W),
                     norm(rng.integers(-1, H, k) + 0.5, H)], -1)
    free = rng.uniform(-1.2, 1.2, (n - k, 2))
    return np.concatenate([ties, free])[None].astype(np.float32)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_matches_jax(mode, padding_mode, align_corners):
    rng = np.random.default_rng(3)
    H, W = (5, 9) if align_corners else (4, 8)
    img = rng.normal(size=(1, H, W, 3)).astype(np.float32)
    grid = _tie_grid(rng, H, W, align_corners, 64)
    want = np.asarray(jgs.grid_sample(jnp.asarray(img), jnp.asarray(grid), mode=mode,
                                      padding_mode=padding_mode, align_corners=align_corners))
    got = tgs.grid_sample(_nchw(img), torch.from_numpy(grid), mode=mode,
                          padding_mode=padding_mode, align_corners=align_corners)
    assert got.shape == (1, 3, 64)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), want, atol=1e-5, rtol=0)


def test_grid_sample_nearest_rounds_halves_up():
    """floor(x + 0.5): pixel coordinate 0.5 reads pixel 1, 1.5 reads 2
    (torch's own nearest mode rounds half to even: 0 and 2)."""
    img = torch.arange(5, dtype=torch.float32).reshape(1, 1, 1, 5)
    xs = torch.tensor([0.5, 1.5, 2.5]) / 2.0 - 1.0  # align_corners=True, exact
    grid = torch.stack([xs, torch.zeros(3)], -1)[None]
    out = tgs.grid_sample(img, grid, mode="nearest", align_corners=True)
    assert out.flatten().tolist() == [1.0, 2.0, 3.0]


def test_backward_warp_matches_jax():
    """Flows up to 4 px on a 9x11 image: many samples leave the image, so
    the hard validity threshold zeroes a border band on both sides."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, 11, 4)).astype(np.float32)
    flow = rng.uniform(-4, 4, (2, 9, 11, 2)).astype(np.float32)
    want = np.asarray(jops.backward_warp(jnp.asarray(x), jnp.asarray(flow)))
    got = _nhwc(tops.backward_warp(_nchw(x), _nchw(flow)))
    assert (want == 0).all(-1).any()
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_deform_conv3x3_matches_jax():
    rng = np.random.default_rng(5)
    B, H, W, Cin, Cout = 2, 6, 7, 5, 3
    x = rng.normal(size=(B, H, W, Cin)).astype(np.float32)
    offsets = (rng.normal(size=(B, H, W, 18)) * 1.5).astype(np.float32)
    kernel = rng.normal(size=(3, 3, Cin, Cout)).astype(np.float32)
    bias = rng.normal(size=(Cout,)).astype(np.float32)
    want = np.asarray(jops.deform_conv3x3(jnp.asarray(x), jnp.asarray(offsets),
                                          jnp.asarray(kernel), jnp.asarray(bias)))
    got = _nhwc(tops.deform_conv3x3(_nchw(x), _nchw(offsets),
                                    torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
                                    torch.from_numpy(bias)))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


@pytest.mark.parametrize("factor", [2, 4])
def test_up_and_downsample_match_jax(factor):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    up = _nhwc(tops.upsample2d_flow(_nchw(x), factor))
    np.testing.assert_allclose(up, np.asarray(jops.upsample2d_flow(jnp.asarray(x), factor)),
                               atol=1e-5, rtol=0)
    y = rng.normal(size=(2, 16, 24, 3)).astype(np.float32)
    down = _nhwc(tops.downsample2d_flow(_nchw(y), factor))
    np.testing.assert_allclose(down, np.asarray(jops.downsample2d_flow(jnp.asarray(y), factor)),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("src,dst", [
    ((384, 768), (256, 256)),   # predict_pair_flow's flow back to the training size
    ((448, 1024), (436, 1024)),  # predict_flow_native's flow back to Sintel's size
    ((256, 256), (384, 768)),   # the frames up to the net's input
    ((40, 50), (30, 70)),       # one axis shrinks, the other grows
])
def test_resize_bilinear_matches_jax_image_resize(src, dst):
    rng = np.random.default_rng(sum(src))
    x = rng.normal(size=(1,) + src + (2,)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1,) + dst + (2,), "bilinear"))
    got = _nhwc(tinfer.resize_bilinear(_nchw(x), dst))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ------------------------------------------------------------------ losses --

def test_epe_losses_match_jax():
    rng = np.random.default_rng(8)
    B, H, W = 2, 64, 128
    flow = rng.normal(size=(B, H, W, 2)).astype(np.float32) * 3
    mask = (rng.random((B, H, W)) > 0.3).astype(np.float32)
    preds = [rng.normal(size=(B, H // s, W // s, 2)).astype(np.float32) for s in (64, 32, 16, 8, 4)]
    pred = rng.normal(size=(B, H, W, 2)).astype(np.float32)
    tm, tf, tp = torch.from_numpy(mask), _nchw(flow), _nchw(pred)
    np.testing.assert_allclose(tlosses.epe_loss(tp, tf).numpy(),
                               np.asarray(jlosses.epe_loss(pred, flow)), rtol=1e-5)
    for q in (None, 0.4):
        np.testing.assert_allclose(
            tlosses.epe_loss_with_mask(tp, tf, tm, q=q).numpy(),
            np.asarray(jlosses.epe_loss_with_mask(pred, flow, mask, q=q)), rtol=1e-5)
    got = tlosses.multiscale_epe(tf, tm, [_nchw(p) for p in preds]).numpy()
    want = np.asarray(jlosses.multiscale_epe(jnp.asarray(flow), jnp.asarray(mask),
                                             [jnp.asarray(p) for p in preds]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the downsampling match, per level from the JAX pieces (the JAX
    # function's own downsampling branch takes no (B, H, W) mask)
    got = tlosses.multiscale_epe(tf, tm, [_nchw(p) for p in preds], match="downsampling").numpy()
    want = sum(
        np.asarray(jlosses.epe_loss_with_mask(
            p / s, jops.downsample2d_flow(jnp.asarray(flow), s) / s,
            jops.downsample2d_flow(jnp.asarray(mask)[..., None], s)[..., 0])) * w
        for p, w, s in zip(preds, (0.005, 0.01, 0.02, 0.08, 0.32), (64, 32, 16, 8, 4)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ------------------------------------------------------------- the net -----

@pytest.fixture(scope="module")
def jax_params():
    """init_params(PRNGKey(0)) as numpy trees (jitted: the same numbers)."""
    params = jax.jit(jmfn.init_params)(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def port_net(jax_params):
    return tmfn.build(from_jax.maskflownet_from_jax(jax_params), "cpu")


@pytest.fixture(scope="module")
def jax_ref(jax_params):
    """One JAX run of everything the net tests compare, eagerly, at one net
    shape (B=2, 64x128) so the per-op compilations are shared."""
    rng = np.random.default_rng(0)
    im0, im1 = rng.random((2, 2) + NET_HW + (3,), np.float32) - 0.5
    clip = rng.random((1, 3, 32, 32, 3), np.float32)
    n0, n1 = rng.random((2, 2, 60, 120, 3), np.float32)
    ref = dict(im0=im0, im1=im1, clip=clip, n0=n0, n1=n1)
    ref["s_preds"], ref["s_occ"], srcs = jmfn.maskflownet_s(jax_params["s"], im0, im1)
    ref["c30"], ref["c40"] = srcs[3], srcs[4]
    ref["preds"], ref["visuals"], _ = jmfn.maskflownet(jax_params, im0, im1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jinfer, "predict_pair_flow", jinfer.predict_pair_flow.__wrapped__)
        ref["clip_flows"] = jinfer.clip_flows(jax_params, jnp.asarray(clip), 32, NET_HW)
        ref["pair"] = jinfer.predict_pair_flow(jax_params, clip[:, 1], clip[:, 2], 32, NET_HW)
    ref["native"] = jinfer.predict_flow_native(jax_params, n0, n1)
    return jax.tree_util.tree_map(np.asarray, ref)


@pytest.mark.heavy
def test_maskflownet_matches_jax(port_net, jax_ref):
    """Every level's prediction of both stages, the stage-1 occlusion mask
    and stage 2's inputs c30 / c40, within vector relative error 1e-3, and
    the same pixels zeroed by the warp's validity threshold."""
    im0, im1 = _nchw(jax_ref["im0"]), _nchw(jax_ref["im1"])
    before = dict(cc.LAUNCHES)
    with torch.no_grad():
        s_preds, s_occ, (_, _, _, c30, c40) = port_net.MaskFlownet_S(im0, im1)
        preds, visuals = port_net(im0, im1)
    assert cc.LAUNCHES == before
    assert [tuple(p.shape) for p in preds] == [(2, 2, 64 // s, 128 // s)
                                               for s in (64, 32, 16, 8, 4)]
    pairs = [(f"stage1 flow{6 - i}", s_preds[i], jax_ref["s_preds"][i]) for i in range(5)]
    pairs += [(f"flow{6 - i}", preds[i], jax_ref["preds"][i]) for i in range(5)]
    pairs += [("occlusion", s_occ[0], jax_ref["s_occ"][0]), ("c30", c30, jax_ref["c30"]),
              ("c40", c40, jax_ref["c40"]), ("visual", visuals[0], jax_ref["visuals"][0])]
    for name, got, want in pairs:
        assert _rel(_nhwc(got), want) <= NET_REL, (name, _rel(_nhwc(got), want))
    # the warped second image in c40: the hard m < 0.9999 test zeroes the
    # same pixels on both sides
    zeroed = (_nhwc(c40)[..., :3] == 0).all(-1)
    np.testing.assert_array_equal(zeroed, (jax_ref["c40"][..., :3] == 0).all(-1))
    assert zeroed.any()


@pytest.mark.heavy
def test_predict_pair_flow_and_clip_flows_match_jax(port_net, jax_ref):
    """T=3 clips at net_hw 64x128 from 32^2 frames (the frames grow, the
    flow shrinks back): predict_pair_flow, clip_flows, make_flow_fn and
    shift_flows_for_loss in the JAX layouts."""
    clip = jax_ref["clip"]
    pair = tinfer.predict_pair_flow(port_net, clip[:, 1], clip[:, 2], 32, NET_HW)
    assert pair.shape == (1, 32, 32, 2)
    assert _rel(pair.numpy(), jax_ref["pair"]) <= NET_REL
    flows = tinfer.clip_flows(port_net, clip, 32, NET_HW)
    assert flows.shape == (1, 3, 32, 32, 2)
    assert _rel(flows.numpy(), jax_ref["clip_flows"]) <= NET_REL
    assert not flows[:, -1].any()
    batch = tinfer.make_flow_fn(port_net, 32, NET_HW)({"img": clip, "mask": 0})
    assert torch.equal(batch["optical_flows"], flows) and batch["mask"] == 0
    np.testing.assert_array_equal(
        tinfer.shift_flows_for_loss(flows).numpy(),
        np.asarray(jinfer.shift_flows_for_loss(jnp.asarray(flows.numpy()))))


@pytest.mark.heavy
def test_predict_flow_native_matches_jax(port_net, jax_ref):
    """60x120 frames stretched to 64x128 and the flow stretched back."""
    got = tinfer.predict_flow_native(port_net, jax_ref["n0"], jax_ref["n1"])
    assert got.shape == (2, 60, 120, 2)
    assert _rel(got.numpy(), jax_ref["native"]) <= NET_REL


def test_init_params_is_kaiming_and_seeded():
    a = tmfn.init_params(torch.Generator().manual_seed(0))
    b = tmfn.init_params(torch.Generator().manual_seed(0))
    assert a.keys() == tmfn.MaskFlownet().state_dict().keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["MaskFlownet_S.dc_conv1.weight"]  # (128, 579, 3, 3)
    assert abs(w.std().item() / np.sqrt(2.0 / (579 * 9)) - 1.0) < 0.02
    up = a["upfeat5.weight"]  # ConvTranspose2d (Cin, 16, 4, 4): fan_in from Cin
    assert abs(up.std().item() / np.sqrt(2.0 / (up.shape[0] * 16)) - 1.0) < 0.05
    assert not a["conv6_0.bias"].any()


# -------------------------------------------------------- checkpoints -------

def _is_bare(name: str) -> bool:
    """Reference modules saved bare (.weight), as tests/test_flow_infer.py
    lists them; the rest are Sequential(conv, LeakyReLU) -> '.0.weight'."""
    return name.startswith(("pred_flow", "pred_mask", "upfeat", "deform")) or name == "dc_conv7"


def _export(params, form: str, stages=("s", "m")) -> dict:
    """A reference-format state dict of the JAX params: conv HWIO -> OIHW
    and upfeat (kh, kw, O, I) -> ConvTranspose2d (I, O, kh, kw) are one
    transpose. form: 'reference' names, or every module '.0.weight'
    ('sequential') or '.weight' ('bare')."""
    sd = {}
    for stage in stages:
        prefix = "MaskFlownet_S." if stage == "s" and len(stages) == 2 else ""
        for name, p in params[stage].items():
            bare = form == "bare" or (form == "reference" and _is_bare(name))
            key = prefix + name + (".weight" if bare else ".0.weight")
            sd[key] = torch.tensor(np.asarray(p["w"]).transpose(3, 2, 0, 1).copy())
            sd[key[:-len("weight")] + "bias"] = torch.tensor(np.asarray(p["b"]))
    return sd


@pytest.mark.heavy
@pytest.mark.parametrize("form", ["reference", "sequential", "bare"])
def test_load_flow_checkpoint_matches_from_jax(tmp_path, jax_params, form):
    path = tmp_path / "maskflownet.pth"
    torch.save(_export(jax_params, form), str(path))
    got = tinfer.load_flow_checkpoint(str(path))
    want = from_jax.maskflownet_from_jax(jax_params)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    tmfn.build(got, "cpu")  # loads strictly


@pytest.mark.heavy
def test_load_flow_checkpoint_stage1_alone(tmp_path, jax_params):
    path = tmp_path / "maskflownet_s.pth"
    torch.save(_export(jax_params, "reference", stages=("s",)), str(path))
    got = tinfer.load_flow_checkpoint(str(path))
    want = {k: v for k, v in from_jax.maskflownet_from_jax(jax_params).items()
            if k.startswith("MaskFlownet_S.")}
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    tmfn.MaskFlownetS().load_state_dict(
        {k[len("MaskFlownet_S."):]: v for k, v in got.items()})


# ------------------------------------------------------------------ CLI -----

def test_flow_predict_cli(tmp_path, capsys):
    """main() on two 64x128 PNGs and a .flo, random weights, on the CPU:
    it prints an AEPE and writes the visualisation."""
    from PIL import Image

    rng = np.random.default_rng(9)
    paths = []
    for i in range(2):
        p = tmp_path / f"im{i}.png"
        Image.fromarray(rng.integers(0, 256, (64, 128, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    gt = tmp_path / "gt.flo"
    flowlib.write_flo(str(gt), rng.normal(size=(64, 128, 2)).astype(np.float32))
    out = tmp_path / "vis.png"
    assert flow_predict.main(["--im0", paths[0], "--im1", paths[1], "--gt", str(gt),
                              "--out", str(out), "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    aepe = [line for line in text.splitlines() if line.startswith("AEPE: ")]
    assert aepe and np.isfinite(float(aepe[0].split()[1]))
    vis = np.asarray(Image.open(out))
    assert vis.shape == (64, 128, 3) and vis.dtype == np.uint8
