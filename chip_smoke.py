#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile OUT.txt]

Phases, each of which raises (exit code 1) on failure:
  1. build: compiles every CUDA source of the port with nvcc (sm_90a).
  2. kernels: the cull census of the full-width scene (B=16, 256^2, the
     1280-face icosphere, K from auto_K) on the card, in three modes: every
     (pixel, slot) pair outside its cull window must be out of radius under
     the plain geometry (ops/raster_checks.py::cull_census). Then the
     binned rasterizer's forward kernel, soft and hard, and its soft
     backward kernel against their plain PyTorch versions on that scene
     (ops/raster_checks.py's tolerances; pix_to_face equal on every pixel);
     times each kernel alone (its C entry on counts and outputs made once;
     the wrapper's call is logged beside it), its plain version and the
     bin pass; prints four
     (pixel, slot) pair counts per kernel (the bins' pairs, the pairs at
     the kernel's own cull granularity, the pairs inside the cull windows,
     the pairs in radius) and takes the bound from the last two: the full
     per-pair work for each pair in radius, the tests alone for the other
     pairs inside the windows. Then the census and the same checks on
     adversarial_scene (zero-area faces on pixel-centre lines, repeated
     vertices, slivers at the cull's area threshold).
  3. small: the eval step and one train step at the CPU tests' config
     (64^2, f32) on the card against the same weights on the CPU.
  4. main paths, at bench.py's shape (batch 16, 256^2, subdivide 3, 16
     handles, 15 keypoints, tex 6, texture on, bf16 autocast nets, f32
     geometry) on a synthetic batch: make_eval_step timed over
     EVAL_WINDOWS windows of EVAL_STEPS steps, then make_train_step timed
     over TRAIN_WINDOWS windows of TRAIN_STEPS steps (median and spread of
     frames/s). The launch counters are zeroed just before each path's
     timed steps and must read one soft and one hard launch per eval step,
     and one soft, one hard and one soft_bwd launch per train step, after
     them. The outputs must be finite, training must lower total_loss, and
     each path must agree with the same step through the plain rasterizer
     (the train step's gradients with the nets in f32).
  5. flow, the frozen two-stage MaskFlownet in f32 at full width, seeded
     random weights (flow/maskflownet.py::init_params):
     a. the cost-volume kernel against correlation_plain at the 10 distinct
        shapes of one pass at 384x768 with 12 pairs (max abs error <= 1e-5),
        timed with its plain version and its bound;
     b. the net at 64x128, B=2, on the card against the CPU, every level's
        flow within vector relative error 1e-3;
     c. the main flow path, flow/infer.py::make_flow_fn(net, 256, (384, 768))
        on a (12, 2, 256, 256, 3) clip batch, timed over FLOW_WINDOWS windows
        of FLOW_CALLS calls (median pairs/s and spread): exactly 15
        cost-volume launches per call (5 at md=4, 10 at md=2) and none of
        the rasterizer, finite flows, and agreement with the same call
        through correlation_plain (relative error <= 1e-4, beside the
        kernel path's own run-to-run floor), and the convolutions'
        operations per call with their rate over the windows;
     d. the flow CLI's path, predict_flow_native on one 436x1024 pair
        (stretched to 448x1024): finite, 15 launches.
The launch counters of every kernel are zeroed just before each main path
and read just after it.
The second-to-last lines are the card's name and power limit, then one
JSON line of kernel records; the last line is {"ok": true, "device": ...}.
Exits non-zero, printing no result, when no CUDA device is present.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# fp32 operations (an FMA is two) that the function needs per (pixel, valid
# slot) pair and, once, per (view, face); counted in csrc/raster_fwd.cu and
# csrc/raster_bwd.cu.
OPS_PER_PAIR = {"soft": 99, "hard": 47, "soft_bwd": 130}
OPS_PER_FACE = {"soft": 28, "hard": 10, "soft_bwd": 28}
# Of OPS_PER_PAIR, the inside test (pixel-relative differences, sub-areas,
# divides, the test itself) and, soft, the distance and radius tests: all
# that a pair out of radius needs.
OPS_TEST = {"soft": 68, "hard": 23, "soft_bwd": 68}
# The well-conditioned sigma / blur of tests/test_rasterizer_tpu.py's
# gradient parity: at sigma=1e-4 a vertex gradient amplifies an f32
# rounding of the vertex positions by ~1/sigma near silhouette edges.
SIGMA_WIDE, BLUR_WIDE = 5e-3, 6e-2

B, IMG = 16, 256
# the main paths are timed over windows of steps
EVAL_STEPS, EVAL_WINDOWS = 100, 3
TRAIN_STEPS, TRAIN_WINDOWS = 20, 3
# the flow path: batch_size 12 clips of num_frames 2 at img_size 256 (the
# multiframe defaults), the net at its reference input size
FLOW_B, FLOW_NET_HW = 12, (384, 768)
FLOW_CALLS, FLOW_WINDOWS = 3, 3
NATIVE_HW = (436, 1024)  # a Sintel frame


def log(msg: str) -> None:
    print(msg, flush=True)


def time_cuda(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call, CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase_build():
    from acfm_video_3d_reconstruction_tpu_torch.ops import cuda_build

    sources = sorted(p.name for p in cuda_build.CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    logs = cuda_build.build(sources)
    secs = time.perf_counter() - t0
    log(f"[build] {sources} in {secs:.2f} s (nvcc {' '.join(cuda_build.NVCC_FLAGS)})")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {name}: {line.strip()}")
    return secs


def phase_kernels(torch, device):
    """Kernel vs plain version, both modes, at the main path's shapes, with
    ops/raster_checks.py's tolerances: pix_to_face equal on every pixel,
    barycentrics within 1e-4 and zbuf within 1e-5 where a face is hit, mask
    within 2e-4; the backward's rows within relative error 1e-4, z columns
    and invalid slots exactly 0. Before them, the cull census of the same
    scene in three modes: no pair outside its cull window is in radius.
    Then the same checks on adversarial_scene.
    """
    from acfm_video_3d_reconstruction_tpu_torch.ops import raster_checks as chk
    from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer_cuda as rc

    proj, faces = chk.icosphere_scene(B, device)
    F = faces.shape[0]
    K = rc.auto_K(F, IMG, 192)
    ovf = rc.bin_overflow_counts(proj, faces, IMG, K)
    log(f"[kernels] scene B={B} {IMG}^2 F={F} K={K}; bin_overflow_counts max {int(ovf.max())}")
    in_radius = _cull_census(rc, chk, proj, faces, K, IMG, "full width")
    records = []
    for soft in (True, False):
        mode = "soft" if soft else "hard"
        blur = rc.BLUR_RADIUS if soft else 0.0
        table, idx, th, tw = rc.bin_faces(proj, faces, IMG, K, blur)
        kern = rc.forward_cuda(table, idx, IMG, th, tw, rc.SIGMA, blur, soft)
        torch.cuda.synchronize()
        plain = rc.forward_plain(table, idx, IMG, th, tw, rc.SIGMA, blur, soft)
        errs, line = chk.check_forward(kern, plain, mode)
        log(f"[kernels] {line}")

        bin_ms = time_cuda(lambda: rc.bin_faces(proj, faces, IMG, K, blur), 10)
        log(f"[kernels] {mode}: bin pass {bin_ms:.4f} ms")
        # table f32, idx int32, counts (B, T) int32 in; five (B, H, W) maps out
        nbytes = (table.numel() + idx.numel() + idx[..., 0].numel() + 5 * B * IMG * IMG) * 4
        counts = (idx >= 0).sum(-1, dtype=torch.int32)
        ms = _kernel_ms(mode, lambda: rc.launch_fwd(
            rc.fwd_entry(), table, idx, counts, kern, IMG, th, tw, rc.SIGMA, blur, soft),
            lambda: rc.forward_cuda(table, idx, IMG, th, tw, rc.SIGMA, blur, soft))
        records.append(_record(
            f"raster_fwd_{mode}", "raster_fwd.cu", RASTER_TPU + ":259", ms,
            lambda: rc.forward_plain(table, idx, IMG, th, tw, rc.SIGMA, blur, soft),
            _raster_ops(rc, mode, table, idx, th, tw, blur, F, nbytes, in_radius[mode]), nbytes,
            max(errs["bary"], errs["zbuf"], errs["mask"]), mode))
    records.append(_backward_record(torch, rc, chk, proj, faces, K, in_radius["soft"]))
    _adversarial(torch, rc, chk, device)
    return records


def _kernel_ms(what, launch, call):
    """Milliseconds per launch of a rasterizer kernel alone (`launch`: its C
    entry on counts and outputs made once), which the record keeps, and per
    wrapper `call` (which also reduces idx to counts and allocates its
    outputs each time; at ~0.05 ms a kernel the host then sets the pace),
    which is logged beside it."""
    ms, call_ms = time_cuda(launch, 20), time_cuda(call, 20)
    log(f"[kernels] {what}: kernel alone {ms:.4f} ms per launch, wrapper call {call_ms:.4f} ms")
    return ms


def _cull_census(rc, chk, verts, faces, K, size, what):
    """raster_checks.cull_census of the scene, binned as the main path bins
    it, in three modes: soft at sigma 1e-4 (production), soft at
    SIGMA_WIDE / BLUR_WIDE, hard. Fails if any pair outside its cull window
    is in radius. Returns the in-radius pairs of the soft (sigma 1e-4) and
    hard modes."""
    in_radius = {}
    for mode, sigma, blur, soft in (("soft", rc.SIGMA, rc.BLUR_RADIUS, True),
                                    ("soft_wide", SIGMA_WIDE, BLUR_WIDE, True),
                                    ("hard", rc.SIGMA, 0.0, False)):
        table, idx, th, tw = rc.bin_faces(verts, faces, size, K, blur)
        c = chk.cull_census(table, idx, size, th, tw, sigma, blur, soft)
        log(f"[kernels] cull census, {what} {mode} (sigma {sigma:g}, blur {blur:.4g}): "
            f"{c['pairs']} bin pairs, {c['excluded']} outside the windows, of them "
            f"{c['excluded_in_radius']} in radius; {c['in_radius']} pairs in radius; "
            f"{int(c['whole'].sum())} of {int((idx >= 0).sum())} slots keep the whole bin")
        require(c["excluded_in_radius"] == 0,
                f"cull census {what} {mode}: {c['excluded_in_radius']} excluded pairs in radius")
        in_radius[mode] = c["in_radius"]
    return in_radius


def _adversarial(torch, rc, chk, device):
    """Both kernels against their plain versions on adversarial_scene at
    IMG^2 (two views), whose degenerate faces the cull must keep whole; its
    cull census first."""
    verts, faces, degenerate = chk.adversarial_scene(IMG)
    verts, faces = torch.from_numpy(verts).to(device), torch.from_numpy(faces).to(device)
    degenerate = torch.from_numpy(degenerate).to(device, torch.int32)
    _cull_census(rc, chk, verts, faces, 192, IMG, "adversarial")
    dS = torch.from_numpy(np.random.default_rng(5).normal(
        size=(verts.shape[0], IMG, IMG)).astype(np.float32)).to(device)
    for soft in (True, False):
        blur = rc.BLUR_RADIUS if soft else 0.0
        table, idx, th, tw = rc.bin_faces(verts, faces, IMG, 192, blur)
        kern = rc.forward_cuda(table, idx, IMG, th, tw, rc.SIGMA, blur, soft)
        torch.cuda.synchronize()
        plain = rc.forward_plain(table, idx, IMG, th, tw, rc.SIGMA, blur, soft)
        log("[kernels] " + chk.check_forward(
            kern, plain, f"adversarial {'soft' if soft else 'hard'}", degenerate)[1])
    for sigma, blur in ((SIGMA_WIDE, BLUR_WIDE), (rc.SIGMA, rc.BLUR_RADIUS)):
        table, idx, th, tw = rc.bin_faces(verts, faces, IMG, 192, blur)
        log("[kernels] " + chk.check_backward(table, idx, dS, IMG, th, tw, sigma, blur,
                                              "adversarial soft_bwd")[1])


RASTER_TPU = "acfm_video_3d_reconstruction_tpu/ops/rasterizer_tpu.py"
CORRELATION_TPU = "acfm_video_3d_reconstruction_tpu/flow/correlation_pallas.py"
# the granularity at which each kernel walks pairs (rasterizer_cuda.cull_pair_counts)
GRANULARITY = {"soft": "patch", "hard": "patch", "soft_bwd": "warp"}


def _raster_ops(rc, mode, table, idx, th, tw, blur, n_faces, nbytes, in_radius):
    """fp32 operations a rasterizer kernel's function needs on these inputs:
    OPS_PER_PAIR for each of the `in_radius` pairs, OPS_TEST for each other
    pair inside the cull windows (cull_pair_counts "needed"), which needs
    only the inside and distance tests, and OPS_PER_FACE once per (view,
    face). Logs the bins' pairs (the walk before culling), the pairs at the
    kernel's own granularity, the needed pairs and the in-radius pairs,
    with the bound that each of the first three gives at OPS_PER_PAIR (and
    `nbytes`)."""
    soft = mode != "hard"
    counts = rc.cull_pair_counts(rc.cull_windows(table, IMG, th, tw, blur, soft), idx, th, tw)
    faces_ops = B * n_faces * OPS_PER_FACE[mode]
    bounds = {k: _bound(counts[k] * OPS_PER_PAIR[mode] + faces_ops, nbytes)[0]
              for k in ("bin", GRANULARITY[mode], "needed")}
    log(f"[kernels] {mode}: (pixel, slot) pairs: bins {counts['bin']}, kernel's granularity "
        f"({GRANULARITY[mode]}) {counts[GRANULARITY[mode]]}, needed {counts['needed']}, in "
        f"radius {in_radius}; bound from the first three at full pair cost "
        f"{bounds['bin']:.4f} / {bounds[GRANULARITY[mode]]:.4f} / {bounds['needed']:.4f} ms")
    return (in_radius * OPS_PER_PAIR[mode] + (counts["needed"] - in_radius) * OPS_TEST[mode]
            + faces_ops)


def _bound(ops, nbytes):
    """(bound ms, what bounds it): the larger of `ops` fp32 operations over
    PEAK_FP32_FLOPS and `nbytes` over PEAK_BYTES_PER_S."""
    ops_s, bytes_s = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def _record(name, source, replaces, ms, plain, ops, nbytes, max_abs_err, what):
    """The record of a kernel that took `ms` per launch: times its `plain`
    version and gives its bound from `ops` and `nbytes`. main() fills in
    the launches."""
    plain_ms = time_cuda(plain, 3, 1)
    bound_ms, bound_by = _bound(ops, nbytes)
    log(f"[kernels] {what}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    return {
        "name": name, "route": "cuda",
        "source": f"acfm_video_3d_reconstruction_tpu_torch/csrc/{source}",
        "replaces": replaces,
        "launches": None, "max_abs_err": max_abs_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }


def _backward_record(torch, rc, chk, proj, faces, K, in_radius):
    """The soft backward kernel against backward_plain for a seeded dL/dS,
    at sigma=1e-4 (production) and at SIGMA_WIDE / BLUR_WIDE
    (raster_checks.check_backward). Timed at sigma=1e-4 on the soft bin
    pass, whose time phase_kernels gives."""
    dS = torch.from_numpy(
        np.random.default_rng(2).normal(size=(B, IMG, IMG)).astype(np.float32)).to(proj.device)
    for sigma, blur in ((SIGMA_WIDE, BLUR_WIDE), (rc.SIGMA, rc.BLUR_RADIUS)):
        table, idx, th, tw = rc.bin_faces(proj, faces, IMG, K, blur)
        err, line = chk.check_backward(table, idx, dS, IMG, th, tw, sigma, blur, "soft_bwd")
        log(f"[kernels] {line}")
    # table and rows (B, T, K, 9) f32, counts (B, T) int32, dL/dS (B, H, W) f32
    nbytes = 2 * table.numel() * 4 + idx[..., 0].numel() * 4 + dS.numel() * 4
    counts, grad = (idx >= 0).sum(-1, dtype=torch.int32), torch.empty_like(table)
    ms = _kernel_ms("soft_bwd", lambda: rc.launch_bwd(
        rc.bwd_entry(), table, counts, dS, grad, IMG, th, tw, rc.SIGMA, rc.BLUR_RADIUS),
        lambda: rc.backward_cuda(table, idx, dS, IMG, th, tw, rc.SIGMA, rc.BLUR_RADIUS))
    return _record(
        "raster_bwd_soft", "raster_bwd.cu", RASTER_TPU + ":449", ms,
        lambda: rc.backward_plain(table, idx, dS, IMG, th, tw, rc.SIGMA, rc.BLUR_RADIUS),
        _raster_ops(rc, "soft_bwd", table, idx, th, tw, rc.BLUR_RADIUS, faces.shape[0],
                    nbytes, in_radius), nbytes, err, "soft_bwd")


def _bench_batch(num_kps=15):
    rng = np.random.default_rng(0)
    return {
        "img": rng.random((B, IMG, IMG, 3), np.float32),
        "mask": (rng.random((B, IMG, IMG)) > 0.5).astype(np.float32),
        "kp": rng.random((B, num_kps, 3), np.float32),
        "sfm_pose": np.tile(np.asarray([0.8, 0, 0, 1, 0, 0, 0], np.float32), (B, 1)),
        "edt": rng.random((B, IMG, IMG), np.float32),
        "boundaries": rng.random((B, 1000, 3), np.float32),
    }


def _cfg(img_size, nz_feat, num_lbs, num_kps, tex_size, dtype):
    from acfm_video_3d_reconstruction_tpu_torch import config as cfg_lib

    return cfg_lib.Config(
        model=dataclasses.replace(
            cfg_lib.ModelConfig(), img_size=img_size, nz_feat=nz_feat, num_lbs=num_lbs,
            num_kps=num_kps, tex_size=tex_size, texture=True, symmetric=False,
            symmetric_texture=False, dtype=dtype,
        ),
        train=dataclasses.replace(cfg_lib.TrainConfig(), batch_size=B),
    )


def _check_aux(torch, aux, img_size, batch, what):
    for k, v in aux["metrics"].items():
        require(bool(torch.isfinite(v).all()), f"{what}: metric {k} not finite")
    m = aux["mask_pred"]
    require(tuple(m.shape) == (batch, img_size, img_size), f"{what}: mask shape {m.shape}")
    require(bool(((m >= 0) & (m <= 1)).all()), f"{what}: mask outside [0, 1]")
    for k in ("pred_v", "kp_pred", "cam_pred"):
        require(bool(torch.isfinite(aux[k]).all()), f"{what}: {k} not finite")


def _compare_metrics(m_a, m_b, what, rtol):
    require(set(m_a) == set(m_b), f"{what}: metric names differ")
    for k, a in m_a.items():
        a, b = float(a), float(m_b[k])
        require(abs(a - b) <= rtol * abs(b) + 1e-6, f"{what}: metric {k} {a} vs {b} (rtol {rtol})")


def _compare(aux_a, aux_b, what, metric_rtol, mask_atol):
    _compare_metrics(aux_a["metrics"], aux_b["metrics"], what, metric_rtol)
    err = (aux_a["mask_pred"] - aux_b["mask_pred"].to(aux_a["mask_pred"].device)).abs().max()
    require(err.item() <= mask_atol, f"{what}: mask error {err.item()} > {mask_atol}")
    return err.item()


def _small_batch():
    rng = np.random.default_rng(1)
    return {
        "img": rng.random((2, 64, 64, 3), np.float32),
        "mask": (rng.random((2, 64, 64)) > 0.5).astype(np.float32),
        "kp": rng.random((2, 4, 3), np.float32),
        "sfm_pose": np.tile(np.asarray([0.8, 0, 0, 1, 0, 0, 0], np.float32), (2, 1)),
        "edt": rng.random((2, 64, 64), np.float32),
        "boundaries": rng.random((2, 100, 3), np.float32),
    }


@contextlib.contextmanager
def wide_sigma():
    """Within the block the monocular forward's soft silhouette runs at
    SIGMA_WIDE / BLUR_WIDE (tests/test_torch_port_train.py does the same)."""
    from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer as ras

    fn = ras.soft_silhouette_vis_tex
    ras.soft_silhouette_vis_tex = functools.partial(fn, sigma=SIGMA_WIDE, blur_radius=BLUR_WIDE)
    try:
        yield
    finally:
        ras.soft_silhouette_vis_tex = fn


# Gradients held against a neighbour's scale instead of their own: a bias
# followed by a train-mode BatchNorm has an exact gradient of 0 (the mean
# subtraction removes it), and the skinning logits' is first order in the
# ~1e-5 handle offsets at init; both are rounding noise of larger terms.
NOISE_SCALE = {"encoder.enc_conv1.conv.bias": "encoder.enc_conv1.conv.weight",
               "encoder.enc_fc.0.fc.bias": "encoder.enc_fc.0.fc.weight",
               "encoder.enc_fc.1.fc.bias": "encoder.enc_fc.1.fc.weight",
               "lbs_logits": "mean_v"}


def _grads(model):
    return {k: p.grad.detach().float().cpu() for k, p in model.named_parameters()}


def _grad_errors(g_a, g_b, what, bound):
    """Per parameter tensor, |g_a - g_b| / |g_b| (NOISE_SCALE's tensors over
    their neighbour's |g_b|); fails above `bound`. Returns the worst."""
    import torch

    errs = {}
    for k, gb in g_b.items():
        ref = g_b[NOISE_SCALE.get(k, k)]
        errs[k] = (torch.linalg.vector_norm(g_a[k] - gb) / torch.linalg.vector_norm(ref)).item()
    worst = max(errs.items(), key=lambda kv: kv[1])
    require(worst[1] <= bound, f"{what}: gradient of {worst[0]} rel error {worst[1]} > {bound}")
    return worst


def phase_small(torch, device):
    """The CPU tests' config on the card (kernel path) against the CPU
    (plain path), same seeded weights, f32 with TF32 off.

    Eval step: the solve's f32 normal equations round differently on the
    two (cuSOLVER vs LAPACK), so pred_v is held to atol 1e-4
    (tests/test_torch_port_slice.py); at sigma=1e-4 the soft mask moves by
    up to ~50 per unit of vertex displacement at a silhouette edge
    (sigmoid' x 2d/sigma at d ~ sqrt(sigma)), so the mask takes atol 5e-3
    and the metrics rtol 1e-3.
    Train step (make_train_step, at SIGMA_WIDE / BLUR_WIDE for the same
    reason the JAX package's gradient parity uses them): the loss terms
    rtol 1e-3 as above; each parameter tensor's gradient within vector
    relative error 0.05, the JAX package's bound between two rasterizers'
    vertex gradients (an `inside` that flips at an edge-on face under a
    1e-4 vertex difference flips the slope's sign there); the train-mode
    BatchNorms' running-variance updates (0.01 x the biased batch variance,
    held against flax by the CPU tests) within vector relative error 1e-4,
    the f32 rounding of the batch moments, where the unbiased variance of
    a batch of 2 would be off by 100%.
    """
    from acfm_video_3d_reconstruction_tpu_torch.models.template import build_template
    from acfm_video_3d_reconstruction_tpu_torch.train import monocular

    template = build_template(subdivide=2, num_lbs=6, tex_size=2, num_kps=4)
    cfg = _cfg(64, 32, 6, 4, 2, "float32")
    batch = _small_batch()
    aux_gpu = monocular.make_eval_step(monocular.build(cfg, template, 0, device))(batch)
    aux_cpu = monocular.make_eval_step(monocular.build(cfg, template, 0, "cpu"))(batch)
    _check_aux(torch, aux_gpu, 64, 2, "small")
    v_err = (aux_gpu["pred_v"].cpu() - aux_cpu["pred_v"]).abs().max().item()
    require(v_err <= 1e-4, f"small card vs cpu: pred_v error {v_err} > 1e-4")
    err = _compare(aux_gpu, aux_cpu, "small card vs cpu", 1e-3, 5e-3)
    log(f"[small] 64^2 f32 eval step, card (kernel) vs cpu (plain): pred_v err {v_err:.3g}, "
        f"metrics within rtol 1e-3, mask err {err:.3g}")

    with wide_sigma():
        mods_gpu = monocular.build(cfg, template, 0, device)
        m_gpu = monocular.make_train_step(mods_gpu)(batch)
        mods_cpu = monocular.build(cfg, template, 0, "cpu")
        var0 = {k: v.clone() for k, v in mods_cpu.model.named_buffers()
                if k.endswith("running_var")}
        m_cpu = monocular.make_train_step(mods_cpu)(batch)
    _compare_metrics(m_gpu, m_cpu, "small train card vs cpu", 1e-3)
    worst = _grad_errors(_grads(mods_gpu.model), _grads(mods_cpu.model),
                         "small train card vs cpu", 0.05)
    var_cpu, var_gpu = dict(mods_cpu.model.named_buffers()), dict(mods_gpu.model.named_buffers())
    var_err = max((torch.linalg.vector_norm(var_gpu[k].cpu() - var_cpu[k])
                   / torch.linalg.vector_norm(var_cpu[k] - v0)).item()
                  for k, v0 in var0.items() if bool((var_cpu[k] != v0).any()))
    require(var_err <= 1e-4, f"small train card vs cpu: running_var update error {var_err} > 1e-4")
    log(f"[small] 64^2 f32 train step at sigma {SIGMA_WIDE:g}, card (kernels) vs cpu (plain): "
        "loss terms " + json.dumps({k: [float(m_gpu[k]), float(m_cpu[k])] for k in m_gpu})
        + f"; worst gradient rel error {worst[1]:.3g} ({worst[0]}); running_var update rel "
        f"error {var_err:.3g}")


@contextlib.contextmanager
def plain_rasterizer():
    """Within the block, the rasterizer runs its plain versions, forward and
    backward, on CUDA tensors too (no kernel launch, no count): the main
    paths' reference."""
    from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer_cuda as rc

    kernels = rc.forward_cuda, rc.backward_cuda
    rc.forward_cuda, rc.backward_cuda = rc.forward_plain, rc.backward_plain
    try:
        yield
    finally:
        rc.forward_cuda, rc.backward_cuda = kernels


def _counters():
    """Every kernel's launch counter dict."""
    from acfm_video_3d_reconstruction_tpu_torch.flow import correlation_cuda as cc
    from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer_cuda as rc

    return rc.LAUNCHES, cc.LAUNCHES


def zero_launches() -> None:
    for counts in _counters():
        for k in counts:
            counts[k] = 0


def read_launches() -> dict:
    """All kernels' launches since zero_launches()."""
    return {k: v for counts in _counters() for k, v in counts.items()}


def only(**expected) -> dict:
    """The launch counts `expected`, every other kernel at 0."""
    return {k: expected.get(k, 0) for k in read_launches()}


def _timed(torch, fn, windows, steps, what, batch=B, shape=f"{IMG}^2", unit="frames"):
    """Zero the launch counters, call fn in `windows` windows of `steps`
    calls (each window ends in a synchronize); return the last result, the
    median `unit`/s (`batch` per call), its spread (max - min) / median and
    the launches."""
    zero_launches()
    window_rate = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps):
            out = fn()
        torch.cuda.synchronize()
        window_rate.append(batch * steps / (time.perf_counter() - t0))
    launches = read_launches()
    rate = float(np.median(window_rate))
    spread = (max(window_rate) - min(window_rate)) / rate
    log(f"[main] {windows} windows of {steps} {what} calls at B={batch} {shape}: {unit}/s "
        f"{[round(f, 2) for f in window_rate]}, median {rate:.2f} ({batch * 1e3 / rate:.3f} "
        f"ms/call), spread (max-min)/median {spread:.4f}; launches {launches}")
    return out, rate, spread, launches


def _profile(torch, fn, path, what, shape=f"B={B} {IMG}^2"):
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    with open(path, "a") as fh:
        fh.write(f"==== one {what} step, {shape} ====\n{table}\n")
    log(f"[main] profile of one {what} step written to {path}")


def phase_eval(torch, mods, batch, profile):
    from acfm_video_3d_reconstruction_tpu_torch.train import monocular

    step = monocular.make_eval_step(mods)
    step(batch)  # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.synchronize()
    aux, fps, spread, launches = _timed(torch, lambda: step(batch), EVAL_WINDOWS, EVAL_STEPS,
                                        "eval")
    n_steps = EVAL_WINDOWS * EVAL_STEPS
    require(launches == only(soft=n_steps, hard=n_steps),
            f"eval launches {launches} != one soft and one hard per step ({n_steps} steps)")
    _check_aux(torch, aux, IMG, B, "main")

    with plain_rasterizer():
        aux_plain = step(batch)
    # Same bf16 nets on the same inputs on both sides: only the rasterizer
    # differs, so the mask takes its tolerance (atol 2e-4) and the metrics
    # rtol 1e-3 (mask means; texels flipped where a face or atlas cell
    # changes on a tie).
    err = _compare(aux, aux_plain, "main kernel vs plain", 1e-3, 2e-4)
    log(f"[main] eval: kernel path vs plain path: metrics within rtol 1e-3, mask err {err:.3g}")
    log("[main] eval metrics " + json.dumps({k: float(v) for k, v in aux["metrics"].items()}))
    if profile:
        _profile(torch, lambda: step(batch), profile, "eval")
    return fps, spread, launches


def phase_train(torch, mods, batch, profile):
    """make_train_step at bench.py's shape: launches, finite metrics, a
    falling total_loss, and one step's gradients from identical state
    through the kernels and through the plain rasterizer.

    That one-step check runs the nets in f32 (autocast off; the same
    modules, weights and batch): the bf16 nets' backward differs between
    two runs of the same path by a few 1e-3 per tensor (the texture
    decoder's cancelling sums), which would hide a fault of the rasterizer.
    In f32 what differs is the scatter and upsample atomics' order and the
    kernels' summation order against the plain versions' (~1e-7 relative
    in S and the rows), amplified by cancelling sums. Bound: 1e-4 vector
    relative error per tensor, NOISE_SCALE's against their neighbour's
    scale; the floor, the kernel path against itself, is printed beside
    it."""
    from acfm_video_3d_reconstruction_tpu_torch.train import monocular

    step = monocular.make_train_step(mods)
    first = step(batch)  # warm-up, and the loss to fall from
    torch.cuda.synchronize()
    metrics, fps, spread, launches = _timed(torch, lambda: step(batch), TRAIN_WINDOWS,
                                            TRAIN_STEPS, "train")
    n_steps = TRAIN_WINDOWS * TRAIN_STEPS
    require(launches == only(soft=n_steps, hard=n_steps, soft_bwd=n_steps),
            f"train launches {launches} != one soft, hard and soft_bwd per step ({n_steps} steps)")
    for k, v in metrics.items():
        require(bool(torch.isfinite(v).all()), f"train: metric {k} not finite")
    loss0, loss1 = float(first["total_loss"]), float(metrics["total_loss"])
    log(f"[main] train total_loss {loss0:.6g} at the first step, {loss1:.6g} after "
        f"{n_steps + 1} steps")
    require(loss1 < loss0, f"train: total_loss did not fall ({loss0} -> {loss1})")

    state = copy.deepcopy(mods.model.state_dict())
    cfg = mods.cfg
    mods_f32 = dataclasses.replace(mods, cfg=dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dtype="float32")))

    def one_step_grads():
        mods.model.load_state_dict(state)
        mods.model.zero_grad(set_to_none=True)
        loss, _ = monocular.forward(mods_f32, batch, train=True)
        loss.backward()
        return _grads(mods.model)

    g_kernel = one_step_grads()
    floor = _grad_errors(one_step_grads(), g_kernel, "train kernels vs kernels", 1e-4)
    with plain_rasterizer():
        g_plain = one_step_grads()
    mods.model.load_state_dict(state)
    worst = _grad_errors(g_kernel, g_plain, "train kernels vs plain", 1e-4)
    log(f"[main] train: one step from identical state, f32 nets, kernels vs plain "
        f"rasterizer: worst gradient rel error {worst[1]:.3g} ({worst[0]}); kernels vs "
        f"kernels {floor[1]:.3g} ({floor[0]})")
    log("[main] train metrics " + json.dumps({k: float(v) for k, v in metrics.items()}))
    if profile:
        _profile(torch, lambda: step(batch), profile, "train")
    return fps, spread, launches


def _flow_shapes():
    """The cost volume's distinct (md, C, H, W) at FLOW_NET_HW, finest last
    per md, with its launches per two-stage pass: stage 1 one per level at
    md=4, stage 2 two per level (corru, corrv) at md=2."""
    from acfm_video_3d_reconstruction_tpu_torch.flow.maskflownet import PYR_CH

    nh, nw = FLOW_NET_HW
    return [(md, PYR_CH[lvl - 1], nh >> lvl, nw >> lvl, per_pass)
            for md, per_pass in ((4, 1), (2, 2)) for lvl in (6, 5, 4, 3, 2)]


def phase_flow_kernels(torch, device):
    """The cost-volume kernel against correlation_plain (run on the card) at
    every shape of the full-width pass, on seeded N(0, 1) features. Both
    compute the same f32 products; the kernel sums the channels in order,
    the plain version in PyTorch's reduction order, so they differ by
    summation rounding: max abs error <= 1e-5 (values ~N(0, 1/C)).

    Bound per launch: the larger of 2*B*H*W*C*nd operations over
    PEAK_FP32_FLOPS and 4*(2*B*H*W*C + B*H*W*nd) bytes (f1 and f2 read once,
    the volume written once) over PEAK_BYTES_PER_S. One record per md, at
    its finest level (level 2, the largest)."""
    from acfm_video_3d_reconstruction_tpu_torch.flow import correlation_cuda as cc

    records = []
    pass_ms = pass_bound = 0.0
    for md, C, H, W, per_pass in _flow_shapes():
        g = torch.Generator(device=device).manual_seed(md * 1000 + C)
        f1, f2 = (torch.randn(FLOW_B, C, H, W, generator=g, device=device) for _ in range(2))
        kern = cc.correlation_cuda(f1, f2, md)
        torch.cuda.synchronize()
        err = (kern - cc.correlation_plain(f1, f2, md)).abs().max().item()
        nd = (2 * md + 1) ** 2
        what = f"correlation md={md} {FLOW_B}x{C}x{H}x{W}"
        log(f"[flow] {what}: kernel vs plain max abs err {err:.3g}")
        require(err <= 1e-5, f"{what}: kernel vs plain error {err} > 1e-5")
        ops = 2 * FLOW_B * H * W * C * nd
        nbytes = 4 * (2 * FLOW_B * H * W * C + FLOW_B * H * W * nd)
        ms = time_cuda(lambda: cc.correlation_cuda(f1, f2, md), 20)
        bound_ms, bound_by = _bound(ops, nbytes)
        log(f"[flow] {what}: kernel {ms:.5f} ms, bound {bound_ms:.5f} ms ({bound_by}), "
            f"{per_pass} per pass")
        pass_ms += ms * per_pass
        pass_bound += bound_ms * per_pass
        if H == FLOW_NET_HW[0] // 4:
            records.append(_record(
                f"correlation_md{md}", "correlation.cu", CORRELATION_TPU + ":29", ms,
                lambda: cc.correlation_plain(f1, f2, md), ops, nbytes, err, what))
    log(f"[flow] cost volumes of one pass at {FLOW_B} pairs: kernels {pass_ms:.4f} ms, "
        f"bound {pass_bound:.4f} ms ({100 * pass_bound / pass_ms:.1f}% of bound)")
    return records


def _flow_net(torch, device):
    """The frozen net with the seeded random weights of init_params."""
    from acfm_video_3d_reconstruction_tpu_torch.flow import maskflownet as mfn

    return mfn.build(mfn.init_params(torch.Generator().manual_seed(0)), device)


def _rel(torch, a, b) -> float:
    b = b.to(a.device)
    return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()


def phase_flow_small(torch, device):
    """The net at 64x128, B=2, from the same weights on the card (kernel) and
    on the CPU (plain version): every level's flow of both stages within
    vector relative error 1e-3 (PyTorch's own f32 convolutions on the card
    and on the CPU, summed in other orders)."""
    net_gpu, net_cpu = _flow_net(torch, device), _flow_net(torch, "cpu")
    rng = np.random.default_rng(3)
    im0, im1 = (torch.from_numpy(rng.random((2, 3, 64, 128), np.float32) - 0.5) for _ in range(2))
    with torch.no_grad():
        s_gpu, _, _ = net_gpu.MaskFlownet_S(im0.to(device), im1.to(device))
        s_cpu, _, _ = net_cpu.MaskFlownet_S(im0, im1)
        p_gpu, _ = net_gpu(im0.to(device), im1.to(device))
        p_cpu, _ = net_cpu(im0, im1)
    errs = [_rel(torch, a, b) for a, b in zip(s_gpu + p_gpu, s_cpu + p_cpu)]
    log(f"[flow] 64x128 net card vs cpu: flow6..flow2 rel err stage 1 "
        f"{[f'{e:.3g}' for e in errs[:5]]}, stage 2 {[f'{e:.3g}' for e in errs[5:]]}")
    require(max(errs) <= 1e-3, f"flow net card vs cpu: rel error {max(errs)} > 1e-3")


@contextlib.contextmanager
def plain_correlation():
    """Within the block the cost volume runs correlation_plain on CUDA
    tensors too (no kernel launch, no count): the flow path's reference."""
    from acfm_video_3d_reconstruction_tpu_torch.flow import correlation_cuda as cc

    kernel = cc.correlation_cuda
    cc.correlation_cuda = cc.correlation_plain
    try:
        yield
    finally:
        cc.correlation_cuda = kernel


def _conv_flops(torch, net, call) -> int:
    """Operations (an FMA counts two) of the net's convolutions, transposed
    and deformable convolutions in one call, counted by forward hooks."""
    from acfm_video_3d_reconstruction_tpu_torch.flow.maskflownet import DeformConv3x3

    total = 0

    def hook(mod, inputs, output):
        nonlocal total
        w = mod.weight
        if isinstance(mod, torch.nn.ConvTranspose2d):  # (Cin, Cout, kh, kw)
            total += 2 * inputs[0].numel() * w[0].numel()
        else:  # (Cout, Cin, kh, kw)
            total += 2 * output.numel() * w[0].numel()

    mods = [m for m in net.modules()
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, DeformConv3x3))]
    handles = [m.register_forward_hook(hook) for m in mods]
    try:
        call()
    finally:
        for h in handles:
            h.remove()
    return total


def phase_flow(torch, device, profile):
    """The main flow path and the flow CLI's path on the card."""
    from acfm_video_3d_reconstruction_tpu_torch.flow import infer

    net = _flow_net(torch, device)
    rng = np.random.default_rng(4)
    clips = torch.from_numpy(rng.random((FLOW_B, 2, IMG, IMG, 3), np.float32)).to(device)
    flow_fn = infer.make_flow_fn(net, IMG, FLOW_NET_HW)

    def call():
        return flow_fn({"img": clips})["optical_flows"]

    first = call()  # warm-up
    torch.cuda.synchronize()
    out, rate, spread, launches = _timed(
        torch, call, FLOW_WINDOWS, FLOW_CALLS, "make_flow_fn", batch=FLOW_B,
        shape=f"{IMG}^2 clips of 2, net {FLOW_NET_HW}", unit="pairs")
    n_calls = FLOW_WINDOWS * FLOW_CALLS
    require(launches == only(corr_md4=5 * n_calls, corr_md2=10 * n_calls),
            f"flow launches {launches} != 5 md=4 and 10 md=2 per call ({n_calls} calls)")
    require(tuple(out.shape) == (FLOW_B, 2, IMG, IMG, 2), f"flow shape {tuple(out.shape)}")
    require(bool(torch.isfinite(out).all()), "flow: not finite")
    require(not bool(out[:, 1].any()), "flow: the last slot is not zero")
    floor = _rel(torch, out, first)
    with plain_correlation():
        plain = call()
    rel = _rel(torch, out, plain)
    log(f"[flow] make_flow_fn kernel path vs correlation_plain: rel err {rel:.3g}; kernel path "
        f"vs itself {floor:.3g}; flow |dx|, |dy| means {out[:, 0].abs().mean((0, 1, 2)).tolist()}")
    require(rel <= 1e-4, f"flow kernel vs plain: rel error {rel} > 1e-4")
    flops = _conv_flops(torch, net, call)
    log(f"[flow] {flops / 1e12:.4f} TFLOP of convolutions per make_flow_fn call, "
        f"{flops * rate / FLOW_B / 1e12:.2f} TFLOP/s at the median window")
    if profile:
        _profile(torch, call, profile, "make_flow_fn", f"{FLOW_B} pairs, net {FLOW_NET_HW}")

    pair = torch.from_numpy(rng.random((2, 1) + NATIVE_HW + (3,), np.float32)).to(device)
    zero_launches()
    native = infer.predict_flow_native(net, pair[0], pair[1])
    torch.cuda.synchronize()
    native_launches = read_launches()
    log(f"[flow] predict_flow_native on 1 pair at {NATIVE_HW}: launches {native_launches}")
    require(native_launches == only(corr_md4=5, corr_md2=10),
            f"native launches {native_launches} != 5 md=4 and 10 md=2")
    require(tuple(native.shape) == (1,) + NATIVE_HW + (2,), f"native shape {native.shape}")
    require(bool(torch.isfinite(native).all()), "native flow: not finite")
    return rate, spread, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=None,
                    help="append torch.profiler tables of one eval step, one train step and "
                    "one make_flow_fn call here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from acfm_video_3d_reconstruction_tpu_torch.models.template import build_template
    from acfm_video_3d_reconstruction_tpu_torch.train import monocular

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}; conv nets bf16 autocast, "
        f"geometry f32")

    phase_build()
    records = phase_kernels(torch, device)
    phase_small(torch, device)

    t0 = time.perf_counter()
    template = build_template(subdivide=3, num_lbs=16, tex_size=6, num_kps=15)
    mods = monocular.build(_cfg(IMG, 200, 16, 15, 6, "bfloat16"), template, 0, device)
    batch = monocular.to_device_batch(mods, _bench_batch())
    log(f"[main] template + model built in {time.perf_counter() - t0:.2f} s")
    eval_fps, eval_spread, eval_launches = phase_eval(torch, mods, batch, args.profile)
    train_fps, train_spread, train_launches = phase_train(torch, mods, batch, args.profile)
    del mods, batch

    records += phase_flow_kernels(torch, device)
    phase_flow_small(torch, device)
    flow_pps, flow_spread, flow_launches = phase_flow(torch, device, args.profile)

    counter = {"raster_fwd_soft": "soft", "raster_fwd_hard": "hard",
               "raster_bwd_soft": "soft_bwd", "correlation_md4": "corr_md4",
               "correlation_md2": "corr_md2"}
    for r in records:
        r["launches"] = sum(launches[counter[r["name"]]]
                            for launches in (eval_launches, train_launches, flow_launches))
    n_eval, n_train = EVAL_WINDOWS * EVAL_STEPS, TRAIN_WINDOWS * TRAIN_STEPS
    n_flow = FLOW_WINDOWS * FLOW_CALLS
    log("[result] " + json.dumps({
        "eval_frames_per_s_median": eval_fps, "eval_frames_per_s_spread": eval_spread,
        "train_frames_per_s_median": train_fps, "train_frames_per_s_spread": train_spread,
        "flow_pairs_per_s_median": flow_pps, "flow_pairs_per_s_spread": flow_spread,
        "batch": B, "image_size": IMG, "eval_steps": n_eval, "train_steps": n_train,
        "flow_pairs_per_call": FLOW_B, "flow_net_hw": FLOW_NET_HW, "flow_calls": n_flow,
        "launches_per_eval_step": {k: v / n_eval for k, v in eval_launches.items()},
        "launches_per_train_step": {k: v / n_train for k, v in train_launches.items()},
        "launches_per_flow_call": {k: v / n_flow for k, v in flow_launches.items()}}))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
