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
  4b. driver: the monocular CLIs' train and evaluate on a CUB-format tree
     (tools/cub_fixture.py, 96 train and 24 test images of 300-400 px) at
     the CLI's defaults (the full-width bird model, f32), through the CUB
     dataset, the loader with native edt / boundaries (native/build.sh runs
     first), prefetch, the driver loop, the logger and the checkpoints: 8
     train steps with exactly 8 soft, 8 hard and 8 soft_bwd launches, finite
     metrics.jsonl records, the checkpoint files; 2 eval batches with
     exactly 2 soft and 2 hard launches and the reference-format line; the
     latest checkpoint restored into a fresh build gives the same eval step.
     Logs the driver's frames/s over steps 2-8, the loader's batches/s alone
     and the seconds of one checkpoint save.
  5. flow, the frozen two-stage MaskFlownet in f32 at full width, seeded
     random weights (flow/maskflownet.py::init_params):
     a. the cost-volume kernel against correlation_plain at the 10 distinct
        shapes of each pass that c and d run (384x768 with 12 pairs;
        448x1024 with one) (max abs error <= 1e-5), timed alone (device
        time), back to back and through its wrapper, with its launch plan,
        its plain version and its bound;
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
        (stretched to 448x1024): finite, 15 launches, and within relative
        error 1e-4 of the same call through correlation_plain.
  6. multiframe: camera-multiplex training as users run it, the CLI's
     `train` (cli/multiframe_main.py) at its defaults (the horse model: G 8
     hypotheses, batch 8 clips of 2 frames, 256², 642 vertices, 15
     handles, nz_feat 200, texture on, f32, the frozen flow net at 384x768
     with seeded random weights) on a TigDog-format tree from
     tools/tigdog_fixture.py (4 clips of 8 frames at 360x640), with the pose
     warm-up, the camera-embedding init and one epoch: 4 warm-up and 4
     train steps. Exactly 1 soft + 1 soft_bwd per warm-up step, 1 soft + 1
     hard + 1 soft_bwd per train step and 15 cost volumes per batch; the
     first step's bin_overflow_counts, time_per_iter, peak memory, the
     cost volume's launch_plan at 8 pairs; the latest checkpoint restored
     into a fresh build gives the same loss matrix bit for bit; one train
     step's forward and backward through the kernels against the same
     through the plain rasterizer and correlation_plain (deterministic
     algorithms, so the floor is 0: loss matrix, probs and every gradient
     within 1e-4, mean_v, behind the solve's adjoint, within 1e-3); each
     kernel alone at the step's 128 views and 8 pairs with its bound; with
     --profile, device ms of one flow call and one train step by kind.
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

from acfm_video_3d_reconstruction_tpu_torch.ops.timing import time_cuda, time_device

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
# predict_flow_native stretches a frame to the next multiple of 64
NATIVE_NET_HW = tuple(-(-n // 64) * 64 for n in NATIVE_HW)
# the driver phase's CUB tree: one epoch of 8 steps at batch 12, 2 eval
# batches, raw images large enough that crop and resize really run
DRIVER_TRAIN, DRIVER_TEST, DRIVER_RAW = 96, 24, (300, 400)
LOADER_EPOCHS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


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


def _check_metrics_jsonl(path, n):
    with open(path) as fh:
        recs = [json.loads(line) for line in fh if line.strip()]
    require(len(recs) == n, f"driver: {len(recs)} metrics.jsonl records, expected {n}")
    for r in recs:
        bad = [k for k, v in r.items() if not np.isfinite(v)]
        require(not bad, f"driver: non-finite {bad} at step {r['step']}")
    return recs


def phase_driver(torch, device, card):
    """The monocular trainer and evaluator as users run them: the CLIs'
    `train` and `evaluate` on a CUB-format tree (tools/cub_fixture.py) at
    the CLI's defaults, the full-width bird model (batch 12, 256², subdivide
    3, 15 handles, 15 keypoints, nz_feat 200, tex 6, texture on, symmetric,
    f32 nets, SfM mean-shape keypoints from the tree), through the CUB
    dataset, the loader (native edt / boundaries, built here), prefetch, the
    driver loop, the logger and the checkpoints.

    Train one epoch of DRIVER_TRAIN images (8 steps): exactly 8 soft, 8 hard
    and 8 soft_bwd launches and no cost volume; every metrics.jsonl record
    finite; opts.log, pred_net_latest.pth and pred_net_1.pth written.
    Evaluate the test split from pred_net_latest.pth: 2 batches, exactly 2
    soft and 2 hard launches, the reference-format line. Restore latest
    into a fresh build: the same state, and its eval step bit-identical to
    the trained modules' (or within the trained modules' own run-to-run
    difference). Logs the driver loop's frames/s over steps 2-8 (from
    metrics.jsonl's time_per_iter: host clock, each step ending where the
    logger reads its metrics off the card), the loader's batches/s alone and
    the seconds of one checkpoint save. The 8 steps start with up to ~5
    batches queued (the loader's and prefetch's queues fill while the model
    builds), so the loader's own rate is also timed alone, over
    LOADER_EPOCHS epochs in one stream."""
    import io
    import os
    import re
    import tempfile

    from tools.cub_fixture import write_cub_tree

    here = os.path.dirname(os.path.abspath(__file__))
    build = subprocess.run(["sh", os.path.join(here, "native", "build.sh")],
                           capture_output=True, text=True, timeout=300)
    from acfm_video_3d_reconstruction_tpu_torch.cli import monocular_evaluate, monocular_main
    from acfm_video_3d_reconstruction_tpu_torch.data import native
    from acfm_video_3d_reconstruction_tpu_torch.data.base import ConcatDataset
    from acfm_video_3d_reconstruction_tpu_torch.data.cub import CUBDataset
    from acfm_video_3d_reconstruction_tpu_torch.data.loader import DataLoader
    from acfm_video_3d_reconstruction_tpu_torch.train import checkpoints, monocular

    log(f"[driver] native/build.sh exit {build.returncode}: {build.stdout.strip()} "
        f"{build.stderr.strip()[-300:]}; edt / boundaries path: "
        f"{'native' if native.available() else 'numpy fallback'}")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root, ckdir = os.path.join(tmp, "cub"), os.path.join(tmp, "snapshots")
        t0 = time.perf_counter()
        write_cub_tree(root, DRIVER_TRAIN, DRIVER_TEST, DRIVER_RAW, seed=0)
        log(f"[driver] CUB tree: {DRIVER_TRAIN} train + {DRIVER_TEST} test images of "
            f"{DRIVER_RAW[0]}-{DRIVER_RAW[1]} px written in {time.perf_counter() - t0:.2f} s")
        common = ["--cub_dir", root, "--cub_cache_dir", root, "--checkpoint_dir", ckdir,
                  "--name", "smoke", "--device", str(device)]
        args = monocular_main.parse(common + ["--num_epochs", "1", "--save_epoch_freq", "1",
                                              "--log_every", "1"])
        cfg = monocular_main.build_cfg(args)
        t0 = time.perf_counter()
        template = monocular_main.build_cub_template(cfg, args)
        dataset = CUBDataset(root, root, split=args.split, img_size=args.img_size)
        log(f"[driver] template ({template.num_verts} verts, {template.num_faces} faces) and "
            f"dataset built in {time.perf_counter() - t0:.2f} s")

        # the loader alone, one stream of LOADER_EPOCHS epochs: its rate after
        # the first batch is what a long epoch would get from it
        t0 = time.perf_counter()
        arrivals = [time.perf_counter() for _ in DataLoader(
            ConcatDataset([dataset] * LOADER_EPOCHS), args.batch_size, shuffle=True, seed=1)]
        loader_bps = (len(arrivals) - 1) / (arrivals[-1] - arrivals[0])
        log(f"[driver] loader alone (CUB crop/resize/mirror + edt/boundaries, B="
            f"{args.batch_size} {args.img_size}^2): {len(arrivals)} batches, the first after "
            f"{arrivals[0] - t0:.4f} s, then {loader_bps:.3f} batches/s "
            f"({loader_bps * args.batch_size:.2f} frames/s)")

        zero_launches()
        t0 = time.perf_counter()
        mods, opt = monocular_main.train(cfg, template, dataset, args)
        train_launches = read_launches()
        t_train = time.perf_counter() - t0
        n_steps = DRIVER_TRAIN // args.batch_size
        require(train_launches == only(soft=n_steps, hard=n_steps, soft_bwd=n_steps),
                f"driver train launches {train_launches} != one soft, hard and soft_bwd per "
                f"step ({n_steps} steps)")
        save_dir = os.path.join(ckdir, "smoke")
        recs = _check_metrics_jsonl(os.path.join(save_dir, "metrics.jsonl"), n_steps)
        for f in ("opts.log", "pred_net_latest.pth", "pred_net_1.pth"):
            require(os.path.exists(os.path.join(save_dir, f)), f"driver: {f} not written")
        # --log_every 1: each record's time_per_iter is the host time since
        # the last record, ending where the logger reads the step's metrics
        # off the card (after the step's update in stream order)
        step_s = [r["time_per_iter"] for r in recs[1:]]
        fps = len(step_s) * args.batch_size / sum(step_s)
        t_save = time.perf_counter()
        checkpoints.save(ckdir, "smoke", "latest", mods, opt)
        save_s = time.perf_counter() - t_save
        log(f"[driver] train: {n_steps} steps in {t_train:.2f} s (build, loader, saves "
            f"included); steps 2-{n_steps}: {fps:.2f} frames/s "
            f"({1e3 * sum(step_s) / len(step_s):.2f} ms/step), step times {step_s} s; "
            f"launches {train_launches}; one checkpoint save {save_s:.4f} s; total_loss "
            f"{recs[0]['total_loss']:.6g} -> {recs[-1]['total_loss']:.6g}; card {card}")

        eval_args = monocular_evaluate.parse(common + ["--split", "test"])
        eval_cfg = monocular_main.build_cfg(eval_args)
        eval_template = monocular_main.build_cub_template(eval_cfg, eval_args)
        test_set = CUBDataset(root, root, split="test", img_size=args.img_size,
                              jitter_frac=0.0)
        out = io.StringIO()
        zero_launches()
        with contextlib.redirect_stdout(out):
            stats = monocular_evaluate.evaluate(eval_cfg, eval_template, test_set, eval_args)
        eval_launches = read_launches()
        n_eval = DRIVER_TEST // args.batch_size
        require(eval_launches == only(soft=n_eval, hard=n_eval),
                f"driver eval launches {eval_launches} != one soft and one hard per batch "
                f"({n_eval} batches)")
        lines = out.getvalue().strip().splitlines()
        require(bool(re.fullmatch(r"mean iou \S+, pck\.1 \S+, pck\.15 \S+", lines[-1])),
                f"driver eval: last line {lines[-1]!r}")
        res = stats.results()
        require(all(np.isfinite(v) for v in res.values()), f"driver eval: {res}")
        log(f"[driver] evaluate (test split, {n_eval} batches): {lines[-1]!r}; launches "
            f"{eval_launches}")

        fresh = monocular.build(mods.cfg, mods.template, seed=1, device=device)
        step_count = checkpoints.restore(ckdir, "smoke", "latest", fresh)
        require(step_count == n_steps, f"driver restore: step {step_count} != {n_steps}")
        trained = mods.model.state_dict()
        for k, v in fresh.model.state_dict().items():
            require(torch.equal(v, trained[k]), f"driver restore: {k} differs")
        batch = next(iter(DataLoader(test_set, args.batch_size, shuffle=False)))
        keys = ("mask_pred", "kp_pred", "pred_v", "cam_pred")

        def outputs(m):
            aux = monocular.make_eval_step(m)(batch)
            return [aux[k] for k in keys] + [v for _, v in sorted(aux["metrics"].items())]

        a, a2, b = outputs(mods), outputs(mods), outputs(fresh)
        diff = max((x - y).abs().max().item() for x, y in zip(a, b))
        floor = max((x - y).abs().max().item() for x, y in zip(a, a2))
        require(diff == 0 or diff <= floor,
                f"driver restore: eval outputs differ by {diff} (run-to-run {floor})")
        log(f"[driver] restore of latest into a fresh build: state equal; eval step vs the "
            f"trained modules max abs diff {diff:.3g} (trained vs itself {floor:.3g})")
    log(f"[driver] phase {time.perf_counter() - t_phase:.2f} s")
    return {"frames_per_s": fps, "loader_batches_per_s": loader_bps,
            "save_s": save_s, "train_launches": train_launches,
            "eval_launches": eval_launches}


# the multiframe phase: the CLI's defaults on a TigDog-format tree of
# MF_VIDEOS clips of MF_FRAMES frames at MF_RAW (tools/tigdog_fixture.py):
# 32 frames, so 4 steps of batch 8 an epoch
MF_VIDEOS, MF_FRAMES, MF_RAW = 4, 8, (360, 640)
# kernel names of one train step's profile, by kind (first match wins)
MF_KINDS = (("rasterizer kernels", ("raster_fwd_kernel", "raster_bwd")),
            ("cost volume", ("corr_tile", "corr_split")),
            ("Adam", ("multi_tensor_apply", "adam")),
            ("solve (Cholesky)", ("potrf", "potrs", "trsm", "cholesky", "syrk")),
            ("bilinear upsampling backward (LPIPS)", ("upsample_bilinear2d_backward",)),
            ("convolutions and matmuls (im2col, FFT included)",
             ("conv", "gemm", "cutlass", "xmma", "sm90", "wgrad", "dgrad", "implicit",
              "winograd", "fft", "im2col", "col2im", "complex", "nhwctonchw", "nchwtonhwc")))


def _mf_grads(mods):
    """Every gradient of one multiframe forward+backward: the model's
    parameters (zeros where none reached them, as the step's Adam sees
    them) and the multiplex tables'."""
    import torch

    out = {}
    for prefix, module in (("", mods.model), ("mpx.", mods.mpx)):
        for k, p in module.named_parameters():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            out[prefix + k] = g.detach().float().cpu()
    return out


# mean_v's gradient leaves the screened-Poisson solve through its adjoint,
# whose f32 rounding the cot Laplacian's near-nullspace amplifies (at zero
# handle offsets the exact adjoint is the identity): held at the bound of
# tests/test_torch_port_train.py::test_solve_gradient_matches_jax for two
# f32 roundings of the solve's gradient. The solve's input gradient, pred_v's,
# is held at the kernels' bound with every other tensor.
SOLVE_FED = {"mean_v": 1e-3}


def _mf_grad_errors(g_a, g_b, what, bound):
    """_grad_errors over the multiframe gradients (SOLVE_FED's tensors at
    their own bound); a tensor whose gradient is exactly zero on both sides
    (no loss term reaches it) passes. Logs the four largest errors."""
    import torch

    errs = {}
    for k, gb in g_b.items():
        ref = torch.linalg.vector_norm(g_b[NOISE_SCALE.get(k, k)])
        diff = torch.linalg.vector_norm(g_a[k] - gb)
        errs[k] = 0.0 if diff == 0 else (diff / ref).item() if ref > 0 else float("inf")
    ranked = sorted(errs.items(), key=lambda kv: -kv[1])
    log(f"[multiframe] {what}: largest gradient rel errors "
        + ", ".join(f"{k} {v:.3g}" for k, v in ranked[:4]))
    over = [(k, v) for k, v in ranked if v > SOLVE_FED.get(k, bound)]
    require(not over, f"{what}: gradient rel errors {over} over their bounds ({bound}, "
            f"{SOLVE_FED})")
    return next((k, v) for k, v in ranked if k not in SOLVE_FED), \
        {k: errs[k] for k in SOLVE_FED if k in errs}


def _mf_kernels(torch, proj, faces, S, net_hw, nb):
    """Each kernel alone at the multiframe step's shapes, with its bound:
    the rasterizer kernels on the first train step's projected views (their
    C entries on counts and outputs made once, time_cuda), the bytes each
    must move (as phase_kernels counts them) and, for the operations, every
    (pixel, slot) pair inside the cull windows at the inside and distance
    tests' cost (OPS_TEST) plus OPS_PER_FACE per (view, face), which is
    less than the work (pairs in radius cost OPS_PER_PAIR); the cost
    volume's pass at `nb` pairs (time_device per shape) against its bytes.
    Returns {name: (ms, bound_ms, bound_by)}."""
    from acfm_video_3d_reconstruction_tpu_torch.flow import correlation_cuda as cc
    from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer as ras
    from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer_cuda as rc

    V = proj.shape[0]
    K = rc.auto_K(faces.shape[0], S, ras.DEFAULT_K)
    out = {}
    for mode, soft, blur in (("soft", True, rc.BLUR_RADIUS), ("hard", False, 0.0),
                             ("soft_bwd", True, rc.BLUR_RADIUS)):
        table, idx, th, tw = rc.bin_faces(proj, faces, S, K, blur)
        counts = (idx >= 0).sum(-1, dtype=torch.int32)
        needed = rc.cull_pair_counts(rc.cull_windows(table, S, th, tw, blur, soft), idx, th,
                                     tw)["needed"]
        ops = needed * OPS_TEST[mode] + V * faces.shape[0] * OPS_PER_FACE[mode]
        if mode == "soft_bwd":
            dS = torch.ones(V, S, S, device=proj.device)
            grad = torch.empty_like(table)
            nbytes = 2 * table.numel() * 4 + counts.numel() * 4 + dS.numel() * 4
            ms = time_cuda(lambda: rc.launch_bwd(rc.bwd_entry(), table, counts, dS, grad, S, th,
                                                 tw, rc.SIGMA, blur), 10)
        else:
            frags = rc.forward_cuda(table, idx, S, th, tw, rc.SIGMA, blur, soft)
            nbytes = (table.numel() + idx.numel() + counts.numel() + 5 * V * S * S) * 4
            ms = time_cuda(lambda: rc.launch_fwd(rc.fwd_entry(), table, idx, counts, frags, S,
                                                 th, tw, rc.SIGMA, blur, soft), 10)
        out[mode] = (ms, *_bound(ops, nbytes))
        log(f"[multiframe] {mode} at {V} views: kernel alone {ms:.4f} ms, bound "
            f"{out[mode][1]:.4f} ms ({out[mode][2]}; {nbytes / 1e6:.1f} MB, {needed} needed "
            f"pairs)")
    fn = cc.entry()
    pass_ms = pass_bound = 0.0
    for md, C, H, W, per_pass in _flow_shapes(net_hw):
        f1, f2 = (torch.randn(nb, C, H, W, device=proj.device) for _ in range(2))
        vol = cc.correlation_cuda(f1, f2, md)
        nd = (2 * md + 1) ** 2
        pass_ms += per_pass * time_device(lambda: cc.launch(fn, f1, f2, vol, md), 50)
        pass_bound += per_pass * _bound(2 * nb * H * W * C * nd,
                                        4 * (2 * nb * H * W * C + nb * H * W * nd))[0]
    out["cost volume pass"] = (pass_ms, pass_bound, "bytes")
    log(f"[multiframe] cost volumes of one pass at {nb} pairs (15 launches), alone "
        f"{pass_ms:.4f} ms, bound {pass_bound:.4f} ms (bytes)")
    return out


def _kinds(events) -> dict:
    """Device ms of a profile's kernels by MF_KINDS, the rest as "other"."""
    out = {kind: 0.0 for kind, _ in MF_KINDS}
    out["other (elementwise, reductions, indexing; the bin pass)"] = 0.0
    for e in events:
        ms = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e3
        if ms <= 0:
            continue
        name = e.key.lower()
        kind = next((k for k, keys in MF_KINDS if any(x in name for x in keys)),
                    "other (elementwise, reductions, indexing; the bin pass)")
        out[kind] += ms
    return out


def _mf_profile(torch, call, what, path):
    """Device ms of one call by kind (torch.profiler), its 12 largest
    kernels, appended to `path` when given."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None and "cuda" in str(e.device_type).lower()]
    kinds = _kinds(events)
    total = sum(kinds.values())
    top = sorted(events, key=lambda e: -getattr(e, "self_device_time_total",
                                                getattr(e, "self_cuda_time_total", 0)))[:12]
    log(f"[multiframe] profile of {what}: {total:.3f} ms of device time; by kind "
        + json.dumps({k: round(v, 4) for k, v in kinds.items()}))
    for e in top:
        t = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e3
        log(f"[multiframe]   {t:9.4f} ms x{e.count:4d}  {e.key[:110]}")
    if path:
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
        with open(path, "a") as fh:
            fh.write(f"==== {what} ====\n{table}\n")
    return total, kinds


def phase_multiframe(torch, device, card, profile=None, **overrides):
    """Multiframe camera-multiplex training as users run it: the CLI's
    `train` (cli/multiframe_main.py) at its defaults, the full-width horse
    model (G 8, B 8, T 2, 256², icosphere subdivide 3, 15 handles, nz_feat
    200, tex 6, texture on, f32 nets, TF32 off), the frozen two-stage
    MaskFlownet at 384x768 with seeded random weights (--flow_random_init),
    on a TigDog-format tree from tools/tigdog_fixture.py; with --warmup
    --num_reps 1 --init_camera_emb, one epoch. `overrides` change options
    (the CPU rehearsal shrinks the model and the flow net).

    Launches over the run, exactly: per warm-up step 1 soft + 1 soft_bwd,
    per train step 1 soft + 1 hard + 1 soft_bwd, per batch of either (the
    flow pass of prep) 5 md=4 + 10 md=2 cost volumes; the init pass none.
    Every metrics.jsonl record finite; the warmup, latest and epoch-1
    checkpoints written. Logs bin_overflow_counts of the first warm-up and
    train step's views, the steps' time_per_iter, the run's peak memory,
    the cost volume's launch_plan at the 8-pair shapes. Then, on the first
    train batch, from the trained state: the latest checkpoint restored
    into a fresh build gives the same loss matrix bit for bit (eval mode,
    beside the trained modules' own run-to-run difference); one train
    step's forward and backward through the kernels against the same
    through the plain rasterizer on flows through correlation_plain, under
    deterministic algorithms (deterministic_algorithms: the kernel path
    then repeats bit for bit; the floor with PyTorch's default algorithms
    is logged beside it): the loss matrix and probs within rel 1e-4 per
    entry, each gradient tensor and pred_v's within vector relative error
    1e-4 (NOISE_SCALE's against their neighbour's scale; zero on both sides
    passes), SOLVE_FED's at their bound, beside the solve adjoint's own f32
    rounding; the step's peak memory; each kernel alone at the step's
    shapes with its bound (_mf_kernels); with `profile`, device ms of one
    flow call and of one train step by kind, the bin pass and LPIPS alone.
    """
    import os
    import tempfile

    from tools.tigdog_fixture import write_tigdog_tree

    from acfm_video_3d_reconstruction_tpu_torch.cli import multiframe_main
    from acfm_video_3d_reconstruction_tpu_torch.flow import correlation_cuda as cc
    from acfm_video_3d_reconstruction_tpu_torch.flow.infer import NET_H, NET_W
    from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer as ras
    from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer_cuda as rc
    from acfm_video_3d_reconstruction_tpu_torch.train import checkpoints
    from acfm_video_3d_reconstruction_tpu_torch.train import multiframe as mf

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_tigdog_tree(os.path.join(tmp, "pkls"), "horse", MF_VIDEOS, MF_FRAMES, MF_RAW)
        log(f"[multiframe] TigDog tree: {MF_VIDEOS} clips of {MF_FRAMES} frames at "
            f"{MF_RAW[0]}x{MF_RAW[1]} written in {time.perf_counter() - t0:.2f} s")
        o = multiframe_main.default_opts()
        o.update(name="smoke", root_dir=os.path.join(tmp, "pkls"),
                 tmp_dir=os.path.join(tmp, "cache"), checkpoint_dir=os.path.join(tmp, "snap"),
                 flow_random_init=True, warmup=True, num_reps=1, init_camera_emb=True,
                 num_epochs=1, save_epoch_freq=1, log_every=1, device=str(device))
        o.update(overrides)
        G, B, T, S = o["num_guesses"], o["batch_size"], o["num_frames"], o["img_size"]
        net_hw = o.get("flow_net_hw", (NET_H, NET_W))

        # bin overflow of the first warm-up and train step's views; the
        # first train batch and the modules, for the checks after the run
        overflow, captured = {}, {}

        def watch(fn, what):
            def wrapped(verts, faces, *args, **kw):
                if what not in overflow:
                    K = rc.auto_K(faces.shape[0], S, ras.DEFAULT_K)
                    ovf = rc.bin_overflow_counts(verts.detach(), faces, S, K)
                    overflow[what] = (tuple(verts.shape), K, int(ovf.max()), int((ovf > 0).sum()),
                                      int(ovf.sum()))
                    captured[what] = verts.detach()
                return fn(verts, faces, *args, **kw)
            return wrapped

        make_train_step = mf.make_train_step

        def capturing_train_step(mods, **kw):
            step = make_train_step(mods, **kw)

            def run(batch):
                captured.setdefault("batch", batch)
                captured["mods"] = mods
                return step(batch)
            return run

        swaps = ((ras, "soft_silhouette_vis", watch(ras.soft_silhouette_vis, "warm-up")),
                 (ras, "soft_silhouette_vis_tex", watch(ras.soft_silhouette_vis_tex, "train")),
                 (mf, "make_train_step", capturing_train_step))
        saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
        for m, n, f in swaps:
            setattr(m, n, f)
        try:
            torch.cuda.reset_peak_memory_stats()
            zero_launches()
            t0 = time.perf_counter()
            mods = multiframe_main.train(o)
            torch.cuda.synchronize()
            t_train = time.perf_counter() - t0
            launches = read_launches()
        finally:
            for m, n, f in saved:
                setattr(m, n, f)
        peak_run = torch.cuda.max_memory_allocated()
        save_dir = os.path.join(o["checkpoint_dir"], "smoke")
        with open(os.path.join(save_dir, "metrics.jsonl")) as fh:
            recs = [json.loads(line) for line in fh if line.strip()]
        warm = [r for r in recs if "warmup_loss" in r]
        main_recs = [r for r in recs if "total_loss" in r]
        n_w, n_t = len(warm), len(main_recs)
        require(n_w > 0 and n_t > 0 and n_w + n_t == len(recs),
                f"multiframe: {n_w} warm-up and {n_t} train records of {len(recs)}")
        for r in recs:
            bad = [k for k, v in r.items() if not np.isfinite(v)]
            require(not bad, f"multiframe: non-finite {bad} at step {r['step']}")
        for label in ("warmup", "latest", 1):
            require(checkpoints.exists(o["checkpoint_dir"], "smoke", label),
                    f"multiframe: checkpoint {label} not written")
        n_b = n_w + n_t
        require(launches == only(soft=n_b, hard=n_t, soft_bwd=n_b, corr_md4=5 * n_b,
                                 corr_md2=10 * n_b),
                f"multiframe launches {launches} != per warm-up step 1 soft + 1 soft_bwd, per "
                f"train step 1 soft + 1 hard + 1 soft_bwd, per batch 15 cost volumes "
                f"({n_w} warm-up and {n_t} train steps)")
        require(main_recs[0]["of_loss"] > 0, "multiframe: of_loss is zero")
        log(f"[multiframe] train (CLI defaults G={G} B={B} T={T} {S}^2, "
            f"{mods.template.num_verts} verts, {mods.template.num_faces} faces, flow net "
            f"{net_hw}): {n_w} warm-up + {n_t} train steps in {t_train:.2f} s (build, fixture "
            f"cache, init pass and saves included); launches {launches}; per warm-up step "
            f"1 soft + 1 soft_bwd, per train step 1 soft + 1 hard + 1 soft_bwd, 15 cost volumes "
            f"per batch; peak memory of the run {peak_run / 2**30:.3f} GiB; card {card}")
        log(f"[multiframe] bin_overflow_counts (views shape, K, max per bin, bins over, faces "
            f"dropped): {json.dumps(overflow)}")
        log("[multiframe] time_per_iter warm-up " + json.dumps([r["time_per_iter"] for r in warm])
            + ", train " + json.dumps([r["time_per_iter"] for r in main_recs]))
        log("[multiframe] first train record " + json.dumps(main_recs[0]))
        for md, C, H, W, per_pass in _flow_shapes(net_hw):
            log(f"[multiframe] launch_plan md={md} {B}x{C}x{H}x{W} (x{per_pass}): "
                f"{cc.launch_plan(B, C, H, W, md)}")

        batch, mods = captured["batch"], captured["mods"]
        k = G  # drop_hypothesis is off: every hypothesis, every epoch

        def loss_matrix(m):
            with torch.no_grad():
                return mf.forward(m, batch, k=k, train=False)[1]["loss_matrix"]

        fresh = mf.build(mods.cfg, mods.template, mods.mpx.probs.shape[0], seed=1,
                         device=device)
        step_count = checkpoints.restore_multiframe(o["checkpoint_dir"], "smoke", "latest",
                                                    fresh)
        require(step_count == n_b, f"multiframe restore: step {step_count} != {n_b}")
        for mine, theirs in ((mods.model, fresh.model), (mods.mpx, fresh.mpx)):
            ref = mine.state_dict()
            for name, v in theirs.state_dict().items():
                require(torch.equal(v, ref[name]), f"multiframe restore: {name} differs")
        a, a2, b = loss_matrix(mods), loss_matrix(mods), loss_matrix(fresh)
        diff, floor = (a - b).abs().max().item(), (a - a2).abs().max().item()
        require(diff == 0 or diff <= floor,
                f"multiframe restore: loss matrix differs by {diff} (run-to-run {floor})")
        log(f"[multiframe] restore of latest into a fresh build: state equal; loss matrix "
            f"({tuple(a.shape)}) vs the trained modules max abs diff {diff:.3g} (trained vs "
            f"itself {floor:.3g})")
        del fresh

        # one train step's forward + backward, kernels vs plain, from one state
        state = copy.deepcopy(mods.model.state_dict())
        mpx_state = copy.deepcopy(mods.mpx.state_dict())
        flow_fn = multiframe_main.make_flow_fn_from_opts(o, S, device)
        upload = {key: v for key, v in batch.items() if key != "optical_flows"}

        def one_step(raster_plain, corr_plain, deterministic=True):
            mods.model.load_state_dict(state)
            mods.mpx.load_state_dict(mpx_state)
            mods.model.zero_grad(set_to_none=True)
            mods.mpx.zero_grad(set_to_none=True)
            with contextlib.ExitStack() as stack:
                if deterministic:
                    stack.enter_context(deterministic_algorithms(torch))
                if corr_plain:
                    stack.enter_context(plain_correlation())
                db = flow_fn(dict(upload))
                if raster_plain:
                    stack.enter_context(plain_rasterizer())
                loss, aux = mf.forward(mods, db, k=k, train=True, drop_deform=True)
                aux["pred_v"].retain_grad()
                loss.backward()
            torch.cuda.synchronize()
            grads = _mf_grads(mods)
            grads["pred_v"] = aux["pred_v"].grad.detach().cpu()
            return aux["loss_matrix"].detach(), aux["probs"], grads

        torch.cuda.reset_peak_memory_stats()
        runs = {"kernels": one_step(False, False)}
        peak_step = torch.cuda.max_memory_allocated()
        runs["kernels again"] = one_step(False, False)
        runs["kernels, PyTorch's default algorithms"] = one_step(False, False,
                                                                deterministic=False)
        runs["plain rasterizer"] = one_step(True, False)
        runs["plain rasterizer and correlation"] = one_step(True, True)
        mods.model.load_state_dict(state)
        mods.mpx.load_state_dict(mpx_state)

        def rel_entries(x, y):
            return ((x - y).abs() / y.abs().clamp_min(1e-12)).max().item()

        ref = runs["kernels"]
        errs = {}
        for name, run in runs.items():
            if name != "kernels":
                errs[name] = (rel_entries(run[0], ref[0]), rel_entries(run[1], ref[1]),
                              *_mf_grad_errors(run[2], ref[2], f"{name} vs kernels",
                                               float("inf")))
                log(f"[multiframe] one train step from identical state (k={k}, {k * B * T} "
                    f"views), {name} vs kernels: loss matrix rel {errs[name][0]:.3g}, probs rel "
                    f"{errs[name][1]:.3g}, worst gradient rel {errs[name][2][1]:.3g} "
                    f"({errs[name][2][0]}), {errs[name][3]}")
        # the solve adjoint's own f32 rounding on mean_v: at zero handle
        # offsets the exact adjoint maps pred_v's gradient to its sum over views
        with torch.enable_grad():
            m = mods.model.get_mean_shape().detach().requires_grad_(True)
            v = mf.screened_poisson_solve(
                m, mods.model.get_lbs().detach(),
                torch.zeros(B * T, mods.template.num_lbs, 3, device=device),
                mf.cot_laplacian(m.detach(), mods.cot))
            (g_solve,) = torch.autograd.grad(v, m, ref[2]["pred_v"].to(device))
        exact = ref[2]["pred_v"].sum(0).to(device)
        solve_floor = (torch.linalg.vector_norm(g_solve - exact)
                       / torch.linalg.vector_norm(exact)).item()
        lm_err, p_err, worst, solve_fed = errs["plain rasterizer and correlation"]
        log(f"[multiframe] kernels vs plain: {solve_fed} against {SOLVE_FED} (the solve "
            f"adjoint's own f32 rounding on pred_v's gradient: rel {solve_floor:.3g}); every "
            f"other gradient within 1e-4, worst {worst[1]:.3g} ({worst[0]})")
        _mf_grad_errors(runs["plain rasterizer and correlation"][2], ref[2],
                        "kernels vs plain, held", 1e-4)
        require(lm_err <= 1e-4, f"multiframe kernels vs plain: loss matrix rel {lm_err} > 1e-4")
        require(p_err <= 1e-4, f"multiframe kernels vs plain: probs rel {p_err} > 1e-4")
        log(f"[multiframe] peak memory of the step {peak_step / 2**30:.3f} GiB")

        prof = {}
        if profile is not None:
            step = make_train_step(mods, k=k)
            step(batch)  # warm-up of the step's allocations
            prof["flow"] = _mf_profile(torch, lambda: flow_fn(dict(upload)),
                                       f"one flow call ({B} pairs, net {net_hw})", profile)
            prof["train"] = _mf_profile(torch, lambda: step(batch),
                                        f"one train step (k={k}, {k * B * T} views)", profile)
            proj = captured["train"]  # the first train step's projected views
            K = rc.auto_K(mods.faces.shape[0], S, ras.DEFAULT_K)
            bin_ms = {m: time_cuda(lambda: rc.bin_faces(proj, mods.faces, S, K, blur), 5)
                      for m, blur in (("soft", rc.BLUR_RADIUS), ("hard", 0.0))}
            log(f"[multiframe] bin pass alone at the step's {proj.shape[0]} views: "
                + json.dumps(bin_ms) + " ms")
            prof["bin_ms"] = bin_ms
            if mods.lpips is not None:
                from acfm_video_3d_reconstruction_tpu_torch.models.lpips import (
                    perceptual_texture_loss)

                n = 2 * k * B * T  # [rendered; mirrored] textures of every view
                g = torch.Generator(device=device).manual_seed(6)
                x = torch.rand(n, S, S, 3, device=device, generator=g, requires_grad=True)
                y = torch.rand(n, S, S, 3, device=device, generator=g)
                m = (torch.rand(n, S, S, device=device, generator=g) > 0.5).float()

                def lpips_step():
                    perceptual_texture_loss(mods.lpips, x, y, m, reduce=False).sum().backward()

                prof["lpips_ms"] = time_cuda(lpips_step, 3)
                log(f"[multiframe] LPIPS alone, forward and input backward over the step's {n} "
                    f"images: {prof['lpips_ms']:.3f} ms")
        kernels = _mf_kernels(torch, captured["train"], mods.faces, S, net_hw, B)
    log(f"[multiframe] phase {time.perf_counter() - t_phase:.2f} s")
    return {"launches": launches, "warmup_steps": n_w, "train_steps": n_t,
            "time_per_iter_train": [r["time_per_iter"] for r in main_recs],
            "peak_run_gib": peak_run / 2**30, "peak_step_gib": peak_step / 2**30,
            "overflow": overflow, "profile": prof, "kernels": kernels}


def _flow_shapes(net_hw):
    """The cost volume's distinct (md, C, H, W) of one pass of the net at
    net_hw, finest last per md, with its launches per two-stage pass:
    stage 1 one per level at md=4, stage 2 two per level (corru, corrv) at
    md=2."""
    from acfm_video_3d_reconstruction_tpu_torch.flow.maskflownet import PYR_CH

    nh, nw = net_hw
    return [(md, PYR_CH[lvl - 1], nh >> lvl, nw >> lvl, per_pass)
            for md, per_pass in ((4, 1), (2, 2)) for lvl in (6, 5, 4, 3, 2)]


def phase_flow_kernels(torch, device):
    """The cost-volume kernel against correlation_plain (run on the card) at
    every shape of the two passes that the flow paths run: make_flow_fn's
    (FLOW_B pairs, net at FLOW_NET_HW) and predict_flow_native's (one pair,
    net at NATIVE_NET_HW), on seeded N(0, 1) features. Both compute the
    same f32 products; the kernel sums the channels in order, the plain
    version in PyTorch's reduction order, so they differ by summation
    rounding: max abs error <= 1e-5 (values ~N(0, 1/C)).

    Each shape is timed three ways: the kernel alone (correlation_cuda.launch
    on inputs and an output made once, 50 launches queued behind a spin of
    the card: time_device), which the records and the pass totals keep; the
    same launches back to back from the host (time_cuda), which the host's
    cost per launch can pace; and the wrapper call (which also allocates its
    output each time).
    Bound per launch: the larger of 2*B*H*W*C*nd operations over
    PEAK_FP32_FLOPS and 4*(2*B*H*W*C + B*H*W*nd) bytes (f1 and f2 read once,
    the volume written once) over PEAK_BYTES_PER_S. One record per md, at
    make_flow_fn's finest level (level 2, the largest)."""
    from acfm_video_3d_reconstruction_tpu_torch.flow import correlation_cuda as cc

    records = []
    fn = cc.entry()
    for path, nb, net_hw in (("make_flow_fn", FLOW_B, FLOW_NET_HW),
                             ("predict_flow_native", 1, NATIVE_NET_HW)):
        pass_ms = pass_host_ms = pass_call_ms = pass_bound = 0.0
        for md, C, H, W, per_pass in _flow_shapes(net_hw):
            g = torch.Generator(device=device).manual_seed(md * 1000 + C)
            f1, f2 = (torch.randn(nb, C, H, W, generator=g, device=device) for _ in range(2))
            kern = cc.correlation_cuda(f1, f2, md)
            torch.cuda.synchronize()
            err = (kern - cc.correlation_plain(f1, f2, md)).abs().max().item()
            nd = (2 * md + 1) ** 2
            what = f"correlation md={md} {nb}x{C}x{H}x{W}"
            log(f"[flow] {what}: kernel vs plain max abs err {err:.3g}")
            require(err <= 1e-5, f"{what}: kernel vs plain error {err} > 1e-5")
            ops = 2 * nb * H * W * C * nd
            nbytes = 4 * (2 * nb * H * W * C + nb * H * W * nd)
            ms = time_device(lambda: cc.launch(fn, f1, f2, kern, md), 50)
            host_ms = time_cuda(lambda: cc.launch(fn, f1, f2, kern, md), 50)
            call_ms = time_cuda(lambda: cc.correlation_cuda(f1, f2, md), 50)
            bound_ms, bound_by = _bound(ops, nbytes)
            log(f"[flow] {what}: kernel alone {ms:.5f} ms ({100 * bound_ms / ms:.1f}% of "
                f"bound), launched back to back {host_ms:.5f} ms, wrapper call {call_ms:.5f} "
                f"ms, bound {bound_ms:.5f} ms ({bound_by}), {per_pass} per pass; "
                f"{cc.launch_plan(nb, C, H, W, md)}")
            pass_ms += ms * per_pass
            pass_host_ms += host_ms * per_pass
            pass_call_ms += call_ms * per_pass
            pass_bound += bound_ms * per_pass
            if path == "make_flow_fn" and H == net_hw[0] // 4:
                records.append(_record(
                    f"correlation_md{md}", "correlation.cu", CORRELATION_TPU + ":29", ms,
                    lambda: cc.correlation_plain(f1, f2, md), ops, nbytes, err, what))
        log(f"[flow] cost volumes of one {path} pass ({nb} pairs, net {net_hw}): kernels "
            f"alone {pass_ms:.4f} ms ({100 * pass_bound / pass_ms:.1f}% of bound), launched "
            f"back to back {pass_host_ms:.4f} ms, wrapper calls {pass_call_ms:.4f} ms "
            f"({100 * pass_bound / pass_call_ms:.1f}%), bound {pass_bound:.4f} ms")
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
def deterministic_algorithms(torch):
    """Within the block PyTorch's ops take their deterministic versions
    where they have one (the index and scatter backwards sum in a fixed
    order instead of with atomics; cuDNN picks deterministic algorithms);
    the rest warn and run as they are."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


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
    with plain_correlation():
        native_plain = infer.predict_flow_native(net, pair[0], pair[1])
    rel = _rel(torch, native, native_plain)
    log(f"[flow] predict_flow_native kernel path vs correlation_plain: rel err {rel:.3g}")
    require(rel <= 1e-4, f"native flow kernel vs plain: rel error {rel} > 1e-4")
    return rate, spread, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=None,
                    help="append torch.profiler tables of one eval step, one train step, one "
                    "make_flow_fn call and one multiframe flow call and train step here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from acfm_video_3d_reconstruction_tpu_torch.models.template import build_template
    from acfm_video_3d_reconstruction_tpu_torch.train import monocular

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0]
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
    driver = phase_driver(torch, device, card)

    records += phase_flow_kernels(torch, device)
    phase_flow_small(torch, device)
    flow_pps, flow_spread, flow_launches = phase_flow(torch, device, args.profile)
    multiframe = phase_multiframe(torch, device, card, args.profile)

    counter = {"raster_fwd_soft": "soft", "raster_fwd_hard": "hard",
               "raster_bwd_soft": "soft_bwd", "correlation_md4": "corr_md4",
               "correlation_md2": "corr_md2"}
    for r in records:
        r["launches"] = sum(launches[counter[r["name"]]]
                            for launches in (eval_launches, train_launches, flow_launches,
                                             driver["train_launches"], driver["eval_launches"],
                                             multiframe["launches"]))
    n_eval, n_train = EVAL_WINDOWS * EVAL_STEPS, TRAIN_WINDOWS * TRAIN_STEPS
    n_flow = FLOW_WINDOWS * FLOW_CALLS
    log("[result] " + json.dumps({
        "eval_frames_per_s_median": eval_fps, "eval_frames_per_s_spread": eval_spread,
        "train_frames_per_s_median": train_fps, "train_frames_per_s_spread": train_spread,
        "flow_pairs_per_s_median": flow_pps, "flow_pairs_per_s_spread": flow_spread,
        "driver_frames_per_s": driver["frames_per_s"],
        "driver_loader_batches_per_s": driver["loader_batches_per_s"],
        "driver_save_s": driver["save_s"],
        "batch": B, "image_size": IMG, "eval_steps": n_eval, "train_steps": n_train,
        "flow_pairs_per_call": FLOW_B, "flow_net_hw": FLOW_NET_HW, "flow_calls": n_flow,
        "launches_per_eval_step": {k: v / n_eval for k, v in eval_launches.items()},
        "launches_per_train_step": {k: v / n_train for k, v in train_launches.items()},
        "launches_per_flow_call": {k: v / n_flow for k, v in flow_launches.items()},
        "multiframe_warmup_steps": multiframe["warmup_steps"],
        "multiframe_train_steps": multiframe["train_steps"],
        "multiframe_launches": multiframe["launches"],
        "multiframe_time_per_iter_train": multiframe["time_per_iter_train"],
        "multiframe_peak_run_gib": multiframe["peak_run_gib"],
        "multiframe_peak_step_gib": multiframe["peak_step_gib"]}))

    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
