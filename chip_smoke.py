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
  4c. synthetic: the synthetic data path and its convergence demo
     (data/synthetic.py, tools/torch_train_synthetic_demo.py at its
     configuration: 1280 faces, batch 8 at 128^2, where the bins hold every
     face, K = 1280): the dataset rendered through the soft kernel (one
     launch) and the plain rasterizer at 128^2 and 256^2 (soft masks within
     2e-4, thresholded >= 99.9% equal, no bin overflow), the small config
     card vs CPU; run_demo for SYN_STEPS steps with exact launches, the loss
     falling, IoU not falling, no synchronizing operation in a train or eval
     step; one train step kernels vs plain (f32 nets, deterministic
     algorithms, 1e-4); each rasterizer kernel alone at K = 1280 with its
     bound; the device ms of one train step by kind.
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
     within 1e-4, mean_v, behind the solve's adjoint, within 1e-3); no
     synchronizing operation in a warm-up step, a train step, a flow call
     and a train step of the az-el multiplex with its rotation biases
     (--az_el_cam --az_el_quat_bias); each kernel alone at the step's 128
     views and 8 pairs with its bound; with --profile, device ms of one flow
     call and one train step by kind.
  6b. evaluate: multiframe evaluation as users run it after training, the
     evaluate CLI's `evaluate` (cli/multiframe_evaluate.py) on phase 6's
     tree and latest checkpoint at the CLI's defaults, 100 TTO iterations,
     the flow term on: (a) the test split with TTO, one panel and
     results.mat; (b) the train split with the argmax-multiplex camera and
     TTO over the camera too; (c) the gauge-aligned GT cameras without TTO.
     Exactly N+2 soft, N+1 hard, N soft_bwd and 15 cost volumes per TTO
     batch, 1 soft per batch without; the TTO lowering the loss on every
     batch; unit quaternions; the JAX CLI's results.npz keys. Then no
     synchronizing operation in a TTO call (set_sync_debug_mode), ms per TTO
     iteration, the kernels against the plain versions from the kernel
     path's own states (one step from each of 19 of its 100: loss, IoU,
     gradient, pred_v and camera after the step within 1e-4), the free
     runs' drift logged (plain, the kernels again, the kernels from a
     one-ulp change of the input), the CPU tests' small TTO card vs CPU, the
     panels (make_multiframe_vis_fn, VisRenderer, diff_vp), each kernel
     alone at the TTO's 16 views with its bound; with --profile, device ms
     of one TTO iteration by kind.
  6c. mini_tigdog: tools/torch_mini_tigdog_parity.py cut in epochs only (60
     synthetic videos at 144^2 with known GT cameras, rendered through the
     kernels and again on the CPU for the first videos; the multiframe CLI's
     train with the tool's options for MT_EPOCHS epochs, 32 views a step at
     128^2, K = 1280; launches exact; the main loss falling; one step
     kernels vs plain; the kernels alone at 32 views; three evaluation
     columns in-process: trained, gauge-aligned GT camera, TTO, with exact
     launches and the TTO loss lower on every batch).
  6d. mini_cub: tools/torch_mini_cub_parity.py cut in steps only (536
     synthetic birds at 192^2 in the CUB schema, card vs CPU for the first
     images; MC_STEPS monocular train steps with exact launches, the loss
     falling, no synchronizing operation in a step; IoU and PCK before and
     after).
  6e. parallel: data parallelism over torch.distributed (parallel/mesh.py).
     (a) A world of one over NCCL at full width: the multiframe train step at
     the CLI defaults (phase 6's options and first train batch, 128 views,
     the flow call), through the group and with no group from one recorded
     state under deterministic algorithms: every tensor bit-equal, mean_v
     within 1e-3, the same launches; PAR_TIMED steps timed each way; one
     group step profiled (the NCCL kernels' device time, all_reduce_grads'
     host time). (b) PAR_RANKS spawned ranks over gloo on the one card at
     64^2 (4 clips of 2 frames, G 4, optimize_deform, every loss weight on,
     the flow net on each rank's clips): the init, a warm-up step and two
     train steps, each held from one process's state before it against that
     process on the whole batch (parallel/checks.py: params, BatchNorm
     statistics, Adam moments, cams and deform at rtol 1e-4 / atol 1e-5,
     probs at rtol 1e-3, beside the floor), the ranks identical bit for bit,
     each rank launching every kernel.
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
import tempfile
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
    paths' reference. The multiframe train step runs eagerly there, neither
    captured nor replayed (utils/graphs.py): a graph holds the kernels'
    launches."""
    from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer_cuda as rc
    from acfm_video_3d_reconstruction_tpu_torch.utils import graphs

    kernels, run = (rc.forward_cuda, rc.backward_cuda), graphs.run
    rc.forward_cuda, rc.backward_cuda = rc.forward_plain, rc.backward_plain
    graphs.run = lambda name, owner, device, signature, eager, **_: eager()
    try:
        yield
    finally:
        (rc.forward_cuda, rc.backward_cuda), graphs.run = kernels, run


# the kernels whose launches utils/tracing.py counts, as `launch.<kernel>`
KERNELS = ("soft", "hard", "soft_bwd", "corr_md4", "corr_md2")
# the launch counts and flow graph captures that zero_launches() last read
_ZERO = dict.fromkeys(KERNELS, 0)
_ZERO_CAPTURES = [0]


def _launch_counts() -> dict:
    from acfm_video_3d_reconstruction_tpu_torch.utils import tracing

    counts = tracing.counters()
    return {k: counts.get(f"launch.{k}", 0) for k in KERNELS}


def _flow_captures() -> int:
    from acfm_video_3d_reconstruction_tpu_torch.utils import tracing

    return tracing.counters().get("flow.graph_captures", 0)


def zero_launches() -> None:
    _ZERO.update(_launch_counts())
    _ZERO_CAPTURES[0] = _flow_captures()


def flow_passes(n_calls: int) -> int:
    """The flow passes that ran in n_calls calls of make_flow_fn's function
    since zero_launches(): each graph captured meanwhile (utils/graphs.py)
    ran WARMUP_RUNS eager passes first, whose cost volumes count."""
    from acfm_video_3d_reconstruction_tpu_torch.utils import graphs

    return n_calls + graphs.WARMUP_RUNS * (_flow_captures() - _ZERO_CAPTURES[0])


def read_launches() -> dict:
    """All kernels' launches since zero_launches()."""
    return {k: n - _ZERO[k] for k, n in _launch_counts().items()}


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


# the synthetic phase: the demo's frames and the image sizes rendered
# through both rasterizer paths (the demo's 128^2, K = F = 1280, and 256^2,
# K = 192); the steps of its training run on the card (the schedule over
# the same steps); the card-vs-CPU render's config
SYN_FRAMES, SYN_SIZES, SYN_STEPS = 32, (128, 256), 200
SYN_SMALL = dict(img=64, template=dict(subdivide=2, num_lbs=6, tex_size=2, num_kps=4))


def _tool(name):
    """tools/<name>.py, imported from this checkout."""
    import importlib
    import os

    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return importlib.import_module(name)


def _demo():
    return _tool("torch_train_synthetic_demo")


def _sync_ops(torch, fn):
    """Stacks of the synchronizing operations that torch.cuda's sync debug
    mode ("warn") reports while fn() runs."""
    import traceback
    import warnings

    stacks = []

    def show(message, *a, **kw):
        if "called a synchronizing" in str(message):
            stacks.append(f"{message}\n" + "".join(traceback.format_stack(limit=10)[:-1]))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return stacks


def phase_synthetic(torch, device, card, profile=None):
    """The synthetic data path and its convergence demo on the card
    (data/synthetic.py, tools/torch_train_synthetic_demo.py at its
    configuration: subdivide 3 (642 vertices, 1280 faces), 12 handles, 8
    keypoints, tex 4, nz_feat 128, bf16 nets, batch 8 at 128^2, seed 3).

    a. The dataset of SYN_FRAMES frames at each of SYN_SIZES: exactly one
       soft launch a dataset; its render through the kernel and through the
       plain rasterizer (uncounted): soft masks within atol 2e-4, thresholded
       masks equal on >= 99.9% of the pixels, keypoints equal; the bins'
       overflow 0 (K = F at 128^2, K = 192 at 256^2). Then the CPU tests'
       config (64^2, subdivide 2) on the card against the CPU: masks equal
       on >= 99.9% of the pixels, keypoints within 1e-5.
    b. run_demo for SYN_STEPS steps (the cosine schedule over SYN_STEPS):
       launches exactly 1 soft (the render), per train step 1 soft + 1 hard
       + 1 soft_bwd, per eval step 1 soft + 1 hard (2 x 4 eval batches); the
       loss at the last logged step below step 0's; mean IoU after >= before;
       no synchronizing operation in one train step and one eval step
       (sync debug mode). Logs IoU and PCK before and after, frames/s (host
       clock over the loop, ending in a synchronize), peak memory and the
       device ms of one train step by kind (torch.profiler).
    c. One train step from the same state through the kernels and through
       the plain rasterizer, the nets in f32 (phase_train's reason), under
       deterministic algorithms: the loss and every gradient within vector
       relative error 1e-4 (NOISE_SCALE's against their neighbour's scale),
       the kernels against themselves beside it.
    d. Each rasterizer kernel alone at K = 1280: the three on the train
       step's 8 views at 128^2, the soft forward on the render's
       SYN_FRAMES frames, each with its bound and its plain version's time
       (_raster_alone)."""
    from acfm_video_3d_reconstruction_tpu_torch.data.synthetic import (
        SyntheticConfig,
        SyntheticDataset,
    )
    from acfm_video_3d_reconstruction_tpu_torch.geometry import camera as cam_utils
    from acfm_video_3d_reconstruction_tpu_torch.models.template import build_template
    from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer_cuda as rc
    from acfm_video_3d_reconstruction_tpu_torch.train import monocular

    demo = _demo()
    t_phase = time.perf_counter()
    anchors = np.random.default_rng(demo.ANCHOR_SEED).choice(
        demo.num_verts(demo.SUBDIVIDE), demo.NUM_KPS, replace=False)
    template = build_template(subdivide=demo.SUBDIVIDE, num_lbs=demo.NUM_LBS,
                              tex_size=demo.TEX_SIZE, num_kps=demo.NUM_KPS,
                              kp_vertex_ids=[np.asarray([a]) for a in anchors])
    F = template.num_faces
    renders = {}
    for size in SYN_SIZES:
        cfg = SyntheticConfig(num_frames_total=SYN_FRAMES, clip_len=1, image_size=size,
                              num_kps=demo.NUM_KPS, seed=demo.DATA_SEED,
                              kp_vertex_ids=tuple(anchors))
        zero_launches()
        ds = SyntheticDataset(template, cfg, device=device)
        launches = read_launches()
        require(launches == only(soft=1),
                f"synthetic {size}^2: launches {launches} != one soft for the dataset")
        with uncounted():
            soft_k, kp_k = ds.render()
        with plain_rasterizer():
            soft_p, kp_p = ds.render()
        proj, faces, _ = ds.project()
        K = rc.auto_K(F, size, 192)
        overflow = int(rc.bin_overflow_counts(proj, faces, size, K).max())
        mask_err = (soft_k - soft_p).abs().max().item()
        agree = ((soft_k > 0.5) == (soft_p > 0.5)).float().mean().item()
        kp_err = (kp_k - kp_p).abs().max().item()
        log(f"[synthetic] {SYN_FRAMES} frames at {size}^2, K={K} (F={F}): 1 soft launch; "
            f"kernel vs plain soft mask max err {mask_err:.3g}, thresholded masks equal on "
            f"{agree:.6f} of the pixels, keypoints max err {kp_err:.3g}; bin overflow "
            f"max {overflow}; mask coverage {float((soft_k > 0.5).float().mean()):.4f}")
        require(mask_err <= 2e-4, f"synthetic {size}^2: soft mask error {mask_err} > 2e-4")
        require(agree >= 0.999, f"synthetic {size}^2: thresholded masks agree on {agree}")
        require(kp_err == 0.0, f"synthetic {size}^2: keypoints differ by {kp_err}")
        require(overflow == 0, f"synthetic {size}^2: bins overflow by {overflow} faces")
        renders[size] = proj
    small_t = build_template(**SYN_SMALL["template"])
    small = SyntheticConfig(num_frames_total=8, clip_len=2, image_size=SYN_SMALL["img"],
                            num_kps=SYN_SMALL["template"]["num_kps"], seed=1)
    with uncounted():
        d_card = SyntheticDataset(small_t, small, device=device)
    d_cpu = SyntheticDataset(small_t, small, device="cpu")
    agree = float((d_card.masks == d_cpu.masks).mean())
    kp_err = float(np.abs(d_card.kps - d_cpu.kps).max())
    log(f"[synthetic] {SYN_SMALL['img']}^2 subdivide 2, card vs CPU: masks equal on "
        f"{agree:.6f} of the pixels, keypoints max err {kp_err:.3g}")
    require(agree >= 0.999 and kp_err <= 1e-5,
            f"synthetic card vs cpu: masks {agree}, keypoints {kp_err}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    res = demo.run_demo(SYN_STEPS, device=device)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    n_eval = 2 * demo.NUM_BATCHES
    require(launches == only(soft=1 + SYN_STEPS + n_eval, hard=SYN_STEPS + n_eval,
                             soft_bwd=SYN_STEPS),
            f"synthetic demo launches {launches} != 1 soft for the render, 1 soft + 1 hard + "
            f"1 soft_bwd per train step ({SYN_STEPS}) and 1 soft + 1 hard per eval step "
            f"({n_eval})")
    before, after, losses = res["before"], res["after"], res["losses"][::demo.LOG_EVERY]
    log(f"[synthetic] run_demo {SYN_STEPS} steps, batch {demo.BATCH}, {demo.IMG}^2, bf16 nets: "
        f"before {json.dumps(before)}, after {json.dumps(after)}; losses every "
        f"{demo.LOG_EVERY} steps {[round(x, 4) for x in losses]}; {res['frames_per_s']:.2f} "
        f"frames/s ({res['seconds']:.3f} s for the loop); peak memory {peak / 2**30:.3f} GiB; "
        f"launches {launches}; card {card}")
    require(np.isfinite(res["losses"]).all(), "synthetic demo: non-finite loss")
    require(losses[-1] < losses[0],
            f"synthetic demo: loss did not fall ({losses[0]} -> {losses[-1]})")
    require(after["mean_iou"] >= before["mean_iou"],
            f"synthetic demo: IoU fell ({before['mean_iou']} -> {after['mean_iou']})")

    mods, step, ev, batches = res["mods"], res["train_step"], res["eval_step"], res["batches"]
    with uncounted():
        stacks = _sync_ops(torch, lambda: (step(batches[0]), ev(batches[1])))
    for st in stacks[:3]:
        log("[synthetic] synchronizing operation in a demo step:\n" + st)
    log(f"[synthetic] sync debug mode: {len(stacks)} synchronizing operations in one train "
        "step and one eval step")
    require(not stacks, f"synthetic: {len(stacks)} synchronizing operations in a step")
    with uncounted():
        step_ms, _ = _mf_profile(torch, lambda: step(batches[0]),
                                 "one demo train step (K=1280)", profile, tag="synthetic")

    state = copy.deepcopy(mods.model.state_dict())
    mods_f32 = dataclasses.replace(mods, cfg=dataclasses.replace(
        mods.cfg, model=dataclasses.replace(mods.cfg.model, dtype="float32")))

    def one_step():
        mods.model.load_state_dict(state)
        mods.model.zero_grad(set_to_none=True)
        loss, _ = monocular.forward(mods_f32, batches[0], train=True)
        loss.backward()
        return loss.detach(), _grads(mods.model)

    with uncounted(), deterministic_algorithms(torch):
        loss_k, g_k = one_step()
        loss_k2, g_k2 = one_step()
        with plain_rasterizer():
            loss_p, g_p = one_step()
    mods.model.load_state_dict(state)
    floor = _grad_errors(g_k2, g_k, "synthetic kernels vs kernels", 1e-4)
    worst = _grad_errors(g_k, g_p, "synthetic kernels vs plain", 1e-4)
    loss_err = _rel_vec(torch, loss_k, loss_p)
    log(f"[synthetic] one train step from the same state, f32 nets, deterministic "
        f"algorithms, kernels vs plain: loss {float(loss_k):.8g} vs {float(loss_p):.8g} (rel "
        f"{loss_err:.3g}), worst gradient rel error {worst[1]:.3g} ({worst[0]}); kernels vs "
        f"kernels {floor[1]:.3g} ({floor[0]}), loss rel {_rel_vec(torch, loss_k2, loss_k):.3g}")
    require(loss_err <= 1e-4, f"synthetic kernels vs plain: loss rel error {loss_err}")

    with torch.no_grad():
        aux = ev(batches[0])
        views = cam_utils.orthographic_proj_withz(aux["pred_v"], batches[0]["sfm_pose"],
                                                  offset_z=mods.cfg.train.offset_z)
    with uncounted():
        kernels = _raster_alone(torch, views, mods.faces, demo.IMG, "synthetic", plain=True)
        kernels["soft render"] = _raster_alone(torch, renders[demo.IMG], mods.faces, demo.IMG,
                                               "synthetic", ("soft",), plain=True)["soft"]
    secs = time.perf_counter() - t_phase
    log(f"[synthetic] phase {secs:.2f} s")
    return {"launches": launches, "before": before, "after": after,
            "frames_per_s": res["frames_per_s"], "peak_gib": peak / 2**30,
            "step_device_ms": step_ms, "kernels": kernels, "seconds": secs}


# the multiframe phase: the CLI's defaults on a TigDog-format tree of
# MF_VIDEOS clips of MF_FRAMES frames at MF_RAW (tools/tigdog_fixture.py):
# 32 frames, so 4 steps of batch 8 an epoch
MF_VIDEOS, MF_FRAMES, MF_RAW = 4, 8, (360, 640)
# the keypoints a fixture clip keeps (19 less the neck, which the loader drops)
MF_KPS = 18
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


def _mf_kernels(torch, proj, faces, S, net_hw, nb, tag="multiframe"):
    """Each kernel alone at the multiframe step's shapes, with its bound:
    the rasterizer kernels on the first train step's projected views
    (_raster_alone); the cost volume's pass at `nb` pairs (time_device per
    shape) against its bytes. Returns {name: (ms, bound_ms, bound_by)}."""
    from acfm_video_3d_reconstruction_tpu_torch.flow import correlation_cuda as cc

    out = _raster_alone(torch, proj, faces, S, tag)
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
    log(f"[{tag}] cost volumes of one pass at {nb} pairs (15 launches), alone "
        f"{pass_ms:.4f} ms, bound {pass_bound:.4f} ms (bytes)")
    return out


def _raster_alone(torch, proj, faces, S, tag, modes=("soft", "hard", "soft_bwd"),
                  plain=False):
    """Each rasterizer kernel of `modes` alone on the projected views `proj`
    at S^2 (its C entry on counts and outputs made once, time_cuda), with
    its bound: the bytes each must move (as phase_kernels counts them) and,
    for the operations, every (pixel, slot) pair inside the cull windows at
    the inside and distance tests' cost (OPS_TEST) plus OPS_PER_FACE per
    (view, face), which is less than the work (pairs in radius cost
    OPS_PER_PAIR). Returns {mode: (ms, bound_ms, bound_by)}, and with
    `plain` {mode: (ms, bound_ms, bound_by, plain version's ms)}."""
    from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer as ras
    from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer_cuda as rc

    V = proj.shape[0]
    K = rc.auto_K(faces.shape[0], S, ras.DEFAULT_K)
    out = {}
    for mode, soft, blur in (("soft", True, rc.BLUR_RADIUS), ("hard", False, 0.0),
                             ("soft_bwd", True, rc.BLUR_RADIUS)):
        if mode not in modes:
            continue
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
            run_plain = functools.partial(rc.backward_plain, table, idx, dS, S, th, tw,
                                          rc.SIGMA, blur)
        else:
            frags = rc.forward_cuda(table, idx, S, th, tw, rc.SIGMA, blur, soft)
            nbytes = (table.numel() + idx.numel() + counts.numel() + 5 * V * S * S) * 4
            ms = time_cuda(lambda: rc.launch_fwd(rc.fwd_entry(), table, idx, counts, frags, S,
                                                 th, tw, rc.SIGMA, blur, soft), 10)
            run_plain = functools.partial(rc.forward_plain, table, idx, S, th, tw, rc.SIGMA,
                                          blur, soft)
        out[mode] = (ms, *_bound(ops, nbytes))
        if plain:
            out[mode] += (time_cuda(run_plain, 3, 1),)
        log(f"[{tag}] {mode} at {V} views, {S}^2, K={K}: kernel alone {ms:.4f} ms, bound "
            f"{out[mode][1]:.4f} ms ({out[mode][2]}; {nbytes / 1e6:.1f} MB, {needed} needed "
            f"pairs)" + (f", plain version {out[mode][3]:.3f} ms" if plain else ""))
    return out


def _kinds(events, extra_kinds=()) -> dict:
    """Device ms of a profile's kernels by `extra_kinds` then MF_KINDS, the
    rest as "other"."""
    table = tuple(extra_kinds) + MF_KINDS
    out = {kind: 0.0 for kind, _ in table}
    out["other (elementwise, reductions, indexing; the bin pass)"] = 0.0
    for e in events:
        ms = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e3
        if ms <= 0:
            continue
        name = e.key.lower()
        kind = next((k for k, keys in table if any(x in name for x in keys)),
                    "other (elementwise, reductions, indexing; the bin pass)")
        out[kind] += ms
    return out


def _mf_profile(torch, call, what, path, tag="multiframe", host_top=0, trace=None,
                extra_kinds=()):
    """Device ms of one call by kind (torch.profiler; `extra_kinds` before
    MF_KINDS), its 12 largest kernels (and its `host_top` largest operators
    by self host time), appended to `path` when given; the timeline to
    `trace` when given."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    if trace:
        prof.export_chrome_trace(trace)
    # kernels only: a user annotation (Optimizer.step's range) also has a
    # device-side event, whose span covers kernels counted on their own
    on_host = {e.key for e in prof.key_averages() if "cpu" in str(e.device_type).lower()}
    events = [e for e in prof.key_averages()
              if "cuda" in str(getattr(e, "device_type", "")).lower() and e.key not in on_host
              and not getattr(e, "is_user_annotation", False)]
    kinds = _kinds(events, extra_kinds)
    total = sum(kinds.values())
    top = sorted(events, key=lambda e: -getattr(e, "self_device_time_total",
                                                getattr(e, "self_cuda_time_total", 0)))[:12]
    log(f"[{tag}] profile of {what}: {total:.3f} ms of device time; by kind "
        + json.dumps({k: round(v, 4) for k, v in kinds.items()}))
    for e in top:
        t = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e3
        log(f"[{tag}]   {t:9.4f} ms x{e.count:4d}  {e.key[:110]}")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:host_top]
    for e in host:
        log(f"[{tag}]   host {e.self_cpu_time_total / 1e3:9.4f} ms x{e.count:5d}  {e.key[:100]}")
    if path:
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
        with open(path, "a") as fh:
            fh.write(f"==== {what} ====\n{table}\n")
    return total, kinds


def phase_multiframe(torch, device, card, tmp, profile=None, **overrides):
    """Multiframe camera-multiplex training as users run it: the CLI's
    `train` (cli/multiframe_main.py) at its defaults, the full-width horse
    model (G 8, B 8, T 2, 256², icosphere subdivide 3, 15 handles, nz_feat
    200, tex 6, texture on, f32 nets, TF32 off), the frozen two-stage
    MaskFlownet at 384x768 with seeded random weights (--flow_random_init),
    on a TigDog-format tree from tools/tigdog_fixture.py written under
    `tmp` (the evaluate phase reads it and the checkpoints after), with its
    keypoint dictionary (--kp_dict: the 18 keypoints a clip keeps, unused
    by training at kp_loss_wt 0, read by the evaluation); with --warmup
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

    from tools.tigdog_fixture import write_kp_dict, write_tigdog_tree

    from acfm_video_3d_reconstruction_tpu_torch.cli import multiframe_main
    from acfm_video_3d_reconstruction_tpu_torch.geometry.icosphere import icosphere
    from acfm_video_3d_reconstruction_tpu_torch.flow import correlation_cuda as cc
    from acfm_video_3d_reconstruction_tpu_torch.flow.infer import NET_H, NET_W
    from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer as ras
    from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer_cuda as rc
    from acfm_video_3d_reconstruction_tpu_torch.train import checkpoints
    from acfm_video_3d_reconstruction_tpu_torch.train import multiframe as mf

    t_phase = time.perf_counter()
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
    o.update(num_kps=MF_KPS, kp_dict=write_kp_dict(
        os.path.join(tmp, "kp_dict.pkl"), len(icosphere(o["subdivide"])[0]), MF_KPS))
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
    n_f = flow_passes(n_b)
    require(launches == only(soft=n_b, hard=n_t, soft_bwd=n_b, corr_md4=5 * n_f,
                             corr_md2=10 * n_f),
            f"multiframe launches {launches} != per warm-up step 1 soft + 1 soft_bwd, per "
            f"train step 1 soft + 1 hard + 1 soft_bwd, per flow pass 15 cost volumes "
            f"({n_w} warm-up and {n_t} train steps, {n_f} flow passes)")
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

    sync = _mf_sync_checks(torch, mods, batch, flow_fn, upload, k)

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
            "overflow": overflow, "profile": prof, "kernels": kernels, "opts": o,
            "sync_ops": sync, "batch": upload, "num_frames": mods.mpx.probs.shape[0]}


def _mf_sync_checks(torch, mods, batch, flow_fn, upload, k):
    """No synchronizing operation (_sync_ops) in one warm-up step, one train
    step and one flow call of the trained modules on the run's first batch,
    nor in one train step of an az-el build of the same model (--az_el_cam
    --az_el_quat_bias: the bias table gathered per step) after its first
    two steps (the first builds the table once per device, the second
    captures the step's CUDA graph, utils/graphs.py: a capture synchronizes
    the device before it begins, and CUDA refuses a synchronizing operation
    inside it). The train steps checked are replays of the steps' graphs.
    Every launch uncounted. Returns {call: number of synchronizing
    operations}, all 0."""
    from acfm_video_3d_reconstruction_tpu_torch.train import multiframe as mf

    cfg = dataclasses.replace(mods.cfg, multiplex=dataclasses.replace(
        mods.cfg.multiplex, az_el_cam=True, az_el_quat_bias=True))
    az = mf.build(cfg, mods.template, mods.mpx.probs.shape[0], seed=2, device=mods.device)
    az_step = mf.make_train_step(az, k=k)
    warm_step, step = mf.make_warmup_step(mods), mf.make_train_step(mods, k=k)
    calls = {"warm-up step": lambda: warm_step(batch), "train step": lambda: step(batch),
             "flow call": lambda: flow_fn(dict(upload)),
             "az-el train step (--az_el_cam --az_el_quat_bias)": lambda: az_step(batch)}
    counts = {}
    with uncounted():
        az_step(batch)
        az_step(batch)
        for what, call in calls.items():
            stacks = _sync_ops(torch, call)
            for st in stacks[:3]:
                log(f"[multiframe] synchronizing operation in the {what}:\n" + st)
            counts[what] = len(stacks)
    del az
    log("[multiframe] sync debug mode, synchronizing operations per call: "
        + json.dumps(counts))
    bad = {what: n for what, n in counts.items() if n}
    require(not bad, f"multiframe: synchronizing operations {bad}")
    return counts


@contextlib.contextmanager
def uncounted():
    """Within the block kernel launches leave the counters as they were: a
    check's own launches beside a counted path."""
    before = _launch_counts()
    try:
        yield
    finally:
        for k, n in _launch_counts().items():
            _ZERO[k] += n - before[k]


# the evaluate phase: the CLI's TTO iterations; the iterations of the
# call the sync check watches; the kernel path's iterations from whose
# state one step through each path is compared (the first 10, then every
# 10th)
EVAL_TTO_ITERS, EVAL_TRACE_ITERS = 100, 10
EVAL_FORCED_AT = tuple(range(10)) + tuple(range(19, EVAL_TTO_ITERS, 10))
EVAL_KEYS = ["cams", "ious", "kp_errs", "kp_pred", "kp_vis"]  # the JAX CLI's results.npz


@contextlib.contextmanager
def tto_params(torch, rec: dict):
    """Within the block every TTO iteration appends its parameters before
    its Adam step (delta_v_res, then the raw camera when it is optimized)
    and their gradients, each as one flat vector, to rec["state"] and
    rec["grad"]."""
    from acfm_video_3d_reconstruction_tpu_torch.eval import predictor

    real = predictor._dense_grads

    def dense(opt):
        real(opt)
        ps = [p for g in opt.param_groups for p in g["params"]]
        rec.setdefault("state", []).append(torch.cat([p.detach().reshape(-1) for p in ps]))
        rec.setdefault("grad", []).append(torch.cat([p.grad.reshape(-1) for p in ps]))

    predictor._dense_grads = dense
    try:
        yield
    finally:
        predictor._dense_grads = real


def _rel_vec(torch, a, b) -> float:
    """Vector relative error ||a - b|| / ||b|| (0 when both are 0)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    diff = torch.linalg.vector_norm(a - b).item()
    return 0.0 if diff == 0 else diff / torch.linalg.vector_norm(b).item()


def _tto_small_scene(torch):
    """The CPU tests' TTO scene (tests/test_torch_port_tto.py::_scene(2)) on
    the CPU, from numpy seeds and the port alone: 32^2, icosphere subdivide
    1, 6 handles, the template at half scale, 2 clips of 2 frames, GT masks
    of the template deformed by known handle offsets, random edt maps and
    boundary points, a smooth flow field. Returns (mods, args)."""
    from types import SimpleNamespace

    from acfm_video_3d_reconstruction_tpu_torch.deform.solve import screened_poisson_solve
    from acfm_video_3d_reconstruction_tpu_torch.geometry import camera
    from acfm_video_3d_reconstruction_tpu_torch.geometry.mesh_ops import cot_laplacian
    from acfm_video_3d_reconstruction_tpu_torch.models.template import build_template
    from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer as ras

    size, T, BT = 32, 2, 4
    t = build_template(subdivide=1, num_lbs=6, tex_size=2, num_kps=0)
    rng = np.random.default_rng(20 + T)
    mean = torch.from_numpy((t.verts * 0.5).astype(np.float32))
    lbs = torch.softmax(torch.from_numpy(t.lbs_logits.astype(np.float32)), dim=0).T
    q = np.asarray([1.0, 0.0, 0.0, 0.0]) + 0.15 * rng.normal(size=(BT, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    cams = torch.from_numpy(np.concatenate([rng.uniform(0.9, 1.1, (BT, 1)),
                                            rng.uniform(-0.05, 0.05, (BT, 2)), q],
                                           -1).astype(np.float32))
    gt_delta = torch.from_numpy((rng.normal(size=(BT, 6, 3)) * 0.1).astype(np.float32))
    faces = torch.as_tensor(t.faces, dtype=torch.long)
    gt_v = screened_poisson_solve(mean, lbs, gt_delta, cot_laplacian(mean, faces))
    proj = camera.orthographic_proj_withz(gt_v, cams, offset_z=0.0)
    mask = (ras.soft_silhouette(proj, faces, size)[0] > 0.5).float()
    bounds = rng.uniform(-0.7, 0.7, (BT, 24, 3)).astype(np.float32)
    bounds[..., 2] = rng.random((BT, 24)) > 0.25
    yy, xx = np.mgrid[:size, :size] / size * 2 - 1
    flows = np.zeros((2, T, size, size, 2), np.float32)
    flows[:, :-1] = np.stack([1.5 + np.sin(2 * xx + 1) + 0.5 * yy,
                              -0.5 + np.cos(3 * yy) * 0.8], -1)
    batch = {"mask": mask, "edt": torch.from_numpy(rng.random((BT, size, size)).astype(np.float32)),
             "boundaries": torch.from_numpy(bounds), "optical_flows": torch.from_numpy(flows)}
    mods = SimpleNamespace(template=t, cfg=SimpleNamespace(model=SimpleNamespace(img_size=size)),
                           device="cpu")
    return mods, (mean, lbs, torch.zeros(BT, 6, 3), cams, batch)


def phase_evaluate(torch, device, card, train_opts, tmp, profile=None):
    """Multiframe evaluation as users run it after training: the evaluate
    CLI's `evaluate` (cli/multiframe_evaluate.py) at its defaults on the
    multiframe phase's tree and its latest checkpoint (the same options:
    the horse model, G 8, batch 8 clips of 2 frames, 256², f32, TF32 off,
    --of_loss_wt 1, --flow_random_init, the keypoint dictionary), with
    --num_optim_iter EVAL_TTO_ITERS, in three runs:
      a. --split test --optimize --save_visuals 1 --save_mat;
      b. --split train --use_argmax_camera --optimize --optimize_camera;
      c. --use_gt_camera --gauge_align, no TTO.
    Launches per run, exactly: with TTO per batch N+2 soft (one per TTO
    iteration, the final loss, the evaluated mask), N+1 hard (the flow
    term's visibility), N soft_bwd and 5 md=4 + 10 md=2 cost volumes (one
    flow call); without TTO 1 soft per batch. On every TTO batch the final
    loss below the loss at iteration 0 (a 0-step refine, uncounted); run
    b's cameras unit quaternions within 1e-5; results.npz with the JAX
    CLI's keys, results.mat, a finite reference line, one
    eval_batch_0000.png. Logs seconds per batch of each run, the TTO views'
    bin_overflow_counts and the runs' peak memory.

    Then, on run b's first batch (16 views, the camera optimized): ms per
    TTO iteration by host clock ((t(N) - t(0)) / N, each call ending in
    synchronize) beside the CLI runs' own; a TTO call under
    torch.cuda.set_sync_debug_mode("warn") must warn of no synchronizing
    operation (the refiner is built before: its build uploads the template's
    tensors, which the mode flags); the kernels against the plain
    rasterizer and correlation_plain under deterministic algorithms, in the
    trace mode. The loss makes discrete choices (the boundary term's
    nearest visible vertex, the flow term's nearest pixel, both
    visibilities), so two free runs part at the first choice a rounding
    difference tips, some 2-14 iterations in
    (tools/torch_tto_drift.py); the kernels are held from the kernel
    path's own states instead: from each of its iterations EVAL_FORCED_AT,
    one step through each path, the loss, IoU and gradient there and pred_v
    and the camera after the step within vector relative error 1e-4. The
    free runs of N iterations, through the plain versions, through the
    kernels again and through the kernels from delta_v_res moved one ulp,
    are logged against the kernel path's: the parameters' drift, the first
    EVAL_TRACE_ITERS iterations' trace, pred_v, the final loss and the
    camera after N. Then the CPU tests' small TTO scene card vs CPU (5 steps, the
    camera and the flow term on, the trace: losses rtol 1e-3, pred_v and
    cameras vector relative error 1e-4, tests/test_torch_port_tto.py's
    bounds); the panels (make_multiframe_vis_fn on the restored state, 1
    soft launch; VisRenderer and diff_vp, 1 hard launch each; PNGs of the
    expected shapes); each kernel alone at the TTO views with its bound;
    with `profile`, device ms of one TTO iteration by kind ((profile of 20
    iterations - profile of 10) / 10) and the bin pass alone."""
    import os

    from acfm_video_3d_reconstruction_tpu_torch.cli import multiframe_evaluate as mfe
    from acfm_video_3d_reconstruction_tpu_torch.cli import multiframe_main
    from acfm_video_3d_reconstruction_tpu_torch.eval import predictor
    from acfm_video_3d_reconstruction_tpu_torch.flow.infer import NET_H, NET_W
    from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer as ras
    from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer_cuda as rc
    from acfm_video_3d_reconstruction_tpu_torch.train.visualize import make_multiframe_vis_fn
    from acfm_video_3d_reconstruction_tpu_torch.utils import vis as vis_utils

    t_phase = time.perf_counter()
    base = mfe.default_opts()
    base.update({k: v for k, v in train_opts.items() if k in base or k == "flow_net_hw"})
    base.update(num_optim_iter=EVAL_TTO_ITERS, device=str(device))
    N, B, T, S = EVAL_TTO_ITERS, base["batch_size"], base["num_frames"], base["img_size"]
    net_hw = base.get("flow_net_hw", (NET_H, NET_W))

    real_make, real_vis = predictor.make_tto_step_fn, ras.soft_silhouette_vis
    calls, first, views = [], {}, {}

    def recording_make(mods, tto, num_frames, trace_vert2kp=None):
        """The CLI's refiner, recording per batch the loss at iteration 0
        (uncounted), the final loss and the seconds; the first batch's
        inputs for the checks after the runs."""
        refine = real_make(mods, tto, num_frames, trace_vert2kp)
        zero_steps = real_make(mods, dataclasses.replace(tto, num_iter=0), num_frames)

        def run(mean_shape, lbs, delta, cam, batch):
            with uncounted():
                loss0 = zero_steps(mean_shape, lbs, delta, cam, batch)[2]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = refine(mean_shape, lbs, delta, cam, batch)
            torch.cuda.synchronize()
            calls.append((float(loss0), float(out[2]), time.perf_counter() - t0))
            first.setdefault(tag, dict(mods=mods, tto=tto, num_frames=num_frames, args=(
                mean_shape, lbs, delta, cam,
                {k: v for k, v in batch.items() if k != "optical_flows"})))
            return out
        return run

    def watching_vis(verts, *a, **kw):
        views.setdefault("tto", verts.detach())
        return real_vis(verts, *a, **kw)

    runs = {}
    for tag, flags in (("a", dict(split="test", optimize=True, save_visuals=1, save_mat=True)),
                       ("b", dict(split="train", use_argmax_camera=True, optimize=True,
                                  optimize_camera=True)),
                       ("c", dict(use_gt_camera=True, gauge_align=True))):
        o = dict(base, results_dir=os.path.join(tmp, f"eval_{tag}"), **flags)
        predictor.make_tto_step_fn, ras.soft_silhouette_vis = recording_make, watching_vis
        del calls[:]
        try:
            torch.cuda.reset_peak_memory_stats()
            zero_launches()
            t0 = time.perf_counter()
            stats = mfe.evaluate(o)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = read_launches()
        finally:
            predictor.make_tto_step_fn, ras.soft_silhouette_vis = real_make, real_vis
        n_b = len(stats.ious)
        res = stats.results()
        require(n_b > 0 and all(np.isfinite(v) for v in res.values()),
                f"evaluate {tag}: {n_b} batches, reference line {res}")
        npz = np.load(os.path.join(o["results_dir"], "results.npz"))
        require(sorted(npz.files) == EVAL_KEYS, f"evaluate {tag}: results.npz keys {npz.files}")
        if o["optimize"]:
            n_f = flow_passes(n_b)
            want = only(soft=n_b * (N + 2), hard=n_b * (N + 1), soft_bwd=n_b * N,
                        corr_md4=5 * n_f, corr_md2=10 * n_f)
            require(len(calls) == n_b and all(c[1] < c[0] for c in calls),
                    f"evaluate {tag}: TTO loss (iteration 0, final, s) per batch {calls}")
        else:
            want = only(soft=n_b)
        require(launches == want, f"evaluate {tag}: launches {launches} != {want} ({n_b} batches)")
        runs[tag] = dict(secs=secs, batches=n_b, launches=launches, results=res,
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         tto=list(calls), cams=npz["cams"])
        log(f"[evaluate] run {tag} {flags}: {n_b} batches of {B} clips x {T} frames at {S}^2 in "
            f"{secs:.2f} s ({secs / n_b:.3f} s per batch, restore and dataset included); "
            f"launches {launches}; reference line {json.dumps(res)}; peak memory "
            f"{runs[tag]['peak_gib']:.3f} GiB; card {card}")
        if calls:
            log(f"[evaluate] run {tag} TTO per batch (loss at iteration 0, final loss, s): "
                + json.dumps([[round(x, 6) for x in c] for c in calls]))
    a_dir = os.path.join(tmp, "eval_a")
    require(os.path.exists(os.path.join(a_dir, "results.mat")), "evaluate a: no results.mat")
    pngs = sorted(f for f in os.listdir(a_dir) if f.endswith(".png"))
    require(pngs == ["eval_batch_0000.png"], f"evaluate a: panels {pngs}")
    q_norm = np.linalg.norm(runs["b"]["cams"][:, 3:], axis=-1)
    q_err = float(np.abs(q_norm - 1).max())
    require(q_err <= 1e-5, f"evaluate b: |q| - 1 up to {q_err}")
    # run b's first batch: the camera optimized, the flow term on. The
    # checks from here on log a failure and raise at the end of the phase,
    # so that one run on the card reports every one of them.
    failures = []

    def check(cond, what):
        if not cond:
            log(f"[evaluate] FAILED: {what}")
            failures.append(what)

    mods, tto, nf = first["b"]["mods"], first["b"]["tto"], first["b"]["num_frames"]
    proj = views["tto"]  # run a's first TTO iteration's projected views
    K = rc.auto_K(mods.faces.shape[0], S, ras.DEFAULT_K)
    ovf = rc.bin_overflow_counts(proj, mods.faces, S, K)
    overflow = (tuple(proj.shape), K, int(ovf.max()), int((ovf > 0).sum()), int(ovf.sum()))
    log(f"[evaluate] bin_overflow_counts of the TTO views (views shape, K, max per bin, bins "
        f"over, faces dropped): {json.dumps(overflow)}; run b |q| - 1 up to {q_err:.3g}")
    mean_shape, lbs, delta, cam, upload = first["b"]["args"]
    flow_fn = multiframe_main.make_flow_fn_from_opts(base, S, device)
    db = flow_fn(dict(upload))

    def tto_fn(n, trace=None):
        """The refiner of n iterations (built outside any timing or check)."""
        return functools.partial(real_make(mods, dataclasses.replace(tto, num_iter=n), nf, trace),
                                 mean_shape, lbs, delta, cam)

    def host_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(db)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    fn_n, fn_0 = tto_fn(N), tto_fn(0)
    host = [(host_s(fn_n), host_s(fn_0)) for _ in range(2)][-1]
    ms_iter = (host[0] - host[1]) / N * 1e3
    in_cli = {tag: float(np.median([c[2] for c in runs[tag]["tto"]])) / N * 1e3
              for tag in ("a", "b")}
    log(f"[evaluate] TTO at {proj.shape[0]} views: {ms_iter:.3f} ms per iteration by host clock "
        f"(({host[0]:.4f} s for {N} iterations - {host[1]:.4f} s for 0) / {N}); in the CLI's "
        f"runs a and b, the median batch's refine / {N}: {json.dumps(in_cli)} ms; card {card}")

    fn = tto_fn(EVAL_TRACE_ITERS)
    fn(db)
    stacks = _sync_ops(torch, lambda: fn(db))
    for st in stacks[:3]:
        log("[evaluate] synchronizing operation in the TTO call:\n" + st)
    log(f"[evaluate] sync debug mode: {len(stacks)} synchronizing operations in a TTO call of "
        f"{EVAL_TRACE_ITERS} iterations")
    check(not stacks, f"evaluate: {len(stacks)} synchronizing operations in a TTO call")

    vert2kp = mods.model.get_vert2kp().detach()
    flows = {}
    for plain in (False, True):
        with contextlib.ExitStack() as stack:
            stack.enter_context(deterministic_algorithms(torch))
            if plain:
                stack.enter_context(plain_correlation())
            flows[plain] = flow_fn(dict(upload))

    def traced(n, plain, start=(delta, cam), rec=None):
        """n iterations in the trace mode under deterministic algorithms,
        through the kernels or the plain versions (the flows too), from
        start = (delta_v_res, raw camera); rec collects each iteration's
        parameters and gradients (tto_params)."""
        with contextlib.ExitStack() as stack:
            stack.enter_context(deterministic_algorithms(torch))
            if plain:
                stack.enter_context(plain_rasterizer())
            if rec is not None:
                stack.enter_context(tto_params(torch, rec))
            out = real_make(mods, dataclasses.replace(tto, num_iter=n), nf, vert2kp)(
                mean_shape, lbs, *start, flows[plain])
        torch.cuda.synchronize()
        return out

    # the free runs: the loss's discrete choices (the boundary term's
    # nearest visible vertex, the flow term's nearest pixel, the
    # visibilities) turn a rounding difference into a different trajectory
    # (tools/torch_tto_drift.py), so they are logged beside the kernel
    # path's response to a one-ulp change of its own input, and the kernels
    # are held from the kernel path's states, one step at a time
    ref = {}
    k_full = traced(N, False, rec=ref)
    coin = torch.rand(delta.shape, generator=torch.Generator(device=device).manual_seed(0),
                      device=device) < 0.5
    ulp_delta = torch.nextafter(delta, torch.where(coin, float("inf"), float("-inf")))
    n10 = EVAL_TRACE_ITERS
    at = [i for i in (1, 2, 3, 5, 10, 20, 30, 50, 75, N - 1) if i < N]
    free = {}
    for name, plain, start in (("plain", True, (delta, cam)), ("again", False, (delta, cam)),
                               ("ulp", False, (ulp_delta, cam))):
        rec = {}
        run = traced(N, plain, start, rec)
        loss = [_rel_vec(torch, run[3]["loss"][i], k_full[3]["loss"][i]) for i in range(N)]
        state = [_rel_vec(torch, rec["state"][i], ref["state"][i]) for i in range(N)]
        free[name] = {f"parameters after {n}": state[n] for n in at}
        free[name].update({
            f"loss, iou and cam over the first {n10}": max(
                _rel_vec(torch, run[3][k][:n10], k_full[3][k][:n10])
                for k in ("loss", "iou", "cam")),
            f"pred_v after {N}": _rel_vec(torch, run[0], k_full[0]),
            f"final loss after {N}": _rel_vec(torch, run[2], k_full[2]),
            f"cam after {N}": _rel_vec(torch, run[1], k_full[1]),
            "loss first over 1e-4 at": next((i for i, d in enumerate(loss) if d > 1e-4), None),
            "parameters first over 1e-4 at": next(
                (i for i, d in enumerate(state) if d > 1e-4), None)})
        log(f"[evaluate] TTO free run, {name} vs kernels (deterministic algorithms, "
            f"{proj.shape[0]} views, camera optimized, vector rel): "
            + json.dumps({k: v if v is None or isinstance(v, int) else float(f"{v:.3g}")
                          for k, v in free[name].items()}))
    n_delta = delta.numel()
    forced = []
    for i in EVAL_FORCED_AT:
        start = (ref["state"][i][:n_delta].reshape(delta.shape),
                 ref["state"][i][n_delta:].reshape(cam.shape) if tto.optimize_camera else cam)
        rk, rp = {}, {}
        k1, p1 = traced(1, False, start, rk), traced(1, True, start, rp)
        forced.append({"loss": _rel_vec(torch, p1[3]["loss"], k1[3]["loss"]),
                       "iou": _rel_vec(torch, p1[3]["iou"], k1[3]["iou"]),
                       "grad": _rel_vec(torch, rp["grad"][0], rk["grad"][0]),
                       "pred_v after the step": _rel_vec(torch, p1[0], k1[0]),
                       "cam after the step": _rel_vec(torch, p1[1], k1[1])})
    worst = {k: max(r[k] for r in forced) for k in forced[0]}
    grads = [float(f"{r['grad']:.2g}") for r in forced]
    log(f"[evaluate] TTO kernels vs plain from the kernel path's state at iterations "
        f"{list(EVAL_FORCED_AT)}, one step each, vector rel: worst "
        + json.dumps({k: float(f"{v:.3g}") for k, v in worst.items()})
        + f"; the gradient's at each {grads}")
    over = {k: v for k, v in worst.items() if v > 1e-4}
    check(not over, f"evaluate: TTO kernels vs plain from the kernel path's states over 1e-4: "
          f"{over}")

    small_mods, small_args = _tto_small_scene(torch)
    small_tto = predictor.TTOConfig(num_iter=5, lr=2e-2, of_wt=1.0, optimize_camera=True)
    kp = torch.softmax(torch.from_numpy(np.random.default_rng(9).normal(
        size=(3, small_mods.template.num_verts)).astype(np.float32)), dim=1)
    on_cpu = real_make(small_mods, small_tto, 2, kp)(*small_args)
    card_mods = type(small_mods)(**dict(vars(small_mods), device=device))
    to_dev = [a.to(device) if torch.is_tensor(a) else {k: v.to(device) for k, v in a.items()}
              for a in small_args]
    on_card = real_make(card_mods, small_tto, 2, kp.to(device))(*to_dev)
    small = {"final_loss": abs(float(on_card[2]) - float(on_cpu[2])) / abs(float(on_cpu[2])),
             "trace_loss": ((on_card[3]["loss"].cpu() - on_cpu[3]["loss"]).abs()
                            / on_cpu[3]["loss"].abs()).max().item(),
             "pred_v": _rel_vec(torch, on_card[0], on_cpu[0]),
             "cam": _rel_vec(torch, on_card[1], on_cpu[1])}
    log(f"[evaluate] small TTO (32^2, 42 vertices, 2 clips x 2 frames, 5 steps, camera and "
        f"flow term on) card (kernels) vs cpu (plain): {json.dumps(small)}")
    check(small["final_loss"] <= 1e-3 and small["trace_loss"] <= 1e-3
          and small["pred_v"] <= 1e-4 and small["cam"] <= 1e-4,
          f"evaluate: small TTO card vs cpu {small} over (1e-3, 1e-3, 1e-4, 1e-4)")

    vis_dir = os.path.join(tmp, "eval_panels")
    zero_launches()
    make_multiframe_vis_fn(mods)(vis_dir, 0, upload)
    check(read_launches() == only(soft=1), f"panels: launches {read_launches()} != 1 soft")
    from PIL import Image

    panel = np.asarray(Image.open(os.path.join(vis_dir, "vis", "step_0000000.png")))
    check(panel.shape == (min(4, B * T) * S, 5 * S, 3), f"panels: vis panel {panel.shape}")
    renderer = vis_utils.VisRenderer(S, mods.template.faces, device=device)
    pred_v, cam_out = k_full[0], k_full[1]
    zero_launches()
    front = renderer(pred_v[0], cam_out[0])
    side = renderer.diff_vp(pred_v[0], cam_out[0])
    check(read_launches() == only(hard=2), f"panels: VisRenderer launches {read_launches()}")
    for name, img in (("front", front), ("diff_vp", side)):
        vis_utils.save_image(os.path.join(vis_dir, f"render_{name}.png"), img)
        saved = np.asarray(Image.open(os.path.join(vis_dir, f"render_{name}.png")))
        check(saved.shape == (S, S, 3) and (saved != 255).any(),
              f"panels: VisRenderer {name} {saved.shape}")
    log(f"[evaluate] panels: make_multiframe_vis_fn {panel.shape} with 1 soft launch; "
        f"VisRenderer and diff_vp {front.shape} with 1 hard launch each")

    prof = {}
    if profile is not None:
        fn20, fn10, fn3 = tto_fn(20), tto_fn(10), tto_fn(3)
        k20 = _mf_profile(torch, lambda: fn20(db), f"a TTO call of 20 iterations "
                          f"({proj.shape[0]} views)", profile, tag="evaluate", host_top=25)
        k10p = _mf_profile(torch, lambda: fn10(db), f"a TTO call of 10 iterations "
                           f"({proj.shape[0]} views)", profile, tag="evaluate")
        _mf_profile(torch, lambda: fn3(db), f"a TTO call of 3 iterations ({proj.shape[0]} "
                    f"views), timeline", None, tag="evaluate", trace=profile + ".tto3.json")
        per_iter = {k: (k20[1][k] - k10p[1][k]) / 10 for k in k20[1]}
        dev_ms = (k20[0] - k10p[0]) / 10
        bin_ms = {m: time_cuda(lambda: rc.bin_faces(proj, mods.faces, S, K, blur), 10)
                  for m, blur in (("soft", rc.BLUR_RADIUS), ("hard", 0.0))}
        prof = {"device_ms_per_iter": dev_ms, "by_kind": per_iter, "bin_ms": bin_ms,
                "busy_share": dev_ms / ms_iter}
        log(f"[evaluate] one TTO iteration: {dev_ms:.4f} ms of device time ((20 - 10 "
            f"iterations) / 10) against {ms_iter:.3f} ms by host clock (device busy "
            f"{100 * dev_ms / ms_iter:.1f}%); by kind "
            + json.dumps({k: round(v, 4) for k, v in per_iter.items()})
            + f"; bin pass alone {json.dumps(bin_ms)} ms")
    kernels = _mf_kernels(torch, proj, mods.faces, S, net_hw, B, tag="evaluate")
    log(f"[evaluate] phase {time.perf_counter() - t_phase:.2f} s")
    require(not failures, f"evaluate: {len(failures)} checks failed: {failures}")
    launches = {k: sum(r["launches"][k] for r in runs.values()) for k in runs["a"]["launches"]}
    return {"launches": launches, "runs": {k: {x: r[x] for x in ("secs", "batches", "peak_gib")}
                                           for k, r in runs.items()},
            "ms_per_tto_iter": ms_iter, "ms_per_tto_iter_in_cli": in_cli, "overflow": overflow,
            "profile": prof, "kernels": kernels}


# the mini_tigdog phase: tools/torch_mini_tigdog_parity.py at its full
# widths (60 videos, 144^2 raw, 128^2 crops), its training options cut in
# epochs only, three of its evaluation columns; the videos rendered again
# on the CPU and the epochs of training
MT_CPU_VIDEOS, MT_EPOCHS = 2, 10
MT_COLUMNS, MT_TTO_ITERS = ("after", "gtcam_al", "tto"), 60
# the mini_cub phase: tools/torch_mini_cub_parity.py's 512 + 24 images at
# 192^2; the images rendered again on the CPU and the train steps
MC_CPU_IMAGES, MC_STEPS = 4, 200
# tests/test_torch_port_synthetic.py's keypoint bound on the demo's
# template (subdivide 3, 12 handles), in [-1, 1] units
KP_BOUND = 1e-4


def _falling(losses, what):
    """The mean of the last tenth of `losses` below the first tenth's."""
    require(len(losses) >= 2 and np.isfinite(losses).all(),
            f"{what}: {len(losses)} losses, or a non-finite one")
    n = max(1, len(losses) // 10)
    first, last = float(np.mean(losses[:n])), float(np.mean(losses[-n:]))
    require(last < first, f"{what}: loss did not fall (first tenth {first}, last {last})")
    return first, last


def _tto_recorder(real_make, calls):
    """predictor.make_tto_step_fn's stand-in: the CLI's refiner, recording
    per batch (loss at iteration 0 (a 0-step refine, uncounted), final
    loss)."""
    def make(mods, tto, num_frames, trace_vert2kp=None):
        refine = real_make(mods, tto, num_frames, trace_vert2kp)
        zero_steps = real_make(mods, dataclasses.replace(tto, num_iter=0), num_frames)

        def run(mean_shape, lbs, delta, cam, batch):
            with uncounted():
                loss0 = zero_steps(mean_shape, lbs, delta, cam, batch)[2]
            out = refine(mean_shape, lbs, delta, cam, batch)
            calls.append((float(loss0), float(out[2])))
            return out
        return run
    return make


def _masks_on_images(n=20):
    """The TigDog augmentation's mask warp held to its image warp on this
    host's cv2: n random ellipses (image = 1 - mask, so the image's border
    fill of 1 reads as background) through MultiFrameDataset._affine at
    the augmentation's zooms and shifts; returns the least share of pixels
    where the warped image thresholded at 0.5 and the warped mask agree
    (only the ellipse's boundary pixels may differ)."""
    from acfm_video_3d_reconstruction_tpu_torch.data import tigdog as tig

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:64, :64]
    least = 1.0
    for _ in range(n):
        cy, cx, ry, rx = rng.uniform(20, 44), rng.uniform(20, 44), *rng.uniform(6, 18, 2)
        mask = ((((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1).astype(np.float64)
        imgs = np.repeat((1.0 - mask)[None, ..., None], 3, -1)
        zoom, shift = rng.uniform(0.8, 1.05), rng.uniform(-0.05, 0.05, 2)
        wi, wm, _ = tig.MultiFrameDataset._affine(None, imgs, mask[None], np.zeros((1, 1, 3)),
                                                  zoom, shift)
        least = min(least, float(((wi[0, ..., 0] < 0.5) == (wm[0] > 0.5)).mean()))
    return least


def phase_mini_tigdog(torch, device, card, tmp):
    """The mini-TigDog parity run (tools/torch_mini_tigdog_parity.py) cut in
    epochs only: the multiframe CLI pair trained and evaluated to
    convergence on synthetic clips with known GT cameras.

    0. The augmentation's mask warp against its image warp (_masks_on_images):
       at least 99% of the pixels agree on every one of 20 warps. The mask
       warp is numpy (data/image_utils.py::warp_affine_nearest); through
       OpenCV 4.13's nearest warp of a float64 mask it would not be.
    a. generate() at the tool's widths (60 videos of 6 frames at 144^2):
       exactly 1 soft + 1 hard launch per video, no bin overflow (K = F =
       1280). The first MT_CPU_VIDEOS videos again on the CPU (the plain
       rasterizer): sfm_poses, bboxes and the background (every pixel both
       masks leave off the mesh: the numpy draws) bit-equal, masks equal on
       >= 99.9% of the pixels, landmarks within KP_BOUND (in raw pixels),
       the frames within 1e-4 where both masks cover the pixel and the hard
       z-buffers pick the same face (the solve's rounding, card against
       CPU, reaches the face normals).
    b. multiframe_main.train with the tool's options (G 4, batch 4 clips x 2
       frames at 128^2, 32 views a step, subdivide 3, 12 handles, 8
       keypoints, kp 30, mask 5, texture off, of_loss_wt 0, warm-up 2 reps,
       init_camera_emb, no mirror) for MT_EPOCHS of its 40 epochs. Launches,
       exactly: per warm-up step 1 soft + 1 soft_bwd; per train step 1 soft
       + 1 soft_bwd (texture off: no hard render of the mirrored view; flow
       off: no cost volume); the init_camera_emb pass none; with S the
       steps of an epoch, num_reps * S warm-up and MT_EPOCHS * S train steps.
       Every metrics.jsonl record finite; the main loop's total_loss falling
       (the last tenth of its logged steps below the first tenth). Logs the
       multiplex report (the tool's multiplex_report from the state after
       the init_camera_emb pass): each hypothesis's distance from its row,
       the argmax histogram over the training frames and its share at
       hypothesis 0, the mean shape's and the BatchNorm statistics' change.
    c. One train step (k = 4, 32 views at K = 1280) from the trained state on
       the first train batch through the kernels and through the plain
       rasterizer, under deterministic algorithms: loss matrix and probs
       within rel 1e-4 per entry, every gradient within vector rel 1e-4,
       mean_v within the solve's 1e-3. Each rasterizer kernel alone at the
       step's 32 views (_raster_alone).
    d. multiframe_evaluate.evaluate in-process with the tool's options for
       the columns MT_COLUMNS (trained; gauge-aligned GT camera; TTO of the
       tool's 60 iterations). Launches per batch, exactly: 1 soft without
       TTO; with N TTO iterations N+2 soft (one an iteration, the final
       loss, the evaluated mask), N soft_bwd, no hard (the flow term, which
       takes the hard visibility, is off) and no cost volume. The TTO loss
       lower than at iteration 0 on every batch; IoU and PCK finite and in
       [0, 1]. Logs the three columns."""
    import os
    import pickle

    from acfm_video_3d_reconstruction_tpu_torch.cli import multiframe_evaluate as mfe
    from acfm_video_3d_reconstruction_tpu_torch.cli import multiframe_main
    from acfm_video_3d_reconstruction_tpu_torch.eval import predictor
    from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer as ras
    from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer_cuda as rc
    from acfm_video_3d_reconstruction_tpu_torch.train import multiframe as mf

    tool = _tool("torch_mini_tigdog_parity")
    t_phase = time.perf_counter()
    import cv2

    on_image = _masks_on_images()
    log(f"[mini_tigdog] the augmentation's masks on its images (cv2 {cv2.__version__}): "
        f"least agreement {on_image:.4f} over 20 warps")
    require(on_image >= 0.99, f"mini_tigdog: the augmented masks leave their images "
            f"(agreement {on_image}; the nearest warp of cv2 {cv2.__version__})")
    template = tool.build_template()
    root = os.path.join(tmp, "mini_tigdog")
    n_v, RAW = tool.N_VIDEOS, tool.RAW
    zero_launches()
    t0 = time.perf_counter()
    info = tool.generate(root, template, device)
    gen_s = time.perf_counter() - t0
    gen_launches = read_launches()
    require(gen_launches == only(soft=n_v, hard=n_v),
            f"mini_tigdog generate: launches {gen_launches} != 1 soft + 1 hard per video ({n_v})")
    require(info["overflow"] == 0, f"mini_tigdog generate: bins drop {info['overflow']} faces")
    cpu = tool.generate(os.path.join(tmp, "mini_tigdog_cpu"), template, "cpu",
                        videos=MT_CPU_VIDEOS)
    agree, kp_err, shade_err = [], 0.0, 0.0
    for v in range(MT_CPU_VIDEOS):
        pkls = []
        for r in (root, os.path.join(tmp, "mini_tigdog_cpu")):
            with open(os.path.join(r, "horse", f"video_{v:03d}.pkl"), "rb") as fh:
                pkls.append(pickle.load(fh))
        card_v, cpu_v = pkls
        for key in ("sfm_poses", "bboxes"):
            require(np.array_equal(card_v[key], cpu_v[key]),
                    f"mini_tigdog video {v}: {key} card {card_v[key][0]} cpu {cpu_v[key][0]}")
        mc, mp_ = card_v["segmentations"], cpu_v["segmentations"]
        agree.append(float((mc == mp_).mean()))
        lc, lp = card_v["landmarks"], cpu_v["landmarks"]
        kp_err = max(kp_err, float(np.abs(lc[..., :2] - lp[..., :2]).max()))
        require(np.array_equal(lc[..., 2], lp[..., 2]), f"mini_tigdog video {v}: visibility")
        off = (mc == 0) & (mp_ == 0)
        require(np.array_equal(card_v["video"][off], cpu_v["video"][off]),
                f"mini_tigdog video {v}: background differs")
        same = ((mc == 1) & (mp_ == 1)
                & (info["pix_to_face"][v] == cpu["pix_to_face"][v]).reshape(mc.shape))
        shade_err = max(shade_err, float(np.abs(card_v["video"][same]
                                                - cpu_v["video"][same]).max()))
    log(f"[mini_tigdog] generated {n_v} videos of {tool.T_RAW} frames at {RAW}^2 in "
        f"{gen_s:.2f} s; launches {gen_launches}; bin overflow 0; card vs CPU, first "
        f"{MT_CPU_VIDEOS} videos: sfm_poses, bboxes, background bit-equal, masks equal on "
        f"{agree} of the pixels, landmarks max err {kp_err:.3g} px, frames where the faces "
        f"agree max err {shade_err:.3g}")
    require(min(agree) >= 0.999, f"mini_tigdog card vs cpu: masks agree on {agree}")
    require(kp_err <= KP_BOUND * (RAW - 1) / 2, f"mini_tigdog card vs cpu: landmarks {kp_err}")
    require(shade_err <= 1e-4, f"mini_tigdog card vs cpu: frames {shade_err}")

    o = tool.train_opts(root, MT_EPOCHS, device=str(device))
    seen = {"warm": 0, "train": 0}
    real_warm, real_train, real_vis = mf.make_warmup_step, mf.make_train_step, ras.soft_silhouette_vis

    def counting_warm(mods):
        step = real_warm(mods)

        def run(batch):
            seen["warm"] += 1
            return step(batch)
        return run

    def counting_train(mods, **kw):
        step = real_train(mods, **kw)

        def run(batch):
            seen["train"] += 1
            if "batch" not in seen:
                seen.update(batch=batch, mods=mods, k=kw["k"])
            return step(batch)
        return run

    def watching_vis(verts, *a, **kw):
        if seen["train"] == 1 and "views" not in seen:  # the first train step's
            seen["views"] = verts.detach()
        return real_vis(verts, *a, **kw)

    mf.make_warmup_step, mf.make_train_step = counting_warm, counting_train
    ras.soft_silhouette_vis = watching_vis
    try:
        zero_launches()
        t0 = time.perf_counter()
        with tool.recording_start({}) as start:
            mods = multiframe_main.train(o)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = read_launches()
    finally:
        mf.make_warmup_step, mf.make_train_step = real_warm, real_train
        ras.soft_silhouette_vis = real_vis
    mpx_report = tool.multiplex_report(start["start"], tool.snapshot(mods))
    require(sum(mpx_report["argmax_hist"]) == mods.mpx.probs.shape[0]
            and all(np.isfinite(mpx_report["hyp_dist"])),
            f"mini_tigdog multiplex report {mpx_report}")
    log(f"[mini_tigdog] multiplex after training, from the init_camera_emb pass: "
        f"{json.dumps(mpx_report)}")
    n_w, n_t, spe = seen["warm"], seen["train"], mods.steps_per_epoch
    require(n_w == o["num_reps"] * spe and n_t == MT_EPOCHS * spe,
            f"mini_tigdog: {n_w} warm-up and {n_t} train steps at {spe} steps an epoch")
    require(train_launches == only(soft=n_w + n_t, soft_bwd=n_w + n_t),
            f"mini_tigdog train launches {train_launches} != 1 soft + 1 soft_bwd per warm-up "
            f"({n_w}) and train ({n_t}) step")
    with open(os.path.join(o["checkpoint_dir"], o["name"], "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh if line.strip()]
    for r in recs:
        bad = [k for k, v in r.items() if not np.isfinite(v)]
        require(not bad, f"mini_tigdog: non-finite {bad} at step {r['step']}")
    main_loss = [r["total_loss"] for r in recs if "total_loss" in r]
    first, last = _falling(main_loss, "mini_tigdog main loop")
    log(f"[mini_tigdog] train, the tool's options, {MT_EPOCHS} epochs: {n_w} warm-up + {n_t} "
        f"train steps ({spe} an epoch) in {train_s:.2f} s; launches {train_launches}; main-loop "
        f"total_loss first tenth {first:.5g}, last tenth {last:.5g} over {len(main_loss)} "
        f"logged steps; card {card}")
    log("[mini_tigdog] main-loop total_loss every log_every: "
        + json.dumps([round(x, 4) for x in main_loss]))

    batch, k = seen["batch"], seen["k"]
    state = copy.deepcopy(mods.model.state_dict())
    mpx_state = copy.deepcopy(mods.mpx.state_dict())

    def one_step(plain):
        mods.model.load_state_dict(state)
        mods.mpx.load_state_dict(mpx_state)
        mods.model.zero_grad(set_to_none=True)
        mods.mpx.zero_grad(set_to_none=True)
        with deterministic_algorithms(torch), \
                (plain_rasterizer() if plain else contextlib.nullcontext()):
            loss, aux = mf.forward(mods, batch, k=k, train=True, drop_deform=True)
            aux["pred_v"].retain_grad()
            loss.backward()
        grads = _mf_grads(mods)
        grads["pred_v"] = aux["pred_v"].grad.detach().cpu()
        return aux["loss_matrix"].detach(), aux["probs"].detach(), grads

    with uncounted():
        ref, plain = one_step(False), one_step(True)
    mods.model.load_state_dict(state)
    mods.mpx.load_state_dict(mpx_state)

    def rel_entries(x, y):
        return ((x - y).abs() / y.abs().clamp_min(1e-12)).max().item()

    lm_err, p_err = rel_entries(plain[0], ref[0]), rel_entries(plain[1], ref[1])
    worst, solve_fed = _mf_grad_errors(plain[2], ref[2], "mini_tigdog kernels vs plain", 1e-4)
    views = seen["views"]
    log(f"[mini_tigdog] one train step from the trained state (k={k}, {views.shape[0]} views "
        f"at {o['img_size']}^2, K={rc.auto_K(mods.faces.shape[0], o['img_size'], ras.DEFAULT_K)}), "
        f"deterministic, "
        f"kernels vs plain: loss matrix rel {lm_err:.3g}, probs rel {p_err:.3g}, worst "
        f"gradient rel {worst[1]:.3g} ({worst[0]}), {solve_fed}")
    require(lm_err <= 1e-4, f"mini_tigdog kernels vs plain: loss matrix rel {lm_err} > 1e-4")
    require(p_err <= 1e-4, f"mini_tigdog kernels vs plain: probs rel {p_err} > 1e-4")
    with uncounted():
        kernels = _raster_alone(torch, views, mods.faces, o["img_size"], "mini_tigdog")
    del mods

    N = MT_TTO_ITERS
    real_make = predictor.make_tto_step_fn
    columns, eval_launches = {}, dict.fromkeys(read_launches(), 0)
    for key in MT_COLUMNS:
        eo = tool.eval_opts(o, tool.plan_flags(key, N))
        calls = []
        predictor.make_tto_step_fn = _tto_recorder(real_make, calls)
        try:
            zero_launches()
            t0 = time.perf_counter()
            stats = mfe.evaluate(eo)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = read_launches()
        finally:
            predictor.make_tto_step_fn = real_make
        n_b, res = len(stats.ious), stats.results()
        if eo["optimize"]:
            want = only(soft=n_b * (N + 2), soft_bwd=n_b * N)
            require(len(calls) == n_b and all(c[1] < c[0] for c in calls),
                    f"mini_tigdog {key}: TTO loss (iteration 0, final) per batch {calls}")
        else:
            want = only(soft=n_b)
        require(launches == want, f"mini_tigdog {key}: launches {launches} != {want} "
                f"({n_b} batches)")
        require(n_b > 0 and all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in res.values()),
                f"mini_tigdog {key}: {n_b} batches, {res}")
        for name, n in launches.items():
            eval_launches[name] += n
        columns[key] = res
        log(f"[mini_tigdog] evaluate {key} {tool.plan_flags(key, N)}: {n_b} batches in "
            f"{secs:.2f} s; launches {launches}; {json.dumps(res)}"
            + (f"; TTO loss per batch (iteration 0, final) "
               f"{json.dumps([[round(x, 6) for x in c] for c in calls])}" if calls else ""))
    secs = time.perf_counter() - t_phase
    log(f"[mini_tigdog] phase {secs:.2f} s")
    return {"launches": {name: gen_launches[name] + train_launches[name] + eval_launches[name]
                         for name in gen_launches},
            "train_launches": train_launches, "warmup_steps": n_w, "train_steps": n_t,
            "loss_first_last_tenth": (first, last), "columns": columns, "kernels": kernels,
            "multiplex": mpx_report,
            "seconds": secs}


def phase_mini_cub(torch, device, card, tmp):
    """The mini-CUB parity run (tools/torch_mini_cub_parity.py) cut in steps
    only: the monocular model trained on synthetic birds in the CUB schema.

    a. generate() at the tool's widths (512 + 24 images at 192^2): exactly 1
       soft + 1 hard launch per GEN_CHUNK images, no bin overflow (K = F =
       1280). The first MC_CPU_IMAGES images rendered again on the CPU (the
       plain rasterizer) against what the card's tree holds: rel_path, the
       bbox and the sfm entry (scale, trans, rot) bit-equal, the mask equal
       on >= 99.9% of its pixels, the parts within KP_BOUND (raw pixels)
       and their visibility row equal, the PNG within one level on >= 99.9%
       of its pixels; S within KP_BOUND.
    b. run_parity for MC_STEPS steps (the tool's loop: batch 8 at 128^2,
       bf16 nets, GT pose, texture on). Launches, exactly: per train step 1
       soft + 1 hard + 1 soft_bwd; per eval batch 1 soft + 1 hard (the test
       split before and after, the train split after). The loss falling
       (the last tenth of the steps below the first tenth); no synchronizing
       operation in a train step. Logs IoU and PCK before and after."""
    import os

    import cv2
    import scipy.io as sio

    tool = _tool("torch_mini_cub_parity")
    t_phase = time.perf_counter()
    template = tool.tig.build_template(tex_size=4)
    root = os.path.join(tmp, "mini_cub")
    n_img, RAW = tool.N_TRAIN + tool.N_TEST, tool.RAW
    chunks = -(-n_img // tool.GEN_CHUNK)
    zero_launches()
    t0 = time.perf_counter()
    tool.generate(root, template, device=device)
    gen_s = time.perf_counter() - t0
    gen_launches = read_launches()
    require(gen_launches == only(soft=chunks, hard=chunks),
            f"mini_cub generate: launches {gen_launches} != 1 soft + 1 hard per "
            f"{tool.GEN_CHUNK} images ({chunks})")

    cams, deform = tool.draw(n_img)
    r = tool.render(template, cams[:MC_CPU_IMAGES], deform[:MC_CPU_IMAGES], "cpu")
    require(r["overflow"] == 0, f"mini_cub: bins drop {r['overflow']} faces")
    load = functools.partial(sio.loadmat, struct_as_record=False, squeeze_me=True)
    images = load(os.path.join(root, "cache", "data", "train_cub_cleaned.mat"))["images"]
    sfm_mat = load(os.path.join(root, "cache", "sfm", "anno_train.mat"))
    agree, png_close, kp_err = [], [], 0.0
    for i in range(MC_CPU_IMAGES):
        rel, img, mask, bbox, parts, sfm = tool.image_record(i, "train", i, r, cams)
        a, s = images[i], sfm_mat["sfm_anno"][i]
        require(a.rel_path == rel, f"mini_cub image {i}: {a.rel_path} != {rel}")
        require(all(getattr(a.bbox, key) == v for key, v in bbox.items()),
                f"mini_cub image {i}: bbox card {vars(a.bbox)} cpu {bbox}")
        for key, want in zip(("scale", "trans", "rot"), sfm):
            require(np.array_equal(np.atleast_1d(getattr(s, key)), np.atleast_1d(want)),
                    f"mini_cub image {i}: sfm {key}")
        agree.append(float((a.mask == mask).mean()))
        kp_err = max(kp_err, float(np.abs(a.parts[:2] - parts[:2]).max()))
        require(np.array_equal(a.parts[2], parts[2]), f"mini_cub image {i}: visibility")
        png = cv2.cvtColor(cv2.imread(os.path.join(root, "images", rel)), cv2.COLOR_BGR2RGB)
        png_close.append(float((np.abs(png.astype(np.int16) - img) <= 1).mean()))
    s_err = float(np.abs(sfm_mat["S"] - r["S"].T).max())
    log(f"[mini_cub] generated {tool.N_TRAIN} + {tool.N_TEST} images at {RAW}^2 in "
        f"{gen_s:.2f} s; launches {gen_launches}; card vs CPU, first {MC_CPU_IMAGES} images: "
        f"rel_path, bbox, sfm bit-equal, masks equal on {agree}, PNGs within one level on "
        f"{png_close} of the pixels, parts max err {kp_err:.3g} px, S max err {s_err:.3g}")
    require(min(agree) >= 0.999, f"mini_cub card vs cpu: masks agree on {agree}")
    require(min(png_close) >= 0.999, f"mini_cub card vs cpu: PNGs within one level {png_close}")
    require(kp_err <= KP_BOUND * RAW / 2, f"mini_cub card vs cpu: parts {kp_err}")
    require(s_err <= KP_BOUND, f"mini_cub card vs cpu: S {s_err}")

    n_eval = 2 * -(-tool.N_TEST // tool.BATCH) + -(-tool.N_TRAIN // tool.BATCH)
    zero_launches()
    res = tool.run_parity(root, MC_STEPS, device, log=lambda m: log(f"[mini_cub] {m}"))
    launches = read_launches()
    require(launches == only(soft=MC_STEPS + n_eval, hard=MC_STEPS + n_eval,
                             soft_bwd=MC_STEPS),
            f"mini_cub launches {launches} != 1 soft + 1 hard + 1 soft_bwd per train step "
            f"({MC_STEPS}) and 1 soft + 1 hard per eval batch ({n_eval})")
    first, last = _falling(res["losses"], "mini_cub")
    with uncounted():
        stacks = _sync_ops(torch, lambda: res["train_step"](res["batch"]))
    for st in stacks[:3]:
        log("[mini_cub] synchronizing operation in a train step:\n" + st)
    require(not stacks, f"mini_cub: {len(stacks)} synchronizing operations in a train step")
    secs = time.perf_counter() - t_phase
    log(f"[mini_cub] {MC_STEPS} steps of batch {tool.BATCH} at {tool.IMG}^2 in "
        f"{res['seconds']:.2f} s; launches {launches}; loss first tenth {first:.5g}, last "
        f"tenth {last:.5g}; before {json.dumps(res['before'])}, after "
        f"{json.dumps(res['after'])}, train split after {json.dumps(res['after_train'])}; no "
        f"synchronizing operation in a train step; card {card}")
    log(f"[mini_cub] phase {secs:.2f} s")
    return {"launches": {name: gen_launches[name] + launches[name] for name in launches},
            "before": res["before"], "after": res["after"], "after_train": res["after_train"],
            "loss_first_last_tenth": (first, last), "seconds": secs}


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
    tensors too (no kernel launch, no count): the flow path's reference.
    make_flow_fn's pass runs eagerly there, neither captured nor replayed
    (utils/graphs.py): a graph holds the kernel's launches."""
    from acfm_video_3d_reconstruction_tpu_torch.flow import correlation_cuda as cc
    from acfm_video_3d_reconstruction_tpu_torch.utils import graphs

    kernel, run = cc.correlation_cuda, graphs.run
    cc.correlation_cuda = cc.correlation_plain
    graphs.run = lambda name, owner, device, signature, eager, **_: eager()
    try:
        yield
    finally:
        cc.correlation_cuda, graphs.run = kernel, run


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
    # the eager pass: the net's forward hooks see no replay
    flops = _conv_flops(torch, net, lambda: infer.clip_flows(net, clips, IMG, FLOW_NET_HW))
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


# the parallel phase's two-rank run: 64^2, 4 clips of 2 frames, G 4, the
# deform tables trained, every loss weight on, the flow net at 64x128
PAR_IMG, PAR_CLIPS, PAR_T, PAR_G, PAR_KPS = 64, 4, 2, 4, 5
PAR_NET_HW = (64, 128)
PAR_RANKS = 2
PAR_TIMED = 5  # train steps timed each way at full width


def _par_modules(device):
    """The two-rank run's modules: the CLI's model widths (subdivide 3, 15
    handles, nz_feat 200, tex 6, texture on) at PAR_IMG^2 with PAR_KPS
    keypoints, G = PAR_G, optimize_deform, every loss weight on."""
    from acfm_video_3d_reconstruction_tpu_torch import config as cfg_lib
    from acfm_video_3d_reconstruction_tpu_torch.models.template import build_template
    from acfm_video_3d_reconstruction_tpu_torch.train import multiframe as mf

    template = build_template(subdivide=3, num_lbs=15, tex_size=6, num_kps=PAR_KPS)
    cfg = cfg_lib.Config(
        model=dataclasses.replace(cfg_lib.ModelConfig(), img_size=PAR_IMG, nz_feat=200,
                                  num_lbs=15, num_kps=PAR_KPS, tex_size=6, texture=True,
                                  symmetric=False, symmetric_texture=False),
        multiplex=dataclasses.replace(cfg_lib.MultiplexConfig(), num_guesses=PAR_G,
                                      optimize_deform=True),
        train=dataclasses.replace(cfg_lib.TrainConfig(), batch_size=PAR_CLIPS,
                                  num_frames=PAR_T, offset_z=0.0),
        mf_weights=dataclasses.replace(cfg_lib.MultiframeLossWeights(), kp=1.0,
                                       handle_deform_reg=0.1),
    )
    return mf.build(cfg, template, PAR_CLIPS * PAR_T * 2, seed=0, device=device)


def _par_batch(seed, frames_idx=None) -> dict:
    """A global batch of PAR_CLIPS clips (numpy)."""
    rng = np.random.default_rng(seed)
    B, T, H = PAR_CLIPS, PAR_T, PAR_IMG
    kp = rng.uniform(-1, 1, (B, T, PAR_KPS, 3)).astype(np.float32)
    kp[..., 2] = rng.random((B, T, PAR_KPS)) > 0.3
    return {
        "img": rng.random((B, T, H, H, 3), np.float32),
        "mask": (rng.random((B, T, H, H)) > 0.5).astype(np.float32),
        "kp": kp,
        "sfm_pose": np.tile(np.asarray([0.8, 0, 0, 1, 0, 0, 0], np.float32), (B, T, 1)),
        "frames_idx": (np.arange(B * T, dtype=np.int32).reshape(B, T)
                       if frames_idx is None else frames_idx),
        "mirror_flag": rng.integers(0, 2, (B, T)).astype(np.int32),
        "transforms": np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (B, T, 1)),
        "edt": rng.random((B * T, H, H)).astype(np.float32),
        "bdt": rng.random((B * T, H, H)).astype(np.float32),
        "boundaries": rng.random((B * T, 32, 3)).astype(np.float32),
    }


def _par_program(device):
    """The two-rank run's Program (parallel/checks.py): the camera-embedding
    init, a warm-up step, a train step at k = G and one at k = 2 on frames
    shared by clips of both ranks (frame 1 in clips 0 and 3, frame 5 in
    clips 1 and 2), each on this process's block, the flows from the
    frozen flow net on the block (15 cost volumes a call)."""
    import torch

    from acfm_video_3d_reconstruction_tpu_torch.flow import infer
    from acfm_video_3d_reconstruction_tpu_torch.flow import maskflownet as mfn
    from acfm_video_3d_reconstruction_tpu_torch.parallel import checks
    from acfm_video_3d_reconstruction_tpu_torch.parallel import mesh as pmesh
    from acfm_video_3d_reconstruction_tpu_torch.train import multiframe as mf

    mods = _par_modules(device)
    net = mfn.build(mfn.init_params(torch.Generator().manual_seed(0)), device)
    flow_fn = infer.make_flow_fn(net, PAR_IMG, PAR_NET_HW)
    shared = np.arange(PAR_CLIPS * PAR_T, dtype=np.int32).reshape(PAR_CLIPS, PAR_T) + 2
    shared[0, 1] = shared[3, 0] = 1
    shared[1, 0] = shared[2, 1] = 5
    batches = [_par_batch(1), _par_batch(2), _par_batch(3, shared)]

    def put(b, flows=True):
        db = mf.to_device_batch(mods, pmesh.shard_batch(b))
        return flow_fn(db) if flows else db

    steps = [("init_camera_emb", lambda: mf.init_camera_emb(mods, put(batches[0], False))
              or {}),
             ("warm-up", lambda: mf.make_warmup_step(mods)(put(batches[0]))),
             ("train k=G", lambda: mf.make_train_step(mods, k=PAR_G, drop_deform=False)(
                 put(batches[1]))),
             ("train k=2", lambda: mf.make_train_step(mods, k=2, drop_deform=False)(
                 put(batches[2])))]
    return checks.Program(mods.model, {"opt": mods.opt, "warm_opt": mods.warm_opt}, steps,
                          mpx=mods.mpx, mods=mods)


def _par_rank(device, work):
    """One rank of the two-rank run (spawned; parallel/ranks.py): the
    Program step by step from the reference's states under deterministic
    algorithms (parallel/checks.py::run_rank); its launches."""
    import torch

    from acfm_video_3d_reconstruction_tpu_torch.parallel import checks

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prog = _par_program(device)
    with deterministic_algorithms(torch):
        zero_launches()
        steps = checks.run_rank(prog, work, "par")
        launches = read_launches()
        warmups = flow_passes(0)
    return {"steps": steps, "launches": launches, "flow_warmups": warmups}


@contextlib.contextmanager
def _cudnn_off(torch):
    with torch.backends.cudnn.flags(enabled=False):
        yield


def _step_ms(torch, step, db, n):
    """Host-clock ms of each of n steps, each ending in a synchronize."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        step(db)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _spread(xs):
    return (max(xs) - min(xs)) / float(np.median(xs))


def phase_parallel(torch, device, card, mf_run, tmp, profile=None):
    """Data parallelism (parallel/mesh.py), in two parts.

    (a) A world of one over NCCL (gloo on the CPU) at full width: the
    multiframe train step at the CLI defaults (the multiframe phase's
    options, 128 views, the flow call of prep on its first train batch),
    through the group and with no group, from one recorded state, under
    deterministic algorithms: every tensor after the step equal bit for bit
    (parameters, BatchNorm statistics, multiplex tables, Adam moments,
    metrics), mean_v and its moments within vector relative error 1e-3 (the
    watch list's floors); the same launches both ways. Each way PAR_TIMED
    steps timed (host clock, PyTorch's default algorithms) with their
    spread, in turn (no group, the group, no group again, each after one
    untimed step); one group step profiled: the NCCL kernels' share of its
    device time, all_reduce_grads' host time and its time between CUDA
    events.

    (b) PAR_RANKS ranks over gloo on the one card (NCCL puts one rank on a
    card), spawned: _par_program at 64^2 (the init, a warm-up step, two
    train steps), each step held from the reference's state before it
    against one process on the whole batch on the card
    (parallel/checks.py's rules: params, BatchNorm statistics, Adam moments,
    cams and deform at rtol 1e-4 / atol 1e-5, probs at rtol 1e-3; the floor
    is the reference step under PyTorch's default algorithms and with cuDNN
    off), the ranks identical bit for bit, each rank launching every kernel:
    3 soft, 2 hard, 3 soft_bwd, 15 md=4 and 30 md=2 cost volumes.
    Returns the group step's launches plus the ranks'."""
    import os

    from acfm_video_3d_reconstruction_tpu_torch.cli import multiframe_main
    from acfm_video_3d_reconstruction_tpu_torch.parallel import checks
    from acfm_video_3d_reconstruction_tpu_torch.parallel import mesh as pmesh
    from acfm_video_3d_reconstruction_tpu_torch.parallel.ranks import Ranks
    from acfm_video_3d_reconstruction_tpu_torch.train import multiframe as mf

    t_phase = time.perf_counter()
    o, upload = mf_run["opts"], mf_run["batch"]
    cfg = multiframe_main.build_cfg(o)
    mods = mf.build(cfg, multiframe_main.build_mf_template(cfg), mf_run["num_frames"], seed=0,
                    device=device)
    flow_fn = multiframe_main.make_flow_fn_from_opts(o, o["img_size"], device)
    G, B, T = o["num_guesses"], o["batch_size"], o["num_frames"]
    step = mf.make_train_step(mods, k=G, drop_deform=True)
    prog = checks.Program(mods.model, {"opt": mods.opt, "warm_opt": mods.warm_opt}, [],
                          mpx=mods.mpx, mods=mods)
    state0 = prog.state()
    # mean_v's Adam moments are named by the parameter's index in the optimizer
    opt_params = [p for g in mods.opt.param_groups for p in g["params"]]
    i_mean_v = next(i for i, p in enumerate(opt_params) if p is mods.model.mean_v)
    mean_v_keys = ("model.mean_v", f"opt[{i_mean_v}].")

    def one_step():
        prog.load(state0, keep_probs=False)
        with deterministic_algorithms(torch):
            zero_launches()
            metrics = step(flow_fn(dict(pmesh.shard_batch(upload))))
            torch.cuda.synchronize()
            launches = read_launches()
        return {k: float(v) for k, v in metrics.items()}, checks.flat(prog.state()), launches

    db = flow_fn(dict(upload))
    with deterministic_algorithms(torch):  # its own flow graph, captured outside the count
        flow_fn(dict(upload))
    alone = one_step()
    prog.load(state0, keep_probs=False)
    ms_alone = _step_ms(torch, step, db, PAR_TIMED + 1)[1:]  # the first warms up
    backend = "nccl" if device.type == "cuda" else "gloo"
    pmesh.init(backend, "file://" + os.path.join(tmp, "world_of_one"), 1, 0, device, 300.0)
    try:
        grouped = one_step()
        prog.load(state0, keep_probs=False)
        ms_group = _step_ms(torch, step, db, PAR_TIMED + 1)[1:]
        reduce_ms, reduce_dev_ms, nccl = [], [], {}
        real_reduce = pmesh.all_reduce_grads

        def timed_reduce(params):
            params = list(params)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            real_reduce(params)
            end.record()
            torch.cuda.synchronize()
            reduce_ms.append((time.perf_counter() - t0) * 1e3)
            reduce_dev_ms.append(start.elapsed_time(end))

        pmesh.all_reduce_grads = timed_reduce
        try:
            total, kinds = _mf_profile(torch, lambda: step(db), f"one train step through a "
                                       f"world of one ({backend}, k={G}, {G * B * T} views)",
                                       profile, tag="parallel", extra_kinds=(("NCCL", ("nccl",)),))
        finally:
            pmesh.all_reduce_grads = real_reduce
        nccl = {"step_device_ms": total, "nccl_device_ms": kinds.get("NCCL", 0.0),
                "all_reduce_grads_host_ms": reduce_ms, "all_reduce_grads_event_ms": reduce_dev_ms}
    finally:
        pmesh.shutdown()
    prog.load(state0, keep_probs=False)
    ms_after = _step_ms(torch, step, db, PAR_TIMED + 1)[1:]  # no group again
    (m_a, s_a, l_a), (m_g, s_g, l_g) = alone, grouped
    require(l_a == l_g and l_a["soft"] == 1 and l_a["hard"] == 1 and l_a["soft_bwd"] == 1,
            f"parallel world of one: launches {l_g} through the group, {l_a} without")
    require(m_a.keys() == m_g.keys() and s_a.keys() == s_g.keys(), "parallel: keys differ")
    unequal, mean_v = [], 0.0
    for k, v in s_a.items():
        if (torch.equal(v, s_g[k]) if torch.is_tensor(v) else v == s_g[k]):
            continue
        if k.startswith(mean_v_keys):
            mean_v = max(mean_v, _rel_vec(torch, s_g[k], v))
        else:
            unequal.append(k)
    unequal += [f"metric {k}" for k in m_a if m_a[k] != m_g[k]]
    log(f"[parallel] world of one ({backend}) vs no group, one train step from one state "
        f"(k={G}, {G * B * T} views, deterministic algorithms): {len(s_a)} tensors, "
        f"{len(unequal)} not bit-equal {unequal[:6]}, mean_v rel {mean_v:.3g}; launches "
        f"{l_g}")
    require(not unequal and mean_v <= 1e-3,
            f"parallel world of one: {unequal} differ, mean_v rel {mean_v}")
    log(f"[parallel] train step ms (host clock, {PAR_TIMED} steps each after one untimed, "
        f"default algorithms), in turn: no group median {np.median(ms_alone):.3f} spread "
        f"{_spread(ms_alone):.3f} {[round(x, 3) for x in ms_alone]}; world of one median "
        f"{np.median(ms_group):.3f} spread {_spread(ms_group):.3f} "
        f"{[round(x, 3) for x in ms_group]}; no group again median {np.median(ms_after):.3f} "
        f"spread {_spread(ms_after):.3f} {[round(x, 3) for x in ms_after]}; profiled group "
        f"step {nccl['step_device_ms']:.3f} ms of device time, NCCL kernels "
        f"{nccl['nccl_device_ms']:.4f} ms, all_reduce_grads {reduce_ms} ms by host clock, "
        f"{reduce_dev_ms} ms between CUDA events; card {card}")
    del mods, db, state0, step, prog

    # (b) two ranks over gloo on the one card against one process
    work = os.path.join(tmp, "parallel")
    os.makedirs(work, exist_ok=True)
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 0
    ranks = Ranks(_par_rank, [str(device)] * PAR_RANKS, "gloo", args=(work,),
                  workdir=os.path.join(work, "ranks"), timeout_s=600.0, threads=2).start()
    t0 = time.perf_counter()
    try:
        prog = _par_program(device)
        if device.type == "cuda":
            floors = (lambda: _default_algorithms(torch), lambda: _cudnn_off(torch))
        else:  # the CPU rehearsal: other thread counts
            floors = tuple(functools.partial(checks.cpu_threads, n) for n in (1, 2))
        with deterministic_algorithms(torch):
            zero_launches()
            checks.record_reference(prog, work, "par", floors=floors)
            ref_launches = read_launches()
    finally:
        ranks_out = ranks.join()
    t_ranks = time.perf_counter() - t0
    n_steps = len(prog.steps)
    del prog
    for r, out in enumerate(ranks_out):
        n_f = 3 + out["flow_warmups"]
        want = only(soft=3, hard=2, soft_bwd=3, corr_md4=5 * n_f, corr_md2=10 * n_f)
        require(out["launches"] == want,
                f"parallel rank {r}: launches {out['launches']} != {want}")
    reports = []
    for i in range(n_steps):
        digests = {out["steps"][i]["digest"] for out in ranks_out}
        rep = checks.merge([out["steps"][i]["report"] for out in ranks_out])
        reports.append(rep)
        worst = max(rep["floor_held"], key=lambda x: x[1] / x[2], default=None)
        log(f"[parallel] {PAR_RANKS} gloo ranks vs one process, step "
            f"{ranks_out[0]['steps'][i]['step']}: fails {rep['fails'][:4]}, held to the floor "
            f"{len(rep['floor_held'])} (worst {worst}), undecided {rep['undecided']} of "
            f"{rep['decided']} (floor {rep['floor_undecided']}), ranks identical "
            f"{len(digests) == 1}")
        require(not rep["fails"] and rep["undecided_ok"] and len(digests) == 1,
                f"parallel step {i + 1}: {rep['fails'][:6]}, undecided {rep['undecided']} of "
                f"{rep['decided']}, digests {digests}")
    log(f"[parallel] {PAR_RANKS} ranks on {n_dev} card(s) over gloo, {n_steps} steps at "
        f"{PAR_IMG}^2 ({PAR_CLIPS} clips of {PAR_T}, G={PAR_G}): {t_ranks:.2f} s with the "
        f"reference and its floors ({ref_launches} launches in this process); phase "
        f"{time.perf_counter() - t_phase:.2f} s")
    launches = {k: l_g[k] + sum(out["launches"][k] for out in ranks_out) for k in l_g}
    return {"launches": launches, "ms_alone": ms_alone, "ms_group": ms_group,
            "ms_alone_after": ms_after, "nccl": nccl,
            "mean_v_rel": mean_v, "reports": reports}


@contextlib.contextmanager
def _default_algorithms(torch):
    """Within deterministic_algorithms: PyTorch's default algorithms."""
    torch.use_deterministic_algorithms(False)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(True, warn_only=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=None,
                    help="append torch.profiler tables of one eval step, one train step, one "
                    "make_flow_fn call, one multiframe flow call and train step and two TTO "
                    "calls here")
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
    synthetic = phase_synthetic(torch, device, card, args.profile)

    records += phase_flow_kernels(torch, device)
    phase_flow_small(torch, device)
    flow_pps, flow_spread, flow_launches = phase_flow(torch, device, args.profile)
    with tempfile.TemporaryDirectory() as tmp:
        multiframe = phase_multiframe(torch, device, card, tmp, args.profile)
        evaluate = phase_evaluate(torch, device, card, multiframe["opts"], tmp, args.profile)
        mini_tigdog = phase_mini_tigdog(torch, device, card, tmp)
        mini_cub = phase_mini_cub(torch, device, card, tmp)
        parallel = phase_parallel(torch, device, card, multiframe, tmp, args.profile)

    counter = {"raster_fwd_soft": "soft", "raster_fwd_hard": "hard",
               "raster_bwd_soft": "soft_bwd", "correlation_md4": "corr_md4",
               "correlation_md2": "corr_md2"}
    for r in records:
        r["launches"] = sum(launches[counter[r["name"]]]
                            for launches in (eval_launches, train_launches, flow_launches,
                                             driver["train_launches"], driver["eval_launches"],
                                             synthetic["launches"], multiframe["launches"],
                                             evaluate["launches"], mini_tigdog["launches"],
                                             mini_cub["launches"], parallel["launches"]))
    n_eval, n_train = EVAL_WINDOWS * EVAL_STEPS, TRAIN_WINDOWS * TRAIN_STEPS
    n_flow = FLOW_WINDOWS * FLOW_CALLS
    log("[result] " + json.dumps({
        "eval_frames_per_s_median": eval_fps, "eval_frames_per_s_spread": eval_spread,
        "train_frames_per_s_median": train_fps, "train_frames_per_s_spread": train_spread,
        "flow_pairs_per_s_median": flow_pps, "flow_pairs_per_s_spread": flow_spread,
        "driver_frames_per_s": driver["frames_per_s"],
        "driver_loader_batches_per_s": driver["loader_batches_per_s"],
        "driver_save_s": driver["save_s"],
        "synthetic_demo_steps": SYN_STEPS, "synthetic_before": synthetic["before"],
        "synthetic_after": synthetic["after"],
        "synthetic_frames_per_s": synthetic["frames_per_s"],
        "synthetic_step_device_ms": synthetic["step_device_ms"],
        "synthetic_peak_gib": synthetic["peak_gib"],
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
        "multiframe_peak_step_gib": multiframe["peak_step_gib"],
        "evaluate_launches": evaluate["launches"], "evaluate_runs": evaluate["runs"],
        "evaluate_ms_per_tto_iter": evaluate["ms_per_tto_iter"],
        "evaluate_ms_per_tto_iter_in_cli": evaluate["ms_per_tto_iter_in_cli"],
        "multiframe_sync_ops": multiframe["sync_ops"],
        "mini_tigdog_epochs": MT_EPOCHS, "mini_tigdog_warmup_steps": mini_tigdog["warmup_steps"],
        "mini_tigdog_train_steps": mini_tigdog["train_steps"],
        "mini_tigdog_loss_first_last_tenth": mini_tigdog["loss_first_last_tenth"],
        "mini_tigdog_columns": mini_tigdog["columns"],
        "mini_tigdog_seconds": mini_tigdog["seconds"], "mini_cub_steps": MC_STEPS,
        "mini_cub_before": mini_cub["before"], "mini_cub_after": mini_cub["after"],
        "mini_cub_after_train": mini_cub["after_train"],
        "mini_cub_loss_first_last_tenth": mini_cub["loss_first_last_tenth"],
        "mini_cub_seconds": mini_cub["seconds"],
        "parallel_step_ms_no_group": parallel["ms_alone"],
        "parallel_step_ms_world_of_one": parallel["ms_group"],
        "parallel_step_ms_no_group_after": parallel["ms_alone_after"],
        "parallel_world_of_one_profile": parallel["nccl"],
        "parallel_world_of_one_mean_v_rel": parallel["mean_v_rel"],
        "parallel_ranks_floor_held": [len(r["floor_held"]) for r in parallel["reports"]],
        "parallel_ranks_undecided": [[r["undecided"], r["decided"]]
                                     for r in parallel["reports"]]}))

    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
