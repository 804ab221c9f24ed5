#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile OUT.txt]

Phases, each of which raises (exit code 1) on failure:
  1. build: compiles every CUDA source of the port with nvcc (sm_90a).
  2. kernels: the binned rasterizer's forward kernel, soft and hard, and
     its soft backward kernel against their plain PyTorch versions at full
     width (B=16, 256^2, the 1280-face icosphere, K from auto_K), with the
     tolerances stated below; times each kernel, its plain version, the bin
     pass and the bound.
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
# The well-conditioned sigma / blur of tests/test_rasterizer_tpu.py's
# gradient parity: at sigma=1e-4 a vertex gradient amplifies an f32
# rounding of the vertex positions by ~1/sigma near silhouette edges.
SIGMA_WIDE, BLUR_WIDE = 5e-3, 6e-2

B, IMG = 16, 256
# the main paths are timed over windows of steps
EVAL_STEPS, EVAL_WINDOWS = 100, 3
TRAIN_STEPS, TRAIN_WINDOWS = 20, 3


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


def _scene(torch, device, seed=0):
    from acfm_video_3d_reconstruction_tpu_torch.geometry import camera, icosphere

    v, f = icosphere.icosphere(3)
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    cams = np.concatenate(
        [rng.uniform(0.6, 0.95, (B, 1)), rng.uniform(-0.1, 0.1, (B, 2)), q], 1
    ).astype(np.float32)
    verts = torch.tensor(v, dtype=torch.float32, device=device)[None].repeat(B, 1, 1) * 0.7
    proj = camera.orthographic_proj_withz(verts, torch.tensor(cams, device=device), offset_z=5.0)
    return proj, torch.tensor(f, dtype=torch.long, device=device)


def phase_kernels(torch, device):
    """Kernel vs plain version, both modes, at the main path's shapes.

    Tolerances (those of tests/test_rasterizer_tpu.py): mask atol 2e-4;
    pix_to_face agreeing on > 99.9% of pixels; barycentrics atol 1e-4 and
    zbuf atol 1e-5 where pix_to_face agrees. The two run the same f32
    arithmetic with the same FMAs; they differ in S's summation order, the
    card's expf/log1pf against PyTorch's, and rare double roundings of the
    plain version's emulated FMA.
    """
    from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer_cuda as rc

    proj, faces = _scene(torch, device)
    F = faces.shape[0]
    K = rc.auto_K(F, IMG, 192)
    ovf = rc.bin_overflow_counts(proj, faces, IMG, K)
    records = []
    for soft in (True, False):
        mode = "soft" if soft else "hard"
        blur = rc.BLUR_RADIUS if soft else 0.0
        table, idx, th, tw = rc.bin_faces(proj, faces, IMG, K, blur)
        if soft:
            log(f"[kernels] scene B={B} {IMG}^2 F={F} K={table.shape[2]} bins {th}x{tw}; "
                f"bin_overflow_counts max {int(ovf.max())}")
        kern = rc.forward_cuda(table, idx, IMG, th, tw, rc.SIGMA, blur, soft)
        torch.cuda.synchronize()
        plain = rc.forward_plain(table, idx, IMG, th, tw, rc.SIGMA, blur, soft)
        agree = kern.pix_to_face == plain.pix_to_face
        frac = agree.float().mean().item()
        hit = agree & (plain.pix_to_face >= 0)
        err_b = max((kern.b0 - plain.b0)[hit].abs().max().item(),
                    (kern.b1 - plain.b1)[hit].abs().max().item())
        err_z = (kern.zbuf - plain.zbuf)[hit].abs().max().item()
        err_m = (torch.exp(kern.S) - torch.exp(plain.S)).abs().max().item() if soft else 0.0
        log(f"[kernels] {mode}: p2f agree {frac:.6f}, bary err {err_b:.3g}, "
            f"zbuf err {err_z:.3g}, mask err {err_m:.3g}")
        require(frac > 0.999, f"{mode}: pix_to_face agreement {frac} <= 0.999")
        require(err_b <= 1e-4, f"{mode}: barycentric error {err_b} > 1e-4")
        require(err_z <= 1e-5, f"{mode}: zbuf error {err_z} > 1e-5")
        require(err_m <= 2e-4, f"{mode}: mask error {err_m} > 2e-4")

        bin_ms = time_cuda(lambda: rc.bin_faces(proj, faces, IMG, K, blur), 10)
        log(f"[kernels] {mode}: bin pass {bin_ms:.4f} ms")
        # table f32, idx int32, counts (B, T) int32 in; five (B, H, W) maps out
        nbytes = (table.numel() + idx.numel() + idx[..., 0].numel() + 5 * B * IMG * IMG) * 4
        records.append(_record(
            f"raster_fwd_{mode}", mode, "raster_fwd.cu", 259,
            lambda: rc.forward_cuda(table, idx, IMG, th, tw, rc.SIGMA, blur, soft),
            lambda: rc.forward_plain(table, idx, IMG, th, tw, rc.SIGMA, blur, soft),
            idx, th * tw, F, nbytes, max(err_b, err_z, err_m)))
    records.append(_backward_record(torch, rc, proj, faces, K))
    return records


def _record(name, mode, source, replaces_line, kernel, plain, idx, bin_pixels, n_faces,
            nbytes, max_abs_err):
    """Time `kernel` and its `plain` version and give the kernel's record.

    The bound is the larger of the operations the function needs (OPS_PER_PAIR
    for each (pixel, valid slot) pair of idx's bins, OPS_PER_FACE once per
    (view, face)) over PEAK_FP32_FLOPS and `nbytes` over PEAK_BYTES_PER_S.
    main() fills in the launches."""
    ms = time_cuda(kernel, 20)
    plain_ms = time_cuda(plain, 3, 1)
    pairs = int((idx >= 0).sum()) * bin_pixels
    ops_s = (pairs * OPS_PER_PAIR[mode] + B * n_faces * OPS_PER_FACE[mode]) / PEAK_FP32_FLOPS
    bytes_s = nbytes / PEAK_BYTES_PER_S
    bound_ms = max(ops_s, bytes_s) * 1e3
    bound_by = "operations" if ops_s >= bytes_s else "bytes"
    log(f"[kernels] {mode}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms; {pairs} (pixel, "
        f"slot) pairs, bound {bound_ms:.4f} ms ({bound_by})")
    return {
        "name": name, "route": "cuda",
        "source": f"acfm_video_3d_reconstruction_tpu_torch/csrc/{source}",
        "replaces": f"acfm_video_3d_reconstruction_tpu/ops/rasterizer_tpu.py:{replaces_line}",
        "launches": None, "max_abs_err": max_abs_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }


def _backward_record(torch, rc, proj, faces, K):
    """The soft backward kernel against backward_plain for a seeded dL/dS,
    at sigma=1e-4 (production) and at SIGMA_WIDE / BLUR_WIDE. The two run
    the same f32 arithmetic per (pixel, slot) and sum over a bin's pixels
    in another order, so the rows differ by summation rounding only:
    vector relative error <= 1e-4. The z columns and every slot past a
    bin's count must be exactly 0 (an invalid slot gathers face 0). Timed
    at sigma=1e-4 on the soft bin pass, whose time phase_kernels gives."""
    dS = torch.from_numpy(
        np.random.default_rng(2).normal(size=(B, IMG, IMG)).astype(np.float32)).to(proj.device)
    for sigma, blur in ((SIGMA_WIDE, BLUR_WIDE), (rc.SIGMA, rc.BLUR_RADIUS)):
        table, idx, th, tw = rc.bin_faces(proj, faces, IMG, K, blur)
        kern = rc.backward_cuda(table, idx, dS, IMG, th, tw, sigma, blur)
        torch.cuda.synchronize()
        plain = rc.backward_plain(table, idx, dS, IMG, th, tw, sigma, blur)
        rel = (torch.linalg.vector_norm(kern - plain) / torch.linalg.vector_norm(plain)).item()
        err = (kern - plain).abs().max().item()
        nz_z = int(torch.count_nonzero(kern[..., 6:]))
        nz_bad = int(torch.count_nonzero(kern[idx < 0]))
        log(f"[kernels] soft_bwd sigma {sigma:g} blur {blur:.4g}: rows rel err {rel:.3g}, "
            f"max abs err {err:.3g} (rows up to {plain.abs().max().item():.4g}); nonzero z "
            f"entries {nz_z}, nonzero invalid-slot entries {nz_bad}")
        require(rel <= 1e-4, f"soft_bwd sigma {sigma}: rows rel error {rel} > 1e-4")
        require(nz_z == 0 and nz_bad == 0, f"soft_bwd sigma {sigma}: z / invalid rows not 0")
    # table and rows (B, T, K, 9) f32, counts (B, T) int32, dL/dS (B, H, W) f32
    nbytes = 2 * table.numel() * 4 + idx[..., 0].numel() * 4 + dS.numel() * 4
    return _record(
        "raster_bwd_soft", "soft_bwd", "raster_bwd.cu", 449,
        lambda: rc.backward_cuda(table, idx, dS, IMG, th, tw, rc.SIGMA, rc.BLUR_RADIUS),
        lambda: rc.backward_plain(table, idx, dS, IMG, th, tw, rc.SIGMA, rc.BLUR_RADIUS),
        idx, th * tw, faces.shape[0], nbytes, err)


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


def _timed(torch, fn, windows, steps, what):
    """Zero the launch counters, call fn in `windows` windows of `steps`
    calls (each window ends in a synchronize); return the last result, the
    median frames/s, its spread (max - min) / median and the launches."""
    from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer_cuda as rc

    for k in rc.LAUNCHES:
        rc.LAUNCHES[k] = 0
    window_fps = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps):
            out = fn()
        torch.cuda.synchronize()
        window_fps.append(B * steps / (time.perf_counter() - t0))
    launches = dict(rc.LAUNCHES)
    fps = float(np.median(window_fps))
    spread = (max(window_fps) - min(window_fps)) / fps
    log(f"[main] {windows} windows of {steps} {what} steps at B={B} {IMG}^2: frames/s "
        f"{[round(f, 2) for f in window_fps]}, median {fps:.2f} ({B * 1e3 / fps:.3f} "
        f"ms/step), spread (max-min)/median {spread:.4f}; launches {launches}")
    return out, fps, spread, launches


def _profile(torch, fn, path, what):
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    with open(path, "a") as fh:
        fh.write(f"==== one {what} step, B={B} {IMG}^2 ====\n{table}\n")
    log(f"[main] profile of one {what} step written to {path}")


def phase_eval(torch, mods, batch, profile):
    from acfm_video_3d_reconstruction_tpu_torch.train import monocular

    step = monocular.make_eval_step(mods)
    step(batch)  # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.synchronize()
    aux, fps, spread, launches = _timed(torch, lambda: step(batch), EVAL_WINDOWS, EVAL_STEPS,
                                        "eval")
    n_steps = EVAL_WINDOWS * EVAL_STEPS
    require(launches == {"soft": n_steps, "hard": n_steps, "soft_bwd": 0},
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
    require(launches == {"soft": n_steps, "hard": n_steps, "soft_bwd": n_steps},
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=None,
                    help="append torch.profiler tables of one eval and one train step here")
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

    counter = {"raster_fwd_soft": "soft", "raster_fwd_hard": "hard",
               "raster_bwd_soft": "soft_bwd"}
    for r in records:
        r["launches"] = eval_launches[counter[r["name"]]] + train_launches[counter[r["name"]]]
    n_eval, n_train = EVAL_WINDOWS * EVAL_STEPS, TRAIN_WINDOWS * TRAIN_STEPS
    log("[result] " + json.dumps({
        "eval_frames_per_s_median": eval_fps, "eval_frames_per_s_spread": eval_spread,
        "train_frames_per_s_median": train_fps, "train_frames_per_s_spread": train_spread,
        "batch": B, "image_size": IMG, "eval_steps": n_eval, "train_steps": n_train,
        "launches_per_eval_step": {k: v / n_eval for k, v in eval_launches.items()},
        "launches_per_train_step": {k: v / n_train for k, v in train_launches.items()}}))

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
