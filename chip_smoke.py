#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile OUT.txt]

Phases, each of which raises (exit code 1) on failure:
  1. build: compiles every CUDA source of the port with nvcc (sm_90a).
  2. kernels: the binned rasterizer forward kernel, soft and hard, against
     its plain PyTorch version at full width (B=16, 256^2, the 1280-face
     icosphere, K from auto_K), with the tolerances stated below; times
     the kernel, the plain version and the bound.
  3. small: the eval step at the CPU tests' config (64^2, f32) on the card
     against the same weights on the CPU.
  4. main path: make_eval_step at bench.py's shape (batch 16, 256^2,
     subdivide 3, 16 handles, 15 keypoints, tex 6, texture on, bf16
     autocast) on a synthetic batch, timed over WINDOWS windows of
     STEPS steps (median and spread of frames/s). The launch counters are
     zeroed just before the timed steps and must read one soft and one hard
     launch per step after them; the outputs must be finite, the mask in
     [0, 1], and the step must agree with the same step through the plain
     rasterizer.
The second-to-last lines are the card's name and power limit, then one
JSON line of kernel records; the last line is {"ok": true, "device": ...}.
Exits non-zero, printing no result, when no CUDA device is present.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
# slot) pair and, once, per (view, face); counted in csrc/raster_fwd.cu.
OPS_PER_PAIR = {"soft": 99, "hard": 47}
OPS_PER_FACE = {"soft": 28, "hard": 10}

B, IMG = 16, 256
STEPS, WINDOWS = 100, 5  # the main path is timed over WINDOWS windows of STEPS steps


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

        ms = time_cuda(lambda: rc.forward_cuda(table, idx, IMG, th, tw, rc.SIGMA, blur, soft), 20)
        plain_ms = time_cuda(
            lambda: rc.forward_plain(table, idx, IMG, th, tw, rc.SIGMA, blur, soft), 3, 1)
        bin_ms = time_cuda(lambda: rc.bin_faces(proj, faces, IMG, K, blur), 10)
        counts = (idx >= 0).sum(-1)
        pairs = int(counts.sum()) * th * tw
        ops_s = (pairs * OPS_PER_PAIR[mode] + B * F * OPS_PER_FACE[mode]) / PEAK_FP32_FLOPS
        n_px = B * IMG * IMG
        nbytes = table.numel() * 4 + idx.numel() * 4 + counts.numel() * 4 + 5 * n_px * 4
        bytes_s = nbytes / PEAK_BYTES_PER_S
        bound_ms = max(ops_s, bytes_s) * 1e3
        log(f"[kernels] {mode}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, binning "
            f"{bin_ms:.4f} ms; {pairs} (pixel, slot) pairs, bound {bound_ms:.4f} ms "
            f"({'operations' if ops_s >= bytes_s else 'bytes'})")
        records.append({
            "name": f"raster_fwd_{mode}", "route": "cuda",
            "source": "acfm_video_3d_reconstruction_tpu_torch/csrc/raster_fwd.cu",
            "replaces": "acfm_video_3d_reconstruction_tpu/ops/rasterizer_tpu.py:259",
            "launches": None, "max_abs_err": max(err_b, err_z, err_m),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "library_ms": None,
        })
    return records


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


def _compare(aux_a, aux_b, what, metric_rtol, mask_atol):
    for k, a in aux_a["metrics"].items():
        a, b = float(a), float(aux_b["metrics"][k])
        require(abs(a - b) <= metric_rtol * abs(b) + 1e-6,
                f"{what}: metric {k} {a} vs {b} (rtol {metric_rtol})")
    err = (aux_a["mask_pred"] - aux_b["mask_pred"].to(aux_a["mask_pred"].device)).abs().max()
    require(err.item() <= mask_atol, f"{what}: mask error {err.item()} > {mask_atol}")
    return err.item()


def phase_small(torch, device):
    """The CPU tests' config on the card (kernel path) against the CPU
    (plain path), same seeded weights, f32 with TF32 off. The solve's f32
    normal equations round differently on the two (cuSOLVER vs LAPACK), so
    pred_v is held to atol 1e-4 (tests/test_torch_port_slice.py); at
    sigma=1e-4 the soft mask moves by up to ~50 per unit of vertex
    displacement at a silhouette edge (sigmoid' x 2d/sigma at d ~ sqrt(sigma)),
    so the mask takes atol 5e-3 and the metrics rtol 1e-3."""
    from acfm_video_3d_reconstruction_tpu_torch.models.template import build_template
    from acfm_video_3d_reconstruction_tpu_torch.train import monocular

    template = build_template(subdivide=2, num_lbs=6, tex_size=2, num_kps=4)
    cfg = _cfg(64, 32, 6, 4, 2, "float32")
    rng = np.random.default_rng(1)
    batch = {
        "img": rng.random((2, 64, 64, 3), np.float32),
        "mask": (rng.random((2, 64, 64)) > 0.5).astype(np.float32),
        "kp": rng.random((2, 4, 3), np.float32),
        "sfm_pose": np.tile(np.asarray([0.8, 0, 0, 1, 0, 0, 0], np.float32), (2, 1)),
        "edt": rng.random((2, 64, 64), np.float32),
        "boundaries": rng.random((2, 100, 3), np.float32),
    }
    aux_gpu = monocular.make_eval_step(monocular.build(cfg, template, 0, device))(batch)
    aux_cpu = monocular.make_eval_step(monocular.build(cfg, template, 0, "cpu"))(batch)
    _check_aux(torch, aux_gpu, 64, 2, "small")
    v_err = (aux_gpu["pred_v"].cpu() - aux_cpu["pred_v"]).abs().max().item()
    require(v_err <= 1e-4, f"small card vs cpu: pred_v error {v_err} > 1e-4")
    err = _compare(aux_gpu, aux_cpu, "small card vs cpu", 1e-3, 5e-3)
    log(f"[small] 64^2 f32 card (kernel) vs cpu (plain): pred_v err {v_err:.3g}, "
        f"metrics within rtol 1e-3, mask err {err:.3g}")


@contextlib.contextmanager
def plain_rasterizer():
    """Within the block, the rasterizer runs its plain version on CUDA
    tensors too (no kernel launch, no count): the main path's reference."""
    from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer_cuda as rc

    kernel = rc.forward_cuda
    rc.forward_cuda = rc.forward_plain
    try:
        yield
    finally:
        rc.forward_cuda = kernel


def phase_main(torch, device, profile):
    from acfm_video_3d_reconstruction_tpu_torch.models.template import build_template
    from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer_cuda as rc
    from acfm_video_3d_reconstruction_tpu_torch.train import monocular

    t0 = time.perf_counter()
    template = build_template(subdivide=3, num_lbs=16, tex_size=6, num_kps=15)
    mods = monocular.build(_cfg(IMG, 200, 16, 15, 6, "bfloat16"), template, 0, device)
    batch = monocular.to_device_batch(mods, _bench_batch())
    log(f"[main] template + model built in {time.perf_counter() - t0:.2f} s")
    step = monocular.make_eval_step(mods)
    aux = step(batch)  # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.synchronize()

    for k in rc.LAUNCHES:
        rc.LAUNCHES[k] = 0
    window_fps = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        for _ in range(STEPS):
            aux = step(batch)
        torch.cuda.synchronize()
        window_fps.append(B * STEPS / (time.perf_counter() - t0))
    launches = dict(rc.LAUNCHES)
    n_steps = WINDOWS * STEPS
    fps = float(np.median(window_fps))
    spread = (max(window_fps) - min(window_fps)) / fps
    log(f"[main] {WINDOWS} windows of {STEPS} eval steps at B={B} {IMG}^2: frames/s "
        f"{[round(f, 2) for f in window_fps]}, median {fps:.2f} ({B * 1e3 / fps:.3f} "
        f"ms/step), spread (max-min)/median {spread:.4f}; launches {launches}")
    require(launches == {"soft": n_steps, "hard": n_steps},
            f"launches {launches} != one soft and one hard per step ({n_steps} steps)")
    _check_aux(torch, aux, IMG, B, "main")

    with plain_rasterizer():
        aux_plain = step(batch)
    # Same bf16 nets on the same inputs on both sides: only the rasterizer
    # differs, so the mask takes its tolerance (atol 2e-4) and the metrics
    # rtol 1e-3 (mask means; texels flipped where a face or atlas cell
    # changes on a tie).
    err = _compare(aux, aux_plain, "main kernel vs plain", 1e-3, 2e-4)
    log(f"[main] kernel path vs plain path: metrics within rtol 1e-3, mask err {err:.3g}")
    log("[main] metrics " + json.dumps({k: float(v) for k, v in aux["metrics"].items()}))

    if profile:
        from torch.profiler import ProfilerActivity, profile as tprofile

        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(batch)
            torch.cuda.synchronize()
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
        with open(profile, "w") as fh:
            fh.write(table)
        log(f"[main] profile of one step written to {profile}")
    return fps, spread, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=None, help="write a torch.profiler table here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
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
    fps, spread, launches = phase_main(torch, device, args.profile)
    for r in records:
        r["launches"] = launches[r["name"].rsplit("_", 1)[1]]
    n_steps = WINDOWS * STEPS
    log("[result] " + json.dumps({
        "eval_frames_per_s_median": fps, "eval_frames_per_s_spread": spread,
        "batch": B, "image_size": IMG, "steps": n_steps,
        "launches_per_step": {k: v / n_steps for k, v in launches.items()}}))

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
