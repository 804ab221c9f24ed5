#!/usr/bin/env python3
"""Times this checkout's CUDA kernels against another checkout's.

    python3 tools/torch_kernel_compare.py --other DIR
        [--kernels raster,correlation] [--iters N]

Needs one CUDA GPU. Builds the chosen kernels' sources of the checkout at
DIR with this checkout's nvcc flags into a temporary directory under TMPDIR
(DIR is only read), launches both sides on the same inputs, each into
outputs made once, prints the outputs' largest difference and times the
kernels alone in turns (other, this, this, other; CUDA events over --iters
launches, ops/timing.py). To time a variant of a kernel or of its launch
plan, give a copy of the checkout whose source holds it.

raster: chip_smoke.py's full-width scene (B=16, 256^2, the 1280-face
icosphere under seeded cameras, K=192, bins 16x128; built by
ops/raster_checks.py::icosphere_scene): the soft and hard forward, and the
backward at sigma 1e-4 on a seeded dL/dS, launched back to back
(time_cuda, --iters 20 by default). DIR's raster_fwd.cu / raster_bwd.cu
must take this checkout's C arguments: both sides launch through this
checkout's ops/rasterizer_cuda.py launch_fwd / launch_bwd.

correlation: the cost volume at the 10 shapes of each of three passes of
the flow net (seeded N(0, 1) features): the multiframe trainer's (12 pairs,
net at 384x768) and the flow CLI's on one Sintel frame (436x1024, net at
448x1024) and one KITTI frame (375x1242, net at 384x1280). Each side
launches through its own flow/correlation_cuda.py (DIR's is read as a
source under another module name, writing no bytecode), so each runs its
own launch plan, printed beside its times: queued behind a ~20 ms spin of
the card, so that the host's cost per launch does not pace them
(time_device), and back to back from the host (time_cuda); --iters 50 by
default. Prints each side's pass totals (one md=4 and two md=2 launches
per level, the faster of each side's two times).

The last lines are the card's name and power limit, then one JSON object
with every time. Exits non-zero, printing no result, when no CUDA device is
present.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from acfm_video_3d_reconstruction_tpu_torch.ops.timing import time_cuda, time_device  # noqa: E402

PKG = "acfm_video_3d_reconstruction_tpu_torch"
SOURCES = {"raster": ("raster_fwd.cu", "raster_bwd.cu"), "correlation": ("correlation.cu",)}
ITERS = {"raster": 20, "correlation": 50}
# (name, pairs, the net's input): the flow paths' passes
FLOW_PASSES = (("trainer", 12, (384, 768)), ("sintel", 1, (448, 1024)),
               ("kitti", 1, (384, 1280)))


def _build_other(root: Path, names, out_dir: Path) -> dict:
    """nvcc each of DIR's named csrc/ sources into out_dir, all at once;
    {name: CDLL}."""
    from acfm_video_3d_reconstruction_tpu_torch.ops import cuda_build

    csrc = root / PKG / "csrc"
    procs = {}
    for name in names:
        so = out_dir / f"other_{Path(name).stem}.so"
        procs[name] = (so, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(csrc / name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"other {name}: nvcc exit {proc.returncode}\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def _import_other_correlation(root: Path):
    """DIR's flow/correlation_cuda.py, its package imported as `other_port`
    without writing bytecode into DIR."""
    sys.dont_write_bytecode = True
    pkg_dir = root / PKG
    spec = importlib.util.spec_from_file_location(
        "other_port", pkg_dir / "__init__.py", submodule_search_locations=[str(pkg_dir)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules["other_port"] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module("other_port.flow.correlation_cuda")


def _in_turns(timer, calls, iters):
    """{side: [two times]}, timed other, this, this, other."""
    t = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        t[who].append(timer(calls[who], iters))
    return t


def compare_raster(torch, lib, iters) -> dict:
    from acfm_video_3d_reconstruction_tpu_torch.ops import raster_checks as chk
    from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer_cuda as rc

    device = torch.device("cuda", 0)
    B, size = 16, 256
    proj, faces = chk.icosphere_scene(B, device)
    K = rc.auto_K(faces.shape[0], size, 192)
    result = {"other_ms": {}, "this_ms": {}, "max_abs_diff": {}}
    dS = torch.from_numpy(np.random.default_rng(2).normal(
        size=(B, size, size)).astype(np.float32)).to(device)
    fwd = {"other": lib["raster_fwd.cu"].acfm_raster_fwd, "this": rc.fwd_entry()}
    bwd = {"other": lib["raster_bwd.cu"].acfm_raster_bwd, "this": rc.bwd_entry()}
    for fn, argtypes in ((fwd["other"], rc.FWD_ARGTYPES), (bwd["other"], rc.BWD_ARGTYPES)):
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    for what in ("soft", "hard", "soft_bwd"):
        soft = what != "hard"
        blur = rc.BLUR_RADIUS if soft else 0.0
        table, idx, th, tw = rc.bin_faces(proj, faces, size, K, blur)
        counts = (idx >= 0).sum(-1, dtype=torch.int32)
        # each side writes its own outputs, made once
        outs = {who: [torch.empty((B, size, size), device=device,
                                  dtype=torch.int32 if i == 1 else torch.float32)
                      for i in range(5)] for who in fwd}
        grads = {who: torch.empty_like(table) for who in fwd}
        if what == "soft_bwd":
            def call(who):
                rc.launch_bwd(bwd[who], table, counts, dS, grads[who], size, th, tw,
                              rc.SIGMA, rc.BLUR_RADIUS)
                return [grads[who]]
        else:
            def call(who):
                rc.launch_fwd(fwd[who], table, idx, counts, outs[who], size, th, tw,
                              rc.SIGMA, blur, soft)
                return outs[who]
        calls = {who: (lambda who=who: call(who)) for who in fwd}
        diff = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(calls["other"](), calls["this"]()))
        t = _in_turns(time_cuda, calls, iters)
        result["other_ms"][what], result["this_ms"][what] = t["other"], t["this"]
        result["max_abs_diff"][what] = diff
        print(f"[compare] raster {what}: other {t['other'][0]:.4f} / {t['other'][1]:.4f} ms, "
              f"this {t['this'][0]:.4f} / {t['this'][1]:.4f} ms; outputs' max abs diff "
              f"{diff:.3g}", flush=True)
    return result


def compare_correlation(torch, lib, other_root: Path, iters) -> dict:
    from acfm_video_3d_reconstruction_tpu_torch.flow import correlation_cuda as this
    from acfm_video_3d_reconstruction_tpu_torch.flow.maskflownet import PYR_CH

    other = _import_other_correlation(other_root)
    fn = lib["correlation.cu"].acfm_correlation
    fn.argtypes, fn.restype = other.ARGTYPES, ctypes.c_int
    sides = {"other": (other, fn), "this": (this, this.entry())}
    device = torch.device("cuda", 0)
    result = {"other_ms": {}, "this_ms": {}, "max_abs_diff": {}, "plans": {}, "pass_ms": {}}
    for name, B, (nh, nw) in FLOW_PASSES:
        totals = {how: {"other": 0.0, "this": 0.0} for how in ("queued", "back to back")}
        for md, per_pass in ((4, 1), (2, 2)):
            for lvl in (6, 5, 4, 3, 2):
                C, H, W = PYR_CH[lvl - 1], nh >> lvl, nw >> lvl
                g = torch.Generator(device=device).manual_seed(md * 1000 + C)
                f1, f2 = (torch.randn(B, C, H, W, generator=g, device=device)
                          for _ in range(2))
                outs = {who: torch.empty((B, (2 * md + 1) ** 2, H, W), device=device)
                        for who in sides}
                calls = {who: (lambda who=who: sides[who][0].launch(
                    sides[who][1], f1, f2, outs[who], md)) for who in sides}
                calls["other"]()
                calls["this"]()
                torch.cuda.synchronize()
                diff = (outs["other"] - outs["this"]).abs().max().item()
                key = f"md{md} {B}x{C}x{H}x{W}"
                # a checkout from before the launch plan has one template
                plans = {who: mod.launch_plan(B, C, H, W, md).template
                         if hasattr(mod, "launch_plan") else "one"
                         for who, (mod, _) in sides.items()}
                result["max_abs_diff"][key] = diff
                result["plans"][key] = plans
                for how, timer in (("queued", time_device), ("back to back", time_cuda)):
                    t = _in_turns(timer, calls, iters)
                    for who in sides:
                        result[f"{who}_ms"].setdefault(how, {})[key] = t[who]
                        totals[how][who] += per_pass * min(t[who])
                    print(f"[compare] correlation {name} {key}, {how}: other "
                          f"{t['other'][0]:.5f} / {t['other'][1]:.5f} ms, this "
                          f"{t['this'][0]:.5f} / {t['this'][1]:.5f} ms; outputs' max abs "
                          f"diff {diff:.3g}; plans other {plans['other']}, this "
                          f"{plans['this']}", flush=True)
        result["pass_ms"][name] = totals
        for how, tot in totals.items():
            print(f"[compare] correlation {name} pass ({B} pairs, net {nh}x{nw}, 15 "
                  f"launches), {how}: other {tot['other']:.4f} ms, this {tot['this']:.4f} ms",
                  flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="root of another checkout whose kernels to time beside these")
    ap.add_argument("--kernels", default="raster,correlation",
                    help="comma-separated: raster, correlation")
    ap.add_argument("--iters", type=int, default=None,
                    help="launches per time (default 20 raster, 50 correlation)")
    args = ap.parse_args(argv)
    kernels = args.kernels.split(",")
    if set(kernels) - set(SOURCES):
        ap.error(f"--kernels takes {sorted(SOURCES)}")

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_compare: no CUDA device available", file=sys.stderr)
        return 1
    other_root = args.other.resolve()
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        lib = _build_other(other_root, [s for k in kernels for s in SOURCES[k]], Path(tmp))
        for k in kernels:
            iters = args.iters or ITERS[k]
            result[k] = (compare_raster(torch, lib, iters) if k == "raster" else
                         compare_correlation(torch, lib, other_root, iters))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
