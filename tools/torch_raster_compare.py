#!/usr/bin/env python3
"""Times this checkout's rasterizer kernels against another checkout's.

    python3 tools/torch_raster_compare.py --parent DIR [--iters 20]

Needs one CUDA GPU. On chip_smoke.py's full-width scene (B=16, 256^2, the
1280-face icosphere under seeded cameras, K=192, bins 16x128; built by
ops/raster_checks.py::icosphere_scene), builds the raster_fwd.cu and
raster_bwd.cu of the checkout at DIR (their C entries acfm_raster_fwd /
acfm_raster_bwd take this checkout's arguments) with this checkout's nvcc
flags into a temporary directory under TMPDIR, and times them in turns with
this checkout's kernels (parent, this, this, parent; CUDA events over
--iters launches after two): the soft and hard forward, and the backward at
sigma 1e-4 on a seeded dL/dS, with the outputs' largest differences. Both
sides launch through ops/rasterizer_cuda.py's launch_fwd / launch_bwd on
counts and outputs made once, so each time is the kernel's alone. DIR is
only read. To time a variant of a kernel, give a copy of the checkout whose
source holds it.

The last lines are the card's name and power limit, then one JSON object
with every time. Exits non-zero, printing no result, when no CUDA device is
present.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _timed(torch, fn, iters):
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _build_parent(parent: Path, out_dir: Path) -> dict:
    """nvcc each parent raster source into out_dir; {name: CDLL}."""
    from acfm_video_3d_reconstruction_tpu_torch.ops import cuda_build

    csrc = parent / "acfm_video_3d_reconstruction_tpu_torch" / "csrc"
    procs = {}
    for name in ("raster_fwd.cu", "raster_bwd.cu"):
        so = out_dir / f"parent_{Path(name).stem}.so"
        procs[name] = (so, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(csrc / name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"parent {name}: nvcc exit {proc.returncode}\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="root of another checkout whose raster kernels to time beside these")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_raster_compare: no CUDA device available", file=sys.stderr)
        return 1
    from acfm_video_3d_reconstruction_tpu_torch.ops import raster_checks as chk
    from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer_cuda as rc

    device = torch.device("cuda", 0)
    B, size = 16, 256
    proj, faces = chk.icosphere_scene(B, device)
    K = rc.auto_K(faces.shape[0], size, 192)
    result = {"parent_ms": {}, "this_ms": {}, "parent_max_abs_diff": {}}
    dS = torch.from_numpy(np.random.default_rng(2).normal(
        size=(B, size, size)).astype(np.float32)).to(device)

    with tempfile.TemporaryDirectory() as tmp:
        libs = _build_parent(args.parent, Path(tmp))
        fwd = {"parent": libs["raster_fwd.cu"].acfm_raster_fwd, "this": rc.fwd_entry()}
        bwd = {"parent": libs["raster_bwd.cu"].acfm_raster_bwd, "this": rc.bwd_entry()}
        for fn, argtypes in ((fwd["parent"], rc.FWD_ARGTYPES), (bwd["parent"], rc.BWD_ARGTYPES)):
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        for what in ("soft", "hard", "soft_bwd"):
            soft = what != "hard"
            blur = rc.BLUR_RADIUS if soft else 0.0
            table, idx, th, tw = rc.bin_faces(proj, faces, size, K, blur)
            counts = (idx >= 0).sum(-1, dtype=torch.int32)
            # each side writes its own outputs, made once
            outs = {who: [torch.empty((B, size, size), device=device,
                                      dtype=torch.int32 if i == 1 else torch.float32)
                          for i in range(5)] for who in ("parent", "this")}
            grads = {who: torch.empty_like(table) for who in ("parent", "this")}
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
            parent_call, this_call = (lambda: call("parent")), (lambda: call("this"))
            diff = max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(parent_call(), this_call()))
            t = {"parent": [], "this": []}
            for who in ("parent", "this", "this", "parent"):
                t[who].append(_timed(torch, parent_call if who == "parent" else this_call,
                                     args.iters))
            result["parent_ms"][what], result["this_ms"][what] = t["parent"], t["this"]
            result["parent_max_abs_diff"][what] = diff
            print(f"[compare] {what}: parent {t['parent'][0]:.4f} / {t['parent'][1]:.4f} ms, "
                  f"this {t['this'][0]:.4f} / {t['this'][1]:.4f} ms (turns parent, this, "
                  f"this, parent); outputs' max abs diff {diff:.3g}", flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
