#!/usr/bin/env python3
"""Times the PyTorch port's frozen flow net under other convolution backends.

    python3 tools/torch_flow_conv_backends.py [--calls 3] [--top 12]

Needs one CUDA GPU. The port's MaskFlownet runs its f32 convolutions
outside cuDNN (flow/maskflownet.py). This script measures that choice on
the main flow path at chip_smoke.py's shape:
flow/infer.py::make_flow_fn(net, 256, (384, 768)) on a seeded
(12, 2, 256, 256, 3) clip batch, the seeded random weights of init_params,
TF32 off.

  1. Per convolution module (Conv2d and ConvTranspose2d): milliseconds of
     one launch on N(0, 1) input of the shape the call gives it, in cuDNN
     (its heuristics) and outside it (PyTorch's own convolution), CUDA
     events over 3 launches after one; the --top slowest in cuDNN are
     printed, with their calls per make_flow_fn call.
  2. One whole make_flow_fn call per variant, median of --calls calls after
     a warm-up (host clock, synchronized), and the vector relative error of
     its flows against the port's call. Each variant wraps the convolution
     modules' forwards, so the module runs in the backend the variant names
     whatever the net's forward set:
       port                 no wrapping: cuDNN off everywhere
       cudnn                cuDNN everywhere
       cudnn_benchmark      cuDNN everywhere, benchmark mode
       cudnn_deterministic  cuDNN everywhere, deterministic mode
       cudnn_pad{4,8,16}    cuDNN everywhere, a Conv2d's input channels (and
                            its weight's) zero-padded to a multiple of 4, 8, 16
       cudnn_channels_last  cuDNN everywhere, a Conv2d's input and weight in
                            channels_last
       cudnn_cin8           cuDNN where the input channels are a multiple of
                            8, outside it elsewhere
       fastest_per_module   each module in the backend step 1 found faster
       cudnn_tf32           cuDNN everywhere with TF32 allowed (other
                            numerics than the port's f32: for scale only)

The last lines are the card's name and power limit, then one JSON object
with every number printed. Exits non-zero, printing no result, when no CUDA
device is present.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

B, IMG, NET_HW = 12, 256, (384, 768)


def _conv_modules(torch, net):
    return [(n, m) for n, m in net.named_modules()
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]


@contextlib.contextmanager
def _wrapped(torch, net, choose):
    """Within the block each convolution module for which choose(name,
    module) gives a forward runs that forward instead of its own."""
    changed = []
    for name, m in _conv_modules(torch, net):
        fwd = choose(name, m)
        if fwd is not None:
            m.forward = fwd
            changed.append(m)
    try:
        yield
    finally:
        for m in changed:
            del m.forward


def _in_cudnn(torch, m, enabled=True, transform=None, allow_tf32=False, **flags):
    """m's forward in (enabled=True) or outside cuDNN, TF32 off unless
    allow_tf32; `transform(m, x)` replaces the module's own convolution
    call."""
    own = type(m).forward.__get__(m)

    def fwd(x):
        with torch.backends.cudnn.flags(enabled=enabled, allow_tf32=allow_tf32, **flags):
            return own(x) if transform is None else transform(m, x)

    return fwd


def _padded(k):
    import torch.nn.functional as F

    def conv(m, x):
        p = -x.shape[1] % k
        return F.conv2d(F.pad(x, (0, 0, 0, 0, 0, p)), F.pad(m.weight, (0, 0, 0, 0, 0, p)),
                        m.bias, m.stride, m.padding, m.dilation)

    return conv


def _channels_last(m, x):
    import torch
    import torch.nn.functional as F

    cl = torch.channels_last
    return F.conv2d(x.contiguous(memory_format=cl), m.weight.contiguous(memory_format=cl),
                    m.bias, m.stride, m.padding, m.dilation)


def _event_ms(torch, fn, iters=3):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def per_module(torch, net, call, top):
    """Step 1: {name: (calls per call, input shape, cuDNN ms, own ms)}."""
    shapes, calls = {}, {}

    def hook(name):
        def record(mod, inputs):
            shapes[name] = tuple(inputs[0].shape)
            calls[name] = calls.get(name, 0) + 1
        return record

    handles = [m.register_forward_pre_hook(hook(n)) for n, m in _conv_modules(torch, net)]
    try:
        call()
    finally:
        for h in handles:
            h.remove()
    torch.cuda.synchronize()
    out = {}
    with torch.no_grad():
        for name, m in _conv_modules(torch, net):
            x = torch.randn(shapes[name], device=m.weight.device,
                            generator=torch.Generator(m.weight.device).manual_seed(0))
            ms = []
            for enabled in (True, False):
                fwd = _in_cudnn(torch, m, enabled=enabled)
                ms.append(_event_ms(torch, lambda: fwd(x)))
            out[name] = (calls[name], shapes[name], ms[0], ms[1])
            del x
    tot = [sum(v[0] * v[2 + i] for v in out.values()) for i in (0, 1)]
    print(f"[module] sum over the convolutions of one call: {tot[0]:.3f} ms in cuDNN, "
          f"{tot[1]:.3f} ms outside it")
    for name, (c, shape, ms_c, ms_o) in sorted(out.items(), key=lambda kv: -kv[1][2])[:top]:
        print(f"[module] {name:34s} x{c} input {shape}: cuDNN {ms_c:.3f} ms, "
              f"outside {ms_o:.3f} ms")
    return out, tot


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=3, help="timed calls per variant")
    ap.add_argument("--top", type=int, default=12, help="modules listed in step 1")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_flow_conv_backends: no CUDA device available", file=sys.stderr)
        return 1
    from acfm_video_3d_reconstruction_tpu_torch.flow import infer
    from acfm_video_3d_reconstruction_tpu_torch.flow import maskflownet as mfn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    net = mfn.build(mfn.init_params(torch.Generator().manual_seed(0)), device)
    rng = np.random.default_rng(4)
    clips = torch.from_numpy(rng.random((B, 2, IMG, IMG, 3), np.float32)).to(device)
    flow_fn = infer.make_flow_fn(net, IMG, NET_HW)

    def call():
        return flow_fn({"img": clips})["optical_flows"]

    ref = call()
    modules, module_totals = per_module(torch, net, call, args.top)

    def everywhere(**kw):
        return lambda name, m: _in_cudnn(torch, m, **kw)

    def conv2d_only(transform):
        return lambda name, m: (_in_cudnn(torch, m, transform=transform)
                                if type(m) is torch.nn.Conv2d else _in_cudnn(torch, m))

    variants = {
        "port": lambda name, m: None,
        "cudnn": everywhere(),
        "cudnn_benchmark": everywhere(benchmark=True),
        "cudnn_deterministic": everywhere(deterministic=True),
        **{f"cudnn_pad{k}": conv2d_only(_padded(k)) for k in (4, 8, 16)},
        "cudnn_channels_last": conv2d_only(_channels_last),
        "cudnn_cin8": lambda name, m: _in_cudnn(torch, m, enabled=m.weight.shape[
            0 if type(m) is torch.nn.ConvTranspose2d else 1] % 8 == 0),
        "fastest_per_module": lambda name, m: _in_cudnn(
            torch, m, enabled=modules[name][2] < modules[name][3]),
        "cudnn_tf32": everywhere(allow_tf32=True),
    }
    results = {}
    for what, choose in variants.items():
        with _wrapped(torch, net, choose):
            out = call()
            torch.cuda.synchronize()
            times = []
            for _ in range(args.calls):
                t0 = time.perf_counter()
                out = call()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        rel = (torch.linalg.vector_norm(out - ref) / torch.linalg.vector_norm(ref)).item()
        results[what] = {"ms_per_call_median": statistics.median(times), "ms": times,
                         "rel_err_vs_port": rel}
        print(f"[call] {what:20s} {statistics.median(times):9.2f} ms per call "
              f"(calls {', '.join(f'{t:.2f}' for t in times)}); rel err vs port {rel:.3g}")
        del out

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "shape": {"pairs": B, "image_size": IMG, "net_hw": NET_HW},
        "module_sum_ms": {"cudnn": module_totals[0], "outside": module_totals[1]},
        "modules": {n: {"calls": c, "input": s, "cudnn_ms": a, "outside_ms": o}
                    for n, (c, s, a, o) in modules.items()},
        "calls": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
