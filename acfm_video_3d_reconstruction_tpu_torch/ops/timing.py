"""Timers of work on the card, CUDA events around repeated calls.

`time_cuda` times calls launched back to back from the host, so the host's
cost per call can set their pace; `time_device` queues them behind a spin of
the card first, so that it reads their device time alone. chip_smoke.py and
tools/torch_kernel_compare.py time with these.
"""
from __future__ import annotations


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


def time_device(fn, iters: int) -> float:
    """Mean device milliseconds per call: CUDA events around `iters` calls
    that queue behind a ~20 ms spin of the card (torch.cuda._sleep), so
    that the host's cost of launching them does not set their pace."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
