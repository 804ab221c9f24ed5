"""Driving a training loop of the program: the clock, the spans and what
the first steps leave for the comparison.

The loop is the program's own (train/driver.py). The harness hands it its
loader, its weight loaders and, as vis_fn at display_freq 1, its per-step
hook, which is the window's clock and ends the loop (WindowClosed) once
the window is over. Around two module-level functions that the loop calls
it puts wrappers that change nothing they return: the step factory
(`make_train_step`, whose steps then run inside the harness's "step" span,
and whose first steps' metrics and state it keeps) and `prefetch.prefetch`
(whose every next() is the loop's wait for its next batch, the "data_wait"
span). `Patched` puts the originals back when the run ends.
"""
from __future__ import annotations

import gc
import threading

import torch

from .bench import Spans, Window, WindowClosed, log


def named_params(parts: dict) -> dict:
    """{prefix.name: parameter} over {prefix: module}."""
    return {f"{pre}.{n}": p for pre, mod in parts.items() for n, p in mod.named_parameters()}


def clone_all(tensors: dict) -> dict:
    return {k: v.detach().clone() for k, v in tensors.items()}


class Capture:
    """What the first `n` steps of the timed path leave for the reference:
    the batches they took, their metrics, the parameters before step 1,
    Adam's first moments after step 1 (its gradient, as the optimizer got
    it, is exp_avg / (1 - beta1)), the tables after step 1 and the
    parameters after step n. Kept on the device, cloned without a host
    read."""

    def __init__(self, n: int):
        self.n = n
        self.steps = 0
        self.batches = []
        self.metrics = []
        self.p0 = self.pn = self.m1 = self.after1 = None

    def before(self, params: dict) -> None:
        """Called before each step."""
        if self.steps == 0:
            self.p0 = clone_all(params)

    def after(self, batch: dict, metrics: dict, params: dict, opt, extra: dict) -> None:
        """Called after each step; keeps nothing after the first n."""
        self.steps += 1
        if self.steps > self.n:
            return
        self.batches.append(batch)
        self.metrics.append({k: v.detach().clone() for k, v in metrics.items()})
        if self.steps == 1:
            self.m1 = {k: opt.state[p]["exp_avg"].detach().clone() for k, p in params.items()
                       if p in opt.state}
            self.after1 = clone_all(extra)
        if self.steps == self.n:
            self.pn = clone_all(params)


class Patched:
    """Set module attributes for the life of a `with` block."""

    def __init__(self, *items):
        self.items = items  # (module, name, new)
        self.saved = []

    def __enter__(self):
        for mod, name, new in self.items:
            self.saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, new)
        return self

    def __exit__(self, *exc):
        for mod, name, old in reversed(self.saved):
            setattr(mod, name, old)
        return False


def timed_prefetch(original, spans: Spans):
    """prefetch.prefetch with every next() in the "data_wait" span."""

    def prefetch(loader, prep, depth: int = 2):
        inner = original(loader, prep, depth)
        try:
            while True:
                with spans.span("data_wait"):
                    try:
                        item = next(inner)
                    except StopIteration:
                        return
                yield item
        finally:
            inner.close()

    return prefetch


def join_prefetch_threads(timeout: float = 120.0) -> None:
    """Wait for the program's prefetch thread to finish its last batch."""
    for t in threading.enumerate():
        if t.name == "acfm-prefetch" and t is not threading.current_thread():
            t.join(timeout)
            if t.is_alive():
                log("warning: a prefetch thread is still running")


def make_hook(window: Window, spans: Spans):
    """The vis_fn the loop calls after every step: the window's clock."""

    def hook(save_dir, step, batch):
        if window.ticks + 1 == window.warm:
            spans.reset()
        window.tick()

    return hook


def finish(window: Window) -> None:
    """After the loop: no thread of the program left running, memory freed."""
    join_prefetch_threads()
    gc.collect()
    if not window.closed:
        raise RuntimeError("the loop ended before the window closed: "
                           f"{window.ticks} steps, {window.units} in the window")


def run_loop(call) -> None:
    """Run the program's loop until the hook ends it."""
    try:
        call()
    except WindowClosed:
        pass


def sync_of(device):
    dev = torch.device(device)
    return (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
