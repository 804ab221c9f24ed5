"""What the per-layer metric files under metrics/ share. A reader takes the
run's context and returns a number, or None when the run has nothing for
it to read (the harness then leaves the metric out of the line)."""
from __future__ import annotations

import glob
import os

from .bench import GPUBENCH, load_module


def per_unit_ms(seconds, units):
    return None if seconds is None or not units else 1e3 * seconds / units


def span_device_ms(ctx, span: str):
    """Device ms of the kernels launched inside a harness span, per unit of
    the window (a step, a batch, a request)."""
    if ctx.trace is None or span not in ctx.trace.span_device:
        return None
    return per_unit_ms(ctx.trace.span_device[span], ctx.units)


def span_any_thread_device_ms(ctx, span: str):
    """Device ms of the kernels of every op begun, on any thread, while a
    harness span was open, per unit of the window (Trace.span_device_any_thread)."""
    if ctx.trace is None:
        return None
    return per_unit_ms(ctx.trace.span_device_any_thread(span), ctx.units)


def span_host_ms(ctx, span: str):
    """Host ms inside a harness span, per unit of the window."""
    if span not in ctx.spans.total:
        return None
    return per_unit_ms(ctx.spans.total[span], ctx.units)


def kernel_entries() -> list:
    return [load_module(p) for p in sorted(glob.glob(os.path.join(GPUBENCH, "kernels", "*.py")))]


def kernel_roofline_pct(ctx):
    """The kernels' least times over their device times in the trace, in %,
    over every kernel entry the trace has launches of."""
    if ctx.trace is None:
        return None
    least = spent = 0.0
    for k in kernel_entries():
        seconds, launches = ctx.trace.kernel_s(k.matches)
        if launches:
            least += launches * k.least_s(ctx.shapes, ctx.cell.config["peak"])
            spent += seconds
    return 100.0 * least / spent if spent > 0 else None


def mfu_pct(ctx):
    """The work of a unit (a step, a batch, a request) over the measured time
    per unit, over the configuration's peak, in %."""
    if ctx.trace is None or not ctx.units:
        return None
    flops = ctx.unit_flops()
    if not flops:
        return None
    return 100.0 * flops * ctx.units / ctx.window_s / ctx.cell.config["peak"]["flops_per_s"]


def device_idle_pct(ctx):
    if ctx.trace is None or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.window_s)
