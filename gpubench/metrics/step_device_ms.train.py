"""Device ms per step of the train step: every device operation of the
traced window but those launched inside the harness's "flow" span (the
flow pass, on the loop's prefetch thread), per step. That is the kernels
the loop's own thread launched, with the batches' uploads beside them;
counted this way because the profiler can attach the prefetch thread's
kernels to the step's span as well (PERF.md)."""
from gpubench.harness.readers import per_unit_ms


def read(ctx):
    if ctx.trace is None:
        return None
    return per_unit_ms(ctx.trace.kernel_total_s - ctx.trace.span_device.get("flow", 0.0),
                       ctx.units)
