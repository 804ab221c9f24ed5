"""Device ms per step of the flow layer: the kernels launched inside the
harness's "flow" span around the flow_fn it hands the loop (the program's
make_flow_fn), on the prefetch thread."""
from gpubench.harness.readers import span_device_ms


def read(ctx):
    return span_device_ms(ctx, "flow")
