"""Host ms per step of the flow pass on the prefetch thread: the program's
`flow.infer` span (flow/infer.py::make_flow_fn's function), less its child
spans."""
from gpubench.harness.program_spans import self_ms


def read(ctx):
    return self_ms(ctx, "flow.infer", "acfm-prefetch")
