"""Host ms per step that the training loop spent waiting for its next batch:
the harness's "data_wait" span around each next() of the loop's prefetch
iterator (the boundary between the data layer and the loop)."""
from gpubench.harness.readers import span_host_ms


def read(ctx):
    return span_host_ms(ctx, "data_wait")
