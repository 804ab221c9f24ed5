"""Host ms per step of the batch's upload on the prefetch thread: the program's
`data.upload` span (train/prefetch.py::to_device: pinning and the
non-blocking copies), less its child spans."""
from gpubench.harness.program_spans import self_ms


def read(ctx):
    return self_ms(ctx, "data.upload", "acfm-prefetch")
