"""Host ms per step that the prefetch thread spent in the loader's next(): the
program's `data.load` span (train/prefetch.py), less its child spans."""
from gpubench.harness.program_spans import self_ms


def read(ctx):
    return self_ms(ctx, "data.load", "acfm-prefetch")
