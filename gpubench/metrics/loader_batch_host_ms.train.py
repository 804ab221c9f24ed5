"""Host ms per step that the loader's producer thread spent building
batches: the program's `data.batch` span (data/loader.py::DataLoader, on
the `acfm-loader` thread), less its child spans."""
from gpubench.harness.program_spans import self_ms


def read(ctx):
    return self_ms(ctx, "data.batch", "acfm-loader")
