"""Clips per step that the loader built on its thread pool: the program's
traced host counter `data.pool_clips` (data/loader.py::DataLoader) over the
window, per step."""
from gpubench.harness.program_spans import counter_per_unit


def read(ctx):
    return counter_per_unit(ctx, "data.pool_clips")
