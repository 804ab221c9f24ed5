"""Host ms per step of the multiplex's probability write-back on the loop's
thread: the program's `multiplex.writeback` span (train/multiframe.py's
train step around multiplex/state.py::scatter_probs over the kept
hypotheses), less its child spans."""
from gpubench.harness.program_spans import self_ms


def read(ctx):
    return self_ms(ctx, "multiplex.writeback", "MainThread")
