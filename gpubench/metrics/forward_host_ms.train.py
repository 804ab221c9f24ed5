"""Host ms per step of the train step's forward: the program's `train.forward` span
(train/multiframe.py::make_train_step) on the loop's thread, less its child spans."""
from gpubench.harness.program_spans import self_ms


def read(ctx):
    return self_ms(ctx, "train.forward", "MainThread")
