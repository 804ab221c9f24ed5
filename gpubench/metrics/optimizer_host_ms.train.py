"""Host ms per step of the train step's update: the program's `train.optimizer`
span (the dense gradients, the rate, Adam and the probabilities' write-back)
on the loop's thread, less its child spans."""
from gpubench.harness.program_spans import self_ms


def read(ctx):
    return self_ms(ctx, "train.optimizer", "MainThread")
