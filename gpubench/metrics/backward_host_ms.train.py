"""Host ms per step of the train step's backward: the program's `train.backward`
span around loss.backward() on the loop's thread, which waits there while
autograd's device thread runs the backward; less its child spans."""
from gpubench.harness.program_spans import self_ms


def read(ctx):
    return self_ms(ctx, "train.backward", "MainThread")
