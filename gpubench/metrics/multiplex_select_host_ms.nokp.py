"""Host ms per step of the multiplex's hypothesis selection on the loop's
thread: the program's `multiplex.select` span
(train/multiframe.py::decode_selected_cameras: the top-k of the frames'
probabilities, the gather of the kept hypotheses, the az-el decode and the
mirror and affine transport), less its child spans."""
from gpubench.harness.program_spans import self_ms


def read(ctx):
    return self_ms(ctx, "multiplex.select", "MainThread")
