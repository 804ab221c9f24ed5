"""Views per step the multiplex decoded and the step rendered (k kept
hypotheses x B clips x T frames): the program's traced host counter
`multiplex.views` (train/multiframe.py::decode_selected_cameras) over the
window, per step."""
from gpubench.harness.program_spans import counter_per_unit


def read(ctx):
    return counter_per_unit(ctx, "multiplex.views")
