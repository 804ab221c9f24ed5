"""Host ms per request of the mask's EDT and boundary points: the program's
`data.mask_geometry` span (data/loader.py::add_mask_geometry, either path)
on the caller's thread."""
from gpubench.harness.program_spans import self_ms


def read(ctx):
    return self_ms(ctx, "data.mask_geometry", "MainThread")
