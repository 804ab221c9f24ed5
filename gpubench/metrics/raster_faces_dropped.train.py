"""Faces per step that the rasterizer's bin pass dropped past a bin's capacity K:
the program's device counter `raster.faces_dropped`
(ops/rasterizer_cuda.py::_face_tables), over every render of the window."""
from gpubench.harness.program_spans import counter_per_unit


def read(ctx):
    return counter_per_unit(ctx, "raster.faces_dropped")
