"""Clips per step from a mask-only source (YouTube-VIS: no keypoints, no
cameras) that the loader assembled in the window: the program's traced host
counter `data.mask_only_clips` (data/tigdog.py::MultiFrameDataset, on the
prefetch thread), per step."""
from gpubench.harness.program_spans import counter_per_unit


def read(ctx):
    return counter_per_unit(ctx, "data.mask_only_clips")
