"""Host ms per request of the crop and resize of image and mask: the program's
`data.crop` span (data/base.py::SingleImageDataset.__getitem__) on the
caller's thread."""
from gpubench.harness.program_spans import self_ms


def read(ctx):
    return self_ms(ctx, "data.crop", "MainThread")
