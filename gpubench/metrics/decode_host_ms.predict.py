"""Host ms per request of the image's decode: the program's `data.decode` span
(data/base.py::SingleImageDataset.__getitem__) on the caller's thread."""
from gpubench.harness.program_spans import self_ms


def read(ctx):
    return self_ms(ctx, "data.decode", "MainThread")
