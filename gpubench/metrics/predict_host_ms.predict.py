"""Host ms per request inside the prediction: the program's `predict` span
(eval/predictor.py::predict_monocular) on the caller's thread, less its
child spans."""
from gpubench.harness.program_spans import self_ms


def read(ctx):
    return self_ms(ctx, "predict", "MainThread")
