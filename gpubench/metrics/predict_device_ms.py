"""Device ms per request of the prediction layer: the kernels launched
inside the harness's "predict" span around eval/predictor.py::
predict_monocular."""
from gpubench.harness.readers import span_device_ms


def read(ctx):
    return span_device_ms(ctx, "predict")
