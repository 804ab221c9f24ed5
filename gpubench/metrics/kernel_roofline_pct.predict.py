"""The hand-written kernels' share of their rooflines over the traced
window: the sum of their least times (kernels/*.py) over the sum of their
device times."""
from gpubench.harness.readers import kernel_roofline_pct


def read(ctx):
    return kernel_roofline_pct(ctx)
