"""The share of the traced window in which no operation ran on the card."""
from gpubench.harness.readers import device_idle_pct


def read(ctx):
    return device_idle_pct(ctx)
