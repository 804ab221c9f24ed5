"""The whole unit's (step, batch or request) share of the configuration's
peak: its work, counted on the reference's modules at the cell's shapes,
over the measured time per unit in the traced window."""
from gpubench.harness.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
