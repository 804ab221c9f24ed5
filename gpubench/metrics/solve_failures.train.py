"""Factors per step whose cholesky_ex failed (info != 0) in the deformation
solve: the program's device counter `solve.failures`
(deform/solve.py::screened_poisson_solve)."""
from gpubench.harness.program_spans import counter_per_unit


def read(ctx):
    return counter_per_unit(ctx, "solve.failures")
