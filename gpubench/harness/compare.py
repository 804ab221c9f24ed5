"""The numbers that decide `correct`, each a gap between what the timed path
produced and what the reference computes from the same inputs.

Norm gaps follow one rule: per leaf, the gap between the program's norm
and the reference's (not the norm of their difference), over the larger of
the reference leaf's norm and the median leaf's; the number is the worst
leaf. Leaves whose reference gradient is under a thousandth of the median
leaf's (nought to rounding: Adam moves them by round-off alone) are left
out of the parameters' change.
"""
from __future__ import annotations

import math

import torch

from .bench import log

TINY_GRAD = 1e-3  # of the median leaf's gradient norm


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def norm_gap(prog: dict, ref: dict, keys=None, what: str = "") -> float:
    """max over leaves |‖prog‖ − ‖ref‖| / max(‖ref‖, median leaf ‖ref‖);
    with `what`, the worst leaf is logged."""
    keys = sorted(ref) if keys is None else keys
    missing = [k for k in keys if k not in prog]
    if missing:
        return math.inf
    rn = _norms({k: ref[k] for k in keys})
    pn = _norms({k: prog[k] for k in keys})
    med = float(torch.tensor(sorted(rn.values())).median()) if rn else 0.0
    gaps = [abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys]
    if what and gaps:
        i = max(range(len(gaps)), key=gaps.__getitem__)
        log(f"{what}: worst leaf {keys[i]} ({pn[keys[i]]:.6g} against {rn[keys[i]]:.6g}, "
            f"median {med:.6g})")
    return max(gaps) if gaps else 0.0


def moved_keys(ref_grad: dict) -> list:
    """The leaves whose reference gradient is not nought to rounding."""
    rn = _norms(ref_grad)
    med = float(torch.tensor(sorted(rn.values())).median())
    return sorted(k for k, v in rn.items() if v >= TINY_GRAD * med)


def change_gap(prog_before: dict, prog_after: dict, ref_before: dict, ref_after: dict,
               keys) -> float:
    prog = {k: prog_after[k] - prog_before[k] for k in keys if k in prog_after}
    ref = {k: ref_after[k] - ref_before[k] for k in keys}
    return norm_gap(prog, ref, keys, "change")


def rel(a: float, b: float) -> float:
    a, b = float(a), float(b)
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-30)


def vector_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """‖a − b‖ / ‖b‖ in float64."""
    a, b = a.double(), b.double().to(a.device)
    if a.shape != b.shape:
        return math.inf
    d = float(torch.linalg.vector_norm(a - b))
    n = float(torch.linalg.vector_norm(b))
    return d / max(n, 1e-30) if math.isfinite(d) else math.inf


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double().to(a.device)
    if a.shape != b.shape:
        return math.inf
    d = float((a - b).abs().max()) if a.numel() else 0.0
    return d if math.isfinite(d) else math.inf


def start_gap(prog: dict, ref: dict) -> float:
    """The largest difference of any parameter before the first step: both
    sides start from the same weights, so 0."""
    if set(prog) != set(ref):
        return math.inf
    return max((max_abs(prog[k], ref[k]) for k in ref), default=0.0)


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: (number, limit)}): correct when every number has a
    limit, is finite and lies within it. What decides a run's `correct`,
    and what a control or a planted fault has to fail."""
    checks = {k: (v, limits.get(k)) for k, v in numbers.items()}
    correct = bool(checks) and all(lim is not None and math.isfinite(v) and v <= lim
                                   for v, lim in checks.values())
    return correct, checks
