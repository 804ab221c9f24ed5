"""The control on the card, at a size a test run can hold: the reference
one precision below the configuration's (multiframe: TF32 for float32 with
TF32 off; monocular: bfloat16 for TF32), put in the program's place, reads
at least three times what a sound run of the program reads in one of the
cell's numbers. The readings at the cells' own sizes, from which the
limits were set, and each control judged against the committed limits,
are tools/calibrate.py's (PERF.md)."""
from __future__ import annotations

import pytest

from gpubench import run as R

from .small import small_cell

SEED = 2 ** 31 + 13


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kind", [("mf-train", "tf32"), ("mono-predict", "bf16")])
def test_control_reads_above_sound_runs(name, kind, card):
    cell = small_cell(name)
    _, checks = R.run_cell(cell, SEED, 1.0, False, card)
    sound = {k: v for k, (v, _) in checks.items()}
    control = cell.driver().control(cell, SEED, card, kind)
    assert any(control[k] >= 3 * sound[k] and control[k] > 0 for k in control), (sound, control)
