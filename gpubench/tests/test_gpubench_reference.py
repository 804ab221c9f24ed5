"""The reference equals the port at small sizes on the CPU (the port runs
its plain kernels there): one multiframe step and one prediction, each
through the harness's own run of
the cell, on one CPU thread: the data and the start exactly, every other
number within 1e-4 (a planted fault reads 1e-2 or more,
test_gpubench_faults.py)."""
from __future__ import annotations

import pytest
import torch

from gpubench import run as R

from .small import CPU, no_native, small_cell


@pytest.fixture
def one_thread():
    """One intra-op thread: every CPU reduction in one order, whichever
    thread (the loop's or its prefetch thread) runs it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["mf-train", "mono-predict"])
def test_reference_equals_port_on_cpu(name, monkeypatch, one_thread):
    no_native(monkeypatch)
    result, checks = R.run_cell(small_cell(name), 2 ** 31 + 7, 2.0, False, CPU)
    numbers = {k: v for k, (v, _) in checks.items()}
    assert result["correct"], numbers
    for k, v in numbers.items():
        assert v == 0.0 if k in ("data", "start", "steps") else v <= 1e-4, (k, v)
