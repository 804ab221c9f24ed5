"""The readers of the program's own spans and counters
(harness/program_spans.py and their files under metrics/): None from an
untraced run, from a window that recorded nothing and from a program
without utils/tracing.py; the right number from a synthetic record."""
from __future__ import annotations

import os
import sys
import types

import pytest

from gpubench.harness import bench

from acfm_video_3d_reconstruction_tpu_torch.utils import tracing

S = tracing.Span
UNITS = 4
# metric: (span or counter, thread); a counter has no thread
READERS = {
    "forward_host_ms.train": ("train.forward", "MainThread"),
    "backward_host_ms.train": ("train.backward", "MainThread"),
    "optimizer_host_ms.train": ("train.optimizer", "MainThread"),
    "loader_host_ms.train": ("data.load", "acfm-prefetch"),
    "upload_host_ms.train": ("data.upload", "acfm-prefetch"),
    "flow_host_ms.train": ("flow.infer", "acfm-prefetch"),
    "decode_host_ms.predict": ("data.decode", "MainThread"),
    "crop_host_ms.predict": ("data.crop", "MainThread"),
    "mask_geometry_host_ms.predict": ("data.mask_geometry", "MainThread"),
    "predict_host_ms.predict": ("predict", "MainThread"),
    "raster_faces_dropped.train": ("raster.faces_dropped", None),
    "solve_failures.train": ("solve.failures", None),
}


def reader(name):
    return bench.load_module(os.path.join(bench.GPUBENCH, "metrics", name + ".py"))


WINDOW_S = 0.1


def ctx(traced=True, units=UNITS):
    return types.SimpleNamespace(trace=object() if traced else None, units=units,
                                 window_s=WINDOW_S)


def synthetic(name, thread):
    """Two spans of `name` on `thread` (3 ms and 5 ms), a 1 ms child span
    inside the first, the same span on another thread and one that ends
    after the window (100 ms from the first span's start): neither read."""
    other = "acfm-prefetch" if thread == "MainThread" else "MainThread"
    ms = 1_000_000
    return [S(1, "child", thread, 6 * ms, 7 * ms, 0, None),
            S(0, name, thread, 5 * ms, 8 * ms, None, 0),
            S(2, name, thread, 10 * ms, 15 * ms, None, 1),
            S(3, name, other, 5 * ms, 50 * ms, None, 0),
            S(4, name, thread, 90 * ms, 2000 * ms, None, 2),
            S(5, "other", "MainThread", 4 * ms, 9 * ms, None, None)]


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_is_listed_for_its_cell(name):
    entry = next(m for m in bench.benchmark()["per_layer"] if m["name"] == name)
    cell = "mf-train" if name.endswith(".train") else "mono-predict"
    assert entry["workloads"] == [cell]


@pytest.mark.parametrize("name", sorted(READERS))
def test_untraced_or_empty_reads_none(name, monkeypatch):
    monkeypatch.setattr(tracing, "record", lambda: [])
    monkeypatch.setattr(tracing, "counters", lambda: {"launch.soft": 3})
    assert reader(name).read(ctx(traced=False)) is None
    assert reader(name).read(ctx()) is None
    assert reader(name).read(ctx(units=0)) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_program_without_tracing_reads_none(name, monkeypatch):
    """A checkout of the program from before utils/tracing.py."""
    from acfm_video_3d_reconstruction_tpu_torch import utils

    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "acfm_video_3d_reconstruction_tpu_torch.utils.tracing", None)
    assert reader(name).read(ctx()) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_synthetic_record(name, monkeypatch):
    what, thread = READERS[name]
    if thread is None:
        monkeypatch.setattr(tracing, "counters", lambda: {what: 6, "launch.soft": 99})
        assert reader(name).read(ctx()) == pytest.approx(6 / UNITS)
    else:
        monkeypatch.setattr(tracing, "record", lambda: synthetic(what, thread))
        # (3 - 1) + 5 ms of self time over 4 units
        assert reader(name).read(ctx()) == pytest.approx(7 / UNITS)
