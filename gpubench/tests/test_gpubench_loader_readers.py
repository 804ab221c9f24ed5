"""The readers of the loader's batch build (metrics/loader_*.train.py):
listed for both multiframe training cells, None from an untraced run, from
a window with no units and from a program without utils/tracing.py or
without the span and counter they read (the parent of the commit that
added them); the right number from a synthetic record."""
from __future__ import annotations

import sys

import pytest

from acfm_video_3d_reconstruction_tpu_torch.utils import tracing
from gpubench.harness import bench

from .test_gpubench_program_spans import UNITS, ctx, reader, synthetic

READERS = {
    "loader_batch_host_ms.train": ("data.batch", "acfm-loader"),
    "loader_pool_clips.train": ("data.pool_clips", None),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_listed_for_both_multiframe_cells(name):
    entry = next(m for m in bench.benchmark()["per_layer"] if m["name"] == name)
    assert entry["workloads"] == ["mf-train", "mf-train-nokp"]
    assert entry["moves"] == "train_frames_per_s"


@pytest.mark.parametrize("name", sorted(READERS))
def test_nothing_to_read_reads_none(name, monkeypatch):
    """Untraced, no units, and a record of the other spans and counters
    only (what the parent's program leaves)."""
    monkeypatch.setattr(tracing, "record", lambda: synthetic("data.load", "acfm-prefetch"))
    monkeypatch.setattr(tracing, "counters",
                        lambda: {"launch.soft": 3, "data.mask_only_clips": 2})
    assert reader(name).read(ctx(traced=False)) is None
    assert reader(name).read(ctx()) is None
    assert reader(name).read(ctx(units=0)) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_program_without_tracing_reads_none(name, monkeypatch):
    from acfm_video_3d_reconstruction_tpu_torch import utils

    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "acfm_video_3d_reconstruction_tpu_torch.utils.tracing", None)
    assert reader(name).read(ctx()) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_synthetic_record(name, monkeypatch):
    what, thread = READERS[name]
    if thread is None:
        monkeypatch.setattr(tracing, "counters", lambda: {what: 32, "launch.soft": 99})
        assert reader(name).read(ctx()) == pytest.approx(32 / UNITS)
    else:
        monkeypatch.setattr(tracing, "record", lambda: synthetic(what, thread))
        # (3 - 1) + 5 ms of self time over 4 units
        assert reader(name).read(ctx()) == pytest.approx(7 / UNITS)
