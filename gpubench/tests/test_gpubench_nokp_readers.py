"""The readers of mf-train-nokp's own metrics (metrics/*.nokp.py): listed
for that cell alone, None from an untraced run, from a window that
recorded nothing and from a program without utils/tracing.py or without
the spans and counters they read (the parent of the commit that added
them); the right number from a synthetic record. The entry's `mix`
number, which holds `correct` to the configuration's views and mask-only
clips."""
from __future__ import annotations

import sys
import types

import pytest
import torch

from acfm_video_3d_reconstruction_tpu_torch.utils import tracing
from gpubench.harness import bench

from .test_gpubench_program_spans import UNITS, ctx, reader, synthetic

READERS = {
    "multiplex_select_host_ms.nokp": ("multiplex.select", "MainThread"),
    "multiplex_writeback_host_ms.nokp": ("multiplex.writeback", "MainThread"),
    "views_per_step.nokp": ("multiplex.views", None),
    "mask_only_clips.nokp": ("data.mask_only_clips", None),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_listed_for_the_cell_alone(name):
    entry = next(m for m in bench.benchmark()["per_layer"] if m["name"] == name)
    assert entry["workloads"] == ["mf-train-nokp"]
    assert entry["moves"] == "train_frames_per_s"


@pytest.mark.parametrize("name", sorted(READERS))
def test_nothing_to_read_reads_none(name, monkeypatch):
    """Untraced, no units, and a record of the other spans and counters
    only (what the parent's program leaves)."""
    monkeypatch.setattr(tracing, "record",
                        lambda: synthetic("train.forward", "MainThread"))
    monkeypatch.setattr(tracing, "counters", lambda: {"launch.soft": 3, "solve.failures": 0})
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
        monkeypatch.setattr(tracing, "counters", lambda: {what: 256, "launch.soft": 99})
        assert reader(name).read(ctx()) == pytest.approx(256 / UNITS)
    else:
        monkeypatch.setattr(tracing, "record", lambda: synthetic(what, thread))
        assert reader(name).read(ctx()) == pytest.approx(7 / UNITS)


def test_mix_counts_departures_from_the_configuration():
    """0 at k·B·T = 4·8·2 views with a mask-only clip captured; 1 for
    each departure: every hypothesis kept, or no clip without keypoints."""
    from gpubench.entries import multiframe_train_nokp as entry

    cell = bench.Cell("mf-train-nokp")
    kp = torch.ones(8, 2, 18, 3)
    one_mask_only = kp.clone()
    one_mask_only[3] = 0

    def info(views):
        return {"frames_per_step": 16, "shapes": {"soft_views": views}}

    cap = types.SimpleNamespace(batches=[{"kp": kp}, {"kp": one_mask_only}])
    assert entry.mix(cell, cap, info(64)) == 0
    assert entry.mix(cell, cap, info(96)) == 1
    cap.batches = [{"kp": kp}, {"kp": kp}]
    assert entry.mix(cell, cap, info(64)) == 1
    assert entry.mix(cell, cap, info(96)) == 2
