"""The cells at sizes a CPU test can hold: the same code paths as on the
card, at 64^2 with small nets and a few clips or images."""
from __future__ import annotations

import torch

from gpubench.harness import bench
from gpubench.tools.calibrate import shrink_cell

MULTIFRAME = {"cli": {"img_size": 64, "subdivide": 1, "num_lbs": 6, "nz_feat": 32,
                      "num_guesses": 2, "batch_size": 2},
              "flow_net_hw": [64, 128], "dataset": {"videos": 2, "frames": 6, "raw": [120, 200]}}
MONOCULAR = {"cli": {"img_size": 64, "num_lbs": 6, "nz_feat": 32, "tex_size": 2, "batch_size": 4},
             "dataset": {"train": 16, "test": 4, "raw": [80, 120]}}
TRAFFIC = {"mf-train": {"warm_steps": 4},
           "mono-predict": {"warm_requests": 3, "sample_every": 2, "control_requests": 2}}


def small_cell(name: str) -> bench.Cell:
    cell = bench.Cell(name)
    changes = dict(MULTIFRAME if "flow_net_hw" in cell.config else MONOCULAR)
    changes["traffic"] = TRAFFIC[name]
    shrink_cell(cell, changes)
    return cell


def no_native(monkeypatch) -> None:
    """The program's mask preprocessing on its numpy path, as in a checkout
    where the native library is not built (the reference takes that path)."""
    from acfm_video_3d_reconstruction_tpu_torch.data import native

    monkeypatch.setattr(native, "available", lambda: False)


CPU = torch.device("cpu")
