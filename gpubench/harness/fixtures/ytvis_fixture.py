"""A YouTube-VIS-format pkl tree made from a seed: mask-only clips.

    python3 -m gpubench.harness.fixtures.ytvis_fixture OUT_DIR [--category horse]
        [--videos 8] [--frames 29] [--raw 720 1280] [--seed 1]

Writes what data/tigdog.py::YTVISPklDataset reads (the schema of the
reference's multiframe/data/ytvis_final.py), one pkl per clip:
  OUT_DIR/<category>/ytvis_<i>.pkl  {"video": (T, H, W, 3) uint8,
                                     "segmentations": (T, H, W) uint8 0/1,
                                     "bboxes": (T, 4) float64 x, y, w, h (padded mask box)}
and no keypoints and no cameras: the dataset puts placeholders in their
place and turns the boxes into squared x1 y1 x2 y2. OUT_DIR is the CLIs'
--root_dir_yt. The clips are tigdog_fixture.make_video's walking blobs
(their keypoints and cameras dropped), at YouTube-VIS's 720p by default.
numpy only; imports nothing of either package of the repo.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle

import numpy as np

from .tigdog_fixture import make_video


def make_clip(rng: np.random.Generator, n_frames: int, raw: tuple[int, int]) -> dict:
    """One mask-only clip: frames, masks and xywh boxes."""
    v = make_video(rng, n_frames, raw)
    boxes = v["bboxes"].copy()
    boxes[:, 2:] -= boxes[:, :2]
    return {"video": v["video"], "segmentations": v["segmentations"], "bboxes": boxes}


def write_ytvis_tree(root: str, category: str = "horse", n_videos: int = 8,
                     n_frames: int = 29, raw: tuple[int, int] = (720, 1280),
                     seed: int = 1) -> str:
    """Write the tree under `root`; returns the category directory."""
    rng = np.random.default_rng(seed)
    out = osp.join(root, category)
    os.makedirs(out, exist_ok=True)
    for i in range(n_videos):
        with open(osp.join(out, f"ytvis_{i:03d}.pkl"), "wb") as f:
            pickle.dump(make_clip(rng, n_frames, raw), f)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out")
    ap.add_argument("--category", default="horse")
    ap.add_argument("--videos", type=int, default=8)
    ap.add_argument("--frames", type=int, default=29)
    ap.add_argument("--raw", type=int, nargs=2, default=(720, 1280))
    ap.add_argument("--seed", type=int, default=1)
    a = ap.parse_args()
    write_ytvis_tree(a.out, a.category, a.videos, a.frames, tuple(a.raw), a.seed)
