"""A TigDog-format pkl tree made from a seed, for tests and smoke runs.

    python3 tools/tigdog_fixture.py OUT_DIR [--category horse] [--videos 4]
        [--frames 8] [--raw 360 640] [--seed 0]

Writes what data/tigdog.py::VideoPklDataset reads, one pkl per video:
  OUT_DIR/<category>/vid_<i>.pkl  {"video": (T, H, W, 3) uint8,
                                   "segmentations": (T, H, W) uint8 0/1,
                                   "bboxes": (T, 4) float64 x1 y1 x2 y2 (padded mask box),
                                   "landmarks": (T, 19, 3) float64 x, y (px), visible,
                                   "sfm_poses": (T, 7) float64 scale, tx, ty, quaternion}
OUT_DIR is the CLIs' --root_dir. Each video holds a quadruped-like blob
(body ellipse, head disc, four legs) with its own colours, walking across a
textured background: it moves a few pixels a frame and its legs swing, so
consecutive frames differ as a clip's do and crop and resize really run at
360x640. Its 19 keypoints lie on the blob (the last, the neck, always
visible; a few others hidden per video); its SfM camera is a side view in
the [-1, 1] units of the bbox crop, turning slowly. numpy only; imports
nothing of either package of the repo.
"""
from __future__ import annotations

import argparse
import math
import os
import os.path as osp
import pickle

import numpy as np

NUM_KPS = 19


def _quat_y(angle: float) -> np.ndarray:
    return np.array([math.cos(angle / 2.0), 0.0, math.sin(angle / 2.0), 0.0])


def make_video(rng: np.random.Generator, n_frames: int = 8,
               raw: tuple[int, int] = (360, 640)) -> dict:
    """One clip: frames, masks, boxes, keypoints and cameras."""
    H, W = raw
    yy, xx = np.mgrid[:H, :W].astype(np.float64)
    size = min(H, W) * rng.uniform(0.35, 0.5)          # body length
    cx0, cy0 = W * rng.uniform(0.3, 0.45), H * rng.uniform(0.4, 0.55)
    vx, vy = rng.uniform(4, 9) * rng.choice([-1, 1]), rng.uniform(-2, 2)
    face = 1.0 if vx > 0 else -1.0
    fg = rng.uniform(0.1, 0.9, 3)
    stripes = rng.uniform(4, 12)
    bg = rng.uniform(0.3, 0.9, 3)
    bg_freq = rng.uniform(8, 30, 2)
    yaw0 = rng.uniform(-0.4, 0.4) + (0.0 if face > 0 else math.pi)
    hidden = rng.permutation(NUM_KPS - 1)[:4]

    video = np.zeros((n_frames, H, W, 3), np.uint8)
    seg = np.zeros((n_frames, H, W), np.uint8)
    bboxes = np.zeros((n_frames, 4))
    landmarks = np.zeros((n_frames, NUM_KPS, 3))
    poses = np.zeros((n_frames, 7))
    a, b = size / 2.0, size / 4.5
    for t in range(n_frames):
        cx, cy = cx0 + vx * t, cy0 + vy * t
        body = ((xx - cx) / a) ** 2 + ((yy - cy) / b) ** 2 <= 1.0
        hx, hy = cx + face * 1.05 * a, cy - 0.8 * b
        head = (xx - hx) ** 2 + (yy - hy) ** 2 <= (0.55 * b) ** 2
        legs = np.zeros_like(body)
        feet = []
        for i, off in enumerate((-0.7, -0.45, 0.45, 0.7)):
            swing = 0.25 * b * math.sin(0.9 * t + i * math.pi / 2)
            lx = cx + off * a + swing
            legs |= (np.abs(xx - lx) <= 0.14 * b) & (yy >= cy) & (yy <= cy + 2.2 * b)
            feet.append((lx, cy + 2.1 * b))
        mask = body | head | legs
        shade = 0.12 * np.sin((xx - cx) / stripes)[..., None]
        back = bg + 0.1 * np.sin(xx[..., None] / bg_freq[0] + yy[..., None] / bg_freq[1]
                                 + np.arange(3))
        img = np.where(mask[..., None], fg + shade, back) + rng.normal(0, 0.02, (H, W, 3))
        video[t] = (np.clip(img, 0, 1) * 255).round().astype(np.uint8)
        seg[t] = mask

        ys, xs = np.nonzero(mask)
        pad = 0.05 * size
        bboxes[t] = [max(xs.min() - pad, 0), max(ys.min() - pad, 0),
                     min(xs.max() + pad, W - 1), min(ys.max() + pad, H - 1)]
        pts = [(hx + face * 0.3 * b, hy - 0.2 * b), (hx - face * 0.1 * b, hy - 0.4 * b),
               (hx, hy + 0.3 * b)]
        pts += feet + [(x, cy + 0.6 * b) for x, _ in feet]
        pts += [(cx + s * a * 0.8, cy + d * b * 0.6) for s in (-1, 1) for d in (-1, 0, 1)]
        pts += [(cx - face * a, cy - 0.2 * b), (cx + face * 0.8 * a, cy - 0.7 * b)]
        pts = np.asarray(pts[:NUM_KPS])
        vis = np.ones(NUM_KPS)
        vis[hidden] = 0.0
        landmarks[t] = np.concatenate([pts * vis[:, None], vis[:, None]], axis=1)

        # weak-perspective side view in the [-1, 1] frame of the square crop
        side = max(bboxes[t, 2] - bboxes[t, 0], bboxes[t, 3] - bboxes[t, 1])
        poses[t, 0] = 2.0 * a / side
        poses[t, 1] = 2.0 * (cx - 0.5 * (bboxes[t, 0] + bboxes[t, 2])) / side
        poses[t, 2] = 2.0 * (cy - 0.5 * (bboxes[t, 1] + bboxes[t, 3])) / side
        poses[t, 3:] = _quat_y(yaw0 + 0.03 * t)
    return {"video": video, "segmentations": seg, "bboxes": bboxes, "landmarks": landmarks,
            "sfm_poses": poses}


def write_tigdog_tree(root: str, category: str = "horse", n_videos: int = 4,
                      n_frames: int = 8, raw: tuple[int, int] = (360, 640),
                      seed: int = 0) -> str:
    """Write the tree under `root`; returns the category directory."""
    rng = np.random.default_rng(seed)
    out = osp.join(root, category)
    os.makedirs(out, exist_ok=True)
    for i in range(n_videos):
        with open(osp.join(out, f"vid_{i:03d}.pkl"), "wb") as f:
            pickle.dump(make_video(rng, n_frames, raw), f)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out")
    ap.add_argument("--category", default="horse")
    ap.add_argument("--videos", type=int, default=4)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--raw", type=int, nargs=2, default=(360, 640))
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    write_tigdog_tree(a.out, a.category, a.videos, a.frames, tuple(a.raw), a.seed)
