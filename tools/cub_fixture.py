"""A CUB-200-2011-format tree made from a seed, for tests and smoke runs.

    python3 tools/cub_fixture.py OUT_DIR [--train 96] [--test 24] [--raw 300 400]

Writes what data/cub.py reads (the reference's CMR cache layout):
  OUT_DIR/images/<split>_<i>.png             raw RGB images, sizes drawn in [raw_lo, raw_hi]
  OUT_DIR/data/<split>_cub_cleaned.mat       `images`: rel_path, mask, bbox.x1..y2, parts (3x15)
  OUT_DIR/sfm/anno_<split>.mat               `sfm_anno` (scale, trans, rot) per image, and the
                                             mean shape `S` (3x15) with its hull `conv_tri`
OUT_DIR serves as both the CUB dir and the CUB cache dir. Each image holds a
bird-like blob (body ellipse and head disc) on a textured background; its
mask is the blob, its bbox the mask's (1-indexed, inclusive), 12 of its 15
keypoints lie inside the blob and the rest are invisible; its SfM camera is
a random rotation with the blob's centre and half its size. numpy, scipy and
PIL only; imports nothing of either package of the repo.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np

NUM_KPS = 15


def _rotation(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def make_sample(rng: np.random.Generator, raw: tuple[int, int]) -> dict:
    """One image, its mask and its annotations."""
    h, w = (int(v) for v in rng.integers(raw[0], raw[1] + 1, size=2))
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    side = min(h, w)
    cy, cx = h * rng.uniform(0.4, 0.6), w * rng.uniform(0.4, 0.6)
    a, b = side * rng.uniform(0.22, 0.32), side * rng.uniform(0.12, 0.2)
    ang = rng.uniform(0, np.pi)
    u = (xx - cx) * np.cos(ang) + (yy - cy) * np.sin(ang)
    v = -(xx - cx) * np.sin(ang) + (yy - cy) * np.cos(ang)
    body = (u / a) ** 2 + (v / b) ** 2 <= 1.0
    hx, hy = cx + 0.95 * a * np.cos(ang), cy + 0.95 * a * np.sin(ang)
    head = (xx - hx) ** 2 + (yy - hy) ** 2 <= (0.45 * b) ** 2
    mask = body | head

    bg = rng.uniform(0.2, 0.9, 3) + 0.1 * np.sin(xx[..., None] / rng.uniform(5, 20)
                                               + rng.uniform(0, 6, 3))
    fg = rng.uniform(0.0, 1.0, 3) + 0.15 * np.cos(u[..., None] / 7.0)
    img = np.where(mask[..., None], fg, bg) + rng.normal(0, 0.03, (h, w, 3))
    img = (np.clip(img, 0, 1) * 255).round().astype(np.uint8)

    ys, xs = np.nonzero(mask)
    parts = np.zeros((3, NUM_KPS))
    pick = rng.choice(len(ys), NUM_KPS, replace=False)
    visible = rng.permutation(NUM_KPS) < 12
    parts[0] = np.where(visible, xs[pick] + 1.0, 0.0)
    parts[1] = np.where(visible, ys[pick] + 1.0, 0.0)
    parts[2] = visible.astype(np.float64)
    bbox = {"x1": float(xs.min() + 1), "y1": float(ys.min() + 1),
            "x2": float(xs.max() + 1), "y2": float(ys.max() + 1)}
    sfm = {"scale": float(a), "trans": np.array([cx + 1.0, cy + 1.0]),
           "rot": _rotation(rng.normal(size=4))}
    return {"img": img, "mask": mask.astype(np.uint8), "bbox": bbox, "parts": parts,
            "sfm": sfm}


def _records(fields: dict) -> np.ndarray:
    """A 1-D struct array for scipy.io.savemat from equal-length lists."""
    n = len(next(iter(fields.values())))
    rec = np.empty((n,), dtype=[(k, object) for k in fields])
    for k, vals in fields.items():
        for i, val in enumerate(vals):
            rec[i][k] = val
    return rec


def mean_shape(rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """(S (3, 15), conv_tri (M, 3) 1-indexed): keypoints on an ellipsoid."""
    from scipy.spatial import ConvexHull

    d = rng.normal(size=(NUM_KPS, 3))
    pts = d / np.linalg.norm(d, axis=1, keepdims=True) * np.array([0.6, 0.35, 0.3])
    return pts.T, ConvexHull(pts).simplices + 1


def write_cub_tree(root: str, n_train: int = 96, n_test: int = 24,
                   raw: tuple[int, int] = (300, 400), seed: int = 0) -> None:
    """Write the tree under `root`."""
    import scipy.io as sio
    from PIL import Image

    rng = np.random.default_rng(seed)
    S, conv_tri = mean_shape(rng)
    for sub in ("images", "data", "sfm"):
        os.makedirs(osp.join(root, sub), exist_ok=True)
    for split, n in (("train", n_train), ("test", n_test)):
        samples = [make_sample(rng, raw) for _ in range(n)]
        names = [f"{split}_{i:04d}.png" for i in range(n)]
        for name, s in zip(names, samples):
            Image.fromarray(s["img"]).save(osp.join(root, "images", name))
        sio.savemat(osp.join(root, "data", f"{split}_cub_cleaned.mat"), {
            "images": _records({"rel_path": names, "mask": [s["mask"] for s in samples],
                                "bbox": [s["bbox"] for s in samples],
                                "parts": [s["parts"] for s in samples]})})
        sio.savemat(osp.join(root, "sfm", f"anno_{split}.mat"), {
            "sfm_anno": _records({k: [s["sfm"][k] for s in samples]
                                  for k in ("scale", "trans", "rot")}),
            "S": S, "conv_tri": conv_tri.astype(np.float64)})


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out")
    ap.add_argument("--train", type=int, default=96)
    ap.add_argument("--test", type=int, default=24)
    ap.add_argument("--raw", type=int, nargs=2, default=(300, 400))
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    write_cub_tree(a.out, a.train, a.test, tuple(a.raw), a.seed)
