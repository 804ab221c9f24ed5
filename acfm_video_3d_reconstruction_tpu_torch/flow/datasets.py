"""Optical-flow benchmark dataset loaders: FlyingChairs, Sintel, KITTI.

A copy of acfm_video_3d_reconstruction_tpu/flow/datasets.py (numpy only; the
port imports nothing of the JAX package).

Parity target: reference multiframe/data/optical_flow/data_loaders/
{Chairs,sintel,kitti}.py — the directory layouts, split files and
validation-index conventions those loaders expect, re-implemented as
plain-numpy iterables for `cli/flow_predict.py` (AEPE evaluation of a
converted MaskFlownet checkpoint). Flow file IO lives in flow/flowlib.py.

Samples are dicts {im0, im1 (H, W, 3) float [0,1], flow (H, W, 2) or None,
mask (H, W) or None, path}.
"""
from __future__ import annotations

import os
import os.path as osp
import re

import numpy as np

from . import flowlib

# KITTI train/val split indices used by the reference (kitti.py:11-13)
KITTI_VALIDATE_INDICES = {
    "2012": [0, 12, 15, 16, 17, 18, 24, 30, 38, 39, 42, 50, 54, 59, 60, 61,
             77, 78, 81, 89, 97, 101, 107, 121, 124, 142, 145, 146, 152, 154,
             155, 158, 159, 160, 164, 182, 183, 184, 190],
    "2015": [10, 11, 12, 25, 26, 30, 31, 40, 41, 42, 46, 52, 53, 72, 73, 74,
             75, 76, 80, 81, 85, 86, 95, 96, 97, 98, 104, 116, 117, 120, 121,
             126, 127, 153, 172, 175, 183, 184, 190, 199],
}


def _imread(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    if img.shape[-1] == 3:
        img = img[..., ::-1]  # BGR -> RGB
    return np.ascontiguousarray(img)


def read_ppm(path: str) -> np.ndarray:
    """Binary P6 PPM reader (FlyingChairs images)."""
    with open(path, "rb") as f:
        assert f.readline().strip() == b"P6", path
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        w, h = map(int, line.split())
        maxval = int(f.readline())
        data = np.frombuffer(f.read(w * h * 3), np.uint8)
    del maxval
    return data.reshape(h, w, 3)


class ChairsDataset:
    """FlyingChairs pairs per the official train/val split file
    (reference Chairs.py: states 1=train, 2=valid)."""

    def __init__(self, root: str, split: str = "train"):
        self.samples = []
        want = {"train": "1", "valid": "2"}[split]
        with open(osp.join(root, "FlyingChairs_train_val.txt")) as fp:
            for i, line in enumerate(fp, start=1):
                if line.strip() and line.strip()[0] == want:
                    self.samples.append(
                        osp.join(root, "data", f"{i:05d}_img1.ppm")
                    )

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int) -> dict:
        p0 = self.samples[idx]
        im0 = read_ppm(p0).astype(np.float32) / 255.0
        im1 = read_ppm(p0.replace("_img1.ppm", "_img2.ppm")).astype(np.float32) / 255.0
        flow = flowlib.read_flo(p0.replace("_img1.ppm", "_flow.flo"))
        return {"im0": im0, "im1": im1, "flow": flow, "mask": None, "path": p0}


class SintelDataset:
    """MPI-Sintel consecutive-frame pairs (clean/final passes), with the
    reference's sintel_train_val_split.txt convention (sintel.py:17-43)."""

    def __init__(self, root: str, split: str = "train", subset: str = "final"):
        self.split = split
        pattern = re.compile(r"frame_(\d+)\.png")
        split_path = osp.join(root, "sintel_train_val_split.txt")
        split_flags = (
            np.loadtxt(split_path) if osp.exists(split_path) else None
        )
        pairs = {"train": [], "valid": [], "test": [], "train+valid": []}
        c = 0
        for part in ("training", "test"):
            base = osp.join(root, part, subset)
            if not osp.isdir(base):
                continue
            for seq in sorted(os.listdir(osp.join(root, part, "clean"))):
                frames = sorted(
                    int(m.group(1))
                    for m in map(pattern.match, os.listdir(osp.join(base, seq)))
                    if m
                )
                for i in frames[:-1]:
                    entry = (
                        osp.join(base, seq, f"frame_{i:04d}.png"),
                        osp.join(base, seq, f"frame_{i + 1:04d}.png"),
                    )
                    if part == "test":
                        pairs["test"].append(entry)
                    else:
                        bucket = (
                            "train"
                            if split_flags is None or split_flags[c] == 1
                            else "valid"
                        )
                        pairs[bucket].append(entry)
                        pairs["train+valid"].append(entry)
                        c += 1
        self.pairs = pairs[split]

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx: int) -> dict:
        p0, p1 = self.pairs[idx]
        im0 = _imread(p0).astype(np.float32) / 255.0
        im1 = _imread(p1).astype(np.float32) / 255.0
        flow = mask = None
        if self.split != "test":
            fp = (
                p0.replace("/clean/", "/flow/")
                .replace("/final/", "/flow/")
                .replace(".png", ".flo")
            )
            flow = flowlib.read_flo(fp)
            mp = p0.replace("/clean/", "/invalid/").replace("/final/", "/invalid/")
            if osp.exists(mp):
                invalid = _imread(mp)[..., 0] > 0
                mask = (~invalid).astype(np.float32)
        return {"im0": im0, "im1": im1, "flow": flow, "mask": mask, "path": p0}


class KITTIDataset:
    """KITTI 2012/2015 flow pairs with the reference's validation-index
    split (kitti.py)."""

    def __init__(self, root: str, split: str = "train", editions: str = "mixed",
                 parts: str = "mixed"):
        layout = {
            "2012": ("kitti_stereo_2012/training/colored_0",
                     "kitti_stereo_2012/training/flow_occ",
                     "kitti_stereo_2012/testing/colored_0"),
            "2015": ("kitti_stereo_2015/training/image_2",
                     "kitti_stereo_2015/training/flow_occ",
                     "kitti_stereo_2015/testing/image_2"),
        }
        eds = ("2012", "2015") if editions == "mixed" else (editions,)
        self.samples = []
        for ed in eds:
            img_dir, flow_dir, test_dir = (osp.join(root, p) for p in layout[ed])
            if split == "train":
                if not osp.isdir(flow_dir):
                    continue
                n = len(os.listdir(flow_dir)) - 1
                valids = set(KITTI_VALIDATE_INDICES[ed])
                for k in range(n):
                    if k in valids and parts == "train":
                        continue
                    if k not in valids and parts == "valid":
                        continue
                    self.samples.append(
                        (osp.join(img_dir, f"{k:06d}_10.png"),
                         osp.join(flow_dir, f"{k:06d}_10.png"))
                    )
            else:
                if not osp.isdir(test_dir):
                    continue
                for name in sorted(os.listdir(test_dir)):
                    if name.endswith("_10.png"):
                        self.samples.append((osp.join(test_dir, name), None))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int) -> dict:
        p0, fp = self.samples[idx]
        im0 = _imread(p0).astype(np.float32) / 255.0
        im1 = _imread(p0.replace("_10.png", "_11.png")).astype(np.float32) / 255.0
        flow = mask = None
        if fp is not None:
            flow, valid = flowlib.read_kitti_png(fp)
            mask = valid.astype(np.float32)
        return {"im0": im0, "im1": im1, "flow": flow, "mask": mask, "path": p0}
