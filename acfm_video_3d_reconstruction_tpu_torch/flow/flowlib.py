"""Optical-flow file I/O and visualization.

A copy of acfm_video_3d_reconstruction_tpu/flow/flowlib.py (numpy only; the
port imports nothing of the JAX package).

Parity target: reference multiframe/data/optical_flow/flowlib.py — .flo
read/write, KITTI png, and the Middlebury color wheel visualization
(re-derived from the public color-wheel spec, vectorized numpy).
"""
from __future__ import annotations

import numpy as np

TAG_FLOAT = 202021.25
UNKNOWN_FLOW_THRESH = 1e7


def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo -> (H, W, 2) float32."""
    with open(path, "rb") as f:
        tag = np.frombuffer(f.read(4), np.float32)[0]
        if tag != TAG_FLOAT:
            raise ValueError(f"bad .flo magic in {path}")
        w = int(np.frombuffer(f.read(4), np.int32)[0])
        h = int(np.frombuffer(f.read(4), np.int32)[0])
        data = np.frombuffer(f.read(4 * 2 * w * h), np.float32)
    return data.reshape(h, w, 2).copy()


def write_flo(path: str, flow: np.ndarray) -> None:
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.asarray([TAG_FLOAT], np.float32).tofile(f)
        np.asarray([w, h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_kitti_png(path: str) -> tuple[np.ndarray, np.ndarray]:
    """KITTI 16-bit png -> (flow (H, W, 2), valid (H, W))."""
    import cv2

    raw = cv2.imread(path, cv2.IMREAD_UNCHANGED).astype(np.float64)
    raw = raw[:, :, ::-1]  # BGR -> RGB channel order (u, v, valid)
    flow = (raw[:, :, :2] - 2**15) / 64.0
    valid = raw[:, :, 2] > 0
    return flow.astype(np.float32), valid


def _color_wheel() -> np.ndarray:
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    n = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((n, 3))
    col = 0
    wheel[:RY, 0] = 255
    wheel[:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


def flow_to_image(flow: np.ndarray) -> np.ndarray:
    """(H, W, 2) flow -> uint8 RGB (Middlebury color coding)."""
    u, v = flow[..., 0].copy(), flow[..., 1].copy()
    bad = (np.abs(u) > UNKNOWN_FLOW_THRESH) | (np.abs(v) > UNKNOWN_FLOW_THRESH)
    u[bad] = 0
    v[bad] = 0
    rad = np.sqrt(u**2 + v**2)
    maxrad = max(rad.max(), 1e-9)
    u, v = u / maxrad, v / maxrad
    wheel = _color_wheel()
    n = len(wheel)
    rad = np.sqrt(u**2 + v**2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1.0) / 2.0 * (n - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % n
    f = fk - k0
    img = np.zeros(flow.shape[:2] + (3,), np.uint8)
    for c in range(3):
        col0 = wheel[k0, c] / 255.0
        col1 = wheel[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        inr = rad <= 1
        col[inr] = 1 - rad[inr] * (1 - col[inr])
        col[~inr] = col[~inr] * 0.75
        img[..., c] = np.where(bad, 0, np.floor(255 * col)).astype(np.uint8)
    return img
