"""Host-side image/mask preprocessing (numpy/scipy/cv2).

A copy of acfm_video_3d_reconstruction_tpu/data/image_utils.py (the port
imports nothing of the JAX package): bbox perturb/square/crop, distance
transforms, barrier DT, and mask-boundary point extraction. A native C++
path for the DT/boundary hot loop lives in native/ (data/native.py, loaded
with ctypes when built); these numpy versions are the fallback and the
test oracle.
"""
from __future__ import annotations

import numpy as np
from scipy.ndimage import binary_dilation, binary_erosion, distance_transform_edt


def resize_img(img: np.ndarray, scale_factor: float):
    import cv2

    new_size = (np.round(np.array(img.shape[:2]) * scale_factor)).astype(int)
    new_img = cv2.resize(img, (new_size[1], new_size[0]))
    actual_factor = [
        new_size[0] / float(img.shape[0]),
        new_size[1] / float(img.shape[1]),
    ]
    return new_img, actual_factor


def peturb_bbox(bbox, pf=0.0, jf=0.0, rng: np.random.Generator | None = None):
    """Pad by pf and jitter by jf fractions of the bbox size."""
    rng = rng or np.random.default_rng()
    bbox = [float(c) for c in bbox]
    bw = bbox[2] - bbox[0] + 1
    bh = bbox[3] - bbox[1] + 1
    out = [
        bbox[0] - pf * bw - (1 - 2 * rng.random()) * jf * bw,
        bbox[1] - pf * bh - (1 - 2 * rng.random()) * jf * bh,
        bbox[2] + pf * bw + (1 - 2 * rng.random()) * jf * bw,
        bbox[3] + pf * bh + (1 - 2 * rng.random()) * jf * bh,
    ]
    return out


def square_bbox(bbox):
    """Expand the short side to make the bbox square."""
    sq = [int(round(c)) for c in bbox]
    bw = sq[2] - sq[0] + 1
    bh = sq[3] - sq[1] + 1
    maxdim = float(max(bw, bh))
    dw2 = int(round((maxdim - bw) / 2.0))
    dh2 = int(round((maxdim - bh) / 2.0))
    sq[0] -= dw2
    sq[1] -= dh2
    sq[2] = sq[0] + maxdim - 1
    sq[3] = sq[1] + maxdim - 1
    return sq


def crop(img: np.ndarray, bbox, bgval=0.0) -> np.ndarray:
    """Crop with out-of-image regions filled with bgval."""
    bbox = [int(round(c)) for c in bbox]
    bw = bbox[2] - bbox[0] + 1
    bh = bbox[3] - bbox[1] + 1
    im_h, im_w = img.shape[0], img.shape[1]
    nc = 1 if img.ndim < 3 else img.shape[2]
    out = np.full((bh, bw, nc), bgval, dtype=np.float64)
    x0s, x1s = max(0, bbox[0]), min(im_w, bbox[2] + 1)
    y0s, y1s = max(0, bbox[1]), min(im_h, bbox[3] + 1)
    x0t = x0s - bbox[0]
    y0t = y0s - bbox[1]
    src = img if img.ndim == 3 else img[..., None]
    out[y0t : y0t + (y1s - y0s), x0t : x0t + (x1s - x0s)] = src[y0s:y1s, x0s:x1s]
    return out


def compute_dt(mask: np.ndarray, norm: bool = True) -> np.ndarray:
    """Euclidean distance transform of the complement of the mask."""
    dist = distance_transform_edt(1 - (np.asarray(mask) > 0.5))
    if norm:
        dist = dist / max(mask.shape)
    return dist.astype(np.float32)


def compute_dt_barrier(mask: np.ndarray, k: float = 50.0) -> np.ndarray:
    """Sigmoid of the signed distance transform (barrier)."""
    m = np.asarray(mask) > 0.5
    dist_out = distance_transform_edt(~m)
    dist_in = distance_transform_edt(m)
    dist_diff = (dist_out - dist_in) / max(mask.shape)
    return (1.0 / (1.0 + np.exp(-k * dist_diff))).astype(np.float32)


def find_boundaries_thick(mask: np.ndarray) -> np.ndarray:
    """'Thick' boundary of a binary mask: pixels whose 4-neighborhood
    contains both values (skimage find_boundaries parity for binary input)."""
    m = np.asarray(mask) > 0.5
    cross = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)
    return binary_dilation(m, cross) ^ binary_erosion(m, cross, border_value=True)


def compute_boundaries(masks: np.ndarray, max_points: int | None = None) -> np.ndarray:
    """Batched boundary point lists, padded, in [-1, 1] coords.

    masks: (B, H, W). Returns (B, N, 3) = [x, y, valid] where N is the max
    boundary length over the batch (or max_points if given). Matches
    reference monocular/utils/image.py:122-146 (x = col coord, y = row).
    """
    B, H, W = masks.shape
    pts = []
    for m in masks:
        bd = np.transpose(find_boundaries_thick(m).nonzero())  # (n, 2) [row, col]
        pts.append(bd)
    max_bd = max([p.shape[0] for p in pts]) if max_points is None else max_points
    max_bd = max(max_bd, 1)
    out = np.zeros((B, max_bd, 3), np.float32)
    for i, bd in enumerate(pts):
        n = min(bd.shape[0], max_bd)
        out[i, :n, 0] = (bd[:n, 1] / W - 0.5) * 2.0  # x from col
        out[i, :n, 1] = (bd[:n, 0] / H - 0.5) * 2.0  # y from row
        out[i, :n, 2] = 1.0
    return out


def perturb_kps_and_bbox_mirror(kp, kp_perm, W):
    """Mirror keypoints horizontally with the category's left/right perm.

    kp: (K, 3) with x in [0, W); returns mirrored copy.
    """
    out = kp.copy()
    out[:, 0] = W - 1 - kp[:, 0]
    return out[kp_perm]
