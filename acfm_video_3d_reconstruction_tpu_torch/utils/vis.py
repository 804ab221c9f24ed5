"""Visualization: keypoint/mask overlays and image panels.

A copy of the numpy part of acfm_video_3d_reconstruction_tpu/utils/vis.py
(parity target: reference */utils/bird_vis.py kp2im overlays and
visutil.py tensor converters), writing PNG panels instead of visdom.
VisRenderer (the novel-viewpoint mesh renders) is not ported yet.
"""
from __future__ import annotations

import numpy as np

COLORS = np.asarray(
    [
        [255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 0], [255, 0, 255],
        [0, 255, 255], [255, 128, 0], [128, 0, 255], [0, 128, 255],
        [128, 255, 0], [255, 0, 128], [0, 255, 128], [128, 128, 255],
        [255, 128, 128], [128, 255, 128], [200, 200, 200], [90, 60, 30],
        [30, 90, 60], [60, 30, 90],
    ],
    np.uint8,
)


def tensor2im(img) -> np.ndarray:
    """(H, W, 3) float [0,1] -> uint8."""
    return (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)


def tensor2mask(mask) -> np.ndarray:
    """(H, W) float [0,1] -> uint8 RGB."""
    m = (np.clip(np.asarray(mask), 0, 1) * 255).astype(np.uint8)
    return np.stack([m, m, m], axis=-1)


def kp2im(kps, img, radius: int = 2) -> np.ndarray:
    """Overlay [-1,1]-normalized keypoints on an image (reference kp2im).

    kps: (K, 2) or (K, 3) with optional vis; img: (H, W, 3) float.
    """
    out = tensor2im(img).copy()
    H, W = out.shape[:2]
    kps = np.asarray(kps)
    for i, kp in enumerate(kps):
        if kp.shape[-1] > 2 and kp[2] <= 0:
            continue
        x = int(round((kp[0] + 1) * W / 2))
        y = int(round((kp[1] + 1) * H / 2))
        color = COLORS[i % len(COLORS)]
        y0, y1 = max(0, y - radius), min(H, y + radius + 1)
        x0, x1 = max(0, x - radius), min(W, x + radius + 1)
        out[y0:y1, x0:x1] = color
    return out


def save_image(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(img).save(path)


def make_panel(images: list[np.ndarray]) -> np.ndarray:
    """Horizontally stack equal-height images (reference np.hstack panels)."""
    h = min(im.shape[0] for im in images)
    return np.concatenate([im[:h] for im in images], axis=1)
