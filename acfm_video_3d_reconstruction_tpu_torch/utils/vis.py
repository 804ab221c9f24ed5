"""Visualization: keypoint/mask overlays and novel-viewpoint mesh renders.

Counterpart of acfm_video_3d_reconstruction_tpu/utils/vis.py (parity
target: reference */utils/bird_vis.py, VisRenderer with its default blue
texture and the diff_vp side / top renders, kp2im overlays, and visutil.py
tensor converters), rendering through the port's rasterizer and writing
PNG panels instead of visdom.
"""
from __future__ import annotations

import numpy as np
import torch

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


class VisRenderer:
    """Human-facing mesh renders through the port's rasterizer.

    A flat blue texture by default; `diff_vp` renders from a rotated
    viewpoint (reference bird_vis.py:18-158). Each render is one hard
    rasterization (render_texture) on `device` (the card unless the caller
    asks for the CPU).
    """

    def __init__(self, img_size: int, faces, offset_z: float = 5.0,
                 device: str | torch.device = "cuda"):
        self.img_size = img_size
        self.device = torch.device(device)
        self.faces = torch.as_tensor(np.asarray(faces), dtype=torch.long, device=self.device)
        self.offset_z = offset_z
        self.default_color = np.asarray([156 / 255.0, 199 / 255.0, 234 / 255.0])

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def __call__(self, verts, cam, texture=None) -> np.ndarray:
        """verts (V, 3), cam (7,), texture (F, T, T, 3) or None -> (H, W, 3) uint8
        on a white background."""
        from ..geometry import camera as cam_utils
        from ..ops import rasterizer as ras

        with torch.no_grad():
            verts = self._tensor(verts)[None]
            cam = self._tensor(cam)[None]
            proj = cam_utils.orthographic_proj_withz(verts, cam, offset_z=self.offset_z)
            if texture is None:
                texture = self._tensor(self.default_color).expand(
                    1, self.faces.shape[0], 2, 2, 3)
            else:
                texture = self._tensor(texture)[None]
            rgb, sil, _ = ras.render_texture(proj, self.faces, texture, self.img_size)
            img = (rgb[0] + (1.0 - sil[0])[..., None]).cpu().numpy()  # white background
        return tensor2im(img)

    def diff_vp(self, verts, cam, angle_deg: float = 90.0, axis=(1, 0, 0), texture=None):
        """Render after rotating the object by angle_deg about `axis`."""
        from ..geometry import quaternion as quat

        q = quat.axis_angle_to_quat(self._tensor(np.asarray(axis, np.float32)),
                                    self._tensor(np.float32(np.deg2rad(angle_deg))))
        v = quat.quat_rotate(self._tensor(verts)[None], q[None])[0]
        return self(v, cam, texture=texture)


def save_image(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(img).save(path)


def make_panel(images: list[np.ndarray]) -> np.ndarray:
    """Horizontally stack equal-height images (reference np.hstack panels)."""
    h = min(im.shape[0] for im in images)
    return np.concatenate([im[:h] for im in images], axis=1)
