"""Training visualization panels (visdom replacement).

Counterpart of acfm_video_3d_reconstruction_tpu/train/visualize.py
(parity target: reference get_current_visuals + Visualizer.
display_current_results, multiframe/main.py:775-923,
utils/visualizer.py:27-119): every display_freq steps, write a PNG panel of
[input+kps | GT mask | predicted mask] rows and a vertex scatter to
<save_dir>/vis/, through the driver's vis_fn hook. The multiframe panel
(make_multiframe_vis_fn) is not ported yet.
"""
from __future__ import annotations

import os
import os.path as osp

import numpy as np

from ..utils import vis as vis_utils


def _to_u8(img: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(img, np.float32) * 255.0, 0, 255).astype(np.uint8)


def _mask_rgb(mask: np.ndarray) -> np.ndarray:
    m = np.asarray(mask, np.float32)
    return _to_u8(np.stack([m, m, m], axis=-1))


def vert_scatter_panel(verts: np.ndarray, size: int) -> np.ndarray:
    """Point-cloud scatter of predicted vertices from two azimuths — the
    headless replacement for the reference's visdom 3D vert scatter
    (utils/visualizer.py:27-119 Visualizer plot of pred_v). Pure numpy
    splatting, no plotting dependency."""
    v = np.asarray(verts, np.float32)
    v = v - v.mean(0, keepdims=True)
    r = max(float(np.abs(v).max()), 1e-6)
    v = v / (1.25 * r)
    cells = []
    for az in (0.0, np.pi / 2):
        c, s = np.cos(az), np.sin(az)
        x = c * v[:, 0] + s * v[:, 2]
        y = v[:, 1]
        z = -s * v[:, 0] + c * v[:, 2]
        px = np.clip(((x + 1) * 0.5 * (size - 1)).astype(np.int32), 0, size - 1)
        py = np.clip(((1 - y) * 0.5 * (size - 1)).astype(np.int32), 0, size - 1)
        depth = (z - z.min()) / max(float(np.ptp(z)), 1e-6)
        img = np.zeros((size, size, 3), np.float32)
        order = np.argsort(z)  # far-to-near so near points overwrite
        for i in order:
            color = np.asarray(
                [0.2 + 0.8 * depth[i], 0.4, 1.0 - 0.8 * depth[i]], np.float32
            )
            y0, y1 = max(py[i] - 1, 0), min(py[i] + 2, size)
            x0, x1 = max(px[i] - 1, 0), min(px[i] + 2, size)
            img[y0:y1, x0:x1] = color
        cells.append(_to_u8(img))
    return np.concatenate(cells, axis=1)


def render_row(imgs, masks, mask_pred, kp_pred=None, renderer_out=None):
    """One row per sample: input (+kps), GT mask, predicted soft mask."""
    rows = []
    n = min(4, imgs.shape[0])
    for i in range(n):
        # kp2im takes the float image (the JAX package passes it the uint8
        # one, which tensor2im's [0, 1] clip turns black and white)
        img = (_to_u8(imgs[i]) if kp_pred is None
               else vis_utils.kp2im(np.asarray(kp_pred[i]), imgs[i]))
        cells = [img, _mask_rgb(masks[i]), _mask_rgb(mask_pred[i])]
        if renderer_out is not None:
            cells.append(_to_u8(renderer_out[i]))
        rows.append(np.concatenate(cells, axis=1))
    return np.concatenate(rows, axis=0)


def make_monocular_vis_fn(mods):
    """vis_fn(save_dir, step, batch) for run_monocular_training: the eval
    step on the batch, drawn as render_row beside a vertex scatter."""
    from . import monocular as mono

    ev = mono.make_eval_step(mods)
    img_size = mods.cfg.model.img_size

    def vis_fn(save_dir, step, batch):
        aux = ev(batch)
        host = {k: aux[k].float().cpu().numpy() for k in ("mask_pred", "kp_pred", "pred_v")}
        panel = render_row(
            np.asarray(batch["img"].cpu()).reshape(-1, img_size, img_size, 3),
            np.asarray(batch["mask"].cpu()).reshape(-1, img_size, img_size),
            host["mask_pred"], kp_pred=host["kp_pred"],
        )
        scatter = vert_scatter_panel(host["pred_v"][0], img_size)
        pad = np.zeros(
            (panel.shape[0] - scatter.shape[0], scatter.shape[1], 3), np.uint8
        )
        panel = np.concatenate([panel, np.concatenate([scatter, pad], 0)], 1)
        out = osp.join(save_dir, "vis")
        os.makedirs(out, exist_ok=True)
        vis_utils.save_image(osp.join(out, f"step_{step:07d}.png"), panel)

    return vis_fn
