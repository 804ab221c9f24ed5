"""PASCAL VOC / ImageNet quadruped still-image datasets (cow expansion).

Counterpart of acfm_video_3d_reconstruction_tpu/data/pascal.py (numpy,
scipy and, imported lazily, cv2: a copy, so its samples are the same).
Parity target: reference multiframe/data/{objects,base2,pascal_voc}.py —
CMR-style .mat annotations (images struct: rel_path, mask, bbox, parts)
for quadruped categories, used to expand video training with still images
(multiframe/main.py:237-242, --expand_pascal). Still images are emitted as
length-T clips of the repeated frame with zero optical flow, so the
multiframe trainer consumes them unchanged.
"""
from __future__ import annotations

import os.path as osp

import numpy as np
import scipy.io as sio

from .base import SingleImageDataset

# ImageNet synsets per quadruped category (objects.py:76-112 lists the
# CMR synset mapping; these are the quadruped entries used for 'cow')
IMNET_SYNSETS = {
    "cow": ["n01887787", "n02402425"],
    "horse": ["n02374451"],
    "sheep": ["n02411705"],
    "zebra": ["n02391049"],
}


class PascalQuadDataset(SingleImageDataset):
    """Still-image quadruped dataset over CMR-style mat annotations."""

    def __init__(
        self,
        img_dir: str,
        anno_path: str,
        kp_perm: np.ndarray,
        img_size: int = 256,
        padding_frac: float = 0.05,
        jitter_frac: float = 0.05,
        split: str = "train",
        seed: int = 0,
    ):
        super().__init__(
            img_size=img_size, padding_frac=padding_frac,
            jitter_frac=jitter_frac, split=split, seed=seed,
        )
        self.img_dir = img_dir
        if not osp.exists(anno_path):
            raise FileNotFoundError(anno_path)
        self.anno = sio.loadmat(
            anno_path, struct_as_record=False, squeeze_me=True
        )["images"]
        self.anno_sfm = [_PlaceholderSfm()] * len(self.anno)
        self.num_imgs = len(self.anno)
        self.kp_perm = kp_perm


class _PlaceholderSfm:
    """Identity camera for datasets without SfM annotations
    (ytvis_final.py:145-150-style placeholder poses)."""

    scale = np.asarray([1.0])
    trans = np.asarray([0.0, 0.0])
    rot = np.eye(3)


class PascalVideoDataset:
    """PASCAL/ImageNet stills as 2-frame video-schema samples for the
    expand-pascal mixing path.

    Parity target: reference base2.py BaseDataset_v2.__getitem__ (:584-593)
    + forward_img (:475-516): each still becomes a duplicated 2-frame
    'video' with raw-pixel kps, placeholder sfm pose and zero bboxes (the
    downstream MultiFrameDataset recomputes tight mask bboxes). Feed it to
    ConcatDataset before explode_to_frames (multiframe/main.py:237-242).
    """

    def __init__(self, img_dir: str, anno_path: str, num_kps: int = 16):
        import cv2  # lazy; only needed with real data

        self._imread = lambda p: cv2.cvtColor(
            cv2.imread(p, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB
        )
        self.img_dir = img_dir
        if not osp.exists(anno_path):
            raise FileNotFoundError(anno_path)
        self.anno = np.atleast_1d(
            sio.loadmat(anno_path, struct_as_record=False, squeeze_me=True)[
                "images"
            ]
        )
        self.num_kps = num_kps

    def __len__(self):
        return len(self.anno)

    def __getitem__(self, i: int) -> dict:
        data = self.anno[i]
        img = self._imread(osp.join(self.img_dir, str(data.rel_path))) / 255.0
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        mask = np.asarray(data.mask, np.float32)
        kp = np.asarray(data.parts, np.float64).T.copy()  # (K, 3)
        vis = kp[:, 2] > 0
        kp[vis, :2] -= 1  # 0-indexing (base2.py:497-499)
        kp = np.nan_to_num(kp, nan=0.0)
        pose = np.asarray([1.0, 0, 0, 1, 0, 0, 0], np.float32)
        return {
            "video": np.stack([img, img]).astype(np.float32),
            "segmentations": np.stack([mask, mask]),
            "landmarks": np.stack([kp, kp]),
            "sfm_poses": np.stack([pose, pose]),
            "bboxes": np.zeros((2, 4), np.float32),
        }


def as_clip(sample: dict, num_frames: int) -> dict:
    """Expand a still-image sample to a clip dict for the multiframe
    trainer (repeated frames, zero flow, mirror/transform defaults)."""
    T = num_frames
    out = {
        "img": np.repeat(sample["img"][None], T, 0),
        "mask": np.repeat(sample["mask"][None], T, 0),
        "kp": np.repeat(sample["kp"][None], T, 0),
        "sfm_pose": np.repeat(sample["sfm_pose"][None], T, 0),
        "frames_idx": np.full((T,), sample.get("inds", 0), np.int32),
        "mirror_flag": np.zeros((T,), np.int32),
        "transforms": np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (T, 1)),
        "optical_flows": np.zeros(
            (T, sample["img"].shape[0], sample["img"].shape[1], 2), np.float32
        ),
    }
    return out


def sample_contour_points(mask: np.ndarray, n_points: int = 1000) -> np.ndarray:
    """Evenly sample mask contour points (base2.py:275-336 equivalent).

    Returns (n_points, 2) [x, y] pixel coords.
    """
    import cv2

    m = (np.asarray(mask) > 0.5).astype(np.uint8)
    contours, _ = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
    if not contours:
        return np.zeros((n_points, 2), np.float32)
    pts = np.concatenate([c.reshape(-1, 2) for c in contours], axis=0)
    idx = np.linspace(0, len(pts) - 1, n_points).astype(int)
    return pts[idx].astype(np.float32)
