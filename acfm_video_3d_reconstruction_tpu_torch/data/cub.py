"""CUB-200-2011 dataset (monocular pipeline).

A copy of acfm_video_3d_reconstruction_tpu/data/cub.py. Parity target:
reference monocular/data/cub.py — .mat annotation files
(`<split>_cub_cleaned.mat`, `sfm/anno_<split>.mat`), the 15-keypoint
left/right permutation, and the base preprocessing chain.
"""
from __future__ import annotations

import os.path as osp

import numpy as np
import scipy.io as sio

from .base import SingleImageDataset

# left/right keypoint swap for horizontal mirroring (cub.py:73)
CUB_KP_PERM = np.array([1, 2, 3, 4, 5, 6, 11, 12, 13, 10, 7, 8, 9, 14, 15]) - 1


class CUBDataset(SingleImageDataset):
    def __init__(
        self,
        cub_dir: str,
        cache_dir: str,
        split: str = "train",
        img_size: int = 256,
        padding_frac: float = 0.05,
        jitter_frac: float = 0.05,
        seed: int = 0,
        mirror: bool = True,
    ):
        super().__init__(
            img_size=img_size, padding_frac=padding_frac, jitter_frac=jitter_frac,
            split=split, seed=seed, mirror=mirror,
        )
        self.img_dir = osp.join(cub_dir, "images")
        anno_path = osp.join(cache_dir, "data", f"{split}_cub_cleaned.mat")
        anno_sfm_path = osp.join(cache_dir, "sfm", f"anno_{split}.mat")
        if not osp.exists(anno_path):
            raise FileNotFoundError(anno_path)
        self.anno = sio.loadmat(anno_path, struct_as_record=False, squeeze_me=True)[
            "images"
        ]
        self.anno_sfm = sio.loadmat(
            anno_sfm_path, struct_as_record=False, squeeze_me=True
        )["sfm_anno"]
        self.num_imgs = len(self.anno)
        self.kp_perm = CUB_KP_PERM


def load_sfm_mean_shape(cache_dir: str, split: str = "train"):
    """SfM mean shape (kp locations + hull) used for vert2kp/template init.

    (reference monocular/main.py:85-88)
    """
    anno_sfm = sio.loadmat(
        osp.join(cache_dir, "sfm", f"anno_{split}.mat"),
        struct_as_record=False,
        squeeze_me=True,
    )
    S = np.transpose(anno_sfm["S"])
    conv_tri = anno_sfm["conv_tri"] - 1
    return S, conv_tri
