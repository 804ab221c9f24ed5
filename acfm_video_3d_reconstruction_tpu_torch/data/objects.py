"""ImageNet quadruped synset datasets (the objects.py loader family).

Counterpart of acfm_video_3d_reconstruction_tpu/data/objects.py (numpy,
scipy and, imported lazily, cv2: a copy, so its samples are the same).
Parity target: reference multiframe/data/objects.py —
`imnet_class2sysnet_list` (:76-112) maps each quadruped category to its
ImageNet synset ids; `ImgnetQuadDataset` (:157-185) concatenates the
CMR-style `{synset}_{split}.mat` annotation structs of every synset;
`standardize_annotation` (:66-74) prefixes bare rel_paths with the synset
directory; `ImgnetPascalQuadDataset` (:188-245) mixes PASCAL keypointed
stills with keypoint-less ImageNet stills (ImageNet entries get
`parts = zeros((3, num_kps))`, :232-235, train split only).

The rebuild emits each still as a 2-frame video-schema sample (see
data/pascal.PascalVideoDataset) so the cache-exploding multiframe pipeline
consumes ImageNet stills unchanged.
"""
from __future__ import annotations

import os.path as osp

import numpy as np
import scipy.io as sio

# reference objects.py:76-112 (verbatim synset ids — shared public data)
IMNET_CLASS2SYNSET = {
    "rhino": ["n02391994"],
    "giraffe": ["n02439033"],
    "camel": ["n02437312"],
    "hippo": ["n02398521"],
    "fox": ["n02119022", "n02119789", "n02120079", "n02120505"],
    "bear": ["n02132136", "n02133161", "n02131653"],
    "leopard": ["n02128385"],
    "bison": ["n02410509"],
    "buffalo": ["n02408429", "n02410702"],
    "donkey": ["n02390640", "n02390738"],
    "goat": ["n02416519", "n02417070"],
    "beest": ["n02421449", "n02422106"],
    "kangaroo": ["n01877812"],
    "german-shepherd": ["n02106662", "n02107574", "n02109047"],
    "pig": ["n02396427", "n02395406", "n02397096"],
    "lion": ["n02129165"],
    "llama": ["n02437616", "n02437971"],
    "tapir": ["n02393580", "n02393940"],
    "tiger": ["n02129604"],
    "warthog": ["n02397096"],
    "wolf": ["n02114367", "n02114548", "n02114712"],
    "horse": ["n02381460"],
    "zebra": ["n02391049"],
    "sheep": ["n10588074"],
    "cow": ["n01887787"],
    "dog": ["n02381460"],
    "elephant": ["n02504013"],
}


def standardize_rel_path(rel_path: str, synset: str) -> str:
    """Prefix bare `<synset>_NNN.JPEG` names with their synset directory
    (reference standardize_annotation, objects.py:66-74)."""
    if "/" in rel_path or osp.sep in rel_path:
        return rel_path
    return osp.join(synset, rel_path)


def load_synset_annos(anno_dir: str, category: str, split: str) -> list:
    """Concatenate the `{synset}_{split}.mat` annos of every synset of the
    category; missing files are skipped (objects.py:170-182). Returns a
    list of (anno_struct, synset) pairs."""
    out = []
    for synset in IMNET_CLASS2SYNSET[category]:
        path = osp.join(anno_dir, f"{synset}_{split}.mat")
        if not osp.exists(path):
            continue
        annos = np.atleast_1d(
            sio.loadmat(path, struct_as_record=False, squeeze_me=True)["images"]
        )
        out.extend((a, synset) for a in annos)
    return out


class ImageNetQuadVideoDataset:
    """ImageNet quadruped stills as 2-frame video-schema samples.

    Keypoints are placeholders (zeros, invisible) exactly like the
    reference's mixing path (objects.py:232-235) — ImageNet stills
    contribute mask/texture supervision only. Mix with video datasets via
    tigdog.ConcatDataset before explode_to_frames (multiframe/main.py:237).
    """

    def __init__(
        self,
        img_dir: str,
        anno_dir: str,
        category: str,
        split: str = "train",
        num_kps: int = 16,
    ):
        import cv2  # lazy; only needed with real data

        self._imread = lambda p: cv2.cvtColor(
            cv2.imread(p, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB
        )
        if category not in IMNET_CLASS2SYNSET:
            raise KeyError(
                f"no ImageNet synsets for category {category!r}; known: "
                f"{sorted(IMNET_CLASS2SYNSET)}"
            )
        self.img_dir = img_dir
        self.anno = load_synset_annos(anno_dir, category, split)
        if not self.anno:
            pats = [
                osp.join(anno_dir, f"{s}_{split}.mat")
                for s in IMNET_CLASS2SYNSET[category]
            ]
            raise FileNotFoundError(f"no synset annotation files among {pats}")
        self.num_kps = num_kps

    def __len__(self):
        return len(self.anno)

    def __getitem__(self, i: int) -> dict:
        data, synset = self.anno[i]
        rel = standardize_rel_path(str(data.rel_path), synset)
        img = self._imread(osp.join(self.img_dir, rel)) / 255.0
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        mask = np.asarray(data.mask, np.float32)
        # placeholder keypoints: zeros, all invisible (objects.py:232-235)
        kp = np.zeros((self.num_kps, 3), np.float64)
        pose = np.asarray([1.0, 0, 0, 1, 0, 0, 0], np.float32)
        return {
            "video": np.stack([img, img]).astype(np.float32),
            "segmentations": np.stack([mask, mask]),
            "landmarks": np.stack([kp, kp]),
            "sfm_poses": np.stack([pose, pose]),
            "bboxes": np.zeros((2, 4), np.float32),
        }
