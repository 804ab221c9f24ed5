"""TigDog / YTVIS / COCO video datasets (multiframe pipeline).

A copy of acfm_video_3d_reconstruction_tpu/data/tigdog.py (numpy and cv2
only): the same files read and written, the same default_rng draws in the
same order and the same cv2 calls, so the same batches bit for bit.

Parity targets:
  - multiframe/data/tigdog_final.py (video-level pkls
    {video, segmentations, bboxes, landmarks, sfm_poses}, deterministic
    14-video test split seeded 42, 19-kp horse/tiger perm),
  - the trainer's cache-exploding step (multiframe/main.py:250-271) that
    writes one pkl per frame and builds sample->video maps,
  - multiframe/data/tigdog_mf_of.py (frame-level multi-frame sampling in a
    ±3 window, tight bboxes, v2 crop, clip-level mirror + RandomAffine with
    camera-transport params, [-1,1] normalization),
  - multiframe/data/ytvis_final.py / coco_final.py (mask+bbox only clips
    with placeholder kps/poses).
"""
from __future__ import annotations

import glob
import os
import os.path as osp
import pickle

import numpy as np

from . import image_utils
from .base import quaternion_from_matrix_np, quaternion_matrix_np

# left/right keypoint permutations (tigdog_mf_of.py:111-114)
KP_PERM_HORSE_TIGER = (
    np.array([2, 1, 3, 5, 4, 7, 6, 8, 10, 9, 12, 11, 14, 13, 16, 15, 18, 17, 19]) - 1
)
KP_PERM_COW = np.array([1, 0, 2, 4, 3, 5, 6, 7, 9, 8, 11, 10, 13, 12, 15, 14])


def kp_perm_for(category: str) -> np.ndarray:
    return KP_PERM_COW if category == "cow" else KP_PERM_HORSE_TIGER


def tigdog_test_split(num_videos: int, num_test: int = 14, seed: int = 42):
    """Deterministic (test_ids, train_ids) video split (tigdog_final.py:104-114).

    The reference permutes with RandomState(42) and takes the LAST
    ``num_test`` entries of the permutation as the test videos
    (``test_video = video_range[-14:]``) and the rest — in permutation
    order, not sorted — as train (``train_video = video_range[:-14]``).
    """
    rng = np.random.RandomState(seed)
    perm = rng.permutation(num_videos)
    return perm[-num_test:], perm[:-num_test]


class VideoPklDataset:
    """Video-level dataset over per-video pkl files.

    Each pkl holds {video (T,H,W,3), segmentations (T,H,W),
    bboxes (T,4), landmarks (T,K,3), sfm_poses (T,7)}; YTVIS/COCO-style
    data may omit landmarks/sfm_poses (placeholders are synthesized:
    ytvis_final.py:145-150) and stores bboxes in xywh format
    (ytvis_final.py:125-127 converts and squares them).

    split='all' keeps every video (the reference's expand-ytvis/coco
    mixing uses split='all': multiframe/main.py:223-228).
    """

    bbox_format = "xyxy"

    def __init__(self, root_dir: str, category: str, split: str = "train",
                 num_kps: int = 19):
        self.root = osp.join(root_dir, category)
        self.num_kps = num_kps
        paths = sorted(glob.glob(osp.join(self.root, "*.pkl")))
        if split in ("train", "test") and len(paths) > 14:
            test_ids, train_ids = tigdog_test_split(len(paths))
            keep = test_ids if split == "test" else train_ids
            # keep the permutation order (reference indexes file_paths by
            # the permuted id array, tigdog_final.py:110-114)
            paths = [paths[i] for i in keep]
        self.paths = paths

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i: int) -> dict:
        with open(self.paths[i], "rb") as f:
            sample = pickle.load(f)
        video = np.asarray(sample["video"])
        if video.dtype == np.uint8 or video.max() > 1.5:
            sample["video"] = video.astype(np.float32) / 255.0
        T = sample["video"].shape[0]
        if self.bbox_format == "xywh":
            bb = np.asarray(sample["bboxes"], np.float64).copy()
            bb[:, 2] += bb[:, 0]
            bb[:, 3] += bb[:, 1]
            sample["bboxes"] = np.stack(
                [image_utils.square_bbox(b) for b in bb]
            )
        if "landmarks" not in sample or sample.get("landmarks") is None:
            sample["landmarks"] = np.zeros((T, self.num_kps, 3), np.float32)
        if "sfm_poses" not in sample or sample.get("sfm_poses") is None:
            poses = np.zeros((T, 7), np.float32)
            poses[:, 0] = 1.0
            poses[:, 3] = 1.0
            sample["sfm_poses"] = poses
        return sample


class YTVISPklDataset(VideoPklDataset):
    """YouTube-VIS clip pkls: mask+bbox only, xywh boxes, uint8 video
    (reference multiframe/data/ytvis_final.py:73-219)."""

    bbox_format = "xywh"

    def __init__(self, root_dir: str, category: str, split: str = "all",
                 num_kps: int = 19):
        super().__init__(root_dir, category, split=split, num_kps=num_kps)


class COCOPklDataset(YTVISPklDataset):
    """COCO still images as length-1 clips with the YTVIS pkl schema
    (reference multiframe/data/coco_final.py — byte-identical pipeline to
    ytvis_final save for the directory)."""


class ConcatDataset:
    """Concatenation of video-level datasets (torch ConcatDataset
    equivalent; reference multiframe/main.py:229 mixes TigDog+YTVIS+COCO
    before the cache-exploding step)."""

    def __init__(self, datasets):
        self.datasets = [d for d in datasets if d is not None]
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, i: int) -> dict:
        d = int(np.searchsorted(self._offsets, i, side="right") - 1)
        return self.datasets[d][i - int(self._offsets[d])]


def explode_to_frames(
    dataset, tmp_dir: str, category: str, num_training_frames: int = 50,
    write: bool = True,
):
    """Cache-exploding step: write one pkl per frame (main.py:250-271).

    Returns (num_frames_total, sample_to_vid, samples_per_vid). write=False
    only returns them (the other ranks of a group, once rank 0 has written).
    """
    directory = osp.join(tmp_dir, category)
    os.makedirs(directory, exist_ok=True)
    save_counter = 0
    sample_to_vid: dict[int, int] = {}
    samples_per_vid: dict[int, list[int]] = {}
    for i_sample in range(len(dataset)):
        sample = dataset[i_sample]
        num_frames = sample["video"].shape[0]
        for i in range(num_frames):
            new_sample = {
                k: sample[k][i]
                for k in ("video", "sfm_poses", "landmarks", "segmentations", "bboxes")
                if k in sample
            }
            if write:
                with open(osp.join(directory, f"{save_counter}.pkl"), "wb") as f:
                    pickle.dump(new_sample, f)
            sample_to_vid[save_counter] = i_sample
            samples_per_vid.setdefault(i_sample, []).append(save_counter)
            save_counter += 1
            if i >= num_training_frames:
                break
    return save_counter, sample_to_vid, samples_per_vid


def _tight_bbox(mask: np.ndarray) -> np.ndarray:
    """Tight bbox [x1, y1, x2, y2] from the mask's nonzero extent."""
    ys, xs = np.nonzero(mask > 0.5)
    if len(ys) == 0:
        h, w = mask.shape
        return np.asarray([0.0, 0.0, w - 1.0, h - 1.0])
    return np.asarray([xs.min(), ys.min(), xs.max(), ys.max()], np.float64)


class MultiFrameDataset:
    """Frame-level dataset sampling num_frames clips in a ±offset window."""

    def __init__(
        self,
        tmp_dir: str,
        category: str,
        sample_to_vid: dict,
        samples_per_vid: dict,
        num_frames: int = 2,
        img_size: int = 256,
        mirror: bool = True,
        transforms: bool = True,
        remove_neck_kp: bool = True,
        padding_frac: float = 0.05,
        tight_bboxes: bool = False,
        v2_crop: bool = False,
        offset: int = 3,
        sequential: bool = False,
        seed: int = 0,
    ):
        self.root = osp.join(tmp_dir, category)
        self.category = category
        self.sample_to_vid = sample_to_vid
        self.samples_per_vid = samples_per_vid
        self.num_frames = num_frames
        self.img_size = img_size
        self.mirror = mirror
        self.transforms = transforms
        self.remove_neck_kp = remove_neck_kp
        self.padding_frac = padding_frac
        self.tight_bboxes = tight_bboxes
        self.v2_crop = v2_crop
        self.offset = offset
        self.sequential = sequential
        self.kp_perm = kp_perm_for(category)
        self.rng = np.random.default_rng(seed)
        self.num_samples = len(sample_to_vid)

    def __len__(self):
        return self.num_samples

    def _select_frames(self, idx: int) -> list[int]:
        samples = list(self.samples_per_vid[self.sample_to_vid[idx]])
        if self.sequential:
            frames = [idx]
            if self.num_frames > 1:
                frames.append(min(idx + 1, samples[-1]))
        else:
            pos = samples.index(idx)
            lo = max(pos - self.offset - 1, 0)
            hi = min(pos + self.offset - 1, len(samples))
            window = samples[lo:hi]
            if idx in window:
                window.remove(idx)
            frames = [idx]
            if self.num_frames > 1 and window:
                extra = self.rng.choice(
                    window, size=min(self.num_frames - 1, len(window)), replace=False
                )
                frames.extend(int(e) for e in extra)
            while len(frames) < self.num_frames:
                frames.append(idx)
        frames.sort()
        return frames

    def __getitem__(self, idx: int) -> dict:
        frames = self._select_frames(int(idx))
        imgs, masks, bboxes, kps, poses = [], [], [], [], []
        for f in frames:
            with open(osp.join(self.root, f"{f}.pkl"), "rb") as fh:
                s = pickle.load(fh)
            img = np.asarray(s["video"], np.float64)
            if img.max() > 1.5:
                img = img / 255.0
            imgs.append(img)
            masks.append(np.asarray(s["segmentations"], np.float64))
            bboxes.append(np.asarray(s["bboxes"], np.float64))
            kps.append(np.asarray(s["landmarks"], np.float64).copy())
            poses.append(np.asarray(s["sfm_poses"], np.float64).copy())

        T = len(frames)
        if self.tight_bboxes:
            bboxes = [
                image_utils.peturb_bbox(
                    _tight_bbox(m), pf=self.padding_frac, jf=0, rng=self.rng
                )
                for m in masks
            ]
        bboxes = [image_utils.square_bbox(b) for b in bboxes]

        out_i, out_m, out_k = [], [], []
        for img, mask, bbox, kp, pose in zip(imgs, masks, bboxes, kps, poses):
            img = image_utils.crop(img, bbox, bgval=1)
            mask = image_utils.crop(mask[..., None], bbox, bgval=0)[..., 0]
            vis = kp[:, 2] > 0
            kp[vis, 0] -= bbox[0]
            kp[vis, 1] -= bbox[1]
            if self.v2_crop:
                # v2 crop recomputes visibility from the crop bounds
                # (reference tigdog_mf_of.py:251-261 / crop_landmarks)
                inb = (
                    (kp[:, 0] >= 0) & (kp[:, 1] >= 0)
                    & (kp[:, 0] < img.shape[1]) & (kp[:, 1] < img.shape[0])
                )
                kp[:, 2] = (vis & inb).astype(kp.dtype)
            # sfm_pose is NOT transported through crop/scale: the reference
            # multiframe loader passes sfm_poses through crop_image/
            # scale_image/normalize_kp untouched (tigdog_mf_of.py:245-299) —
            # the pkl cameras are already final [-1,1]-unit weak-perspective
            # cams for the standard bbox crop. Only mirror flips them below.
            h, w = img.shape[:2]
            sc = self.img_size / float(max(h, w))
            img, _ = image_utils.resize_img(img, sc)
            mask, _ = image_utils.resize_img(mask, sc)
            kp[vis, :2] = np.round(kp[vis, :2] * sc)
            out_i.append(img)
            out_m.append(mask > 0.5)
            out_k.append(kp)
        imgs = np.asarray(out_i)
        masks = np.asarray(out_m, np.float64)
        kps = np.asarray(out_k)
        poses = np.asarray(poses)

        # clip-level mirror
        mirror_flag = np.zeros(T, np.int64)
        if self.mirror and self.rng.random() > 0.5:
            mirror_flag[:] = 1
            imgs = imgs[:, :, ::-1].copy()
            masks = masks[:, :, ::-1].copy()
            new_x = imgs.shape[2] - kps[:, :, 0] - 1
            kps = np.concatenate([new_x[:, :, None], kps[:, :, 1:]], axis=-1)
            if kps.shape[1] == len(self.kp_perm):
                kps = kps[:, self.kp_perm]
            # else: non-standard kp count (placeholder annos) — identity perm
            for pose in poses:
                R = quaternion_matrix_np(pose[3:])
                D = np.diag([-1.0, 1.0, 1.0])
                pose[3:] = quaternion_from_matrix_np(D @ R @ D)
                pose[1] = -pose[1]

        # clip-level random affine with camera-transport params
        transform_params = np.zeros((T, 4), np.float32)
        transform_params[:, 0] = 1.0
        if self.transforms:
            zoom = self.rng.uniform(0.8, 1.05)
            shift = self.rng.uniform(-0.05, 0.05, 2)  # fraction of image size
            imgs, masks, kps = self._affine(imgs, masks, kps, zoom, shift)
            transform_params[:, 0] = zoom
            transform_params[:, 1] = 2.0 * shift[0]
            transform_params[:, 2] = 2.0 * shift[1]
            transform_params[:, 3] = 1.0

        # normalize kps to [-1, 1]
        img_h, img_w = imgs.shape[1:3]
        vis = (kps[:, :, 2] > 0)[..., None].astype(np.float64)
        kpn = np.stack(
            [2 * kps[:, :, 0] / img_w - 1, 2 * kps[:, :, 1] / img_h - 1], axis=-1
        )
        kps = np.concatenate([vis * kpn, vis], axis=-1)
        if self.remove_neck_kp and kps.shape[1] == 19:
            kps = kps[:, :-1]

        return {
            "img": imgs.astype(np.float32),
            "mask": masks.astype(np.float32),
            "kp": kps.astype(np.float32),
            "sfm_pose": poses.astype(np.float32),
            "frames_idx": np.asarray(frames, np.int32),
            "mirror_flag": mirror_flag.astype(np.int32),
            "transforms": transform_params,
        }

    def _affine(self, imgs, masks, kps, zoom, shift):
        """Zoom about image center + translate (fractions of image size)."""
        import cv2

        T, H, W = imgs.shape[:3]
        tx = shift[0] * W
        ty = shift[1] * H
        M = np.asarray(
            [[zoom, 0, (1 - zoom) * W / 2.0 + tx], [0, zoom, (1 - zoom) * H / 2.0 + ty]]
        )
        out_i = np.stack(
            [cv2.warpAffine(im, M, (W, H), flags=cv2.INTER_LINEAR, borderValue=(1, 1, 1))
             for im in imgs]
        )
        out_m = np.stack(
            [cv2.warpAffine(m, M, (W, H), flags=cv2.INTER_NEAREST) for m in masks]
        )
        kp_new = kps.copy()
        vis = kps[:, :, 2] > 0
        xy = kps[:, :, :2] * zoom + np.asarray([(1 - zoom) * W / 2.0 + tx,
                                                (1 - zoom) * H / 2.0 + ty])
        kp_new[:, :, :2] = np.where(vis[..., None], xy, kp_new[:, :, :2])
        return out_i, out_m, kp_new
