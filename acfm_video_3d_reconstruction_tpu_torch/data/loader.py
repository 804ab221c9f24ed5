"""Minimal host-side batch loader with background prefetch.

A copy of acfm_video_3d_reconstruction_tpu/data/loader.py: the same
collates, the same default_rng draws, so the same batches. Collates dict
samples to numpy stacks, applies the DT/boundary preprocessing, and
prepares the next batch on a thread so host preprocessing overlaps device
compute (the reference's known CPU bottleneck: SURVEY.md §3.1). Boundary
point lists are padded to a fixed size, so every batch has one shape.

The producer thread is `acfm-loader`; each batch it builds is the span
`data.batch` (utils/tracing.py). Where the dataset separates its draws from
its work (`draw(idx)` / `build(idx, draws)`, data/tigdog.py), it takes a
batch's draws in order and builds the clips, each with its mask geometry,
on a pool of threads (`acfm-loader-pool_*`; the traced counter
`data.pool_clips`): the same arithmetic on the same draws, so the same
batches as one clip after another.
"""
from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np

from ..utils import tracing
from . import image_utils


def collate(samples: list[dict]) -> dict:
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        out[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) else np.asarray(vals)
    return out


# keys whose leading axis is the clip's time axis (video-level samples)
_TIME_KEYS = (
    "img", "mask", "kp", "sfm_pose", "frames_idx", "mirror_flag",
    "transforms", "video", "segmentations", "landmarks", "sfm_poses",
    "bboxes", "optical_flows",
)


# module-level generator for collate_min_crop's default: a per-call
# default_rng(0) would replay the identical crop offsets for every batch
# (the reference's TigDog_collate draws from global numpy RNG state)
_COLLATE_RNG = np.random.default_rng(0)


def collate_min_crop(samples: list[dict], rng=None) -> dict:
    """Variable-length clip collate: random-crop every clip to the batch's
    min length (reference TigDog_collate, tigdog_final.py:279-307)."""
    rng = rng if rng is not None else _COLLATE_RNG

    def clip_len(s):
        return s[next(k for k in ("img", "video") if k in s)].shape[0]

    min_f = min(clip_len(s) for s in samples)
    starts = [int(rng.integers(0, clip_len(s) - min_f + 1)) for s in samples]
    out = {}
    for k in samples[0]:
        vals = []
        for s, st in zip(samples, starts):
            v = np.asarray(s[k])
            vals.append(v[st : st + min_f] if k in _TIME_KEYS else v)
        out[k] = np.stack(vals)
    return out


def collate_pad_circular(samples: list[dict]) -> dict:
    """Variable-length clip collate: circular-pad every clip to the batch's
    max length (reference TigDog_collate_pad, tigdog_final.py:310-378)."""

    def clip_len(s):
        return s[next(k for k in ("img", "video") if k in s)].shape[0]

    max_f = max(clip_len(s) for s in samples)
    out = {}
    for k in samples[0]:
        vals = []
        for s in samples:
            v = np.asarray(s[k])
            if k in _TIME_KEYS and v.shape[0] < max_f:
                reps = -(-max_f // v.shape[0])
                v = np.concatenate([v] * reps, axis=0)[:max_f]
            vals.append(v)
        out[k] = np.stack(vals)
    return out


def add_mask_geometry(batch: dict, max_boundary_points: int = 1000) -> dict:
    """Attach edt/boundaries for a batch with mask (B, H, W) or (B, T, H, W).

    Uses the native C++ path (data/native.py, exact-parity tested) when
    libacfm_preproc.so is built; numpy/scipy otherwise.

    Note: the barrier DT is deliberately NOT computed — the reference
    computes it every step (monocular/main.py:177, multiframe/main.py:364)
    but its edt loss actually consumes the raw unnormalized DT
    (monocular/main.py:184-187, 268), so the barrier tensor is dead host
    work on the known CPU-bottleneck path.

    Either path is the span `data.mask_geometry` (utils/tracing.py).
    """
    with tracing.span("data.mask_geometry"):
        return _mask_geometry(batch, max_boundary_points)


def _mask_geometry(batch: dict, max_boundary_points: int) -> dict:
    from . import native

    masks = np.asarray(batch["mask"])
    flat = masks.reshape(-1, *masks.shape[-2:])
    batch = dict(batch)
    if native.available():
        edt, bounds = native.preprocess_masks(flat, max_boundary_points)
        batch["edt"], batch["boundaries"] = edt, bounds
        return batch
    batch["edt"] = np.stack(
        [image_utils.compute_dt(m, norm=False) for m in flat]
    ).astype(np.float32)
    bounds = image_utils.compute_boundaries(flat)
    n = bounds.shape[1]
    if n >= max_boundary_points:
        bounds = bounds[:, :max_boundary_points]
    else:
        pad = np.zeros((bounds.shape[0], max_boundary_points - n, 3), np.float32)
        bounds = np.concatenate([bounds, pad], axis=1)
    batch["boundaries"] = bounds
    return batch


def pool_size(batch_size: int) -> int:
    """Threads that build a batch's clips: the producer and its pool take
    half the usable cores, the other half is left to the training loop's
    thread, the prefetch thread and the CUDA driver; 0 (one clip after
    another on the producer) where that leaves a single thread. On the
    8 cores of an H100's host, pools of 2, 3 and 4 all kept the multiframe
    loop fed, and 3 gave the loop its best mean rate."""
    n = min(batch_size, len(os.sched_getaffinity(0)) // 2 - 1)
    return n if n > 1 else 0


class DataLoader:
    """Shuffling epoch iterator with threaded prefetch."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        preprocess: Optional[Callable[[dict], dict]] = add_mask_geometry,
        prefetch: int = 2,
        collate_fn: Callable[[list], dict] = collate,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.preprocess = preprocess
        self.prefetch = prefetch
        self.collate_fn = collate_fn

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx

    def _make_batch(self, ids, pool: Optional[ThreadPoolExecutor] = None) -> dict:
        with tracing.span("data.batch"):
            if pool is None or len(ids) < 2:
                batch = self.collate_fn([self.dataset[int(i)] for i in ids])
                return batch if self.preprocess is None else self.preprocess(batch)
            return self._pooled_batch(ids, pool)

    def _pooled_batch(self, ids, pool: ThreadPoolExecutor) -> dict:
        """The batch's draws in order here, then each clip's build (and its
        mask geometry, where the batch's is the default) on the pool."""
        draws = [self.dataset.draw(int(i)) for i in ids]
        per_clip = self.preprocess is add_mask_geometry and self.collate_fn is collate

        def build(i, d):
            s = self.dataset.build(int(i), d)
            return s, (add_mask_geometry({"mask": s["mask"]}) if per_clip else None)

        built = list(pool.map(build, ids, draws))
        tracing.count_traced("data.pool_clips", len(built))
        batch = self.collate_fn([s for s, _ in built])
        if not per_clip:
            return batch if self.preprocess is None else self.preprocess(batch)
        for k in ("edt", "boundaries"):
            batch[k] = np.concatenate([g[k] for _, g in built])
        return batch

    def __iter__(self) -> Iterator[dict]:
        idx = self._epoch_indices()
        nb = len(self)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            split = hasattr(self.dataset, "draw") and hasattr(self.dataset, "build")
            n = pool_size(self.batch_size) if split else 0
            pool = ThreadPoolExecutor(n, thread_name_prefix="acfm-loader-pool") if n else None
            try:
                for b in range(nb):
                    if stop.is_set():
                        return
                    ids = idx[b * self.batch_size : (b + 1) * self.batch_size]
                    if not put(self._make_batch(ids, pool)):
                        return
                put(None)
            except BaseException as e:  # propagate to the consumer
                put(e)
            finally:
                if pool is not None:
                    pool.shutdown(cancel_futures=True)

        t = threading.Thread(target=producer, name="acfm-loader", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # ended, failed or abandoned: no thread of the epoch outlives it
            stop.set()
            t.join()
