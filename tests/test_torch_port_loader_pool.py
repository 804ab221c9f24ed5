"""The loader's pooled batch build (data/loader.py) against its serial one,
on the CPU: a TigDog-format tree and a YouTube-VIS-format one (the
benchmark's fixture generators, at the JAX tests' 64^2 scenes) exploded to
frames; MultiFrameDataset's `draw` / `build` split (data/tigdog.py); the
loader's threads after an epoch that ends early or fails."""
import os
import pickle
import threading

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from acfm_video_3d_reconstruction_tpu_torch.data import loader as tloader
from acfm_video_3d_reconstruction_tpu_torch.data import native
from acfm_video_3d_reconstruction_tpu_torch.data import tigdog as ttig
from acfm_video_3d_reconstruction_tpu_torch.train import prefetch
from acfm_video_3d_reconstruction_tpu_torch.utils import tracing
from gpubench.harness.fixtures.tigdog_fixture import write_tigdog_tree
from gpubench.harness.fixtures.ytvis_fixture import write_ytvis_tree

B = 4
# the TigDog categories' crop, and the other categories' (tight boxes, v2)
CROPS = {"tigdog": {}, "tight_v2": dict(tight_bboxes=True, v2_crop=True, remove_neck_kp=False)}


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """2 TigDog videos and 2 mask-only clips of 6 frames, exploded; one
    TigDog frame's mask filled past its box, so its crop touches the
    image's edge."""
    root = tmp_path_factory.mktemp("loader_pool")
    write_tigdog_tree(str(root / "tig"), n_videos=2, n_frames=6, raw=(120, 200), seed=5)
    write_ytvis_tree(str(root / "yt"), n_videos=2, n_frames=6, raw=(144, 256), seed=6)
    videos = ttig.ConcatDataset([ttig.VideoPklDataset(str(root / "tig"), "horse", split="all"),
                                 ttig.YTVISPklDataset(str(root / "yt"), "horse")])
    n, s2v, spv = ttig.explode_to_frames(videos, str(root / "cache"), "horse")
    path = os.path.join(root, "cache", "horse", "2.pkl")
    with open(path, "rb") as f:
        s = pickle.load(f)
    x1, y1, x2, y2 = (int(v) for v in s["bboxes"])
    s["segmentations"][y1 - 2:y2 + 3, x1 - 2:(x1 + x2) // 2] = 1
    with open(path, "wb") as f:
        pickle.dump(s, f)
    return dict(tmp_dir=str(root / "cache"), category="horse", sample_to_vid=s2v,
                samples_per_vid=spv, num_frames=2, img_size=64)


@pytest.fixture(autouse=True)
def clean_record():
    tracing.reset()
    yield
    tracing.reset()


def _loader(frames, monkeypatch, threads, crop="tigdog", dataset=ttig.MultiFrameDataset):
    monkeypatch.setattr(tloader, "pool_size", lambda batch_size: threads)
    ds = dataset(mirror=True, transforms=True, seed=11, **CROPS[crop], **frames)
    return tloader.DataLoader(ds, B, shuffle=True, seed=12)


def _epochs(loader, n=2):
    with profile(activities=[ProfilerActivity.CPU]):
        batches = [b for _ in range(n) for b in loader]
    return batches, tracing.counters()


def _loader_threads():
    return [t.name for t in threading.enumerate() if t.name.startswith("acfm-loader")]


@pytest.mark.parametrize("crop", sorted(CROPS))
def test_pooled_batches_equal_serial(frames, monkeypatch, crop):
    """Two epochs of the same seeds, built one clip after another and on a
    pool of 3 threads: every key of every batch equal (edt and boundaries
    included, on the numpy path and the native one where it is built), the
    same mask-only clips counted, every clip built on the pool, one mask
    touching the image's edge."""
    paths = [False] + ([True] if native.available() else [])
    for use_native in paths:
        monkeypatch.setattr(native, "available", lambda: use_native)
        serial, serial_counts = _epochs(_loader(frames, monkeypatch, 0, crop))
        tracing.reset()
        pooled, pooled_counts = _epochs(_loader(frames, monkeypatch, 3, crop))
        tracing.reset()
        assert len(pooled) == len(serial) == 2 * (24 // B)
        for a, b in zip(serial, pooled):
            assert list(a) == list(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert pooled_counts["data.mask_only_clips"] == serial_counts["data.mask_only_clips"] > 0
        assert pooled_counts["data.pool_clips"] == B * len(pooled)
        assert "data.pool_clips" not in serial_counts
    masks = np.stack([b["mask"] for b in serial])
    edges = (masks[..., 0, :].any(-1) | masks[..., -1, :].any(-1)
             | masks[..., :, 0].any(-1) | masks[..., :, -1].any(-1))
    assert edges.any()


def test_getitem_is_build_of_draw(frames):
    """__getitem__(i) equals build(i, draw(i)) of a dataset of the same seed,
    and leaves its generator where draw leaves it; build draws nothing."""
    kw = dict(mirror=True, transforms=True, seed=21, **CROPS["tight_v2"], **frames)
    whole, split = ttig.MultiFrameDataset(**kw), ttig.MultiFrameDataset(**kw)
    for i in range(len(whole)):
        a = whole[i]
        d = split.draw(i)
        state = split.rng.bit_generator.state
        b = split.build(i, d)
        assert split.rng.bit_generator.state == state
        assert whole.rng.bit_generator.state == state
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


class _Failing(ttig.MultiFrameDataset):
    def build(self, idx, draws):
        if idx == self.bad:
            raise RuntimeError("bad clip")
        return super().build(idx, draws)


@pytest.mark.parametrize("threads", [0, 3])
def test_early_stop_leaves_no_loader_thread(frames, monkeypatch, threads):
    """`break` after one batch, from the loader and through the training
    loop's prefetch thread: no acfm-loader thread is left once the
    prefetch thread has ended."""
    loader = _loader(frames, monkeypatch, threads)
    for _ in loader:
        break
    assert _loader_threads() == []
    for _ in prefetch.prefetch(loader, lambda b: b):
        break
    for t in threading.enumerate():
        if t.name == "acfm-prefetch":
            t.join(10)
    assert _loader_threads() == []


def test_a_clip_that_fails_raises_at_the_consumer(frames, monkeypatch):
    """An exception in one clip's build, on the pool, re-raises at the
    consumer, and no acfm-loader thread outlives it."""
    loader = _loader(frames, monkeypatch, 3, dataset=_Failing)
    loader.dataset.bad = int(loader._epoch_indices()[B + 1])
    loader.rng = np.random.default_rng(12)  # the epoch's order again
    got = []
    with pytest.raises(RuntimeError, match="bad clip"):
        for b in loader:
            got.append(b)
    assert len(got) == 1
    assert _loader_threads() == []
