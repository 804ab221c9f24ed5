"""The mini-TigDog lockstep tool (tools/mini_tigdog_lockstep.py) and the
data path's nearest warp of the masks, on the CPU.

The lockstep case runs the tool's `dump` on a small tree
(tools/tigdog_fixture.py's: 16 clips of 2 frames at 72x96, the 14-video
test split leaving 2 training clips, 4 frames: one step a pass) with a
small model (icosphere subdivide 1, nz_feat 32, the fixture's 18
keypoints on a keypoint dictionary; the tool's other options, at 64^2):
the JAX CLI trains one warm-up rep and 2 epochs with a
snapshot after the init_camera_emb pass, the rep and each epoch, then
evaluates its final checkpoint. The port holds one step from each
snapshot, the warm-up -> main-loop boundary included, at the step tests'
bounds (tests/test_torch_port_multiframe.py), and evaluates JAX's final
state through its evaluate CLI for the trained, argmax and gauge-aligned
columns at the evaluate test's bounds
(tests/test_torch_port_multiframe_evaluate.py).

The warp cases hold tigdog.py's clip-level affine augmentation to masks
that do not depend on cv2's INTER_NEAREST warp, which OpenCV 4.13 computes
off the image for a float64 mask: image_utils.warp_affine_nearest is
OpenCV 5.0's warp of a float64 mask bit for bit, and with cv2's nearest
warp replaced by a wrong one the port's samples stay JAX's.
"""
import os
import sys

import cv2
import numpy as np
import pytest

from acfm_video_3d_reconstruction_tpu.data import tigdog as jtig
from acfm_video_3d_reconstruction_tpu_torch.data import image_utils
from acfm_video_3d_reconstruction_tpu_torch.data import tigdog as ttig
from tools.tigdog_fixture import write_kp_dict, write_tigdog_tree

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
sys.path.insert(0, TOOLS)

import mini_tigdog_lockstep as ls  # noqa: E402
import mini_tigdog_parity as jt  # noqa: E402
import torch  # noqa: E402
import torch_mini_tigdog_parity as tt  # noqa: E402

torch.set_num_threads(1)


def _augmentation_matrix(rng, H, W):
    """The affine of tigdog.py / base.py: zoom about the centre, shift."""
    zoom, shift = rng.uniform(0.8, 1.05), rng.uniform(-0.05, 0.05, 2)
    return np.asarray([[zoom, 0, (1 - zoom) * W / 2.0 + shift[0] * W],
                       [0, zoom, (1 - zoom) * H / 2.0 + shift[1] * H]])


@pytest.mark.parametrize("shape", [(64, 64), (48, 40), (128, 128)])
def test_warp_affine_nearest_equals_cv2(shape):
    """warp_affine_nearest against cv2.warpAffine(..., INTER_NEAREST) here
    (OpenCV 5.0) on float64 masks, the dtype the TigDog augmentation warps,
    bit for bit: 500 random masks under the augmentation's transforms and
    100 under general affines (rotation, shear, shifts past the border).
    (OpenCV 5.0 warps float32 and uint8 by other arithmetic.)"""
    assert cv2.__version__.startswith("5.")
    rng = np.random.default_rng(shape[1])
    H, W = shape
    for i in range(600):
        src = (rng.random((H, W)) > 0.5).astype(np.float64)
        M = (_augmentation_matrix(rng, H, W) if i < 500
             else np.concatenate([rng.normal(1.0, 0.3, (2, 2)) * [[1, 0.3], [0.3, 1]],
                                  rng.uniform(-20, 20, (2, 1))], 1))
        want = cv2.warpAffine(src, M, (W, H), flags=cv2.INTER_NEAREST)
        got = image_utils.warp_affine_nearest(src, M, (W, H))
        assert got.dtype == want.dtype and np.array_equal(got, want), (i, M)


def _wrong_nearest(monkeypatch):
    """cv2.warpAffine with its nearest warp replaced by one off the image
    (the matrix's inverse), as a host's OpenCV may compute it."""
    real = cv2.warpAffine

    def warp(src, M, dsize, *a, flags=cv2.INTER_LINEAR, **kw):
        if flags == cv2.INTER_NEAREST:
            return real(src, cv2.invertAffineTransform(M), dsize, *a, flags=flags, **kw)
        return real(src, M, dsize, *a, flags=flags, **kw)

    monkeypatch.setattr(cv2, "warpAffine", warp)


def test_tigdog_augmented_masks_do_not_take_cv2_nearest_warp(tmp_path, monkeypatch):
    """MultiFrameDataset with the clip-level affine: every sample of the
    port, with cv2's nearest warp made wrong, bit-equal to the JAX
    package's with cv2's own (OpenCV 5.0 here), and its masks moved by
    the affine (the transform is not the identity)."""
    write_tigdog_tree(str(tmp_path / "pkls"), "horse", n_videos=2, n_frames=6, raw=(96, 128),
                      seed=4)
    ds = ttig.VideoPklDataset(str(tmp_path / "pkls"), "horse", num_kps=18)
    n, s2v, spv = ttig.explode_to_frames(ds, str(tmp_path / "c"), "horse", 50)
    kw = dict(tmp_dir=str(tmp_path / "c"), category="horse", sample_to_vid=s2v,
              samples_per_vid=spv, num_frames=2, img_size=64, seed=3)
    j = jtig.MultiFrameDataset(**kw)
    want = [j[i] for i in range(n)]
    _wrong_nearest(monkeypatch)
    t = ttig.MultiFrameDataset(**kw)
    for i in range(n):
        got = t[i]
        for key, v in want[i].items():
            assert np.array_equal(got[key], v), (i, key)
        assert got["transforms"][0, 0] != 1.0


@pytest.fixture(scope="module")
def dumped(tmp_path_factory):
    """The dump on the small tree and model (module docstring)."""
    out = tmp_path_factory.mktemp("lockstep")
    write_tigdog_tree(str(out / "root"), "horse", n_videos=16, n_frames=2, raw=(72, 96), seed=4)
    kp_dict = write_kp_dict(str(out / "kp.pkl"), num_verts=42)
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((jt, "N_VIDEOS"), (jt, "RAW"), (jt, "IMG"), (tt, "IMG")):
            mp.setattr(mod, name, getattr(mod, name))
        meta = ls.dump(str(out), img=64, videos=16, epochs=2, reps=1, at=(1,), skip_gen=True,
                       overrides=dict(subdivide=1, nz_feat=32, num_training_frames=1,
                                      num_kps=18, kp_dict=kp_dict))
        yield str(out), meta


@pytest.mark.heavy
def test_lockstep_one_step_from_each_snapshot(dumped):
    """3a: from the init, the warm-up rep (the boundary to the main loop:
    the full Adam's first step) and epoch 1, one port step on JAX's next
    batch: loss matrix, metrics, probabilities, gradients, Adam's update,
    the BatchNorm running statistics within the step tests' bounds."""
    out, meta = dumped
    assert meta["labels"] == ["init", "warm1", "epoch1", "epoch2"]
    assert meta["steps_per_epoch"] == 1
    mods, _, _ = ls.build_port(meta, out, torch.device("cpu"))
    kinds = []
    for label in meta["labels"][:-1]:
        r = ls.hold_step(mods, ls._load(out, label))
        kinds.append((r["kind"], r["step"]))
        assert not r["fails"], (label, r)
    assert kinds == [("warm", 0), ("train", 1), ("train", 2)]


@pytest.mark.heavy
def test_lockstep_evaluates_jax_final_state_as_jax(dumped):
    """3c: JAX's final state through the port's evaluate CLI gives JAX's
    trained, train-split argmax and gauge-aligned columns: IoU within 1e-3,
    PCK within one keypoint's share, the cameras within 1e-4."""
    out, meta = dumped
    r = ls.hold_eval(meta, out, torch.device("cpu"))
    assert sorted(r["columns"]) == sorted(ls.EVAL_COLUMNS)
    assert not r["fails"], r
