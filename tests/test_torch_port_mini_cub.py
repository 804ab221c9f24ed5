"""tools/torch_mini_cub_parity.py against the JAX package's
tools/mini_cub_parity.py, on the CPU.

Both generators write 8 train + 4 test images at the tools' 192^2 (the JAX
tool's GEN_CHUNK, which only pads its static render shapes, set to the 12
images with monkeypatch; the file untouched). JAX renders with its dense
rasterizer, the port bins at K = F. Held, loadmat field by field:
* the numpy draws (the returned handle offsets, the keypoint vertices), the
  sfm entries (scale, trans, rot), rel_path and conv_tri bit-equal;
* the bboxes bit-equal: they follow the masks' extreme pixels, so this
  holds the masks' outline exactly;
* each mask equal on >= 99.9% of its pixels;
* the parts and S within tests/test_torch_port_synthetic.py's keypoint
  bound on the demo's template (1e-4 in [-1, 1] units, the solve's f32
  normal equations rounded in another order; parts in pixels); the
  visibility row equal;
* each PNG within one level on >= 99.9% of its pixels ((img * 255) is
  truncated to uint8, so a shade 1e-6 apart can move a pixel by one).
A heavy case runs the port tool's main end to end with --device cpu at
--n_train 16 --steps 4: the table parses, and no file is written outside
--root and --out.
"""
import os
import re
import sys

import cv2
import numpy as np
import pytest
import scipy.io as sio
import torch

from acfm_video_3d_reconstruction_tpu.models import build_template as jbuild_template

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import mini_cub_parity as jtool  # noqa: E402
import torch_mini_cub_parity as ttool  # noqa: E402

torch.set_num_threads(1)

N_TRAIN, N_TEST = 8, 4
KP_BOUND = 1e-4  # test_torch_port_synthetic.py, the demo's template


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("mini_cub")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtool, "GEN_CHUNK", N_TRAIN + N_TEST)
        jt = jbuild_template(subdivide=3, num_lbs=jtool.NUM_LBS, tex_size=4,
                             num_kps=jtool.NUM_KPS,
                             kp_vertex_ids=[np.asarray([a]) for a in jtool.ANCHORS])
        out_j = jtool.generate(str(root / "jax"), jt, n_train=N_TRAIN, n_test=N_TEST)
    out_t = ttool.generate(str(root / "port"), ttool.tig.build_template(tex_size=4),
                           n_train=N_TRAIN, n_test=N_TEST, device="cpu")
    return {"jax": root / "jax", "port": root / "port", "out_j": out_j, "out_t": out_t}


def _mat(root, *path):
    return sio.loadmat(os.path.join(root, "cache", *path), struct_as_record=False,
                       squeeze_me=True)


def test_constants_match_the_jax_tool():
    for name in ("RAW", "IMG", "N_TRAIN", "N_TEST", "NUM_KPS", "NUM_LBS"):
        assert getattr(ttool, name) == getattr(jtool, name), name
    np.testing.assert_array_equal(ttool.ANCHORS, jtool.ANCHORS)


def test_draws_bit_equal(trees):
    (dj, kj), (dt, kt) = trees["out_j"], trees["out_t"]
    assert dt.dtype == np.asarray(dj).dtype == np.float32
    np.testing.assert_array_equal(dt, np.asarray(dj))
    np.testing.assert_array_equal(kt, kj)


@pytest.mark.parametrize("split", ["train", "test"])
def test_annotations_match_jax(trees, split):
    ij = _mat(trees["jax"], "data", f"{split}_cub_cleaned.mat")["images"]
    it = _mat(trees["port"], "data", f"{split}_cub_cleaned.mat")["images"]
    assert len(it) == len(ij) == (N_TRAIN if split == "train" else N_TEST)
    bound = KP_BOUND * ttool.RAW / 2  # [-1, 1] units -> raw pixels
    for a, b in zip(it, ij):
        assert a.rel_path == b.rel_path
        assert a.mask.dtype == b.mask.dtype == np.uint8
        agree = float((a.mask == b.mask).mean())
        assert agree >= 0.999, (a.rel_path, agree)
        for key in ("x1", "y1", "x2", "y2"):
            assert getattr(a.bbox, key) == getattr(b.bbox, key), (a.rel_path, key)
        np.testing.assert_allclose(a.parts[:2], b.parts[:2], atol=bound, rtol=0)
        np.testing.assert_array_equal(a.parts[2], b.parts[2])
    sj = _mat(trees["jax"], "sfm", f"anno_{split}.mat")
    st = _mat(trees["port"], "sfm", f"anno_{split}.mat")
    for a, b in zip(st["sfm_anno"], sj["sfm_anno"]):
        for key in ("scale", "trans", "rot"):
            np.testing.assert_array_equal(getattr(a, key), getattr(b, key), err_msg=key)
    np.testing.assert_allclose(st["S"], sj["S"], atol=KP_BOUND, rtol=0)
    np.testing.assert_array_equal(st["conv_tri"], sj["conv_tri"])


def test_images_within_one_level(trees):
    names = sorted(os.listdir(trees["jax"] / "images"))
    assert names == sorted(os.listdir(trees["port"] / "images"))
    assert len(names) == N_TRAIN + N_TEST
    for name in names:
        a = cv2.imread(str(trees["port"] / "images" / name)).astype(np.int16)
        b = cv2.imread(str(trees["jax"] / "images" / name)).astype(np.int16)
        assert a.shape == b.shape == (ttool.RAW, ttool.RAW, 3)
        close = float((np.abs(a - b) <= 1).mean())
        assert close >= 0.999, (name, close)


ROW = re.compile(r"^\| (mean mask IoU|PCK@0\.1|PCK@0\.15) \| ([0-9.]+) \| ([0-9.]+) \|$", re.M)


@pytest.mark.heavy
def test_main_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    """The tool as users run it, with --device cpu at --n_train 16 --steps
    4: the table's before and after columns parse as numbers in [0, 1];
    nothing is written outside --root and --out (the working directory and
    TMPDIR stay empty)."""
    cwd, tmp = tmp_path / "cwd", tmp_path / "tmp"
    cwd.mkdir()
    tmp.mkdir()
    monkeypatch.chdir(cwd)
    monkeypatch.setenv("TMPDIR", str(tmp))
    # unset here, restored unset after main (which sets it under --root)
    monkeypatch.setenv("TORCHINDUCTOR_CACHE_DIR", "")
    monkeypatch.delenv("TORCHINDUCTOR_CACHE_DIR")
    root, out = tmp_path / "root", tmp_path / "table.md"
    assert ttool.main(["--n_train", "16", "--steps", "4", "--device", "cpu",
                       "--root", str(root), "--out", str(out)]) == 0
    rows = ROW.findall(out.read_text())
    assert [r[0] for r in rows] == ["mean mask IoU", "PCK@0.1", "PCK@0.15"]
    for _, before, after in rows:
        assert 0.0 <= float(before) <= 1.0 and 0.0 <= float(after) <= 1.0
    assert "train-split fit after training" in out.read_text()
    assert not os.listdir(cwd) and not os.listdir(tmp)
    assert sorted(os.listdir(tmp_path)) == ["cwd", "root", "table.md", "tmp"]
