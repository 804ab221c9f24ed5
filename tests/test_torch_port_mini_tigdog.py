"""tools/torch_mini_tigdog_parity.py against the JAX package's
tools/mini_tigdog_parity.py, on the CPU.

Both generators write the tree at 3 videos, 64^2 crops (72^2 raw frames;
the JAX tool's module globals set with monkeypatch, the file untouched).
JAX renders with its dense rasterizer, the port bins at K = F. Held:
* the numpy draws: the cameras and the handle offsets that reach the solve
  and the projection, the background of every pixel both masks leave off
  the mesh, bit-equal;
* `sfm_poses` (crop_cams) and `bboxes` bit-equal: both follow the masks'
  extreme pixels, so this holds the masks' outline exactly;
* the masks (`segmentations`) equal on >= 99.9% of the pixels;
* the landmarks within tests/test_torch_port_synthetic.py's keypoint bound
  on the demo's template (1e-4 in [-1, 1] units, the solve's f32 normal
  equations rounded in another order), in raw pixels; visibility equal;
* the shading: each face's shade from the JAX generator's own projected
  meshes within 1e-5 of the JAX generator's (the face normal's dot product
  with the light); the frames, each side from its own meshes, within 1e-4
  where both masks cover the pixel and the hard z-buffers pick the same
  face (colour <= 0.9 times the shade, whose inputs differ by the solve's
  rounding: the meshes within 1e-4 as the keypoints, ~2e-5 measured).
A heavy case runs the port tool's main end to end with --device cpu at 16
videos, 64^2, 1 epoch and 2 TTO iterations: every column of the table
parses, and no file is written outside --root and --out.
"""
import os
import pickle
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acfm_video_3d_reconstruction_tpu.geometry import camera as jcam
from acfm_video_3d_reconstruction_tpu.models import build_template as jbuild_template
from acfm_video_3d_reconstruction_tpu.ops import rasterizer as jras

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import mini_tigdog_parity as jtool  # noqa: E402
import torch_mini_tigdog_parity as ttool  # noqa: E402

torch.set_num_threads(1)

VIDEOS, IMG, RAW = 3, 64, 72
KP_BOUND = 1e-4  # test_torch_port_synthetic.py, the demo's template


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Both trees, with what each generator passed to its solve and its
    projection and each hard rasterization's pix_to_face."""
    root = tmp_path_factory.mktemp("mini_tigdog")
    seen = {"j_cams": [], "j_proj": [], "j_deforms": [], "j_p2f": [], "j_shade_f": [],
            "t_cams": [], "t_deforms": []}

    def spy(fn, key, pick, meshes_only=False):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            # not the keypoints' projection; not a call traced inside a jit
            if (not meshes_only or a[0].shape[-2] == 642) and \
                    not isinstance(a[0], jax.core.Tracer):
                seen[key].append(np.array(pick(a, out)))
            return out
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        for mod in (jtool, ttool):
            mp.setattr(mod, "N_VIDEOS", VIDEOS)
            mp.setattr(mod, "RAW", RAW)
            mp.setattr(mod, "IMG", IMG)
        from acfm_video_3d_reconstruction_tpu.deform import solve as jsolve

        mp.setattr(jsolve, "screened_poisson_solve",
                   spy(jsolve.screened_poisson_solve, "j_deforms", lambda a, o: a[2]))
        mp.setattr(jcam, "orthographic_proj_withz",
                   spy(spy(jcam.orthographic_proj_withz, "j_proj", lambda a, o: o, True),
                       "j_cams", lambda a, o: a[1], True))
        # the generator gathers each face's shade per pixel with
        # take_along_axis(shade_f, face index, axis=1)
        mp.setattr(jnp, "take_along_axis",
                   spy(jnp.take_along_axis, "j_shade_f", lambda a, o: a[0]))
        mp.setattr(jras, "hard_rasterize",
                   spy(jras.hard_rasterize, "j_p2f", lambda a, o: o.pix_to_face))
        mp.setattr(ttool, "screened_poisson_solve",
                   spy(ttool.screened_poisson_solve, "t_deforms", lambda a, o: a[2]))
        real_proj = ttool.cam_utils.orthographic_proj_withz
        mp.setattr(ttool.cam_utils, "orthographic_proj_withz",
                   spy(real_proj, "t_cams", lambda a, o: a[1], True))
        jt = jbuild_template(subdivide=3, num_lbs=jtool.NUM_LBS, tex_size=2,
                             num_kps=jtool.NUM_KPS,
                             kp_vertex_ids=[np.asarray([a]) for a in jtool.ANCHORS])
        jtool.generate(str(root / "jax"), jt)
        info = ttool.generate(str(root / "port"), ttool.build_template(), device="cpu")

    def load(side):
        out = []
        for v in range(VIDEOS):
            with open(root / side / "horse" / f"video_{v:03d}.pkl", "rb") as fh:
                out.append(pickle.load(fh))
        return out

    return {"jax": load("jax"), "port": load("port"), "seen": seen, "info": info}


def test_constants_match_the_jax_tool():
    for name in ("T_RAW", "NUM_KPS", "NUM_LBS"):
        assert getattr(ttool, name) == getattr(jtool, name), name
    assert (ttool.RAW, ttool.IMG, ttool.N_VIDEOS) == (144, 128, 60)
    np.testing.assert_array_equal(ttool.ANCHORS, jtool.ANCHORS)


def test_draws_cameras_and_deformations_bit_equal(trees):
    s = trees["seen"]
    assert len(s["j_deforms"]) == len(s["t_deforms"]) == VIDEOS
    for dj, dt in zip(s["j_deforms"], s["t_deforms"]):
        assert dj.dtype == dt.dtype == np.float32
        np.testing.assert_array_equal(dt, dj)
    # the cameras that project each video's meshes
    assert len(s["j_cams"]) == len(s["t_cams"]) == VIDEOS
    for cj, ct in zip(s["j_cams"], s["t_cams"]):
        np.testing.assert_array_equal(ct, cj)


def test_poses_and_bboxes_bit_equal(trees):
    for pj, pt in zip(trees["jax"], trees["port"]):
        for key in ("sfm_poses", "bboxes"):
            assert pt[key].dtype == pj[key].dtype == np.float64, key
            np.testing.assert_array_equal(pt[key], pj[key], err_msg=key)
        assert set(pt) == set(pj)


def test_masks_agree(trees):
    agree = [float((pt["segmentations"] == pj["segmentations"]).mean())
             for pj, pt in zip(trees["jax"], trees["port"])]
    assert min(agree) >= 0.999, agree
    assert all(pt["segmentations"].dtype == np.float32 for pt in trees["port"])
    assert trees["info"]["overflow"] == 0


def test_landmarks_within_the_keypoint_bound(trees):
    bound = KP_BOUND * (RAW - 1) / 2  # [-1, 1] units -> raw pixels
    for pj, pt in zip(trees["jax"], trees["port"]):
        lj, lt = pj["landmarks"], pt["landmarks"]
        assert lt.dtype == lj.dtype == np.float64 and lt.shape == lj.shape
        np.testing.assert_allclose(lt[..., :2], lj[..., :2], atol=bound, rtol=0)
        np.testing.assert_array_equal(lt[..., 2], lj[..., 2])


def test_face_shades_match_jax(trees):
    """face_shades on the JAX generator's projected meshes against the
    per-face shade the JAX generator computed from them: within 1e-5."""
    s = trees["seen"]
    faces = torch.as_tensor(ttool.build_template().faces, dtype=torch.long)
    assert len(s["j_proj"]) == len(s["j_shade_f"]) == VIDEOS
    for proj, want in zip(s["j_proj"], s["j_shade_f"]):
        got = ttool.face_shades(torch.as_tensor(proj), faces).numpy()
        assert got.shape == want.shape == (jtool.T_RAW, 1280)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_frames_background_bit_equal_and_shading_close(trees):
    """Off both masks the frame is the background draw, bit for bit; on
    both masks with the same front face it is the shade times the colour,
    within 1e-4 (each side's shade from its own meshes)."""
    n_shaded = 0
    for v, (pj, pt) in enumerate(zip(trees["jax"], trees["port"])):
        vj, vt = pj["video"], pt["video"]
        assert vt.dtype == vj.dtype == np.float32 and vt.shape == vj.shape
        off = (pj["segmentations"] == 0) & (pt["segmentations"] == 0)
        np.testing.assert_array_equal(vt[off], vj[off])
        p2f_j = trees["seen"]["j_p2f"][v].reshape(vj.shape[:3])
        p2f_t = trees["info"]["pix_to_face"][v].reshape(vt.shape[:3])
        same = ((pj["segmentations"] == 1) & (pt["segmentations"] == 1)
                & (p2f_j == p2f_t) & (p2f_j >= 0))
        assert same.mean() > 0.05
        n_shaded += int(same.sum())
        np.testing.assert_allclose(vt[same], vj[same], atol=1e-4, rtol=0)
    assert n_shaded > 0


ROW = re.compile(r"^\| (mean mask IoU|PCK@0\.1|PCK@0\.15) \|(.*)\|$", re.M)


@pytest.mark.heavy
def test_main_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    """The tool as users run it, with --device cpu at 16 videos, 64^2, one
    epoch and 2 TTO iterations: every one of the 8 columns parses as a
    number in [0, 1]; nothing is written outside --root and --out (the
    working directory and TMPDIR stay empty)."""
    for name in ("N_VIDEOS", "RAW", "IMG"):  # main overrides them
        monkeypatch.setattr(ttool, name, getattr(ttool, name))
    cwd, tmp = tmp_path / "cwd", tmp_path / "tmp"
    cwd.mkdir()
    tmp.mkdir()
    monkeypatch.chdir(cwd)
    monkeypatch.setenv("TMPDIR", str(tmp))
    # unset here, restored unset after main (which sets it under --root)
    monkeypatch.setenv("TORCHINDUCTOR_CACHE_DIR", "")
    monkeypatch.delenv("TORCHINDUCTOR_CACHE_DIR")
    root, out = tmp_path / "root", tmp_path / "table.md"
    threads = torch.get_num_threads()
    torch.set_num_threads(4)  # the in-process training (the module runs on one thread)
    try:
        assert ttool.main(["--device", "cpu", "--videos", "16", "--img", "64", "--epochs", "1",
                           "--num_optim_iter", "2", "--root", str(root), "--out", str(out)]) == 0
    finally:
        torch.set_num_threads(threads)
    rows = ROW.findall(out.read_text())
    assert [r[0] for r in rows] == ["mean mask IoU", "PCK@0.1", "PCK@0.15"]
    for label, cells in rows:
        values = [float(c) for c in cells.split("|")]
        assert len(values) == 8 and all(0.0 <= x <= 1.0 for x in values), (label, values)
    assert "PARTIAL" not in out.read_text()
    assert not os.listdir(cwd) and not os.listdir(tmp)
    assert sorted(os.listdir(tmp_path)) == ["cwd", "root", "table.md", "tmp"]
