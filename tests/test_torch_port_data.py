"""The port's host data path against the JAX package's, on the CPU.

A CUB-format tree from tools/cub_fixture.py (8 train images of 80-120 px,
img_size 64) goes through both packages' CUBDataset + DataLoader with the
same seeds, jitter and mirror on, over two epochs, once through the native
edt / boundaries library and once through the numpy fallback on both sides:
every key of every batch is equal, bit for bit (the port's resize_img calls
cv2.resize as the JAX package's does). Then image_utils function by
function, the native bindings, the quaternion helpers, the clip collates,
eval/metrics.py on the fixtures of tests/test_eval_ckpt.py::TestMetrics, and
utils/obj_io.py, each exactly.
"""
import numpy as np
import pytest

from acfm_video_3d_reconstruction_tpu.data import base as jbase
from acfm_video_3d_reconstruction_tpu.data import cub as jcub
from acfm_video_3d_reconstruction_tpu.data import image_utils as jiu
from acfm_video_3d_reconstruction_tpu.data import loader as jloader
from acfm_video_3d_reconstruction_tpu.data import native as jnative
from acfm_video_3d_reconstruction_tpu.eval import metrics as jmetrics
from acfm_video_3d_reconstruction_tpu.utils import obj_io as jobj
from acfm_video_3d_reconstruction_tpu_torch.data import base as tbase
from acfm_video_3d_reconstruction_tpu_torch.data import cub as tcub
from acfm_video_3d_reconstruction_tpu_torch.data import image_utils as tiu
from acfm_video_3d_reconstruction_tpu_torch.data import loader as tloader
from acfm_video_3d_reconstruction_tpu_torch.data import native as tnative
from acfm_video_3d_reconstruction_tpu_torch.eval import metrics as tmetrics
from acfm_video_3d_reconstruction_tpu_torch.utils import obj_io as tobj
from tools.cub_fixture import write_cub_tree

IMG = 64


@pytest.fixture(scope="module")
def cub_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cub"))
    write_cub_tree(root, n_train=8, n_test=4, raw=(80, 120), seed=3)
    return root


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_cub_loader_matches_jax(cub_root, path, monkeypatch):
    """Two epochs of shuffled, jittered, mirrored batches with edt and
    boundaries: every array equal on both sides."""
    if path == "numpy":
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(tnative, "available", lambda: False)
    else:
        assert jnative.available() and tnative.available(), "native/build.sh not built"
    loaders = [
        lib_loader.DataLoader(lib_cub.CUBDataset(cub_root, cub_root, img_size=IMG, seed=5),
                              batch_size=4, shuffle=True, seed=7)
        for lib_cub, lib_loader in ((jcub, jloader), (tcub, tloader))
    ]
    n = 0
    for _ in range(2):
        for bj, bt in zip(*loaders):
            assert set(bj) == set(bt) == {"img", "mask", "kp", "sfm_pose", "inds", "edt",
                                          "boundaries"}
            for k in bj:
                assert bj[k].dtype == bt[k].dtype, k
                np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)
            n += 1
    assert n == 4


def test_cub_test_split_and_mean_shape_match_jax(cub_root):
    """The test split (no jitter, no mirror) sample by sample, and the SfM
    mean shape with its hull."""
    dj = jcub.CUBDataset(cub_root, cub_root, split="test", img_size=IMG, jitter_frac=0.0)
    dt = tcub.CUBDataset(cub_root, cub_root, split="test", img_size=IMG, jitter_frac=0.0)
    assert len(dj) == len(dt) == 4
    for i in range(len(dj)):
        sj, st = dj[i], dt[i]
        for k in sj:
            np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
    for a, b in zip(tcub.load_sfm_mean_shape(cub_root), jcub.load_sfm_mean_shape(cub_root)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tcub.CUB_KP_PERM, jcub.CUB_KP_PERM)


def _mask(seed, h=48, w=56):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
    return (((yy - cy) / (0.3 * h)) ** 2 + ((xx - cx) / (0.25 * w)) ** 2 < 1).astype(np.float64)


def _image_utils_cases():
    rng = np.random.default_rng(11)
    img = rng.random((37, 53, 3))
    mask = _mask(1)
    kp = np.concatenate([rng.random((15, 2)) * 50, np.ones((15, 1))], 1)
    return {
        # scale factors with rounding ties and an exact 2x downscale
        "resize_img_down2": ("resize_img", (rng.random((64, 48, 3)), 0.5)),
        "resize_img_up": ("resize_img", (img, 1.7)),
        "resize_img_down": ("resize_img", (img, 0.61)),
        "resize_img_mask": ("resize_img", (mask, 64 / 56)),
        "resize_img_mask_down2": ("resize_img", (mask, 0.5)),
        "peturb_bbox": ("peturb_bbox", ([3.0, 4.0, 40.0, 30.0], 0.05, 0.1)),
        "square_bbox": ("square_bbox", ([3.2, 4.0, 40.7, 30.1],)),
        "crop_inside": ("crop", (img, [2, 3, 30, 20], 1)),
        "crop_outside": ("crop", (img, [-5, -7, 60, 40], 0)),
        "crop_2d": ("crop", (mask, [-3, 4, 50, 60], 0)),
        "compute_dt": ("compute_dt", (mask,)),
        "compute_dt_unnormalized": ("compute_dt", (mask, False)),
        "compute_dt_barrier": ("compute_dt_barrier", (mask,)),
        "find_boundaries_thick": ("find_boundaries_thick", (mask,)),
        "compute_boundaries": ("compute_boundaries", (np.stack([mask, _mask(2)]),)),
        "compute_boundaries_capped": ("compute_boundaries", (np.stack([mask, _mask(2)]), 40)),
        "perturb_kps_and_bbox_mirror": ("perturb_kps_and_bbox_mirror",
                                        (kp, tcub.CUB_KP_PERM, 56)),
    }


@pytest.mark.parametrize("case", sorted(_image_utils_cases()))
def test_image_utils_match_jax(case):
    name, args = _image_utils_cases()[case]
    if name == "peturb_bbox":  # its jitter draws from the generator passed
        got = tiu.peturb_bbox(*args, rng=np.random.default_rng(4))
        want = jiu.peturb_bbox(*args, rng=np.random.default_rng(4))
    else:
        got, want = getattr(tiu, name)(*args), getattr(jiu, name)(*args)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("fn", ["compute_dt", "compute_dt_barrier", "preprocess_masks"])
def test_native_bindings_match_jax(fn):
    """The port's ctypes bindings call the same library as JAX's."""
    assert jnative.available() and tnative.available(), "native/build.sh not built"
    masks = np.stack([_mask(s) for s in range(3)])
    if fn == "preprocess_masks":
        kw = {"max_pts": 300, "with_barrier": True}
        pairs = zip(tnative.preprocess_masks(masks, **kw), jnative.preprocess_masks(masks, **kw))
    else:
        pairs = [(getattr(tnative, fn)(m), getattr(jnative, fn)(m)) for m in masks]
    for a, b in pairs:
        np.testing.assert_array_equal(a, b)


def test_quaternion_helpers_match_jax():
    rng = np.random.default_rng(6)
    for _ in range(5):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        R = jbase.quaternion_matrix_np(q)
        np.testing.assert_array_equal(tbase.quaternion_matrix_np(q), R)
        np.testing.assert_array_equal(tbase.quaternion_from_matrix_np(R),
                                      jbase.quaternion_from_matrix_np(R))


@pytest.mark.parametrize("collate", ["collate", "collate_min_crop", "collate_pad_circular"])
def test_collates_match_jax(collate):
    rng = np.random.default_rng(8)
    samples = [{"img": rng.random((t, 4, 4, 3)), "mask": rng.random((t, 4, 4)),
                "inds": np.int64(i)} for i, t in enumerate((3, 5, 2))]
    if collate == "collate":
        samples = [{k: v[:2] if k != "inds" else v for k, v in s.items()} for s in samples]
    kw_t, kw_j = ({"rng": np.random.default_rng(9)} if collate == "collate_min_crop" else {}
                  for _ in range(2))
    got = getattr(tloader, collate)(samples, **kw_t)
    want = getattr(jloader, collate)(samples, **kw_j)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_concat_dataset_matches_jax():
    parts = [list(range(3)), list(range(10, 15)), list(range(20, 21))]
    cj, ct = jbase.ConcatDataset(parts), tbase.ConcatDataset(parts)
    assert len(cj) == len(ct) == 9
    assert [ct[i] for i in range(9)] == [cj[i] for i in range(9)]


def _metric_cases():
    a = np.zeros((2, 4, 4), np.float32)
    a[:, :2] = 1
    kp_gt = np.zeros((3, 3, 3))
    kp_gt[..., 2] = [[1.0, 1.0, 1.0], [1.0, 0.0, 1.0], [1.0, 1.0, 1.0]]
    kp_pred = np.zeros((3, 3, 2))
    kp_pred[:, 0, 0], kp_pred[:, 1, 0], kp_pred[:, 2, 0] = 0.1, 0.25, 0.5
    errs = np.asarray([[0.05, 0.05, 0.0], [0.05, 0.50, 0.0], [0.05, 0.05, 0.0]])
    vis = np.asarray([[1.0, 1.0, 0.0], [1.0, 1.0, 0.0], [1.0, 0.0, 0.0]])
    return {
        "mask_iou_equal": ("mask_iou", (a, a)),
        "mask_iou_half": ("mask_iou", (a, np.ones((2, 4, 4), np.float32))),
        "kp_errors": ("kp_errors", (kp_pred, kp_gt, 0.05)),
        "kp_errors_pixel": ("kp_errors_pixel", (kp_pred, kp_gt, 64)),
        "bench_stats_aggregation": ("stats", [(np.asarray([0.5, 0.7]),
                                               np.asarray([[0.05], [0.2]]),
                                               np.asarray([[1.0], [1.0]]))]),
        "bench_stats_never_visible": ("stats", [(np.ones(3), errs, vis)]),
        "bench_stats_two_batches": ("stats", [(np.ones(3), errs, vis),
                                              (np.asarray([0.2, 0.4, 0.6]), errs[::-1],
                                               np.ones((3, 3)))]),
    }


@pytest.mark.parametrize("case", sorted(_metric_cases()))
def test_metrics_match_jax(case, tmp_path):
    name, args = _metric_cases()[case]
    if name != "stats":
        got, want = getattr(tmetrics, name)(*args), getattr(jmetrics, name)(*args)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(a, b)
        return
    st, sj = tmetrics.BenchStats(), jmetrics.BenchStats()
    for upd in args:
        st.update(*upd)
        sj.update(*upd)
    assert st.results() == sj.results()
    for k, v in sj.arrays().items():
        np.testing.assert_array_equal(st.arrays()[k], v)
    st.save(str(tmp_path / "t"), save_mat=True)
    sj.save(str(tmp_path / "j"), save_mat=True)
    for k in ("ious", "kp_errs", "kp_vis"):
        np.testing.assert_array_equal(np.load(tmp_path / "t" / "results.npz")[k],
                                      np.load(tmp_path / "j" / "results.npz")[k])


def test_obj_io_round_trip(tmp_path):
    """save_obj / load_obj: the port's file loads back the same mesh on
    both sides, and the JAX package's file loads in the port; quads are
    fan-triangulated alike."""
    rng = np.random.default_rng(12)
    verts = rng.normal(size=(6, 3)).round(4)
    faces = np.asarray([[0, 1, 2], [2, 3, 4], [1, 4, 5]])
    tobj.save_obj(str(tmp_path / "t.obj"), verts, faces)
    jobj.save_obj(str(tmp_path / "j.obj"), verts, faces)
    assert (tmp_path / "t.obj").read_text() == (tmp_path / "j.obj").read_text()
    for v, f in (tobj.load_obj(str(tmp_path / "t.obj")), jobj.load_obj(str(tmp_path / "t.obj")),
                 tobj.load_obj(str(tmp_path / "j.obj"))):
        np.testing.assert_allclose(v, verts, atol=1e-6)
        np.testing.assert_array_equal(f, faces)
    (tmp_path / "q.obj").write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1/1 2/2 3/3 4/4\n")
    for a, b in zip(tobj.load_obj(str(tmp_path / "q.obj")), jobj.load_obj(str(tmp_path / "q.obj"))):
        np.testing.assert_array_equal(a, b)
