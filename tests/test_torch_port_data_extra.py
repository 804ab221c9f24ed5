"""The port's remaining host data modules against the JAX package's, on the
CPU: the keypoint groups (data/kp_splits.py), PASCAL and ImageNet stills
(data/pascal.py, data/objects.py) on tests/test_data_parsers.py's in-test
fixtures, the multiframe CLI's PASCAL / ImageNet mixes for the cow, the
affine-augmented SingleImageDatasetV2 on tools/cub_fixture.py's tree, and
the SfM initialiser (tools/sfm_init.py) on tests/test_sfm_flowlib.py's
scenes. All of it is numpy / scipy / cv2 on both sides, so every check is
bit for bit.
"""
import pickle

import cv2
import numpy as np
import pytest
import scipy.io as sio
import test_sfm_flowlib as jsfm_cases

from acfm_video_3d_reconstruction_tpu.cli import multiframe_main as jcli
from acfm_video_3d_reconstruction_tpu.data import base as jbase
from acfm_video_3d_reconstruction_tpu.data import cub as jcub
from acfm_video_3d_reconstruction_tpu.data import kp_splits as jkps
from acfm_video_3d_reconstruction_tpu.data import objects as jobj
from acfm_video_3d_reconstruction_tpu.data import pascal as jpascal
from acfm_video_3d_reconstruction_tpu.data import tigdog as jtig
from acfm_video_3d_reconstruction_tpu.tools import sfm_init as jsfm
from acfm_video_3d_reconstruction_tpu_torch.cli import multiframe_main as tcli
from acfm_video_3d_reconstruction_tpu_torch.data import base as tbase
from acfm_video_3d_reconstruction_tpu_torch.data import cub as tcub
from acfm_video_3d_reconstruction_tpu_torch.data import kp_splits as tkps
from acfm_video_3d_reconstruction_tpu_torch.data import objects as tobj
from acfm_video_3d_reconstruction_tpu_torch.data import pascal as tpascal
from acfm_video_3d_reconstruction_tpu_torch.data import tigdog as ttig
from acfm_video_3d_reconstruction_tpu_torch.tools import sfm_init as tsfm
from tools.cub_fixture import write_cub_tree

COW_KPS = 16  # the cow's keypoint permutation (data/tigdog.py::KP_PERM_COW)
COW_SYNSET = "n01887787"  # objects.py's ImageNet synset of the cow


def _equal(a, b, what=""):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _equal(a[k], b[k], f"{what} {k}")
        return
    x, y = np.asarray(a), np.asarray(b)
    assert x.dtype == y.dtype and x.shape == y.shape, what
    np.testing.assert_array_equal(x, y, err_msg=what)


def _write_png(path, rng, hw):
    img = (rng.random((*hw, 3)) * 255).astype(np.uint8)
    path.parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(path), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))


def write_still_fixtures(root, num_kps=COW_KPS, seed=0):
    """A cow tree: two YTVIS clips (tests/test_data_parsers.py's schema), one
    PASCAL still with a CMR-style annotation (one-indexed parts, one
    invisible keypoint, one NaN) and one ImageNet still of the cow's synset
    with a bare rel_path. Returns the CLI options that mix all three."""
    rng = np.random.default_rng(seed)
    yt = root / "yt" / "cow"
    yt.mkdir(parents=True)
    for i in range(2):
        video = (rng.random((3, 48, 48, 3)) * 255).astype(np.uint8)
        seg = np.zeros((3, 48, 48), np.float32)
        seg[:, 10 + i:30, 12:36 - i] = 1.0
        bboxes = np.tile(np.asarray([12.0, 10.0, 24.0, 20.0]), (3, 1))  # xywh
        with open(yt / f"{i}.pkl", "wb") as f:
            pickle.dump({"video": video, "segmentations": seg, "bboxes": bboxes}, f)

    _write_png(root / "voc" / "cow1.png", rng, (40, 52))
    mask = np.zeros((40, 52), np.uint8)
    mask[8:30, 10:40] = 1
    parts = np.stack([rng.uniform(11, 39, num_kps), rng.uniform(9, 29, num_kps),
                      (rng.random(num_kps) > 0.3).astype(np.float64)])
    parts[:, 1] = np.nan  # an unannotated keypoint
    dt = np.dtype([("rel_path", "O"), ("mask", "O"), ("parts", "O")])
    images = np.zeros((1,), dt)
    images[0] = ("cow1.png", mask, parts)
    sio.savemat(str(root / "cow_train.mat"), {"images": images})

    _write_png(root / "imnet" / COW_SYNSET / "cow_a.png", rng, (32, 48))
    mask = np.zeros((32, 48), np.uint8)
    mask[4:20, 6:30] = 1
    dt = np.dtype([("rel_path", "O"), ("mask", "O")])
    images = np.zeros((1,), dt)
    images[0] = ("cow_a.png", mask)
    (root / "annos").mkdir()
    sio.savemat(str(root / "annos" / f"{COW_SYNSET}_train.mat"), {"images": images})
    return dict(category="cow", num_kps=num_kps, root_dir=str(root / "yt"),
                expand_pascal=True, pascal_img_dir=str(root / "voc"),
                pascal_anno_path=str(root / "cow_train.mat"), expand_imgnet=True,
                imgnet_dir=str(root / "imnet"), imgnet_anno_path=str(root / "annos"))


@pytest.fixture(scope="module")
def stills(tmp_path_factory):
    root = tmp_path_factory.mktemp("stills")
    return root, write_still_fixtures(root)


def test_kp_splits_match_jax():
    """The group tables and get_kp_splits for every category branch."""
    assert tkps.QUADRUPED_GROUPS == jkps.QUADRUPED_GROUPS
    assert tkps.BIRD_GROUPS == jkps.BIRD_GROUPS
    names = ["Nose", "L_F_Paw", "Withers", "TailBase", "Beak", "Tail", "LWing", "other"]
    for cat in ("horse", "cow", "sheep", "tiger", "bird", "car"):
        assert tkps.get_kp_splits(names, cat) == jkps.get_kp_splits(names, cat), cat


def test_pascal_stills_match_jax(stills):
    """PascalVideoDataset (0-indexed, NaN-safe keypoints; a duplicated
    2-frame clip), PascalQuadDataset's placeholder SfM camera, as_clip and
    sample_contour_points: JAX's, bit for bit."""
    root, o = stills
    t = tpascal.PascalVideoDataset(o["pascal_img_dir"], o["pascal_anno_path"], COW_KPS)
    j = jpascal.PascalVideoDataset(o["pascal_img_dir"], o["pascal_anno_path"], COW_KPS)
    assert len(t) == len(j) == 1
    _equal(t[0], j[0], "pascal")
    assert tpascal.IMNET_SYNSETS == jpascal.IMNET_SYNSETS
    for k in ("scale", "trans", "rot"):
        _equal(getattr(tpascal._PlaceholderSfm, k), getattr(jpascal._PlaceholderSfm, k), k)
    with pytest.raises(FileNotFoundError):
        tpascal.PascalQuadDataset(o["pascal_img_dir"], str(root / "none.mat"), None)
    # a one-image file loads as a bare struct, which has no len(): both fail
    for lib in (tpascal, jpascal):
        with pytest.raises(TypeError):
            lib.PascalQuadDataset(o["pascal_img_dir"], o["pascal_anno_path"], None)
    images = sio.loadmat(o["pascal_anno_path"])["images"]
    sio.savemat(str(root / "two.mat"), {"images": np.concatenate([images, images], 1)})
    quads = [lib.PascalQuadDataset(o["pascal_img_dir"], str(root / "two.mat"),
                                   np.arange(COW_KPS), seed=2) for lib in (tpascal, jpascal)]
    assert [q.num_imgs for q in quads] == [2, 2]
    assert quads[0].anno_sfm[0] is quads[0].anno_sfm[1]
    _equal(quads[0].anno[1].parts, quads[1].anno[1].parts, "quad parts")

    rng = np.random.default_rng(4)
    sample = {"img": rng.random((24, 24, 3)).astype(np.float32),
              "mask": (rng.random((24, 24)) > 0.5).astype(np.float32),
              "kp": rng.random((COW_KPS, 3)).astype(np.float32),
              "sfm_pose": rng.random(7).astype(np.float32), "inds": 5}
    for T in (1, 3):
        _equal(tpascal.as_clip(sample, T), jpascal.as_clip(sample, T), f"as_clip {T}")
    _equal(tpascal.as_clip({k: v for k, v in sample.items() if k != "inds"}, 2),
           jpascal.as_clip({k: v for k, v in sample.items() if k != "inds"}, 2), "no inds")
    mask = np.zeros((40, 52), np.float32)
    mask[5:20, 8:30] = 1
    mask[25:35, 35:48] = 0.7
    for m, n in ((mask, 100), (mask, 7), (np.zeros((10, 10)), 5)):
        _equal(tpascal.sample_contour_points(m, n), jpascal.sample_contour_points(m, n),
               f"contour {n}")


def test_imagenet_stills_match_jax(stills, tmp_path):
    """objects.py: the synset map, standardize_rel_path, load_synset_annos
    and ImageNetQuadVideoDataset (placeholder keypoints) as JAX's; the same
    failures for an unknown category and an empty annotation directory."""
    root, o = stills
    assert tobj.IMNET_CLASS2SYNSET == jobj.IMNET_CLASS2SYNSET
    for rel in ("x_1.JPEG", "a/b.JPEG"):
        assert tobj.standardize_rel_path(rel, "n1") == jobj.standardize_rel_path(rel, "n1")
    t = tobj.load_synset_annos(o["imgnet_anno_path"], "cow", "train")
    j = jobj.load_synset_annos(o["imgnet_anno_path"], "cow", "train")
    assert [s for _, s in t] == [s for _, s in j] == [COW_SYNSET]
    assert tobj.load_synset_annos(o["imgnet_anno_path"], "cow", "test") == []
    t = tobj.ImageNetQuadVideoDataset(o["imgnet_dir"], o["imgnet_anno_path"], "cow",
                                      num_kps=COW_KPS)
    j = jobj.ImageNetQuadVideoDataset(o["imgnet_dir"], o["imgnet_anno_path"], "cow",
                                      num_kps=COW_KPS)
    assert len(t) == len(j) == 1
    _equal(t[0], j[0], "imagenet")
    with pytest.raises(KeyError):
        tobj.ImageNetQuadVideoDataset(o["imgnet_dir"], o["imgnet_anno_path"], "dragon")
    with pytest.raises(FileNotFoundError):
        tobj.ImageNetQuadVideoDataset(o["imgnet_dir"], str(tmp_path), "cow")


def _first_batch(cli, o, monkeypatch):
    """The CLI's `train` up to the driver loop: (its video dataset, the
    loader's first batch, the frame count)."""
    seen = {}
    real = cli.build_video_dataset

    def recording(opts):
        seen["video_ds"] = real(opts)
        return seen["video_ds"]

    def stop(cfg, template, loader, loader_noag, n_frames, **kw):
        seen["batch"] = next(iter(loader))
        seen["n_frames"] = n_frames

    with monkeypatch.context() as mp:
        mp.setattr(cli, "build_video_dataset", recording)
        mp.setattr(cli.driver, "run_multiframe_training", stop)
        cli.train(o)
    return seen


def test_cow_mix_matches_jax_cli(stills, tmp_path, monkeypatch):
    """build_video_dataset with --category cow --expand_pascal
    --expand_imgnet: YTVIS clips, then the PASCAL still, then the ImageNet
    still, clip for clip as the JAX CLI's; the frame cache written from it
    and the training loader's first batch (tight mask boxes, v2 crop,
    mirror and affine augmentation) bit for bit."""
    _, fix = stills
    seen = {}
    for side, cli in (("t", tcli), ("j", jcli)):
        o = cli.default_opts()
        o.update(fix, name="cow", tmp_dir=str(tmp_path / side / "c"),
                 checkpoint_dir=str(tmp_path / side / "s"), img_size=32, num_lbs=6,
                 subdivide=1, nz_feat=32, num_frames=2, batch_size=2, num_guesses=2,
                 of_loss_wt=0.0)
        if side == "t":
            o["device"] = "cpu"
        seen[side] = _first_batch(cli, o, monkeypatch)
    t, j = seen["t"]["video_ds"], seen["j"]["video_ds"]
    assert [type(d).__name__ for d in t.datasets] == [type(d).__name__ for d in j.datasets] \
        == ["YTVISPklDataset", "PascalVideoDataset", "ImageNetQuadVideoDataset"]
    assert len(t) == len(j) == 4
    for i in range(len(t)):
        _equal(t[i], j[i], f"clip {i}")
    assert seen["t"]["n_frames"] == seen["j"]["n_frames"] == 10
    for f in range(10):
        a, b = (pickle.load(open(tmp_path / side / "c" / "cow" / f"{f}.pkl", "rb"))
                for side in ("t", "j"))
        _equal(a, b, f"frame {f}")
    _equal(seen["t"]["batch"], seen["j"]["batch"], "first batch")
    assert isinstance(t, ttig.ConcatDataset)


@pytest.fixture(scope="module")
def cub_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cub"))
    write_cub_tree(root, n_train=6, n_test=3, raw=(80, 120), seed=4)
    return root


@pytest.mark.parametrize("split", ["train", "test"])
def test_single_image_dataset_v2_matches_jax(cub_root, split):
    """SingleImageDatasetV2 over the CUB reader (the random affine zoom and
    shift with cv2.warpAffine on the train split, drawn from the sample's
    generator after v1's jitter and mirror; none on the test split), with
    and without the affine: every sample's arrays JAX's, bit for bit, over
    two passes."""
    for affine in (True, False):
        t = type("CUB2", (tcub.CUBDataset, tbase.SingleImageDatasetV2), {})(
            cub_root, cub_root, split=split, img_size=48, seed=9)
        j = type("CUB2", (jcub.CUBDataset, jbase.SingleImageDatasetV2), {})(
            cub_root, cub_root, split=split, img_size=48, seed=9)
        t.affine = j.affine = affine
        zooms = []
        for _ in range(2):
            for i in range(len(t)):
                a, b = t[i], j[i]
                _equal(a, b, f"{split} affine={affine} {i}")
                zooms.append(float(a["transforms"][0]))
        assert (split == "train" and affine) == any(z != 1.0 for z in zooms)


def _sfm_scene(**kw):
    return jsfm_cases.TestSfM.make_scene(None, **kw)


def test_sfm_factorization_matches_jax():
    """rigid_factorization, reproj_error, align_sfm_model and the
    cub_sfm.m pipeline on tests/test_sfm_flowlib.py's scenes: bit for bit."""
    for seed, n_iter in ((0, 60), (1, 40)):
        kps, vis, _ = _sfm_scene(seed=seed)
        t = tsfm.rigid_factorization(kps, vis, n_iter=n_iter)
        j = jsfm.rigid_factorization(kps, vis, n_iter=n_iter)
        for a, b in zip(t, j):
            _equal(a, b, f"factorization {seed}")
        assert tsfm.reproj_error(kps, vis, *t) == jsfm.reproj_error(kps, vis, *j)
    _, _, S = _sfm_scene(seed=2)
    for a, b in zip(tsfm.align_sfm_model(S), jsfm.align_sfm_model(S)):
        _equal(a, b, "align")
    kps, vis, _ = _sfm_scene(N=6, K=8, seed=5)
    (t, St), (j, Sj) = (m.sfm_camera_annotations(kps, vis, [(64, 64)] * 6, n_iter=10)
                        for m in (tsfm, jsfm))
    _equal(St, Sj, "mean shape")
    for a, b in zip(t, j):
        _equal(a, b, "camera")


def test_sfm_mask_refinement_matches_jax():
    """mask_chamfer and refine_camera_mask (BFGS, then Nelder-Mead) on the
    scene of tests/test_sfm_flowlib.py::test_refine_camera_mask_recovers_
    perturbed_camera: bit for bit."""
    from scipy.ndimage import distance_transform_edt

    rng = np.random.default_rng(3)
    K = 10
    S = rng.normal(size=(3, K))
    S -= S.mean(1, keepdims=True)
    S /= np.abs(S).max()
    ang = 0.4
    R_gt = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                     [0, 0, 1.0]])
    c_gt, t_gt = 12.0, np.array([32.0, 32.0])
    proj = c_gt * (R_gt @ S)[:2] + t_gt[:, None]
    mask = np.zeros((64, 64))
    yy, xx = np.mgrid[:64, :64]
    for k in range(K):
        mask[(xx - proj[0, k]) ** 2 + (yy - proj[1, k]) ** 2 < 36] = 1.0
    md = distance_transform_edt(~(mask > 0))
    for pts in (np.array([[10.0, 15.0], [10.0, 20.0]]), np.array([[2.0], [2.0]]),
                np.array([[40.0], [16.0]]), np.zeros((2, 0)), proj):
        assert tsfm.mask_chamfer(md, pts) == jsfm.mask_chamfer(md, pts)
    P = proj.copy()
    P[:, K // 2:] = np.nan
    dR = np.array([[np.cos(0.25), -np.sin(0.25), 0], [np.sin(0.25), np.cos(0.25), 0],
                   [0, 0, 1.0]])
    args = (P, S, mask, c_gt * 1.3, dR @ R_gt, t_gt + np.array([5.0, -4.0]))
    for a, b in zip(tsfm.refine_camera_mask(*args), jsfm.refine_camera_mask(*args)):
        _equal(a, b, "refine")
