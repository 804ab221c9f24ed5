"""ctypes bindings for the native preprocessing library (native/preproc.cpp).

A copy of acfm_video_3d_reconstruction_tpu/data/native.py, loading the same
native/libacfm_preproc.so when built (native/build.sh); callers fall back to
the numpy implementations in data/image_utils.py otherwise. The numpy
versions are the test oracle (tests/test_data.py::TestNativeParity).
"""
from __future__ import annotations

import ctypes
import os.path as osp

import numpy as np

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = osp.join(
        osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))),
        "native", "libacfm_preproc.so",
    )
    if not osp.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.acfm_compute_dt.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p
    ]
    lib.acfm_compute_dt_barrier.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    ]
    lib.acfm_compute_boundaries.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int
    ]
    lib.acfm_compute_boundaries.restype = ctypes.c_int
    lib.acfm_preprocess_masks.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def compute_dt(mask: np.ndarray, norm: bool = True) -> np.ndarray:
    lib = _load()
    m = np.ascontiguousarray((np.asarray(mask) > 0.5).astype(np.uint8))
    h, w = m.shape
    out = np.empty((h, w), np.float32)
    lib.acfm_compute_dt(m.ctypes.data, h, w, int(norm), out.ctypes.data)
    return out


def compute_dt_barrier(mask: np.ndarray, k: float = 50.0) -> np.ndarray:
    lib = _load()
    m = np.ascontiguousarray((np.asarray(mask) > 0.5).astype(np.uint8))
    h, w = m.shape
    out = np.empty((h, w), np.float32)
    lib.acfm_compute_dt_barrier(m.ctypes.data, h, w, ctypes.c_float(k), out.ctypes.data)
    return out


def preprocess_masks(
    masks: np.ndarray,
    max_pts: int = 1000,
    barrier_k: float = 50.0,
    with_barrier: bool = False,
):
    """Batched edt/boundaries (B, H, W) -> ((B,H,W), (B,N,3)).

    with_barrier=True additionally returns the sigmoid barrier DT as a
    third array (off by default: the training losses consume only the raw
    DT, matching the reference's actual use — monocular/main.py:184-187).
    """
    lib = _load()
    m = np.ascontiguousarray((np.asarray(masks) > 0.5).astype(np.uint8))
    b, h, w = m.shape
    edt = np.empty((b, h, w), np.float32)
    bdt = np.empty((b, h, w), np.float32) if with_barrier else None
    bounds = np.empty((b, max_pts, 3), np.float32)
    lib.acfm_preprocess_masks(
        m.ctypes.data, b, h, w, ctypes.c_float(barrier_k), max_pts,
        edt.ctypes.data,
        bdt.ctypes.data if with_barrier else None,
        bounds.ctypes.data,
    )
    if with_barrier:
        return edt, bdt, bounds
    return edt, bounds
