"""The native mask preprocessing's stand-in: a frozen copy of the port's
data/native.py that never loads the C++ library, so data/loader.py takes its
numpy / scipy path (bit-equal to the native one in the port's tests)."""
from __future__ import annotations


def available() -> bool:
    return False


def preprocess_masks(masks, max_boundary_points):
    raise RuntimeError("the reference runs the numpy path")
