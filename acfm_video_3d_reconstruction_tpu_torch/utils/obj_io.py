"""Minimal OBJ mesh I/O (replaces pytorch3d.io.load_obj usage).

A copy of acfm_video_3d_reconstruction_tpu/utils/obj_io.py."""
from __future__ import annotations

import numpy as np


def load_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Load vertices and triangular faces from an OBJ file.

    Returns (verts (V, 3) float64, faces (F, 3) int64, 0-indexed). Quads and
    higher polygons are fan-triangulated; texture/normal indices ignored.
    """
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(x) for x in parts[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for i in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in np.asarray(verts):
            f.write(f"v {v[0]:f} {v[1]:f} {v[2]:f}\n")
        for face in np.asarray(faces):
            f.write(f"f {face[0] + 1:d} {face[1] + 1:d} {face[2] + 1:d}\n")
