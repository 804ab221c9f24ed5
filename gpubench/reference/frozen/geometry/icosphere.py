"""Icosphere template construction (host-side, numpy).

Replaces the reference's meshzoo dependency (monocular/utils/meshzoo.py,
used via monocular/utils/mesh.py:13-17 create_sphere). Standard icosahedron
midpoint subdivision projected to the unit sphere. Subdivision 3 gives
642 vertices / 1280 faces, matching the reference template topology.

The construction is exactly mirror-symmetric about x=0 (the golden-ratio
icosahedron is, and midpoint + normalization preserve IEEE-exact mirror
pairs), which geometry/symmetry.py relies on.
"""
from __future__ import annotations

import numpy as np


def icosahedron() -> tuple[np.ndarray, np.ndarray]:
    """Unit icosahedron with vertices on the sphere, symmetric about x=0."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    return verts, faces


def subdivide(verts: np.ndarray, faces: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One midpoint subdivision step; new vertices projected to the sphere."""
    edges = {}
    verts = list(verts)

    def midpoint(i: int, j: int) -> int:
        key = (min(i, j), max(i, j))
        if key not in edges:
            m = (np.asarray(verts[i]) + np.asarray(verts[j])) / 2.0
            m = m / np.linalg.norm(m)
            edges[key] = len(verts)
            verts.append(m)
        return edges[key]

    new_faces = []
    for a, b, c in faces:
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        new_faces.extend([[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]])
    return np.asarray(verts), np.asarray(new_faces, dtype=np.int64)


def icosphere(n_subdivide: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """Icosphere: n=3 -> 642 verts / 1280 faces; n=4 -> 2562 / 5120."""
    verts, faces = icosahedron()
    for _ in range(n_subdivide):
        verts, faces = subdivide(verts, faces)
    return verts.astype(np.float64), faces


def create_sphere(n_subdivide: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """Alias matching the reference API (monocular/utils/mesh.py:13)."""
    return icosphere(n_subdivide)
