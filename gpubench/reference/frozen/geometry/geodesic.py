"""Geodesic distances, farthest-point handle sampling, LBS / vert2kp init.

Host-side, numpy/scipy; runs once at model-build time on a static template
(matching the reference which computes these once in MeshNet.__init__:
monocular/nnutils/mesh_net.py:399-427).

The reference uses exact polyhedral geodesics (cython `gdist` package). We
use Dijkstra shortest paths on the mesh edge graph, which on a near-uniform
icosphere approximates geodesic distance to within a few percent and
preserves the farthest-point-sampling structure. This is a deliberate
re-design: the distances only seed handle placement and inverse-distance^p
skinning weights, both of which are then learned.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import dijkstra

from .mesh_ops import compute_edges

SAFE_LN_MIN = 1e-10


def safe_ln(x: np.ndarray, minval: float = SAFE_LN_MIN) -> np.ndarray:
    return np.log(np.clip(x, minval, None))


def geodesic_distance_matrix(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """All-pairs graph-geodesic distances (V, V) via Dijkstra on edges."""
    edges = compute_edges(faces)
    w = np.linalg.norm(verts[edges[:, 0]] - verts[edges[:, 1]], axis=1)
    V = verts.shape[0]
    g = sp.csr_matrix(
        (np.concatenate([w, w]),
         (np.concatenate([edges[:, 0], edges[:, 1]]),
          np.concatenate([edges[:, 1], edges[:, 0]]))),
        shape=(V, V),
    )
    return dijkstra(g, directed=False)


def farthest_point_sampling(
    dist: np.ndarray, num_samples: int, start: int = 0
) -> np.ndarray:
    """Greedy farthest-point sampling over a precomputed distance matrix.

    Returns `num_samples + 1` indices (start point + num_samples picks),
    mirroring the reference which keeps the seed vertex 0 plus num_lbs-1
    picks (monocular/nnutils/mesh_net.py:62-79, called with num_lbs-1).
    """
    selected = [start]
    far = dist[:, start].copy()
    for _ in range(num_samples):
        s = int(np.argmax(far))
        selected.append(s)
        far = np.minimum(far, dist[:, s])
    return np.asarray(selected, dtype=np.int64)


def init_lbs_logits(
    verts: np.ndarray, faces: np.ndarray, num_lbs: int, power: float = 16.0
) -> tuple[np.ndarray, np.ndarray]:
    """Initial LBS logits (V, num_lbs) + handle vertex indices (num_lbs,).

    Handles = vertex 0 + (num_lbs - 1) geodesic-FPS picks, index-sorted.
    Weight init: 1 / geodesic_dist^power, with each handle's own row set to
    the column max (the reference's inf-fix), then safe-log. A softmax over
    the vertex axis recovers the skinning matrix.
    Matches reference monocular/nnutils/mesh_net.py:399-427 semantics.
    """
    dist = geodesic_distance_matrix(verts, faces)
    idx = farthest_point_sampling(dist, num_lbs - 1)
    idx = np.sort(idx)
    d = dist[:, idx]  # (V, num_lbs)
    with np.errstate(divide="ignore"):
        lbs = 1.0 / d**power
    lbs[~np.isfinite(lbs)] = 0.0
    col_max = lbs.max(axis=0)
    lbs[idx, np.arange(num_lbs)] = col_max
    return safe_ln(lbs).astype(np.float32), idx


def init_vert2kp_logits_from_points(
    verts: np.ndarray, kp_points: np.ndarray, power: float = 4.0
) -> np.ndarray:
    """vert2kp logits (K, V) from 3D keypoint locations (SfM mean shape).

    1/dist^power, L2-normalized per keypoint row, safe-log.
    Matches reference monocular/nnutils/mesh_net.py:383-397.
    """
    d = np.linalg.norm(verts[:, None, :] - kp_points[None, :, :], axis=-1)  # (V, K)
    with np.errstate(divide="ignore"):
        w = (1.0 / d**power).T  # (K, V)
    w[~np.isfinite(w)] = 0.0
    norm = np.linalg.norm(w, ord=1, axis=1, keepdims=True)
    w = w / np.maximum(norm, 1e-12)
    return safe_ln(w).astype(np.float32)


def init_vert2kp_logits_from_dict(
    verts: np.ndarray, kp_vertex_ids: list, power: float = 12.0
) -> np.ndarray:
    """vert2kp logits (K, V) from a keypoint->vertex-ids dictionary.

    Inverse euclidean distance^power to each keypoint's anchor centroid,
    with the anchor vertices themselves boosted to the row max.
    Matches reference monocular/nnutils/mesh_net.py:354-380.
    """
    K = len(kp_vertex_ids)
    V = verts.shape[0]
    onehot = np.zeros((K, V), dtype=np.float64)
    for k, ids in enumerate(kp_vertex_ids):
        onehot[k, np.asarray(ids)] = 1.0
    kps = onehot @ verts  # (K, 3) summed anchor positions (reference: no mean)
    d = np.linalg.norm(verts[:, None, :] - kps[None, :, :], axis=-1)  # (V, K)
    with np.errstate(divide="ignore"):
        w = (1.0 / d**power).T  # (K, V)
    w[~np.isfinite(w)] = 0.0
    for k, ids in enumerate(kp_vertex_ids):
        w[k, np.asarray(ids)] = 0.0
        w[k, np.asarray(ids)] = w[k].max()
    return safe_ln(w).astype(np.float32)
