"""Mesh operators: topology and UV sampler (numpy), smoothing terms (torch).

Counterpart of acfm_video_3d_reconstruction_tpu/geometry/mesh_ops.py. The
host-side constructors are numpy copies that give the same arrays bit for bit;
the per-step terms work on torch tensors. Laplacians are dense (V x V):
V=642 for the standard template.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch


# ---------------------------------------------------------------- topology --

def compute_edges(faces: np.ndarray) -> np.ndarray:
    """Unique undirected edges (E, 2) from faces (F, 3). Host-side."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0)


def compute_edges2verts(faces: np.ndarray) -> np.ndarray:
    """For each interior edge, [v0, v1, opposite_a, opposite_b] (E, 4)."""
    edge_dict: dict[tuple[int, int], list[int]] = {}
    for face in faces:
        for e1, e2, o in ((0, 1, 2), (0, 2, 1), (1, 2, 0)):
            key = tuple(sorted((int(face[e1]), int(face[e2]))))
            others = edge_dict.setdefault(key, [])
            if int(face[o]) not in others:
                others.append(int(face[o]))
    rows = [list(k) + v for k, v in edge_dict.items() if len(v) == 2]
    return np.asarray(rows, dtype=np.int64)


def uniform_laplacian(faces: np.ndarray, num_verts: int) -> np.ndarray:
    """Dense uniform Laplacian, pytorch3d `laplacian_packed` convention:

    L[i, j] = 1/deg(i) for each neighbor j; L[i, i] = -1. Host-side numpy.
    """
    edges = compute_edges(faces)
    A = np.zeros((num_verts, num_verts), dtype=np.float64)
    A[edges[:, 0], edges[:, 1]] = 1.0
    A[edges[:, 1], edges[:, 0]] = 1.0
    deg = A.sum(1)
    L = A / np.maximum(deg, 1.0)[:, None]
    L[np.arange(num_verts), np.arange(num_verts)] = -1.0
    return L.astype(np.float32)


# ---------------------------------------------------------------- uv atlas --

def get_spherical_coords(X: np.ndarray) -> np.ndarray:
    """(N, 3) points -> (N, 2) UV in [-1, 1] (azimuth u, inclination v)."""
    rad = np.linalg.norm(X, axis=1)
    theta = np.arccos(np.clip(X[:, 2] / rad, -1.0, 1.0))
    phi = np.arctan2(X[:, 1], X[:, 0])
    vv = (theta / np.pi) * 2 - 1
    uu = ((phi + np.pi) / (2 * np.pi)) * 2 - 1
    return np.stack([uu, vv], axis=1)


def compute_uvsampler(verts: np.ndarray, faces: np.ndarray, tex_size: int = 2) -> np.ndarray:
    """Per-face barycentric sample points mapped to spherical UV.

    Returns (F, T, T, 2) sampling coords in [-1, 1]. Grid cell (a, b)
    corresponds to barycentric weights (alpha_a, beta_b, 1-alpha-beta) on
    (v0, v1, v2).
    """
    alpha = np.arange(tex_size, dtype=np.float64) / (tex_size - 1)
    beta = np.arange(tex_size, dtype=np.float64) / (tex_size - 1)
    coords = np.stack([p for p in itertools.product(alpha, beta)])  # (T*T, 2)
    vs = verts[faces]
    v2 = vs[:, 2]
    v0v2 = vs[:, 0] - vs[:, 2]
    v1v2 = vs[:, 1] - vs[:, 2]
    samples = np.dstack([v0v2, v1v2]) @ coords.T + v2.reshape(-1, 3, 1)
    samples = np.transpose(samples, (0, 2, 1)).reshape(-1, 3)
    uv = get_spherical_coords(samples)
    return uv.reshape(-1, tex_size, tex_size, 2)


# ------------------------------------------------------------ torch terms --

def safe_norm(x: torch.Tensor, dim=-1, keepdim: bool = False,
              eps: float = 1e-12) -> torch.Tensor:
    """L2 norm with a finite gradient at 0.

    sqrt(max(sum sq, eps^2)) equals the norm for norms >= eps and has
    gradient exactly 0 at the degenerate point (a collapsed edge under a
    large deformation would otherwise give 0 * NaN). torch.maximum splits
    the gradient at sum sq == eps^2 as jnp.maximum does; clamp would not.
    """
    sq = (x * x).sum(dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.maximum(sq, sq.new_tensor(eps * eps)))


def uniform_laplacian_smoothing(verts: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """pytorch3d mesh_laplacian_smoothing(method='uniform') equivalent.

    verts: (B, V, 3); L: (V, V). loss = mean_b mean_v ||(L v)_i||.
    """
    Lv = torch.einsum("ij,bjc->bic", L, verts)
    return safe_norm(Lv, dim=-1).mean()
