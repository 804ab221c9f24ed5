"""Mesh operators: topology and UV sampler (numpy), smoothing terms (torch).

Counterpart of acfm_video_3d_reconstruction_tpu/geometry/mesh_ops.py. The
host-side constructors are numpy copies that give the same arrays bit for bit;
the per-step terms work on torch tensors. Laplacians are dense (V x V):
V=642 for the standard template.

The cotangent weights are assembled by a fixed gather, not a scatter-add:
`CotEdges` lists, once per face array, the (face, corner) cotangents that
land on each undirected edge, so W sums the same terms in the same order on
every run (index_add_ on CUDA sums with atomics, in a varying order).
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


# ------------------------------------------------------- cot Laplacian --

class CotEdges:
    """The assembly plan of the dense cotangent weight matrix of `faces`.

    W[i, j] of the JAX package is the sum of the corner cotangents c[f, k]
    scattered to the ordered pair (faces[f, (k+1)%3], faces[f, (k+2)%3]),
    plus its transpose. Per undirected edge (a < b): `fwd` holds the flat
    indices f*3 + k of the corners scattered to (a, b), `bwd` those
    scattered to (b, a), each in face order and padded with 3F, the index
    of an appended zero; W[a, b] = W[b, a] = sum(fwd) + sum(bwd).
    """

    def __init__(self, faces, num_verts: int | None = None, device=None):
        f = np.asarray(faces.cpu() if torch.is_tensor(faces) else faces, np.int64)
        V = int(f.max()) + 1 if num_verts is None else num_verts
        ii = f[:, [1, 2, 0]].reshape(-1)
        jj = f[:, [2, 0, 1]].reshape(-1)
        lo, hi = np.minimum(ii, jj), np.maximum(ii, jj)
        keys, inv = np.unique(lo * V + hi, return_inverse=True)
        fwd = [[] for _ in keys]
        bwd = [[] for _ in keys]
        for slot, (e, i) in enumerate(zip(inv.reshape(-1), ii)):
            (fwd if i == lo[slot] else bwd)[e].append(slot)
        width = max(1, max(len(x) for x in fwd + bwd))
        pad = 3 * len(f)

        def table(rows):
            return torch.tensor([r + [pad] * (width - len(r)) for r in rows], device=device)

        self.num_verts = V
        self.a = torch.as_tensor(keys // V, device=device)
        self.b = torch.as_tensor(keys % V, device=device)
        self.fwd, self.bwd = table(fwd), table(bwd)
        self.faces = torch.as_tensor(f, device=device)


def _cot_edges(faces) -> CotEdges:
    return faces if isinstance(faces, CotEdges) else CotEdges(faces)


def cot_laplacian_weights(verts: torch.Tensor, faces) -> torch.Tensor:
    """Dense symmetric cotangent weight matrix W (..., V, V), differentiable.

    W[i, j] = (cot a_ij + cot b_ij) / 4 on edges, 0 elsewhere; the area
    clamped at 1e-12 as in the reference (geom_utils.py:258-325). verts
    (..., V, 3); `faces` (F, 3) or a CotEdges built from them (the
    trainer's, made once).
    """
    ce = _cot_edges(faces)
    fv = verts[..., ce.faces, :]  # (..., F, 3, 3)
    v0, v1, v2 = fv[..., 0, :], fv[..., 1, :], fv[..., 2, :]
    A = safe_norm(v1 - v2, dim=-1)
    B = safe_norm(v0 - v2, dim=-1)
    C = safe_norm(v0 - v1, dim=-1)
    s = 0.5 * (A + B + C)
    area = torch.sqrt(torch.clamp(s * (s - A) * (s - B) * (s - C), min=1e-12))
    A2, B2, C2 = A * A, B * B, C * C
    cot = torch.stack([(B2 + C2 - A2) / area, (A2 + C2 - B2) / area,
                       (A2 + B2 - C2) / area], dim=-1) / 4.0  # (..., F, 3)
    flat = cot.reshape(*cot.shape[:-2], -1)
    flat = torch.cat([flat, flat.new_zeros(flat.shape[:-1] + (1,))], dim=-1)
    vals = flat[..., ce.fwd].sum(-1) + flat[..., ce.bwd].sum(-1)  # (..., E)
    V = verts.shape[-2]
    W = verts.new_zeros(verts.shape[:-2] + (V, V))
    W[..., ce.a, ce.b] = vals
    W[..., ce.b, ce.a] = vals
    return W


def cot_laplacian(verts: torch.Tensor, faces) -> torch.Tensor:
    """Dense cot Laplacian L = W - diag(rowsum(W)) (reference
    geom_utils.py:249-255)."""
    W = cot_laplacian_weights(verts, faces)
    return W - torch.diag_embed(W.sum(-1))


def cot_laplacian_smoothing(verts: torch.Tensor, faces) -> torch.Tensor:
    """pytorch3d mesh_laplacian_smoothing(method='cot') equivalent.

    The weights are computed from each mesh under no_grad (pytorch3d builds
    them under torch.no_grad(), the JAX package behind stop_gradient);
    gradients flow only through the final matmul. Loss per vertex
    ||(W v)_i / rowsum(W)_i - v_i||; mean over vertices, then over the batch.
    verts (B, V, 3).
    """
    with torch.no_grad():
        W = cot_laplacian_weights(verts, faces)
        norm_w = W.sum(-1, keepdim=True)
        norm_w = torch.where(norm_w > 0, 1.0 / norm_w, torch.zeros_like(norm_w))
    Lv = torch.bmm(W, verts) * norm_w - verts
    return safe_norm(Lv, dim=-1).mean(-1).mean()


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
