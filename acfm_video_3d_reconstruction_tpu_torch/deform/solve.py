"""LBS handles + screened-Poisson deformation solve.

Counterpart of acfm_video_3d_reconstruction_tpu/deform/solve.py. Given the
template mean_v (V, 3), the skinning matrix A = lbs (K, V) and handle
offsets delta (B, K, 3), solve per sample

    min_v ||L v - L mean_v||^2 + ||A v - (A mean_v + delta)||^2

through the normal equations (L^T L + A^T A) v = L^T L mean_v + A^T (A mean_v + delta).
The system matrix is shared across the batch, so it is factored once and
all B*3 right-hand sides are solved together.

Precision: everything here is float32 without TF32. The Laplacian
near-nullspace (min eigenvalue ~2e-3) is pinned only by A^T A, and
bf16/TF32-grade matmuls move the solution by ~1e-1 on the template scale;
callers on the card keep `torch.backends.cuda.matmul.allow_tf32` False.
"""
from __future__ import annotations

import torch

from ..utils import tracing


def screened_poisson_solve(
    mean_v: torch.Tensor,
    lbs: torch.Tensor,
    delta_handles: torch.Tensor,
    L: torch.Tensor,
) -> torch.Tensor:
    """mean_v (V, 3), lbs (K, V), delta_handles (B, K, 3), L (V, V) -> (B, V, 3)."""
    V = mean_v.shape[0]
    B = delta_handles.shape[0]
    A = lbs.float()
    L = L.float()
    mean_v = mean_v.float()
    target = (A @ mean_v)[None] + delta_handles.float()  # (B, K, 3)
    M = L.T @ L + A.T @ A
    rhs = (L.T @ (L @ mean_v))[None] + torch.einsum("kv,bkc->bvc", A, target)
    # cholesky_ex: the same factor without cholesky's check of `info`, a
    # read on the host that waits for the stream; a matrix that is not
    # positive definite gives a non-finite factor, as JAX's cho_factor does;
    # while counts are taken (tracing, a graph's capture) such factors count
    # as `solve.failures`
    chol, info = torch.linalg.cholesky_ex(M)
    if tracing.counting():
        tracing.count_device("solve.failures", info != 0)
    rhs_flat = rhs.permute(1, 0, 2).reshape(V, B * 3)
    sol = torch.cholesky_solve(rhs_flat, chol)
    return sol.reshape(V, B, 3).permute(1, 0, 2)


def lbs_from_logits(lbs_logits: torch.Tensor) -> torch.Tensor:
    """(V, K) logits -> (K, V) skinning matrix: softmax over the vertex axis,
    then transpose (reference mesh_net.get_lbs + .permute(1, 0))."""
    return torch.softmax(lbs_logits, dim=0).T
