"""Rigid structure-from-motion factorization for camera/template init.

Counterpart of acfm_video_3d_reconstruction_tpu/tools/sfm_init.py (numpy
and scipy: a copy, so its results are the same). Parity target: the reference's offline MATLAB preprocessing
(*/misc/preprocess/sfm/sfmFactorization.m — rank-3 Tomasi-Kanade rigid
factorization with missing data; sfmFactorizationKnownShape.m;
alignSfmModel.m), which produces the `anno_<split>.mat` sfm_anno cameras
and mean shape consumed at training time. Re-implemented in numpy with
visibility-weighted alternation; emits the same artifacts: per-image
(scale, trans, rot) and a (3, K) mean shape.
"""
from __future__ import annotations

import numpy as np


def _orthonormalize(R: np.ndarray) -> np.ndarray:
    """Project a 2x3 (or 3x3) matrix onto the (scaled) Stiefel manifold."""
    u, _, vt = np.linalg.svd(R, full_matrices=False)
    return u @ vt


def rigid_factorization(
    kps: np.ndarray,
    vis: np.ndarray,
    n_iter: int = 50,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Rank-3 rigid factorization with missing data.

    Args:
      kps: (N, K, 2) keypoint locations (any consistent image frame).
      vis: (N, K) visibility in {0, 1}.
    Returns:
      (scales (N,), trans (N, 2), rots (N, 3, 3), shape (3, K)):
      kps[i] ~ scales[i] * (rots[i] @ S)[:2] + trans[i].
    """
    N, K, _ = kps.shape
    vis = vis.astype(np.float64)
    rng = np.random.default_rng(seed)

    # per-image visible centroid -> translations
    wsum = np.maximum(vis.sum(1, keepdims=True), 1.0)
    trans = (kps * vis[..., None]).sum(1) / wsum  # (N, 2)
    W = (kps - trans[:, None]) * vis[..., None]   # centered, zeros at missing

    # init: SVD of the stacked measurement matrix with missing entries = 0
    Wf = W.transpose(0, 2, 1).reshape(2 * N, K)
    u, s, vt = np.linalg.svd(Wf, full_matrices=False)
    M = u[:, :3] * s[:3]          # (2N, 3) motion
    S = vt[:3]                    # (3, K) shape

    for _ in range(n_iter):
        # shape update: least squares over visible entries
        lhs = np.zeros((3, 3, K))
        rhs = np.zeros((3, K))
        Ms = M.reshape(N, 2, 3)
        for i in range(N):
            v = vis[i]  # (K,)
            A = Ms[i]   # (2, 3)
            lhs += (A.T @ A)[:, :, None] * v[None, None, :]
            rhs += A.T @ (W[i].T * v[None, :])
        for k in range(K):
            S[:, k] = np.linalg.solve(lhs[:, :, k] + 1e-9 * np.eye(3), rhs[:, k])

        # motion update per image, then metric projection
        for i in range(N):
            v = vis[i][:, None]
            Sv = S * vis[i][None, :]
            G = Sv @ Sv.T + 1e-9 * np.eye(3)
            Mi = (W[i].T * vis[i][None, :]) @ S.T @ np.linalg.inv(G)
            # project to scaled rotation rows
            scale = np.linalg.norm(Mi, ord="fro") / np.sqrt(2.0)
            Ri = _orthonormalize(Mi / max(scale, 1e-9))
            Ms[i] = scale * Ri
        M = Ms.reshape(2 * N, 3)

        # translation refit against the current model (missing-data
        # centroids bias the initial estimate)
        for i in range(N):
            proj = (Ms[i] @ S).T  # (K, 2)
            v = vis[i][:, None]
            trans[i] = ((kps[i] - proj) * v).sum(0) / max(vis[i].sum(), 1.0)
        W = (kps - trans[:, None]) * vis[..., None]

    # decompose: scale + full rotation (third row via cross product)
    scales = np.zeros(N)
    rots = np.zeros((N, 3, 3))
    Ms = M.reshape(N, 2, 3)
    for i in range(N):
        scales[i] = np.linalg.norm(Ms[i], ord="fro") / np.sqrt(2.0)
        R2 = _orthonormalize(Ms[i] / max(scales[i], 1e-9))
        r3 = np.cross(R2[0], R2[1])
        rots[i] = np.vstack([R2, r3])
    return scales, trans, rots, S


def reproj_error(kps, vis, scales, trans, rots, S) -> float:
    """Mean visible reprojection error (reprojMinimize.m's objective)."""
    errs = []
    for i in range(len(kps)):
        proj = scales[i] * (rots[i] @ S)[:2].T + trans[i]
        e = np.linalg.norm((proj - kps[i]) * vis[i][:, None], axis=1)
        errs.append(e[vis[i] > 0])
    return float(np.concatenate(errs).mean())


def align_sfm_model(S: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Canonicalize the mean shape: centered, PCA-aligned, unit scale
    (alignSfmModel.m equivalent). Returns (S_aligned, R_align)."""
    Sc = S - S.mean(1, keepdims=True)
    u, _, _ = np.linalg.svd(Sc @ Sc.T)
    if np.linalg.det(u) < 0:
        u[:, -1] *= -1
    Sa = u.T @ Sc
    Sa = Sa / np.abs(Sa).max()
    return Sa, u.T


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    """Scalar-first unit quaternion -> 3x3 rotation matrix."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def mask_chamfer(mask_dist: np.ndarray, pts: np.ndarray) -> float:
    """Squared bilinear chamfer distance of 2D points to a mask.

    Parity: chamferLossInterp (reprojMaskMinimize.m:64-86) — points are
    clamped into the image (the squared clamping displacement is added),
    then the mask distance transform is bilinearly sampled at the clamped
    locations and its squares summed. ``mask_dist`` follows MATLAB
    ``bwdist(mask)`` semantics: 0 inside the mask, Euclidean pixel
    distance to the nearest mask pixel outside.

    pts: (2, M) in (x, y) pixel coordinates.
    """
    from scipy.ndimage import map_coordinates

    if pts.size == 0:
        return 0.0
    h, w = mask_dist.shape
    clamped = np.stack([
        np.clip(pts[0], 0.0, w - 1.0),
        np.clip(pts[1], 0.0, h - 1.0),
    ])
    err_pt = float(((pts - clamped) ** 2).sum())
    # map_coordinates wants (row, col) = (y, x)
    d = map_coordinates(mask_dist, clamped[::-1], order=1, mode="nearest")
    return err_pt + float((d * d).sum())


def refine_camera_mask(
    P: np.ndarray,
    S: np.ndarray,
    mask: np.ndarray,
    c_init: float,
    R_init: np.ndarray,
    t_init: np.ndarray,
) -> tuple[float, np.ndarray, np.ndarray, float]:
    """Mask-based camera refinement (reprojMaskMinimize.m).

    Jointly refines (scale, rotation, translation) of a weak-perspective
    camera so that VISIBLE keypoints (non-NaN columns of ``P``) reproject
    onto their annotations (squared error) while NON-visible keypoints'
    projections are pulled inside the foreground mask via the squared
    bilinear chamfer distance (reprojMaskMinimize.m:12-31: the objective
    is ``err_kp + chamferLossInterp(bwdist(mask), proj_non_vis)``),
    optimized quasi-Newton over x = [c, t, quat] like the reference's
    ``fminunc``.

    Args:
      P: (2, K) pixel keypoints, NaN columns = invisible.
      S: (3, K) canonical shape.
      mask: (H, W) foreground mask (>0 = object).
      c_init / R_init / t_init: initial scale, (3,3) rotation, (2,) trans.
    Returns:
      (c, R, t, err): refined camera and final objective value.
    """
    from scipy.ndimage import distance_transform_edt
    from scipy.optimize import minimize

    from ..data.base import quaternion_from_matrix_np

    P = np.asarray(P, np.float64)
    S = np.asarray(S, np.float64)
    vis = ~np.isnan(P[0])
    S_vis, P_vis = S[:, vis], P[:, vis]
    S_non = S[:, ~vis]

    # bwdist(mask): distance to the nearest foreground pixel (0 inside)
    mask_dist = distance_transform_edt(~(np.asarray(mask) > 0))

    q_init = quaternion_from_matrix_np(np.asarray(R_init, np.float64))
    x0 = np.concatenate([[float(c_init)], np.asarray(t_init, np.float64), q_init])

    def objective(x):
        c, t = x[0], x[1:3]
        R2 = _quat_to_mat(x[3:7])[:2]
        err = float(((c * (R2 @ S_vis) + t[:, None] - P_vis) ** 2).sum())
        if S_non.shape[1]:
            err += mask_chamfer(mask_dist, c * (R2 @ S_non) + t[:, None])
        return err

    res = minimize(objective, x0, method="BFGS",
                   options={"maxiter": 300, "gtol": 1e-8})
    # numeric-gradient BFGS stalls near the optimum on the quaternion
    # scale degeneracy; a short simplex polish matches fminunc's
    # convergence on the reference's scenes
    res = minimize(objective, res.x, method="Nelder-Mead",
                   options={"maxiter": 2000, "xatol": 1e-10, "fatol": 1e-12})
    x = res.x
    return float(x[0]), _quat_to_mat(x[3:7]), x[1:3].copy(), float(res.fun)


def sfm_camera_annotations(kps_px, vis, img_sizes, n_iter=50):
    """Full pipeline: pixel kps -> [-1,1]-frame (scale, trans, quat) per
    image + aligned mean shape — the cub_sfm.m output contract."""
    from ..data.base import quaternion_from_matrix_np

    scales, trans, rots, S = rigid_factorization(np.asarray(kps_px), np.asarray(vis), n_iter)
    S_aligned, R_align = align_sfm_model(S)
    out = []
    for i in range(len(kps_px)):
        R = rots[i] @ R_align.T
        q = quaternion_from_matrix_np(R)
        out.append(
            {"scale": scales[i], "trans": trans[i], "rot": R, "quat": q}
        )
    return out, S_aligned
