"""Multiframe evaluation's geometry of the port against the JAX package, on
the CPU: quat_to_matrix / matrix_to_quat, the Kabsch similarity and the
gauge-aligned GT cameras, the argmax-multiplex camera, and the TTO refiner
(eval/predictor.py::make_tto_step_fn).

The TTO runs at tests/test_eval_ckpt.py::test_tto_reduces_loss's config:
32^2, icosphere subdivide 1 (42 vertices, 80 faces), 6 handles, the
template at half scale, random edt maps and boundary points so that every
loss term is on, 5 Adam steps. Both sides start from the same numpy
inputs; the JAX side runs its jitted fori_loop (or scan, in the trace mode)
with its dense rasterizer, the port its eager loop with the binned plain
versions (auto_K gives the exact capacity at 32^2), both at the production
sigma 1e-4, as the evaluator runs them.

Tolerances: the losses rtol 1e-3 (the multiframe step tests' `_tol` for
the terms read off the mask); pred_v and the camera by vector relative
error, TTO_REL = 1e-4. Five Adam steps of lr 2e-2 move the mesh by ~10%
of its size; the two sides end within 1e-5 (delta, flow) to 5e-5 (the
camera optimized, whose first steps move each entry by ~lr whatever its
gradient's size) of each other, from gradients that differ by f32
rounding of two rasterizers' sums.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_multiframe import _tol

from acfm_video_3d_reconstruction_tpu import config as jcfg
from acfm_video_3d_reconstruction_tpu.deform import solve as jsolve
from acfm_video_3d_reconstruction_tpu.eval import predictor as jpred
from acfm_video_3d_reconstruction_tpu.geometry import camera as jcam
from acfm_video_3d_reconstruction_tpu.geometry import mesh_ops as jmesh
from acfm_video_3d_reconstruction_tpu.geometry import quaternion as jquat
from acfm_video_3d_reconstruction_tpu.models import build_template as jbuild_template
from acfm_video_3d_reconstruction_tpu.multiplex import state as jmpx
from acfm_video_3d_reconstruction_tpu.ops import rasterizer as jras
from acfm_video_3d_reconstruction_tpu_torch import config as tcfg
from acfm_video_3d_reconstruction_tpu_torch.eval import predictor as tpred
from acfm_video_3d_reconstruction_tpu_torch.geometry import quaternion as tquat
from acfm_video_3d_reconstruction_tpu_torch.models import template as ttemplate
from acfm_video_3d_reconstruction_tpu_torch.multiplex import state as tmpx

torch.set_num_threads(1)

IMG = 32
TEMPLATE = dict(subdivide=1, num_lbs=6, tex_size=2, num_kps=0)
TTO_REL = 1e-4


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------- quaternions

def _unit(q):
    q = np.asarray(q, np.float64)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _near_branch(case, rng, n=64):
    """Unit quaternions whose rotation matrix makes Shepperd's `case`
    candidate (w, x, y or z) the largest score, some near the boundary
    with the next one; random ones for "random"."""
    if case == "random":
        return _unit(rng.normal(size=(n, 4)))
    i = "wxyz".index(case)
    q = rng.normal(size=(n, 4)) * 0.3
    q[:, i] = 1.0
    q[: n // 4, (i + 1) % 4] = 1.0 - 1e-4  # near a tie of two scores
    return _unit(q)


@pytest.mark.parametrize("case", ["random", "w", "x", "y", "z"])
def test_quat_matrix_round_trip_matches_jax(case):
    """quat_to_matrix and matrix_to_quat against JAX (atol 1e-6), on random
    quaternions and near each of Shepperd's branches; the round trip gives
    the standardized quaternion back (atol 1e-6) and a proper rotation."""
    rng = np.random.default_rng(["random", "w", "x", "y", "z"].index(case))
    q = _near_branch(case, rng)
    m_t = tquat.quat_to_matrix(torch.tensor(q))
    m_j = np.asarray(jquat.quat_to_matrix(jnp.asarray(q)))
    np.testing.assert_allclose(m_t.numpy(), m_j, atol=1e-6)
    q_t = tquat.matrix_to_quat(torch.tensor(m_j)).numpy()
    q_j = np.asarray(jquat.matrix_to_quat(jnp.asarray(m_j)))
    np.testing.assert_allclose(q_t, q_j, atol=1e-6)
    want = np.where(q[:, :1] < 0, -q, q)
    np.testing.assert_allclose(q_t, want, atol=1e-6)
    np.testing.assert_allclose(np.linalg.det(m_t.numpy()), 1.0, atol=1e-5)


# ---------------------------------------------------------- gauge alignment

def _gauge_case(case):
    """The cases of tests/test_gauge_align.py: (template, learned mean
    shape, GT cameras); a known similarity, none, and a reflection that
    Kabsch must fold into a proper rotation."""
    rng = np.random.default_rng({"drift": 2, "no_drift": 3, "reflection": 4,
                                 "recover": 0}[case])
    n = {"drift": 64, "no_drift": 32, "reflection": 40, "recover": 50}[case]
    template = rng.normal(size=(n, 3)).astype(np.float32)
    q_d = _unit(rng.normal(size=4))
    R = np.asarray(jquat.quat_to_matrix(jnp.asarray(q_d)))
    if case == "no_drift":
        learned = template
    elif case == "reflection":
        learned = (0.9 * template @ (R @ np.diag([1.0, 1.0, -1.0])).T).astype(np.float32)
    else:
        s, c = (0.8, [0.1, 0.2, -0.3]) if case == "drift" else (1.7, [0.3, -0.2, 0.5])
        learned = (s * template @ R.T + np.asarray(c)).astype(np.float32)
    B = 6
    cams = np.concatenate([rng.uniform(0.5, 1.5, (B, 1)), rng.uniform(-0.3, 0.3, (B, 2)),
                           _unit(rng.normal(size=(B, 4)))], -1).astype(np.float32)
    return template, learned, cams


@pytest.mark.parametrize("case", ["recover", "drift", "no_drift", "reflection"])
def test_kabsch_and_gauge_cameras_match_jax(case):
    """similarity_kabsch, gauge_correction, apply_gauge_correction and
    gauge_align_cameras against JAX (atol 1e-5); with a similarity drift
    the corrected cameras project the learned shape where the GT cameras
    project the template (tests/test_gauge_align.py's check, atol 1e-4)."""
    template, learned, cams = _gauge_case(case)
    s_t, R_t, c_t = tpred.similarity_kabsch(torch.tensor(template), torch.tensor(learned))
    s_j, R_j, c_j = jpred.similarity_kabsch(template, learned)
    np.testing.assert_allclose(float(s_t), float(s_j), atol=1e-5)
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-5)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-5)
    assert float(torch.linalg.det(R_t)) > 0.99
    corr_t = tpred.gauge_correction(torch.tensor(template), torch.tensor(learned))
    corr_j = jpred.gauge_correction(jnp.asarray(template), jnp.asarray(learned))
    for a, b in zip(corr_t, corr_j):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)
    got = tpred.apply_gauge_correction(torch.tensor(cams), corr_t).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jpred.apply_gauge_correction(jnp.asarray(cams), corr_j)), atol=1e-5)
    aligned = tpred.gauge_align_cameras(torch.tensor(cams), torch.tensor(template),
                                        torch.tensor(learned)).numpy()
    np.testing.assert_allclose(aligned, got, atol=1e-6)
    if case in ("recover", "drift"):
        from acfm_video_3d_reconstruction_tpu_torch.geometry import camera as tcam

        B = cams.shape[0]
        want = tcam.project_points(torch.tensor(np.tile(template[None], (B, 1, 1))),
                                   torch.tensor(cams))
        proj = tcam.project_points(torch.tensor(np.tile(learned[None], (B, 1, 1))),
                                   torch.tensor(aligned))
        np.testing.assert_allclose(proj.numpy(), want.numpy(), atol=1e-4)


# -------------------------------------------------------- argmax multiplex

def test_argmax_multiplex_camera_matches_jax():
    """The top-1 hypothesis of each frame, decoded with scale_lr_decay, on
    the JAX package's seeded quaternion multiplex carried across as
    arrays, with distinct probabilities and ties (the lower index wins on
    both sides): the same selection, cameras atol 1e-6."""
    j = jmpx.init_quat_multiplex(10, 4, 6, seed=5)
    rng = np.random.default_rng(6)
    cams = np.asarray(j.cams).copy()
    cams[:, :, 0] = rng.normal(size=cams.shape[:2])  # raw scales away from 0
    probs = rng.random((10, 4)).astype(np.float32)
    probs[1] = [0.2, 0.5, 0.5, 0.1]
    probs[3] = [0.25, 0.25, 0.25, 0.25]
    probs[7] = [0.1, 0.4, 0.3, 0.4]
    j = dataclasses.replace(j, cams=jnp.asarray(cams), probs=jnp.asarray(probs))
    t = tmpx.MultiplexState(torch.tensor(cams), torch.tensor(probs), None, None)
    frames = np.asarray([[1, 3], [7, 0], [9, 4]])
    got = tpred.argmax_multiplex_camera(t, torch.tensor(frames), scale_lr_decay=0.07).numpy()
    want = np.asarray(jpred.argmax_multiplex_camera(j, jnp.asarray(frames), 0.07))
    np.testing.assert_allclose(got, want, atol=1e-6)
    sel = np.argmax(probs[frames.reshape(-1)], axis=1)  # numpy's argmax: first maximum
    np.testing.assert_allclose(got[:, 1:3], cams[sel, frames.reshape(-1), 1:3], atol=0)


# ------------------------------------------------------------------ the TTO

@functools.lru_cache(maxsize=None)
def _templates():
    return jbuild_template(**TEMPLATE), ttemplate.build_template(**TEMPLATE)


def _mods(lib, template, **extra):
    cfg = lib.Config(model=dataclasses.replace(
        lib.ModelConfig(), img_size=IMG, num_lbs=6, num_kps=0, texture=False, symmetric=False,
        symmetric_texture=False))
    return types.SimpleNamespace(template=template, cfg=cfg, **extra)


@functools.lru_cache(maxsize=None)
def _scene(T: int):
    """Inputs shared by both sides: 2 clips of T frames (BT = 2T views), GT
    masks rendered from the template deformed by known handle offsets under
    cameras that turn a little per frame, random edt maps and boundary
    points, the refined handle offsets starting at zero, a smooth flow field
    (clip_flows layout) for T=2."""
    jt, _ = _templates()
    BT = 2 * T
    rng = np.random.default_rng(20 + T)
    mean_shape = (np.asarray(jt.verts) * 0.5).astype(np.float32)
    lbs = np.asarray(jsolve.lbs_from_logits(jnp.asarray(jt.lbs_logits)))
    q = _unit(np.asarray([1.0, 0.0, 0.0, 0.0]) + 0.15 * rng.normal(size=(BT, 4)))
    cams = np.concatenate([rng.uniform(0.9, 1.1, (BT, 1)), rng.uniform(-0.05, 0.05, (BT, 2)),
                           q], -1).astype(np.float32)
    gt_delta = (rng.normal(size=(BT, 6, 3)) * 0.1).astype(np.float32)
    faces = jnp.asarray(jt.faces)
    gt_v = jsolve.screened_poisson_solve(jnp.asarray(mean_shape), jnp.asarray(lbs),
                                         jnp.asarray(gt_delta),
                                         jmesh.cot_laplacian(jnp.asarray(mean_shape), faces))
    proj = jcam.orthographic_proj_withz(gt_v, jnp.asarray(cams), offset_z=0.0)
    gt_mask = (np.asarray(jras.soft_silhouette(proj, faces, IMG, face_chunk=80)[0]) > 0.5)
    bounds = rng.uniform(-0.7, 0.7, (BT, 24, 3)).astype(np.float32)
    bounds[..., 2] = rng.random((BT, 24)) > 0.25
    batch = {"mask": gt_mask.astype(np.float32),
             "edt": rng.random((BT, IMG, IMG)).astype(np.float32),
             "boundaries": bounds}
    if T > 1:
        yy, xx = np.mgrid[:IMG, :IMG] / IMG * 2 - 1
        flows = np.zeros((2, T, IMG, IMG, 2), np.float32)
        flows[:, :-1] = np.stack([1.5 + np.sin(2 * xx + 1) + 0.5 * yy,
                                  -0.5 + np.cos(3 * yy) * 0.8], -1)
        batch["optical_flows"] = flows
    delta0 = np.zeros((BT, 6, 3), np.float32)
    return mean_shape, lbs, delta0, cams, batch


def _run_both(tto_kw, T=1, trace=False):
    jt, tt = _templates()
    mean_shape, lbs, delta0, cams, batch = _scene(T)
    vert2kp = None
    if trace:
        logits = np.random.default_rng(9).normal(size=(3, jt.verts.shape[0]))
        vert2kp = np.asarray(jax.nn.softmax(jnp.asarray(logits, jnp.float32), axis=1))
    tto_j = jpred.TTOConfig(**tto_kw)
    tto_t = tpred.TTOConfig(**tto_kw)
    fn_j = jpred.make_tto_step_fn(_mods(jcfg, jt), tto_j, num_frames=T, face_chunk=80,
                                  trace_vert2kp=None if vert2kp is None else jnp.asarray(vert2kp))
    fn_t = tpred.make_tto_step_fn(_mods(tcfg, tt, device="cpu"), tto_t, num_frames=T,
                                  trace_vert2kp=None if vert2kp is None else torch.tensor(vert2kp))
    out_j = fn_j(jnp.asarray(mean_shape), jnp.asarray(lbs), jnp.asarray(delta0),
                 jnp.asarray(cams), {k: jnp.asarray(v) for k, v in batch.items()})
    out_t = fn_t(torch.tensor(mean_shape), torch.tensor(lbs), torch.tensor(delta0),
                 torch.tensor(cams), {k: torch.tensor(v) for k, v in batch.items()})
    return out_j, out_t


TTO_CASES = {
    "delta": dict(num_iter=5, lr=2e-2, of_wt=0.0),
    "camera": dict(num_iter=5, lr=2e-2, of_wt=0.0, optimize_camera=True),
    "flow": dict(num_iter=5, lr=2e-2, of_wt=1.0),
}


@pytest.mark.parametrize("case", list(TTO_CASES))
def test_tto_matches_jax(case):
    """make_tto_step_fn against JAX's for 5 Adam steps: over delta_v_res
    alone, with the camera (the decoded camera returned, |q| = 1), and with
    the flow term on a T=2 batch with flows (its hard-rasterized
    visibility): final_loss rtol 1e-3, pred_v and the camera within vector
    relative error TTO_REL."""
    T = 2 if case == "flow" else 1
    (v_j, cam_j, loss_j), (v_t, cam_t, loss_t) = _run_both(TTO_CASES[case], T=T)
    np.testing.assert_allclose(float(loss_t), float(loss_j), **_tol("total_loss"))
    assert _rel(v_t.numpy(), v_j) <= TTO_REL, _rel(v_t.numpy(), v_j)
    assert _rel(cam_t.numpy(), cam_j) <= TTO_REL, _rel(cam_t.numpy(), cam_j)
    delta = _scene(T)[2]
    v0 = np.asarray(jsolve.screened_poisson_solve(
        jnp.asarray(_scene(T)[0]), jnp.asarray(_scene(T)[1]), jnp.asarray(delta),
        jmesh.cot_laplacian(jnp.asarray(_scene(T)[0]), jnp.asarray(_templates()[0].faces))))
    assert _rel(v_t.numpy(), v0) > 100 * TTO_REL  # the steps moved the mesh
    if case == "camera":
        np.testing.assert_allclose(np.linalg.norm(cam_t[:, 3:].numpy(), axis=-1), 1.0,
                                   atol=1e-6)
        assert _rel(cam_t.numpy(), _scene(T)[3]) > 100 * TTO_REL


def test_tto_trace_matches_jax():
    """The trace mode (camera optimized, flow term on): per-iteration loss
    rtol 1e-3, IoU within one pixel's share of the union, keypoints and
    cameras within TTO_REL per iteration, and the same final result."""
    (v_j, cam_j, loss_j, tr_j), (v_t, cam_t, loss_t, tr_t) = _run_both(
        dict(TTO_CASES["camera"], of_wt=1.0), T=2, trace=True)
    n = TTO_CASES["camera"]["num_iter"]
    assert tr_t["loss"].shape == (n,) and tr_t["iou"].shape == (n, 4)
    assert tr_t["kp_pred"].shape == (n, 4, 3, 2) and tr_t["cam"].shape == (n, 4, 7)
    np.testing.assert_allclose(tr_t["loss"].numpy(), np.asarray(tr_j["loss"]),
                               **_tol("total_loss"))
    np.testing.assert_allclose(tr_t["iou"].numpy(), np.asarray(tr_j["iou"]), atol=2.0 / 100)
    for i in range(n):
        assert _rel(tr_t["kp_pred"][i].numpy(), tr_j["kp_pred"][i]) <= TTO_REL, i
        assert _rel(tr_t["cam"][i].numpy(), tr_j["cam"][i]) <= TTO_REL, i
    np.testing.assert_allclose(float(loss_t), float(loss_j), **_tol("total_loss"))
    assert _rel(v_t.numpy(), v_j) <= TTO_REL
    assert _rel(cam_t.numpy(), cam_j) <= TTO_REL


def test_tto_factors_once_and_reduces_loss(monkeypatch):
    """The port's own check, 30 steps of lr 2e-2 as
    tests/test_eval_ckpt.py::test_tto_reduces_loss runs JAX's: the final
    loss below the loss at zero offsets (a 0-step refine), and with the
    camera optimized a decoded camera (|q| = 1 within 1e-6). The system
    matrix is factored once per call (one cholesky_ex, no cholesky)
    however many steps run."""
    _, tt = _templates()
    mean_shape, lbs, delta0, cams, batch = _scene(1)
    mods = _mods(tcfg, tt, device="cpu")
    args = (torch.tensor(mean_shape), torch.tensor(lbs), torch.tensor(delta0),
            torch.tensor(cams), {k: torch.tensor(v) for k, v in batch.items()})
    calls = []
    real = torch.linalg.cholesky_ex
    monkeypatch.setattr(torch.linalg, "cholesky_ex",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(torch.linalg, "cholesky", None)
    kw = dict(lr=2e-2, of_wt=0.0, edt_wt=0.0, bdt_wt=0.0)
    loss0 = float(tpred.make_tto_step_fn(mods, tpred.TTOConfig(num_iter=0, **kw), 1)(*args)[2])
    _, _, loss = tpred.make_tto_step_fn(mods, tpred.TTOConfig(num_iter=30, **kw), 1)(*args)
    assert calls == [1, 1]
    assert float(loss) < loss0, (float(loss), loss0)
    _, cam, loss_c = tpred.make_tto_step_fn(
        mods, tpred.TTOConfig(num_iter=30, optimize_camera=True, **kw), 1)(*args)
    assert float(loss_c) < loss0
    np.testing.assert_allclose(np.linalg.norm(cam[:, 3:].numpy(), axis=-1), 1.0, atol=1e-6)
