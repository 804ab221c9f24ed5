"""Mini-TigDog multiframe quality-parity run of the PyTorch port.

Counterpart of tools/mini_tigdog_parity.py (the JAX package's tool), with
its constants, its generator's numpy draws in the same order, its training
options and its evaluation plan. It writes a mini-TigDog pkl tree (per-video
pkls {video, segmentations, bboxes, landmarks, sfm_poses} under horse/, the
reference's tigdog_final.py layout with its deterministic 14-video test
split) of Lambertian-shaded synthetic quadruped clips with known GT cameras
and deformations, rendered through the port (the solve, the projection,
one soft rasterization for the masks and one hard rasterization for the
shading per video); then trains the multiframe CLI's `train` in-process
(warm-up and main loop on the camera multiplex, --of_loss_wt 0, so no
MaskFlownet weights are needed) and runs the evaluate CLI once per column,
each in a subprocess, parsing `mean iou ..., pck.1 ..., pck.15 ...`.

    python3 tools/torch_mini_tigdog_parity.py [--epochs 40] [--out FILE]
        [--root DIR] [--device cuda|cpu]

Runs on the card unless --device cpu, and exits without a card otherwise.
Prints the results table, and writes it to --out when given (rewritten
after every column; never DEMO_RESULTS.md, the JAX tool's file). Writes
nothing outside --root and --out.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

TOOLS = osp.dirname(osp.abspath(__file__))
REPO = osp.dirname(TOOLS)
sys.path.insert(0, REPO)
sys.path.insert(0, TOOLS)

from torch_train_synthetic_demo import card_name  # noqa: E402

from acfm_video_3d_reconstruction_tpu_torch.cli import multiframe_evaluate as mfe  # noqa: E402
from acfm_video_3d_reconstruction_tpu_torch.data import image_utils  # noqa: E402
from acfm_video_3d_reconstruction_tpu_torch.deform.solve import (  # noqa: E402
    lbs_from_logits,
    screened_poisson_solve,
)
from acfm_video_3d_reconstruction_tpu_torch.geometry import camera as cam_utils  # noqa: E402
from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer as ras  # noqa: E402
from acfm_video_3d_reconstruction_tpu_torch.ops import rasterizer_cuda as rc  # noqa: E402

# the JAX tool's constants (tools/mini_tigdog_parity.py)
RAW = 144          # raw frame size written into the pkls
IMG = 128          # training/eval crop size
N_VIDEOS = 60      # > 14 so the deterministic split keeps 14 test videos
T_RAW = 6          # frames per video
NUM_KPS = 8
NUM_LBS = 12
ANCHORS = np.random.default_rng(11).choice(642, NUM_KPS, replace=False)
LIGHT = (0.45, -0.35, 0.82)
EVAL_MODULE = "acfm_video_3d_reconstruction_tpu_torch.cli.multiframe_evaluate"


def build_template(tex_size: int = 2):
    """The tools' template: subdivide 3 (642 vertices, 1280 faces), NUM_LBS
    handles, NUM_KPS keypoints anchored at ANCHORS."""
    from acfm_video_3d_reconstruction_tpu_torch.models.template import build_template as build

    return build(subdivide=3, num_lbs=NUM_LBS, tex_size=tex_size, num_kps=NUM_KPS,
                 kp_vertex_ids=[np.asarray([a]) for a in ANCHORS])


def deformed_meshes(template, deforms, device):
    """The template deformed by handle offsets (N, NUM_LBS, 3): lbs and the
    screened-Poisson solve, on `device` -> (N, V, 3)."""
    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)

    A = lbs_from_logits(f32(template.lbs_logits))
    return screened_poisson_solve(f32(template.verts), A, f32(deforms),
                                  f32(template.uniform_L))


def face_shades(proj, faces):
    """Per-face Lambertian shade of projected meshes (N, V, 3): 0.35 + 0.65 *
    clip(n . light, 0, 1), n the face's camera-space unit normal turned
    toward the camera -> (N, F). The dot product is written out (no matmul,
    so TF32 cannot touch it)."""
    tri = proj[:, faces]                              # (N, F, 3, 3)
    n = torch.linalg.cross(tri[..., 1, :] - tri[..., 0, :],
                           tri[..., 2, :] - tri[..., 0, :], dim=-1)
    n = n * torch.where(n[..., 2:] < 0, -1.0, 1.0)   # face the camera
    n = n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-8)
    dot = n[..., 0] * LIGHT[0] + n[..., 1] * LIGHT[1] + n[..., 2] * LIGHT[2]
    return 0.35 + 0.65 * torch.clamp(dot, 0.0, 1.0)


def shaded_render(proj, faces, size: int):
    """Masks and shading of projected meshes (N, V, 3) at size^2: the soft
    silhouette thresholded at 0.5, and per pixel the face_shades of the hard
    z-buffer's front face, 0 off the mesh. Two launches on the card: one
    soft, one hard. Returns numpy (masks (N, size, size) f32, shades (N,
    size, size) f32, pix_to_face (N, size*size) int32)."""
    N = proj.shape[0]
    with torch.no_grad():
        soft, _ = ras.soft_silhouette(proj, faces, size)
        frag = ras.hard_rasterize(proj, faces, size)
        shade_f = face_shades(proj, faces)
        p2f = frag.pix_to_face.reshape(N, -1)           # (N, H, W) -> (N, P)
        covered = p2f >= 0
        shade = torch.gather(shade_f, 1, torch.where(covered, p2f, 0).long())
        shade = torch.where(covered, shade, 0.0)
    masks = (soft > 0.5).float().cpu().numpy()
    return (masks, shade.cpu().numpy().reshape(N, size, size),
            p2f.cpu().numpy())


def bin_overflow(proj, faces, size: int) -> int:
    """The most faces any bin drops at the rasterizer's capacity (auto_K)."""
    K = rc.auto_K(faces.shape[0], size, ras.DEFAULT_K)
    return int(rc.bin_overflow_counts(proj, faces, size, K).max())


def generate(root, template, device="cuda", videos=None):
    """Render synthetic clips into the TigDog pkl schema, as the JAX tool's
    generate does: `sfm_poses` are [-1, 1] weak-perspective cameras in the
    square-bbox crop frame, `landmarks` and `bboxes` raw-frame pixels. The
    frames are Lambertian-shaded (shaded_render) over a noise background.

    Per video the numpy draws of the JAX tool in its order: ang0, dang,
    scale, trans, base_deform, ddeform, then the background and the colour.
    `videos` (default N_VIDEOS) writes the first videos of the full tree.
    Returns {"videos", "overflow" (the most faces a bin dropped),
    "pix_to_face" (per video (T_RAW, RAW*RAW) int32)}."""
    device = torch.device(device)
    rng = np.random.default_rng(7)
    if osp.isdir(root):
        shutil.rmtree(root)
    cat_dir = osp.join(root, "horse")
    os.makedirs(cat_dir, exist_ok=True)
    faces = torch.as_tensor(template.faces, dtype=torch.long, device=device)
    anchors = torch.as_tensor(ANCHORS, dtype=torch.long, device=device)
    n_videos = N_VIDEOS if videos is None else videos
    overflow, p2fs = 0, []

    for vid in range(n_videos):
        # smooth camera path + slowly-varying articulation across the clip
        ang0 = rng.uniform(-0.7, 0.7)
        dang = rng.uniform(-0.06, 0.06)
        scale = rng.uniform(0.35, 0.45)
        trans = rng.uniform(-0.12, 0.12, 2)
        base_deform = rng.normal(size=(NUM_LBS, 3)) * 0.05
        ddeform = rng.normal(size=(NUM_LBS, 3)) * 0.01

        cams = np.zeros((T_RAW, 7), np.float32)
        deforms = np.zeros((T_RAW, NUM_LBS, 3), np.float32)
        for t in range(T_RAW):
            a = ang0 + dang * t
            cams[t] = [scale, trans[0], trans[1],
                       np.cos(a / 2), 0.0, np.sin(a / 2), 0.0]
            deforms[t] = base_deform + ddeform * t

        with torch.no_grad():
            pred_v = deformed_meshes(template, deforms, device)
            tcams = torch.as_tensor(cams, device=device)
            proj = cam_utils.orthographic_proj_withz(pred_v, tcams, offset_z=0.0)
            kp_ndc = cam_utils.project_points(pred_v[:, anchors], tcams).cpu().numpy()
        overflow = max(overflow, bin_overflow(proj, faces, RAW))
        mask, shade, p2f = shaded_render(proj, faces, RAW)
        p2fs.append(p2f)

        video = rng.uniform(0.0, 0.15, (T_RAW, RAW, RAW, 3)).astype(np.float32)
        color = rng.uniform(0.4, 0.9, 3).astype(np.float32)
        lit = mask * np.maximum(shade, 0.35 * mask)
        video = video * (1 - mask[..., None]) + lit[..., None] * color
        video = np.clip(video, 0, 1)

        # landmarks: anchor vertices projected to RAW pixel coords
        kp_px = (kp_ndc + 1.0) * 0.5 * (RAW - 1)
        vis = (
            (kp_px[..., 0] >= 0) & (kp_px[..., 0] < RAW)
            & (kp_px[..., 1] >= 0) & (kp_px[..., 1] < RAW)
        ).astype(np.float64)
        landmarks = np.concatenate([kp_px, vis[..., None]], -1)

        ys, xs = np.nonzero(mask.max(0))
        bbox = np.asarray(
            [xs.min() - 4, ys.min() - 4, xs.max() + 4, ys.max() + 4], np.float64
        )
        # the cameras in the square-crop frame the loader produces:
        # raw-NDC -> crop-NDC for the square_bbox at (x0, y0) with side S
        sq = image_utils.square_bbox(bbox)
        x0, y0, S = sq[0], sq[1], sq[2] - sq[0] + 1
        crop_cams = cams.copy()
        r = (RAW - 1) / S
        crop_cams[:, 0] = cams[:, 0] * r
        crop_cams[:, 1] = (cams[:, 1] + 1.0) * r - 2.0 * x0 / S - 1.0
        crop_cams[:, 2] = (cams[:, 2] + 1.0) * r - 2.0 * y0 / S - 1.0
        with open(osp.join(cat_dir, f"video_{vid:03d}.pkl"), "wb") as f:
            pickle.dump(
                {
                    "video": video,
                    "segmentations": mask,
                    "bboxes": np.tile(bbox, (T_RAW, 1)),
                    "landmarks": landmarks,
                    "sfm_poses": crop_cams.astype(np.float64),
                },
                f,
            )
    print(f"wrote {n_videos} videos to {cat_dir} (bin overflow max {overflow})", flush=True)
    return {"videos": n_videos, "overflow": overflow, "pix_to_face": p2fs}


def train_opts(root, epochs, guesses=4, device="cuda"):
    """The JAX tool's training options (multiframe_main.default_opts()
    plus its changes) for a tree under `root`."""
    from acfm_video_3d_reconstruction_tpu_torch.cli import multiframe_main

    o = multiframe_main.default_opts()
    o.update(
        name="mini_tigdog", category="horse", root_dir=root,
        tmp_dir=osp.join(root, "cache"), checkpoint_dir=osp.join(root, "snapshots"),
        img_size=IMG, num_lbs=NUM_LBS, subdivide=3, num_kps=NUM_KPS, num_frames=2,
        num_guesses=guesses, batch_size=4, num_epochs=epochs, num_training_frames=1000,
        num_reps=2, texture=False, of_loss_wt=0.0, kp_loss_wt=30.0, mask_loss_wt=5.0,
        warmup=True, init_camera_emb=True,
        # the synthetic anchors have no left/right-symmetric layout, so the
        # mirror's keypoint permutation cannot apply
        mirror=False, log_every=20, save_epoch_freq=max(epochs, 1), save_latest_freq=200,
        device=str(device),
    )
    return o


# the JAX tool's evaluation plan, in its order: (key, label, extra flags);
# `iters` stands for --num_optim_iter's value
PLAN = [
    ("after", "trained", []),
    ("gtcam_al", "held-out, gauge-aligned GT camera", ["--use_gt_camera", "--gauge_align"]),
    ("tto_cam", "trained + TTO(shape+camera)",
     ["--optimize", "--optimize_camera", "--num_optim_iter", "iters"]),
    ("tto", "trained + TTO", ["--optimize", "--num_optim_iter", "iters"]),
    ("train_argmax", "train split (argmax multiplex)", ["--split", "train",
                                                         "--use_argmax_camera"]),
    ("gtcam", "held-out, GT camera (diagnostic)", ["--use_gt_camera"]),
    ("train_reg", "train split (regressed cam)", ["--split", "train"]),
]


def plan_flags(key, num_optim_iter):
    """The extra evaluate flags of PLAN's column `key`."""
    extra = next(e for k, _, e in PLAN if k == key)
    return [str(num_optim_iter) if x == "iters" else x for x in extra]


def eval_argv(o, extra):
    """The evaluate CLI's arguments for training options `o` plus `extra`."""
    return [
        "--name", o["name"], "--category", "horse",
        "--root_dir", o["root_dir"], "--tmp_dir", o["tmp_dir"],
        "--checkpoint_dir", o["checkpoint_dir"],
        "--img_size", str(IMG), "--num_lbs", str(NUM_LBS),
        "--num_kps", str(NUM_KPS), "--num_frames", "2",
        "--num_guesses", str(o["num_guesses"]), "--batch_size", "4",
        "--num_training_frames", "1000",
        "--texture=False", "--of_loss_wt", "0",
        "--results_dir", osp.join(o["tmp_dir"], "eval"),
        "--device", o["device"],
    ] + list(extra)


def eval_opts(o, extra) -> dict:
    """eval_argv's options as the evaluate CLI parses them: what
    multiframe_evaluate.evaluate takes in-process."""
    return vars(mfe.parse(eval_argv(o, extra)))


METRICS_RE = re.compile(
    r"mean iou ([0-9.eE+-]+|nan), pck\.1 ([0-9.eE+-]+|nan), pck\.15 ([0-9.eE+-]+|nan)")


def parse_metrics(text: str) -> dict:
    """The last `mean iou ..., pck.1 ..., pck.15 ...` line of the evaluate
    CLI's output."""
    found = METRICS_RE.findall(text)
    if not found:
        raise RuntimeError("evaluate CLI did not print metrics:\n" + text[-4000:])
    iou, p1, p15 = found[-1]
    return {"mean_iou": float(iou), "pck_0.1": float(p1), "pck_0.15": float(p15)}


def run_eval(o, extra) -> dict:
    """The evaluate CLI in a subprocess (this checkout's package first on
    its path); its metrics line parsed."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    out = subprocess.run([sys.executable, "-m", EVAL_MODULE] + eval_argv(o, extra),
                         capture_output=True, text=True, env=env)
    text = out.stdout + out.stderr
    if out.returncode:
        raise RuntimeError(f"evaluate CLI exited {out.returncode}:\n" + text[-4000:])
    return parse_metrics(text)


def format_table(args, before, res, dt, where, partial=False) -> str:
    """The JAX tool's 8-column table (nan -> 'n/a' for pending columns)."""

    def cell(d, k):
        v = d[k]
        return "n/a" if v != v else f"{v:.3f}"

    rows = []
    for label, k in (("mean mask IoU", "mean_iou"), ("PCK@0.1", "pck_0.1"),
                     ("PCK@0.15", "pck_0.15")):
        rows.append(
            f"| {label} | {cell(before, k)} | {cell(res['after'], k)} "
            f"| {cell(res['tto'], k)} | {cell(res['tto_cam'], k)} "
            f"| {cell(res['train_argmax'], k)} | {cell(res['train_reg'], k)} "
            f"| {cell(res['gtcam'], k)} | {cell(res['gtcam_al'], k)} |"
        )
    head = (
        "\n## Mini-TigDog multiframe parity run, PyTorch port "
        "(tools/torch_mini_tigdog_parity.py)"
        + (" — PARTIAL (evaluations still running)" if partial else "") + "\n\n"
        f"On {where}. {N_VIDEOS} synthetic videos of {T_RAW} frames at {RAW}^2 in the "
        "TigDog per-video pkl schema (deterministic 14-video test split) -> camera-multiplex "
        f"warm-up + {args.epochs} epochs (batch 4 clips x 2 frames, {IMG}^2, "
        f"{args.guesses} hypotheses, --of_loss_wt 0, --texture=False) -> the evaluate CLI "
        "(frame-0 IoU, pixel PCK), with and without test-time optimization "
        f"({args.num_optim_iter} iterations).\n\n"
        "| metric | random init | trained | trained + TTO | + TTO(shape+camera) "
        "| train split (argmax mpx) | train split (regressed cam) "
        "| held-out, GT camera (diagnostic) | held-out, gauge-aligned GT camera |\n"
        "|---|---|---|---|---|---|---|---|---|\n"
    )
    return head + "\n".join(rows) + f"\n\ntrain wall-clock {dt:.1f}s.\n"


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--root", default=osp.join(tempfile.gettempdir(), "mini_tigdog"))
    ap.add_argument("--out", default=None, help="also write the results table here")
    ap.add_argument("--num_optim_iter", type=int, default=60)
    ap.add_argument("--videos", type=int, default=0,
                    help="override N_VIDEOS (>14 keeps the 14-video test split)")
    ap.add_argument("--img", type=int, default=0,
                    help="override the crop size (the raw frames scale with it)")
    ap.add_argument("--guesses", type=int, default=4, help="camera hypotheses")
    ap.add_argument("--skip_train", action="store_true",
                    help="reuse the tree and the trained checkpoint under --root")
    ap.add_argument("--skip_gen", action="store_true",
                    help="reuse the tree under --root, train from scratch")
    ap.add_argument("--skip_before", action="store_true",
                    help="skip the random-init column")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    global N_VIDEOS, IMG, RAW
    args = parse(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: no CUDA device (pass --device cpu)")
        # the solve's f32 normal equations (deform/solve.py)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    # PyTorch's compile cache (the optimizers touch it) under --root, not TMPDIR
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", osp.join(args.root, "torchinductor"))
    if args.videos:
        N_VIDEOS = args.videos
    if args.img:
        RAW = round(args.img * RAW / IMG)
        IMG = args.img
    from acfm_video_3d_reconstruction_tpu_torch.cli import multiframe_main

    if not args.skip_train and not args.skip_gen:
        print("generating mini-TigDog ...", flush=True)
        generate(args.root, build_template(), device)
    o = train_opts(args.root, args.epochs, args.guesses, device)
    where = card_name(device)

    nan = {"mean_iou": float("nan"), "pck_0.1": float("nan"), "pck_0.15": float("nan")}
    before, dt = dict(nan), 0.0
    if not args.skip_train:
        if not args.skip_before:
            before = run_eval(o, [])
            print("before (random init):", before, flush=True)
        t0 = time.perf_counter()
        multiframe_main.train(o)
        dt = time.perf_counter() - t0
        print(f"trained {args.epochs} epochs in {dt:.1f}s", flush=True)

    res = {key: dict(nan) for key, _, _ in PLAN}
    for key, label, _ in PLAN:
        res[key] = run_eval(o, plan_flags(key, args.num_optim_iter))
        print(f"{label}: {res[key]}", flush=True)
        if args.out:
            with open(args.out, "w") as fh:
                fh.write(format_table(args, before, res, dt, where, partial=True))
    text = format_table(args, before, res, dt, where)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
