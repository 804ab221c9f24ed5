"""Mini-CUB monocular quality-parity run of the PyTorch port.

Counterpart of tools/mini_cub_parity.py (the JAX package's tool), with its
constants, its generator's numpy draws, its configuration and its loop. It
writes a mini-CUB in the reference's annotation schema (images/ PNGs,
cache/data/<split>_cub_cleaned.mat with rel_path / mask / bbox / one-indexed
parts, cache/sfm/anno_<split>.mat with scale / trans / rot, S and conv_tri)
of Lambertian-shaded synthetic birds with known GT cameras and
deformations, rendered through the port (the solve, the projection, a soft
rasterization for the masks and a hard one for the shading); then trains
the monocular model on it through CUBDataset -> DataLoader ->
train/monocular.py::make_train_step and evaluates the held-out split
through the predicted camera (make_eval_step, eval/metrics.py), as the JAX
tool's own loop does.

    python3 tools/torch_mini_cub_parity.py [--steps 3000] [--n_train 512]
        [--out FILE] [--root DIR] [--device cuda|cpu]

Runs on the card unless --device cpu, and exits without a card otherwise.
Prints the results table, and writes it to --out when given (never
DEMO_RESULTS.md, the JAX tool's file). Writes nothing outside --root and
--out. `run_parity` holds the loop; tests and chip_smoke.py call it.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import os.path as osp
import sys
import tempfile
import time

import numpy as np
import scipy.io as sio
import torch

TOOLS = osp.dirname(osp.abspath(__file__))
sys.path.insert(0, osp.dirname(TOOLS))
sys.path.insert(0, TOOLS)

import torch_mini_tigdog_parity as tig  # noqa: E402

from acfm_video_3d_reconstruction_tpu_torch import config as cfg_lib  # noqa: E402
from acfm_video_3d_reconstruction_tpu_torch.geometry import camera as cam_utils  # noqa: E402

# the JAX tool's constants (tools/mini_cub_parity.py)
RAW = 192          # raw image size written to disk
IMG = 128          # training crop size
N_TRAIN = 512      # the recorded JAX run's split
N_TEST = 24
GEN_CHUNK = 64     # frames per rasterization (any grouping renders the same)
NUM_KPS = 8
NUM_LBS = 12
ANCHORS = np.random.default_rng(11).choice(642, NUM_KPS, replace=False)
BATCH = 8
LOG_EVERY = 50


def quaternion_matrix(q):
    w, x, y, z = q
    return np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def draw(n):
    """The JAX tool's numpy draws for n images, in its order: GT cameras in
    the RAW frame (N, 7) f32 and handle offsets (N, NUM_LBS, 3) f32."""
    rng = np.random.default_rng(7)
    cams = np.zeros((n, 7), np.float32)
    ang = rng.uniform(-0.7, 0.7, n)
    cams[:, 0] = rng.uniform(0.35, 0.45, n)
    cams[:, 1:3] = rng.uniform(-0.15, 0.15, (n, 2))
    cams[:, 3] = np.cos(ang / 2)
    cams[:, 5] = np.sin(ang / 2)
    deform = (rng.normal(size=(n, NUM_LBS, 3)) * 0.1).astype(np.float32)
    return cams, deform


def render(template, cams, deform, device="cuda", chunk=None):
    """The birds at RAW^2 on `device`: the solve, the projection (offset_z
    5), then tig.shaded_render per `chunk` frames (default GEN_CHUNK; one
    soft and one hard launch each on the card). Returns numpy {"masks" (N,
    RAW, RAW) f32, "shades" (N, RAW, RAW) f32, "kp_px" (N, K, 2) f32 (pixels
    of the raw frame), "S" (3, K) f32 (the first image's keypoint
    vertices), "overflow" (the most faces a bin dropped)}."""
    device = torch.device(device)
    chunk = chunk or GEN_CHUNK
    faces = torch.as_tensor(template.faces, dtype=torch.long, device=device)
    anchors = torch.as_tensor(ANCHORS, dtype=torch.long, device=device)
    with torch.no_grad():
        pred_v = tig.deformed_meshes(template, deform, device)
        tcams = torch.as_tensor(cams, device=device)
        proj = cam_utils.orthographic_proj_withz(pred_v, tcams, offset_z=5.0)
        kp2d = cam_utils.project_points(pred_v[:, anchors], tcams).cpu().numpy()
        S = pred_v[0, anchors].cpu().numpy().T
    masks, shades, overflow = [], [], 0
    for c0 in range(0, len(cams), chunk):
        pj = proj[c0:c0 + chunk]
        overflow = max(overflow, tig.bin_overflow(pj, faces, RAW))
        m, sh, _ = tig.shaded_render(pj, faces, RAW)
        masks.append(m)
        shades.append(sh)
    return {"masks": np.concatenate(masks), "shades": np.concatenate(shades),
            "kp_px": (kp2d + 1.0) / 2.0 * RAW, "S": S, "overflow": overflow}


def image_record(i, split, j, r, cams):
    """Image i of the render `r` as the JAX tool writes it, the j-th of its
    split: (rel_path, the RGB image uint8, mask uint8, one-indexed bbox
    dict, parts (3, K), the sfm entry (scale, trans, rot))."""
    m, sh = r["masks"][i], r["shades"][i]
    gx = np.linspace(0, 1, RAW, dtype=np.float32)
    img = np.stack([sh * 0.9, sh * 0.55 + 0.25 * m * gx[None, :], m * 0.5], axis=-1)
    rel = f"{split}_{j:03d}.png"
    ys, xs = np.nonzero(m > 0.5)
    pad = 6
    # one-indexed bbox (the reference schema subtracts 1 on load)
    bbox = {
        "x1": float(max(xs.min() - pad, 0) + 1),
        "y1": float(max(ys.min() - pad, 0) + 1),
        "x2": float(min(xs.max() + pad, RAW - 1) + 1),
        "y2": float(min(ys.max() + pad, RAW - 1) + 1),
    }
    parts = np.concatenate(
        [r["kp_px"][i].T + 1.0, np.ones((1, NUM_KPS))], axis=0
    )  # (3, K) one-indexed, all visible
    # pixel-frame weak-perspective camera of the raw image
    s_px = RAW / 2.0 * cams[i, 0]
    t_px = RAW * (cams[i, 1:3] + 1.0) / 2.0
    sfm = (np.asarray([s_px]), t_px.astype(np.float64), quaternion_matrix(cams[i, 3:7]))
    return rel, (img * 255).astype(np.uint8), m.astype(np.uint8), bbox, parts, sfm


def generate(root, template, n_train=None, n_test=None, device="cuda"):
    """Render synthetic birds into the reference CUB annotation layout, as
    the JAX tool's generate does (n_train / n_test default to N_TRAIN /
    N_TEST). Returns (the handle offsets, the keypoint vertices), as
    there."""
    import cv2

    n_train = N_TRAIN if n_train is None else n_train
    n_test = N_TEST if n_test is None else n_test
    N = n_train + n_test
    cams, deform = draw(N)
    r = render(template, cams, deform, device)
    for d in ("images", osp.join("cache", "data"), osp.join("cache", "sfm")):
        os.makedirs(osp.join(root, d), exist_ok=True)

    splits = {"train": range(n_train), "test": range(n_train, N)}
    for split, ids in splits.items():
        dt = np.dtype([("rel_path", "O"), ("mask", "O"), ("bbox", "O"), ("parts", "O")])
        images = np.zeros((len(ids),), dt)
        sdt = np.dtype([("scale", "O"), ("trans", "O"), ("rot", "O")])
        sfm = np.zeros((images.shape[0],), sdt)
        for j, i in enumerate(ids):
            rel, img, m, bbox, parts, cam = image_record(i, split, j, r, cams)
            cv2.imwrite(osp.join(root, "images", rel), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            images[j] = (rel, m, bbox, parts)
            sfm[j] = cam
        sio.savemat(osp.join(root, "cache", "data", f"{split}_cub_cleaned.mat"),
                    {"images": images})
        sio.savemat(osp.join(root, "cache", "sfm", f"anno_{split}.mat"),
                    {"sfm_anno": sfm, "S": r["S"].T, "conv_tri": np.ones((1, 3))})
    print(f"wrote {n_train} + {n_test} images to {root} (bin overflow max {r['overflow']})",
          flush=True)
    return deform, ANCHORS


def build(device, img, batch):
    """The JAX tool's model and configuration: nz_feat 128, tex 4, texture
    on, bf16 nets, GT pose to train, lr 3e-4, mask weight 5, triangle 0.3;
    the model from seed 0. Returns (mods, eval_mods): eval_mods projects
    through the predicted camera (the reference evaluator never uses GT
    pose)."""
    from acfm_video_3d_reconstruction_tpu_torch.train import monocular

    template = tig.build_template(tex_size=4)
    cfg = cfg_lib.Config(
        model=dataclasses.replace(
            cfg_lib.ModelConfig(), img_size=img, nz_feat=128, num_lbs=NUM_LBS,
            num_kps=NUM_KPS, tex_size=4, texture=True, symmetric=False,
            symmetric_texture=False, dtype="bfloat16",
        ),
        # mask 5 balances kp 30 on synthetic data (the JAX tool's ablation)
        mono_weights=dataclasses.replace(cfg_lib.MonocularLossWeights(), triangle=0.3,
                                         mask=5.0),
        train=dataclasses.replace(cfg_lib.TrainConfig(), batch_size=batch, use_gtpose=True,
                                  learning_rate=3e-4),
    )
    mods = monocular.build(cfg, template, 0, device)
    eval_cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, use_gtpose=False))
    return mods, dataclasses.replace(mods, cfg=eval_cfg)


def loaders(root, img, batch):
    """The JAX tool's three loaders: (train (shuffled, seed 0, no mirror),
    test (padding 0.05), the train split in eval mode (no random mirror))."""
    from acfm_video_3d_reconstruction_tpu_torch.data.cub import CUBDataset
    from acfm_video_3d_reconstruction_tpu_torch.data.loader import DataLoader

    cache = osp.join(root, "cache")
    # mirror=False: the synthetic anchors have no left/right-symmetric
    # layout, so mirrored samples would carry unlearnable keypoint labels
    train_ds = CUBDataset(root, cache, split="train", img_size=img, jitter_frac=0.0,
                          mirror=False)
    train_eval_ds = CUBDataset(root, cache, split="train", img_size=img, jitter_frac=0.0)
    train_eval_ds.split = "eval"  # no random mirror
    test_ds = CUBDataset(root, cache, split="test", img_size=img, jitter_frac=0.0,
                         padding_frac=0.05)
    return (DataLoader(train_ds, batch, shuffle=True, seed=0),
            DataLoader(test_ds, batch, shuffle=False, drop_last=False),
            DataLoader(train_eval_ds, batch, shuffle=False, drop_last=False))


def evaluate(mods, eval_step, loader) -> dict:
    """BenchStats over the loader: mask IoU of the thresholded render and
    PCK of the predicted keypoints (eval/metrics.py)."""
    from acfm_video_3d_reconstruction_tpu_torch.eval import metrics as em
    from acfm_video_3d_reconstruction_tpu_torch.train import monocular

    stats = em.BenchStats()
    for b in loader:
        aux = eval_step(monocular.to_device_batch(mods, b))
        mp = (aux["mask_pred"] > 0.5).float().cpu().numpy()
        iou = em.mask_iou(np.asarray(b["mask"]), mp)
        err, vis = em.kp_errors(aux["kp_pred"].float().cpu().numpy(), np.asarray(b["kp"]))
        stats.update(iou, err, vis)
    return stats.results()


def run_parity(root, steps, device="cuda", log=print) -> dict:
    """The JAX tool's loop over the tree at `root` (IMG^2 crops, batches of
    BATCH): evaluate the random
    init on the test split, train `steps` steps over the shuffled train
    loader (epoch after epoch), evaluate on the test split and the train
    split. The loss is read every LOG_EVERY steps, as there; every step's
    loss stays on the device until the loop ends.

    Returns {before, after, after_train (BenchStats.results()), losses
    (every step's total loss), logged ([(step, loss)] every LOG_EVERY),
    seconds (the loop, host clock, ending in a synchronize on the card),
    and mods, eval_mods, train_step, eval_step, batch (the last device
    batch) for checks after the run}."""
    from acfm_video_3d_reconstruction_tpu_torch.train import monocular

    device = torch.device(device)
    mods, eval_mods = build(device, IMG, BATCH)
    loader, test_loader, train_eval_loader = loaders(root, IMG, BATCH)
    step = monocular.make_train_step(mods)
    ev = monocular.make_eval_step(eval_mods)
    before = evaluate(mods, ev, test_loader)
    log(f"before: {before}")
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    n, losses, logged, db = 0, [], [], None
    while n < steps:
        for b in loader:
            db = monocular.to_device_batch(mods, b)
            losses.append(step(db)["total_loss"])
            n += 1
            if n % LOG_EVERY == 0:
                logged.append((n, round(float(losses[-1]), 4)))
                log(f"step {n}: {logged[-1][1]}")
            if n >= steps:
                break
    sync()
    seconds = time.perf_counter() - t0
    after = evaluate(mods, ev, test_loader)
    after_train = evaluate(mods, ev, train_eval_loader)
    log(f"after (test): {after}")
    log(f"after (train-fit): {after_train}")
    return {"before": before, "after": after, "after_train": after_train,
            "losses": torch.stack(losses).float().cpu().numpy() if losses else np.zeros(0),
            "logged": logged, "seconds": seconds, "mods": mods, "eval_mods": eval_mods,
            "train_step": step, "eval_step": ev, "batch": db}


def report(res, n_train, steps, where) -> str:
    b, a, t = res["before"], res["after"], res["after_train"]
    return (
        "\n## Mini-CUB parity run, PyTorch port (tools/torch_mini_cub_parity.py)\n\n"
        f"On {where}. Monocular pipeline on a generated mini-CUB in the reference's "
        f".mat / images schema ({n_train} train / {N_TEST} held-out images at {RAW}^2): "
        f"CUBDataset -> DataLoader -> {steps} train steps (batch {BATCH}, {IMG}^2, bf16 "
        "nets, GT pose) -> held-out evaluation through the predicted camera.\n\n"
        "| metric | random init | trained |\n|---|---|---|\n"
        f"| mean mask IoU | {b['mean_iou']:.3f} | {a['mean_iou']:.3f} |\n"
        f"| PCK@0.1 | {b['pck_0.1']:.3f} | {a['pck_0.1']:.3f} |\n"
        f"| PCK@0.15 | {b['pck_0.15']:.3f} | {a['pck_0.15']:.3f} |\n\n"
        f"train-split fit after training: IoU {t['mean_iou']:.3f}, "
        f"PCK@0.1 {t['pck_0.1']:.3f}\n\n"
        f"loss trajectory (every {LOG_EVERY}): {[x for _, x in res['logged']]}\n\n"
        f"wall-clock {res['seconds']:.1f}s for the loop.\n"
    )


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--n_train", type=int, default=N_TRAIN,
                    help="training images (the held-out PCK through the predicted camera "
                    "is bound by the data: >= 512 for the recorded run)")
    ap.add_argument("--root", default=osp.join(tempfile.gettempdir(), "mini_cub"))
    ap.add_argument("--out", default=None, help="also write the results table here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
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
    print("generating mini-CUB ...", flush=True)
    generate(args.root, tig.build_template(tex_size=4), n_train=args.n_train, device=device)
    res = run_parity(args.root, args.steps, device, log=lambda m: print(m, flush=True))
    text = report(res, args.n_train, args.steps, tig.card_name(device))
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
