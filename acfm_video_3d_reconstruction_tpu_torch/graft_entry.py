"""Entry points: a forward loss of the flagship model, and a multi-rank dry
run of the full multiframe train step.

Counterpart of the repo's __graft_entry__.py (`entry`, `dryrun_multichip`),
at its shapes and with its numpy batches. Both run on the card unless the
caller passes device="cpu".

    python -m acfm_video_3d_reconstruction_tpu_torch.graft_entry [--device cpu] [--ranks N]
"""
from __future__ import annotations

import argparse
import dataclasses
import math

import numpy as np
import torch

from . import config as cfg_lib
from .models.template import build_template


def _build_small(img_size=64, batch=2, subdivide=2, num_lbs=6, num_kps=4, texture=True,
                 device="cuda"):
    """The monocular model at __graft_entry__.py::_build_small's shapes."""
    from .train import monocular

    template = build_template(subdivide=subdivide, num_lbs=num_lbs, tex_size=2, num_kps=num_kps)
    cfg = cfg_lib.Config(
        model=dataclasses.replace(
            cfg_lib.ModelConfig(), img_size=img_size, nz_feat=64, num_lbs=num_lbs,
            num_kps=num_kps, tex_size=2, texture=texture, symmetric=False,
            symmetric_texture=False,
        ),
        train=dataclasses.replace(cfg_lib.TrainConfig(), batch_size=batch),
    )
    mods = monocular.build(cfg, template, seed=0, device=device)
    return mods, template, cfg


def _fake_batch(rng, batch, img_size, num_kps, n_boundary=64) -> dict:
    """__graft_entry__.py::_fake_batch's arrays, drawn in its order."""
    return {
        "img": rng.random((batch, img_size, img_size, 3), np.float32),
        "mask": (rng.random((batch, img_size, img_size)) > 0.5).astype(np.float32),
        "kp": rng.random((batch, num_kps, 3), np.float32),
        "sfm_pose": np.tile(np.asarray([0.8, 0, 0, 1, 0, 0, 0], np.float32), (batch, 1)),
        "edt": rng.random((batch, img_size, img_size), np.float32),
        "boundaries": rng.random((batch, n_boundary, 3), np.float32),
    }


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass device='cpu')")
    return device


def entry(device="cuda"):
    """(fn, args): fn(*args) -> (total_loss, metrics), the monocular forward
    (eval mode) on the small model and a seeded batch; args = (modules,
    batch on the device)."""
    from .train import monocular

    device = _check_device(device)
    mods, _, cfg = _build_small(device=device)
    rng = np.random.default_rng(0)
    batch = monocular.to_device_batch(
        mods, _fake_batch(rng, cfg.train.batch_size, cfg.model.img_size, cfg.model.num_kps))

    def fwd(mods, batch):
        with torch.no_grad():
            loss, aux = monocular.forward(mods, batch, train=False)
        return loss, aux["metrics"]

    return fwd, (mods, batch)


# __graft_entry__.py::dryrun_multichip's shapes
DRY_IMG, DRY_LBS, DRY_T, DRY_G = 48, 6, 2, 2


def dryrun_batch(B: int) -> dict:
    """__graft_entry__.py::dryrun_multichip's batch of B clips (numpy)."""
    rng = np.random.default_rng(0)
    H, T = DRY_IMG, DRY_T
    return {
        "img": rng.random((B, T, H, H, 3), np.float32),
        "mask": (rng.random((B, T, H, H)) > 0.5).astype(np.float32),
        "kp": rng.random((B, T, 1, 3), np.float32),
        "sfm_pose": np.tile(np.asarray([0.8, 0, 0, 1, 0, 0, 0], np.float32), (B, T, 1)),
        "frames_idx": np.arange(B * T, dtype=np.int32).reshape(B, T),
        "mirror_flag": np.zeros((B, T), np.int32),
        "transforms": np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (B, T, 1)),
        "optical_flows": np.zeros((B, T, H, H, 2), np.float32),
        "edt": rng.random((B * T, H, H)).astype(np.float32),
        "bdt": rng.random((B * T, H, H)).astype(np.float32),
        "boundaries": rng.random((B * T, 32, 3)).astype(np.float32),
    }


def dryrun_step(device, B: int) -> float:
    """One full multiframe train step (k = G, deform tables trained) at the
    dry run's shapes on `device`, over the process group when there is one
    (each rank takes its block of the B clips). Returns the global
    total_loss."""
    from .parallel import mesh as pmesh
    from .train import multiframe as mf

    template = build_template(subdivide=1, num_lbs=DRY_LBS, tex_size=2, num_kps=0)
    cfg = cfg_lib.Config(
        model=dataclasses.replace(
            cfg_lib.ModelConfig(), img_size=DRY_IMG, nz_feat=32, num_lbs=DRY_LBS,
            num_kps=0, tex_size=2, texture=False, symmetric=False, symmetric_texture=False,
        ),
        multiplex=dataclasses.replace(cfg_lib.MultiplexConfig(), num_guesses=DRY_G),
        train=dataclasses.replace(cfg_lib.TrainConfig(), batch_size=B, num_frames=DRY_T,
                                  offset_z=0.0),
        mf_weights=dataclasses.replace(cfg_lib.MultiframeLossWeights(), kp=0.0),
    )
    mods = mf.build(cfg, template, B * DRY_T * 2, seed=0, device=device)
    step = mf.make_train_step(mods, k=DRY_G, drop_deform=False)
    metrics = step(mf.to_device_batch(mods, pmesh.shard_batch(dryrun_batch(B))))
    return float(metrics["total_loss"])


def dryrun_multichip(n_devices: int, device="cuda", timeout_s: float = 600.0) -> float:
    """The full multiframe train step over n ranks, one clip a rank (B = n):
    NCCL over n cards, or gloo processes on the CPU with device="cpu". On
    fewer than n cards it refuses (NCCL puts one rank on each card).
    Prints `dryrun_multichip(n) ok: total_loss=...` and returns the loss."""
    from .parallel.ranks import Ranks

    device = _check_device(device)
    if device.type == "cuda":
        have = torch.cuda.device_count()
        if have < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} CUDA devices "
                               f"for NCCL (one rank a card), found {have}")
        devices, backend = [f"cuda:{r}" for r in range(n_devices)], "nccl"
    else:
        devices, backend = ["cpu"] * n_devices, "gloo"
    losses = Ranks(dryrun_step, devices, backend, args=(n_devices,), timeout_s=timeout_s).run()
    loss = losses[0]
    if not (math.isfinite(loss) and all(x == loss for x in losses)):
        raise RuntimeError(f"dryrun_multichip({n_devices}): total_loss per rank {losses}")
    print(f"dryrun_multichip({n_devices}) ok: total_loss={loss:.4f}")
    return loss


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ranks", type=int, default=0,
                    help="ranks of the dry run (default: every card, or 2 on the CPU)")
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device)
    print("entry loss:", float(fn(*fargs)[0]))
    n = args.ranks or (torch.cuda.device_count() if args.device.startswith("cuda") else 2)
    dryrun_multichip(n, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
