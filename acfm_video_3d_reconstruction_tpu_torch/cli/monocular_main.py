"""Monocular training CLI (reference monocular/main.py compatible).

Counterpart of acfm_video_3d_reconstruction_tpu/cli/monocular_main.py, with
argparse in place of absl and the same flag names and defaults, plus
--device (default cuda; --device cpu runs the plain rasterizer on the CPU).
Boolean flags take `--texture`, `--texture=True` or `--texture=False`.

Usage:
  python -m acfm_video_3d_reconstruction_tpu_torch.cli.monocular_main \\
      --name bird_net --cub_dir <CUB_200_2011> --cub_cache_dir <cachedir/cub> \\
      --num_lbs 16 --batch_size 12
"""
from __future__ import annotations

import argparse
import dataclasses
import pickle
import sys

import numpy as np
import torch

from .. import config as cfg_lib
from ..data.cub import CUBDataset, load_sfm_mean_shape
from ..data.loader import DataLoader
from ..models.template import build_template
from ..parallel import mesh as pmesh
from ..train import driver
from ..utils.obj_io import load_obj


def str2bool(v: str) -> bool:
    """absl's boolean spellings: true/false, 1/0 (any case)."""
    s = str(v).lower()
    if s in ("true", "1"):
        return True
    if s in ("false", "0"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {v}")


def add_flags(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The JAX CLI's flags (monocular_main.py:24-63), then --device."""
    def flag(name, default, doc):
        if isinstance(default, bool):
            ap.add_argument(f"--{name}", type=str2bool, nargs="?", const=True,
                            default=default, help=doc)
        else:
            ap.add_argument(f"--{name}", type=type(default), default=default, help=doc)

    flag("name", "exp_name", "Experiment name")
    flag("cub_dir", "misc/CUB_200_2011", "CUB data dir")
    flag("cub_cache_dir", "misc/cachedir/cub", "CUB cache dir")
    flag("mesh_dir", "", "template mesh OBJ (default: icosphere)")
    flag("kp_dict", "", "keypoint->vertex dictionary pkl")
    flag("checkpoint_dir", "cachedir/snapshots", "checkpoints")
    flag("num_lbs", 15, "number of LBS handles")
    flag("num_kps", 15, "number of keypoints")
    flag("batch_size", 12, "batch size")
    flag("img_size", 256, "image size")
    flag("num_epochs", 500, "epochs")
    flag("num_pretrain_epochs", 0, "resume epoch")
    flag("learning_rate", 1e-4, "lr")
    flag("texture", True, "predict texture")
    flag("symmetric", True, "symmetric mesh")
    flag("use_gtpose", True, "use GT sfm pose for projection")
    flag("split", "train", "data split")
    flag("nz_feat", 200, "latent feature size")
    flag("tex_size", 6, "texture atlas resolution per face")
    flag("save_epoch_freq", 50, "save every N epochs")
    flag("kp_loss_wt", 30.0, "keypoint loss weight")
    flag("mask_loss_wt", 1.0, "mask loss weight")
    flag("cam_loss_wt", 2.0, "camera loss weight")
    flag("boundaries_reg_wt", 1.0, "silhouette-consistency weight")
    flag("edt_reg_wt", 0.1, "edt weight inside sil-cons")
    flag("bdt_reg_wt", 0.1, "boundary weight inside sil-cons")
    flag("tex_loss_wt", 0.5, "texture loss weight")
    flag("rigid_wt", 0.5, "locally-rigid prior weight")
    flag("triangle_reg_wt", 30.0, "laplacian smoothing weight")
    flag("deform_reg_wt", 10.0, "deformation L2 reg weight")
    flag("vert2kp_loss_wt", 0.16, "vertex-assignment reg weight")
    flag("tex_dt_loss_wt", 0.5, "texture dt loss weight")
    flag("entropy_lbs_loss_wt", 0.0016, "vert2kp entropy reg weight")
    flag("log_every", 20, "steps between scalar logs")
    flag("save_latest_freq", 0, "mid-epoch latest saves (steps)")
    flag("display_freq", 0, "visualization panels every N steps")
    # pretrained weights (reference: ImageNet resnet18 encoder
    # monocular/nnutils/mesh_net.py:87-95, LPIPS AlexNet loss_utils.py:361-363)
    flag("pretrained_resnet18", "", "torchvision resnet18 .pth")
    flag("lpips_alexnet", "", "torchvision alexnet .pth")
    flag("device", "cuda", "torch device (cuda, or cpu for the plain rasterizer)")
    return ap


def check_device(args) -> torch.device:
    """The run's device; a CUDA device must exist unless --device cpu."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device (pass --device cpu)")
    return device


def build_cfg(args) -> cfg_lib.Config:
    return cfg_lib.Config(
        model=dataclasses.replace(
            cfg_lib.ModelConfig(),
            img_size=args.img_size,
            nz_feat=args.nz_feat,
            tex_size=args.tex_size,
            num_lbs=args.num_lbs,
            num_kps=args.num_kps,
            texture=args.texture,
            symmetric=args.symmetric,
            symmetric_texture=args.symmetric,
            mesh_path=args.mesh_dir or None,
            kp_dict_path=args.kp_dict or None,
        ),
        mono_weights=dataclasses.replace(
            cfg_lib.MonocularLossWeights(),
            kp=args.kp_loss_wt, mask=args.mask_loss_wt,
            cam=args.cam_loss_wt, boundaries=args.boundaries_reg_wt,
            edt=args.edt_reg_wt, bdt=args.bdt_reg_wt,
            tex=args.tex_loss_wt, rigid=args.rigid_wt,
            triangle=args.triangle_reg_wt,
            deform_reg=args.deform_reg_wt, vert2kp=args.vert2kp_loss_wt,
            tex_dt=args.tex_dt_loss_wt, entropy_lbs=args.entropy_lbs_loss_wt,
        ),
        train=dataclasses.replace(
            cfg_lib.TrainConfig(),
            batch_size=args.batch_size,
            learning_rate=args.learning_rate,
            num_epochs=args.num_epochs,
            num_pretrain_epochs=args.num_pretrain_epochs,
            use_gtpose=args.use_gtpose,
            save_epoch_freq=args.save_epoch_freq,
            save_latest_freq=args.save_latest_freq,
            display_freq=args.display_freq,
            checkpoint_dir=args.checkpoint_dir,
            name=args.name,
        ),
    )


def make_pretrained_loaders(args):
    """(load_pretrained, load_lpips) per the flags, or Nones: each loads a
    torchvision checkpoint into the built module."""
    from ..models import torch_import

    load_pretrained = load_lpips = None
    if args.pretrained_resnet18:
        def load_pretrained(model):  # noqa: F811
            if not torch_import.maybe_load_pretrained_encoder(model, args.pretrained_resnet18):
                raise FileNotFoundError(args.pretrained_resnet18)

    if args.lpips_alexnet:
        def load_lpips(lpips):  # noqa: F811
            sd = torch_import.load_torch_state_dict(args.lpips_alexnet)
            torch_import.load_checked(lpips, torch_import.convert_alexnet_features(sd),
                                      require_all=True)

    return load_pretrained, load_lpips


def build_cub_template(cfg: cfg_lib.Config, args):
    """Template from mesh OBJ + kp dict, or icosphere + SfM mean shape.

    (reference monocular/main.py:78-99)
    """
    m = cfg.model
    verts = faces = None
    kp_ids = None
    sfm_kp = None
    if m.mesh_path:
        verts, faces = load_obj(m.mesh_path)
    if m.kp_dict_path:
        with open(m.kp_dict_path, "rb") as f:
            kp_dict = pickle.load(f)
        kp_ids = [np.atleast_1d(v) for v in kp_dict.values()]
    else:
        try:
            S, _ = load_sfm_mean_shape(args.cub_cache_dir, args.split)
            sfm_kp = S
        except (OSError, KeyError, ValueError):
            sfm_kp = None
    return build_template(
        verts, faces,
        subdivide=m.subdivide, num_lbs=m.num_lbs, tex_size=m.tex_size,
        symmetric=m.symmetric and verts is None,
        symmetric_texture=m.symmetric_texture and verts is None,
        num_kps=m.num_kps, kp_vertex_ids=kp_ids, sfm_kp_points=sfm_kp,
    )


def train(cfg: cfg_lib.Config, template, dataset, args):
    """The training run of `main` on a built dataset: returns (mods, opt).
    Under torchrun every rank joins the group (parallel/mesh.py::
    init_from_env) and trains on its block of each global batch."""
    device = pmesh.init_from_env(check_device(args))
    loader = DataLoader(dataset, args.batch_size, shuffle=True)
    load_pretrained, load_lpips = make_pretrained_loaders(args)
    return driver.run_monocular_training(
        cfg, template, loader, log_every=args.log_every,
        load_pretrained=load_pretrained, load_lpips=load_lpips, device=device,
    )


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    return add_flags(ap).parse_args(argv)


def main(argv=None):
    args = parse(argv)
    cfg = build_cfg(args)
    template = build_cub_template(cfg, args)
    dataset = CUBDataset(
        args.cub_dir, args.cub_cache_dir, split=args.split, img_size=args.img_size,
    )
    try:
        return train(cfg, template, dataset, args)
    finally:
        pmesh.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
