"""Multiframe training CLI (reference multiframe/main.py compatible).

Counterpart of acfm_video_3d_reconstruction_tpu/cli/multiframe_main.py,
with argparse in place of absl and the same flag names and defaults, plus
--device (default cuda; --device cpu runs the plain kernels' versions on the
CPU). Boolean flags take `--warmup`, `--warmup=True` or `--texture=False`.
`train(o)` takes the options as a plain dict (`default_opts()` plus
changes), as the JAX CLI's does; `flow_net_hw` there sets the flow net's
input size (the reference's 384x768 by default).

Usage:
  python -m acfm_video_3d_reconstruction_tpu_torch.cli.multiframe_main \\
      --name horse_net --category horse --root_dir <TigDog_pkls> \\
      --warmup --init_camera_emb --flow_checkpoint weights/maskflownet.pth

Not ported yet, and refused with an error naming what is missing: the
PASCAL and ImageNet mixes (--expand_pascal, --expand_imgnet: data/pascal.py,
data/objects.py) and the visualisation panels (--display_freq > 0:
train/visualize.py::make_multiframe_vis_fn).
"""
from __future__ import annotations

import argparse
import dataclasses
import pickle
import sys
from types import SimpleNamespace

import numpy as np
import torch

from .. import config as cfg_lib
from ..data import tigdog as tig
from ..data.loader import DataLoader
from ..models.template import build_template
from ..train import driver
from ..utils.obj_io import load_obj
from .monocular_main import check_device, make_pretrained_loaders, str2bool

# (name, default, help): the JAX CLI's flags (multiframe_main.py:29-120)
_FLAGS = [
    ("name", "exp_name", "Experiment name"),
    ("category", "horse", "category"),
    ("root_dir", "", "TigDog/YTVIS pkl root dir"),
    ("tmp_dir", "tmp/", "frame-cache dir"),
    ("mesh_dir", "", "template mesh OBJ"),
    ("kp_dict", "", "keypoint dictionary pkl"),
    ("checkpoint_dir", "cachedir/snapshots", "checkpoints"),
    ("num_lbs", 15, "number of handles"),
    ("subdivide", 3, "icosphere subdivisions (no mesh_dir)"),
    ("num_kps", 15, "number of keypoints"),
    ("nz_feat", 200, "latent feature size"),
    ("num_training_frames", 50, "frames per video"),
    ("img_size", 256, "image size"),
    ("num_frames", 2, "clip length"),
    ("num_guesses", 8, "camera hypotheses"),
    ("batch_size", 8, "batch size"),
    ("num_epochs", 200, "epochs"),
    ("num_pretrain_epochs", 0, "resume epoch"),
    ("num_reps", 20, "pose-warmup epochs"),
    ("tex_num_reps", 20, "texture-warmup reps per batch"),
    ("learning_rate", 1e-4, "lr"),
    ("warmup_lr", 1e-2, "pose-warmup Adam lr"),
    ("texture", True, "predict texture"),
    ("warmup", False, "pose warmup"),
    ("load_warmup", False, "resume from warmup ckpt, skip warmups"),
    ("texture_warmup", False, "texture warmup"),
    ("init_camera_emb", False, "write GT cams into table 0"),
    ("drop_hypothesis", False, "hypothesis dropping"),
    ("finetune_camera", False, "switch off gtpose at epoch 30"),
    ("use_gtpose", False, "use GT poses"),
    ("az_el_cam", False, "azimuth-elevation multiplex"),
    ("az_el_quat_bias", False, "pi/4 hypothesis rotation biases (the reference builds but "
     "never applies this chain — off for strict parity)"),
    ("optimize_deform", False, "per-frame deform embeddings"),
    ("scale_mesh", False, "normalize template scale"),
    ("multistep_lr", False, "MultiStepLR([5,150], 0.1)"),
    ("separate_camera_opt", False, "separate camera Adam"),
    ("camera_learning_rate", 1e-4, "camera Adam lr"),
    ("scale_lr_decay", 0.05, "embedding scale decode lr"),
    ("scale_bias", 1.0, "az-el scale bias"),
    ("az_euler_range", 30.0, "azimuth range (deg)"),
    ("el_euler_range", 60.0, "elevation range (deg)"),
    ("cyc_euler_range", 60.0, "cyclo-rotation range (deg)"),
    ("optimize_deform_lr", 100.0, "deform embedding lr mult"),
    ("kp_loss_wt", 0.0, "keypoint loss weight"),
    ("of_loss_wt", 1.0, "optical flow loss weight"),
    ("mask_loss_wt", 1.0, "mask loss weight"),
    ("boundaries_reg_wt", 1.0, "silhouette-consistency weight"),
    ("edt_reg_wt", 0.1, "edt weight inside sil-cons"),
    ("bdt_reg_wt", 2.0, "boundary weight inside sil-cons"),
    ("rigid_wt", 0.5, "locally-rigid prior weight"),
    ("triangle_reg_wt", 0.1, "laplacian smoothing weight"),
    ("tex_loss_wt", 0.5, "texture loss weight"),
    ("cam_loss_wt", 2.0, "camera distillation weight"),
    ("deform_reg_wt", 1.0, "texture cycle weight"),
    ("deform_loss_wt", 2.0, "deform distillation weight"),
    ("handle_deform_reg_wt", 0.0, "handle offset reg weight"),
    ("log_every", 20, "logging interval"),
    ("expand_ytvis", False, "mix YTVIS clips into training"),
    ("expand_pascal", False, "mix PASCAL stills (cow)"),
    ("root_dir_yt", "", "YTVIS pkl root dir"),
    ("root_dir_coco", "", "COCO pkl root dir"),
    ("pascal_img_dir", "", "PASCAL/VOC image dir"),
    ("pascal_anno_path", "", "PASCAL CMR-style .mat annos"),
    ("expand_imgnet", False, "mix ImageNet synset stills (objects.py synset map; kp-less)"),
    ("imgnet_dir", "", "ImageNet images root (synset subdirs)"),
    ("imgnet_anno_path", "", "dir of {synset}_{split}.mat annos"),
    ("padding_frac", 0.05, "tight-bbox padding fraction"),
    ("v2_crop", False, "v2 crop (recompute kp visibility)"),
    ("save_epoch_freq", 50, "save every N epochs"),
    ("save_latest_freq", 0, "mid-epoch latest saves (steps)"),
    ("display_freq", 0, "visualization panels every N steps"),
    ("tight_bboxes", False, "use mask-derived bboxes"),
    ("mirror", True, "random horizontal mirror augmentation (disable for annotation schemas "
     "without a left/right kp permutation, e.g. synthetic parity data)"),
    ("pretrained_resnet18", "", "torchvision resnet18 .pth"),
    ("lpips_alexnet", "", "torchvision alexnet .pth"),
    ("flow_checkpoint", "", "MaskFlownet torch checkpoint"),
    ("flow_random_init", False, "run the frozen flow net with random weights (plumbing tests "
     "only)"),
    ("device", "cuda", "torch device (cuda, or cpu for the plain kernels' versions)"),
]


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for name, default, doc in _FLAGS:
        if isinstance(default, bool):
            ap.add_argument(f"--{name}", type=str2bool, nargs="?", const=True,
                            default=default, help=doc)
        else:
            ap.add_argument(f"--{name}", type=type(default), default=default, help=doc)
    return ap.parse_args(argv)


def default_opts() -> dict:
    """Flag defaults as a plain dict (for tests / programmatic use)."""
    return vars(parse([]))


def build_cfg(o: dict) -> cfg_lib.Config:
    return cfg_lib.Config(
        model=dataclasses.replace(
            cfg_lib.ModelConfig(),
            img_size=o["img_size"], nz_feat=o["nz_feat"], num_lbs=o["num_lbs"],
            subdivide=o["subdivide"], num_kps=o["num_kps"], texture=o["texture"],
            symmetric=False, symmetric_texture=False, mesh_path=o["mesh_dir"] or None,
            kp_dict_path=o["kp_dict"] or None, scale_mesh=o["scale_mesh"],
        ),
        mf_weights=dataclasses.replace(
            cfg_lib.MultiframeLossWeights(),
            kp=o["kp_loss_wt"], of=o["of_loss_wt"], mask=o["mask_loss_wt"],
            boundaries=o["boundaries_reg_wt"], edt=o["edt_reg_wt"], bdt=o["bdt_reg_wt"],
            rigid=o["rigid_wt"], triangle=o["triangle_reg_wt"], tex=o["tex_loss_wt"],
            cam=o["cam_loss_wt"], deform_reg=o["deform_reg_wt"], deform=o["deform_loss_wt"],
            handle_deform_reg=o["handle_deform_reg_wt"],
        ),
        multiplex=dataclasses.replace(
            cfg_lib.MultiplexConfig(),
            num_guesses=o["num_guesses"], az_el_cam=o["az_el_cam"],
            az_el_quat_bias=o["az_el_quat_bias"], optimize_deform=o["optimize_deform"],
            optimize_deform_lr=o["optimize_deform_lr"], drop_hypothesis=o["drop_hypothesis"],
            scale_lr_decay=o["scale_lr_decay"], scale_bias=o["scale_bias"],
            az_euler_range=o["az_euler_range"], el_euler_range=o["el_euler_range"],
            cyc_euler_range=o["cyc_euler_range"],
        ),
        train=dataclasses.replace(
            cfg_lib.TrainConfig(),
            batch_size=o["batch_size"], num_frames=o["num_frames"],
            learning_rate=o["learning_rate"], warmup_lr=o["warmup_lr"],
            num_epochs=o["num_epochs"], num_pretrain_epochs=o["num_pretrain_epochs"],
            num_reps=o["num_reps"], tex_num_reps=o["tex_num_reps"], warmup=o["warmup"],
            texture_warmup=o["texture_warmup"], use_gtpose=o["use_gtpose"],
            multistep_lr=o["multistep_lr"], separate_camera_opt=o["separate_camera_opt"],
            camera_learning_rate=o["camera_learning_rate"],
            save_epoch_freq=o["save_epoch_freq"], save_latest_freq=o["save_latest_freq"],
            display_freq=o["display_freq"], checkpoint_dir=o["checkpoint_dir"],
            name=o["name"], offset_z=0.0,
        ),
    )


def build_mf_template(cfg: cfg_lib.Config):
    m = cfg.model
    verts = faces = None
    kp_ids = None
    if m.mesh_path:
        verts, faces = load_obj(m.mesh_path)
    if m.kp_dict_path:
        with open(m.kp_dict_path, "rb") as f:
            kp_dict = pickle.load(f)
        kp_ids = [np.atleast_1d(v) for v in kp_dict.values()]
    return build_template(
        verts, faces, subdivide=m.subdivide, num_lbs=m.num_lbs, tex_size=m.tex_size,
        symmetric=False, symmetric_texture=False, num_kps=m.num_kps, kp_vertex_ids=kp_ids,
        scale_mesh=m.scale_mesh,
    )


def make_flow_fn_from_opts(o: dict, img_size: int, device="cuda"):
    """The frozen-flow batch preprocessor on `device` (None when of wt = 0)."""
    if o["of_loss_wt"] <= 0:
        return None
    from ..flow import infer as flow_infer
    from ..flow import maskflownet as mfn

    if o["flow_checkpoint"]:
        state_dict = flow_infer.load_flow_checkpoint(o["flow_checkpoint"])
    elif o["flow_random_init"]:
        state_dict = mfn.init_params(torch.Generator().manual_seed(0))
    else:
        raise ValueError(
            "of_loss_wt > 0 needs --flow_checkpoint (or --flow_random_init "
            "for plumbing tests, or --of_loss_wt=0)"
        )
    net_hw = o.get("flow_net_hw", (flow_infer.NET_H, flow_infer.NET_W))
    return flow_infer.make_flow_fn(mfn.build(state_dict, device), img_size, net_hw)


def make_pretrained_loader(o: dict):
    """The ImageNet resnet18 encoder loader per --pretrained_resnet18, or None."""
    return make_pretrained_loaders(SimpleNamespace(**o))[0]


def make_lpips_loader(o: dict):
    """The LPIPS AlexNet loader per --lpips_alexnet, or None."""
    return make_pretrained_loaders(SimpleNamespace(**o))[1]


def build_video_dataset(o: dict):
    """Video-level dataset mixing (reference multiframe/main.py:216-242):
    horse/tiger: TigDog (+ YTVIS + COCO with --expand_ytvis); other
    quadrupeds: YTVIS (+ COCO). The PASCAL and ImageNet mixes are refused:
    their data modules are not ported yet."""
    for flag, module in (("expand_pascal", "data/pascal.py"),
                         ("expand_imgnet", "data/objects.py")):
        if o.get(flag):
            raise NotImplementedError(
                f"--{flag} needs {module}, which the PyTorch port does not have yet")
    cat = o["category"]
    kps = o["num_kps"]
    parts = []
    if cat in ("horse", "tiger"):
        parts.append(tig.VideoPklDataset(o["root_dir"], cat, split="train", num_kps=kps))
        if o["expand_ytvis"]:
            parts.append(tig.YTVISPklDataset(o["root_dir_yt"], cat, num_kps=kps))
            if o["root_dir_coco"]:
                parts.append(tig.COCOPklDataset(o["root_dir_coco"], cat, num_kps=kps))
    else:
        parts.append(tig.YTVISPklDataset(o["root_dir_yt"] or o["root_dir"], cat, num_kps=kps))
    return parts[0] if len(parts) == 1 else tig.ConcatDataset(parts)


def train(o: dict):
    """Full multiframe training from an options dict; returns the modules."""
    if o["display_freq"] > 0:
        raise NotImplementedError(
            "--display_freq > 0 needs train/visualize.py::make_multiframe_vis_fn, which the "
            "PyTorch port does not have yet")
    device = check_device(SimpleNamespace(device=o.get("device", "cuda")))
    if device.type == "cuda":
        # f32 throughout: the solve's Cholesky needs full-precision matmuls
        # (deform/solve.py), and the JAX reference runs f32 convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = build_cfg(o)
    template = build_mf_template(cfg)

    video_ds = build_video_dataset(o)
    n_frames, s2v, spv = tig.explode_to_frames(
        video_ds, o["tmp_dir"], o["category"], o["num_training_frames"]
    )
    print(f"Training samples (frames): {n_frames}")

    is_tigdog = o["category"] in ("horse", "tiger")
    mk = dict(
        tmp_dir=o["tmp_dir"], category=o["category"], sample_to_vid=s2v,
        samples_per_vid=spv, num_frames=o["num_frames"], img_size=o["img_size"],
        # no-kp categories use tight mask bboxes + v2 crop
        # (reference multiframe/main.py:292-306)
        tight_bboxes=o["tight_bboxes"] or not is_tigdog,
        v2_crop=o["v2_crop"] or not is_tigdog,
        padding_frac=o["padding_frac"], remove_neck_kp=is_tigdog,
    )
    dataset = tig.MultiFrameDataset(mirror=o["mirror"], transforms=True, **mk)
    # no-aug loader for the camera-embedding init pass; TigDog uses
    # padding_frac=0 here (reference multiframe/main.py:283-290)
    mk_noag = dict(mk, padding_frac=0.0 if is_tigdog else o["padding_frac"])
    dataset_noag = tig.MultiFrameDataset(mirror=False, transforms=False, **mk_noag)
    loader = DataLoader(dataset, o["batch_size"], shuffle=True)
    loader_noag = DataLoader(dataset_noag, o["batch_size"], shuffle=False, drop_last=False)

    return driver.run_multiframe_training(
        cfg, template, loader, loader_noag, n_frames,
        init_camera_emb=o["init_camera_emb"], finetune_camera=o["finetune_camera"],
        load_warmup=o["load_warmup"], log_every=o["log_every"],
        flow_fn=make_flow_fn_from_opts(o, o["img_size"], device),
        load_pretrained=make_pretrained_loader(o), load_lpips=make_lpips_loader(o),
        device=device,
    )


def main(argv=None):
    return train(vars(parse(argv)))


if __name__ == "__main__":
    main(sys.argv[1:])
