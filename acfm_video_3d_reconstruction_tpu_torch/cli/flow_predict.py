"""Standalone optical-flow inference / evaluation CLI.

Counterpart of acfm_video_3d_reconstruction_tpu/cli/flow_predict.py, with
the same flags (parsed by argparse) plus --device. Reference
multiframe/data/optical_flow/predict_pair.py / predict.py: load a
MaskFlownet checkpoint, run a frame pair (centralize -> stretch to /64 ->
net -> Upsample x4 -> stretch back), report AEPE if ground truth is given,
save a color visualization. With --dataset, loops a Chairs/Sintel/KITTI
split and prints the mean AEPE like predict.py:62-97.

Usage:
  python -m acfm_video_3d_reconstruction_tpu_torch.cli.flow_predict \\
      --im0 a.png --im1 b.png --checkpoint weights.pth [--gt flow.flo] \\
      --out flow_vis.png
  python -m acfm_video_3d_reconstruction_tpu_torch.cli.flow_predict \\
      --dataset sintel --root <MPI-Sintel> --split valid \\
      --checkpoint weights.pth
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..flow import flowlib, infer
from ..flow import maskflownet as mfn


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--im0", default="", help="first frame")
    ap.add_argument("--im1", default="", help="second frame")
    ap.add_argument("--checkpoint", default="", help="torch MaskFlownet checkpoint (.pth)")
    ap.add_argument("--gt", default="", help="optional GT .flo for AEPE")
    ap.add_argument("--out", default="flow_vis.png", help="output visualization png")
    ap.add_argument("--dataset", default="", help="chairs | sintel | kitti (AEPE eval)")
    ap.add_argument("--root", default="", help="dataset root directory")
    ap.add_argument("--split", default="valid", help="dataset split")
    ap.add_argument("--subset", default="final", help="sintel pass (clean/final)")
    ap.add_argument("--max_samples", type=int, default=0, help="cap evaluated samples (0 = all)")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    return ap.parse_args(argv)


def load_image(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path)).astype(np.float32)[..., :3] / 255.0


def load_net(args) -> mfn.MaskFlownet:
    if args.checkpoint:
        sd = infer.load_flow_checkpoint(args.checkpoint)
    else:
        print("warning: no checkpoint; running random-init net")
        sd = mfn.init_params(torch.Generator().manual_seed(0))
    return mfn.build(sd, args.device)


def _flow(net, im0: np.ndarray, im1: np.ndarray) -> np.ndarray:
    return infer.predict_flow_native(net, im0[None], im1[None])[0].cpu().numpy()


def eval_dataset(net, args):
    """Dataset AEPE loop (reference predict.py:62-97)."""
    from ..flow import datasets as fds

    if args.dataset == "chairs":
        ds = fds.ChairsDataset(args.root, split=args.split)
    elif args.dataset == "sintel":
        ds = fds.SintelDataset(args.root, split=args.split, subset=args.subset)
    elif args.dataset == "kitti":
        ds = fds.KITTIDataset(args.root, split=args.split)
    else:
        raise ValueError(args.dataset)
    n = len(ds) if args.max_samples == 0 else min(len(ds), args.max_samples)
    epes = []
    for i in range(n):
        s = ds[i]
        gt = s["flow"]
        if gt is None:
            continue
        epe = np.sqrt(((_flow(net, s["im0"], s["im1"]) - gt[..., :2]) ** 2).sum(-1))
        if s["mask"] is not None:
            epe = epe[s["mask"] > 0]
        epes.append(epe.mean())
        if i % 20 == 0 and epes:
            print(f"{i}/{n} running AEPE {np.mean(epes):.4f}")
    if not epes:
        # e.g. --split test on KITTI/Sintel: GT flow is not distributed
        print(f"AEPE: {args.dataset} n/a (no ground-truth flow in this split)")
        return None
    print(f"AEPE: {args.dataset} {np.mean(epes):.4f} ({len(epes)} samples)")
    return float(np.mean(epes))


def main(argv=None) -> int:
    args = parse_args(argv)
    net = load_net(args)
    if args.dataset:
        eval_dataset(net, args)
        return 0

    flow = _flow(net, load_image(args.im0), load_image(args.im1))
    if args.gt:
        gt = flowlib.read_flo(args.gt)
        aepe = np.sqrt(((flow - gt[..., :2]) ** 2).sum(-1)).mean()
        print(f"AEPE: {aepe:.4f}")
    from PIL import Image

    Image.fromarray(flowlib.flow_to_image(flow)).save(args.out)
    print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
