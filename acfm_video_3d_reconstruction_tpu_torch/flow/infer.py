"""Frozen optical-flow inference for the multiframe trainer and the flow CLI.

Counterpart of acfm_video_3d_reconstruction_tpu/flow/infer.py (reference
multiframe/main.py:385-411, set_input's no-grad MaskFlownet pass): resize
the frame pair to 384x768, centralize (subtract the pair's mean RGB), run
the net, Upsample(pred[-1], 4), resize back to the training resolution.

The conventions are the JAX package's (its module docstring gives the
reasons): the net emits (dy, dx); these functions emit (dx, dy), each
rescaled to output pixels. Layouts are the JAX package's too: images in as
(B, H, W, 3) or (B, T, H, W, 3), flows out as (B, [T,] H, W, 2). `net` is
a flow.maskflownet.MaskFlownet (see `build`); inputs go to its device.

make_flow_fn's function, the multiframe trainer's and TTO's flow pass, runs
`clip_flows` through utils/graphs.py: on clips already on a CUDA device the
pass (~4,800 small kernels) is replayed as a CUDA graph, bit-equal to the
eager pass. `clip_flows`, `predict_pair_flow` and the flow CLI's
`predict_flow_native` stay eager.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import graphs, tracing
from . import maskflownet as mfn
from . import ops

NET_H, NET_W = 384, 768


@functools.lru_cache(maxsize=None)
def _resize_weights(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """(n_in, n_out) weights of jax.image.resize(..., "bilinear") along one
    axis (antialias=True, its default: a triangle kernel widened by the
    shrink factor when shrinking), in the f32 arithmetic XLA's CPU backend
    gives jax._src.image.scale.compute_weight_mat (scale = n_out / n_in, no
    translation): the sample positions as one FMA, (i + 0.5) * inv_scale -
    0.5, and the division by the kernel scale as a multiplication by its
    reciprocal. Sample positions reach n_in in f32, so a separately rounded
    product moves a weight by up to ~1e-5. Built once per (sizes, device)
    and shared: callers must not write to it. Kept for the process: a
    captured flow graph (make_flow_fn) reads it by its address."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    centres = np.arange(n_out, dtype=f32) + f32(0.5)
    # exact f32 x f32 product in f64, one rounding to f32: the FMA
    sample_f = (centres.astype(np.float64) * float(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) * (f32(1.0) / kernel_scale)
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    w = np.where(inside[None, :], w, f32(0.0)).astype(f32)
    return torch.from_numpy(w).to(device)


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """jax.image.resize(x, ..., "bilinear") for x (B, C, H, W) -> (B, C, *size):
    one weight matrix per axis whose size changes, applied as a matmul."""
    h, w = size
    if x.shape[2] != h:
        x = torch.matmul(_resize_weights(x.shape[2], h, x.device).t(), x)
    if x.shape[3] != w:
        x = torch.matmul(x, _resize_weights(x.shape[3], w, x.device))
    return x


def centralize(im0: torch.Tensor, im1: torch.Tensor):
    """Subtract the pair's mean RGB (reference main.py:413-417); NCHW."""
    rgb_mean = torch.cat([im0, im1], dim=2).mean(dim=(2, 3), keepdim=True)
    return im0 - rgb_mean, im1 - rgb_mean


def _device(net: mfn.MaskFlownet) -> torch.device:
    return next(net.parameters()).device


def _nchw(images, device) -> torch.Tensor:
    """(B, H, W, 3) images (array or tensor) -> f32 (B, 3, H, W) on device."""
    images = torch.as_tensor(images, dtype=torch.float32, device=device)
    return images.permute(0, 3, 1, 2).contiguous()


def _flow_out(up: torch.Tensor, h_scale: float, w_scale: float, size) -> torch.Tensor:
    """Net-resolution (dy, dx) flow (B, 2, nh, nw) -> (dx, dy) rescaled per
    axis, resized to `size`, (B, h, w, 2)."""
    flow = torch.stack([up[:, 1] * w_scale, up[:, 0] * h_scale], dim=1)
    return resize_bilinear(flow, size).permute(0, 2, 3, 1)


@torch.no_grad()
def predict_pair_flow(net: mfn.MaskFlownet, im0, im1, out_size: int,
                      net_hw: tuple[int, int] = (NET_H, NET_W)) -> torch.Tensor:
    """im0/im1 (B, H, W, 3) in [0, 1] -> flow (B, out, out, 2).

    Output channels are (dx, dy) in out_size-pixel units. net_hw must be
    divisible by 64; the reference runs at (384, 768).
    """
    nh, nw = net_hw
    dev = _device(net)
    im0c, im1c = centralize(resize_bilinear(_nchw(im0, dev), net_hw),
                            resize_bilinear(_nchw(im1, dev), net_hw))
    preds, _ = net(im0c, im1c)
    up = ops.upsample2d_flow(preds[-1], 4)  # (B, 2, nh, nw) = (dy, dx)
    return _flow_out(up, out_size / nh, out_size / nw, (out_size, out_size))


def clip_flows(net: mfn.MaskFlownet, imgs, image_size: int,
               net_hw: tuple[int, int] = (NET_H, NET_W)) -> torch.Tensor:
    """Batch of clips (B, T, H, W, 3) -> (B, T, S, S, 2).

    Slot t holds flow(frame t -> frame t+1) for every consecutive pair; the
    last slot is zero. All T-1 pairs run as one batched net call.
    """
    imgs = torch.as_tensor(imgs, dtype=torch.float32, device=_device(net))
    B, T, H, W = imgs.shape[:4]
    S = image_size
    if T < 2:
        return imgs.new_zeros((B, T, S, S, 2))
    im0 = imgs[:, :-1].reshape(B * (T - 1), H, W, 3)
    im1 = imgs[:, 1:].reshape(B * (T - 1), H, W, 3)
    flow = predict_pair_flow(net, im0, im1, S, net_hw).reshape(B, T - 1, S, S, 2)
    return torch.cat([flow, flow.new_zeros((B, 1, S, S, 2))], dim=1)


@torch.no_grad()
def predict_flow_native(net: mfn.MaskFlownet, im0, im1) -> torch.Tensor:
    """Native-resolution flow for benchmark evaluation (AEPE).

    Reference predict.py:74-93: centralize, stretch to the next size
    divisible by 64 (the reference 'pads' by bilinear interpolation), run
    the net, Upsample x4, stretch back with a per-axis vector rescale.
    im0/im1 (B, H, W, 3) -> (B, H, W, 2), channels (dx, dy) in pixels.
    """
    dev = _device(net)
    im0, im1 = _nchw(im0, dev), _nchw(im1, dev)
    H, W = im0.shape[2:]
    nh = -(-H // 64) * 64
    nw = -(-W // 64) * 64
    im0c, im1c = centralize(im0, im1)
    preds, _ = net(resize_bilinear(im0c, (nh, nw)), resize_bilinear(im1c, (nh, nw)))
    up = ops.upsample2d_flow(preds[-1], 4)  # (B, 2, nh, nw) = (dy, dx)
    return _flow_out(up, H / nh, W / nw, (H, W))


def shift_flows_for_loss(flows: torch.Tensor) -> torch.Tensor:
    """clip_flows layout -> loss layout: slot t+1 = flow(t -> t+1), slot 0
    zero. Equals the reference's flip along T for T=2 (main.py:648)."""
    return torch.cat([torch.zeros_like(flows[:, :1]), flows[:, :-1]], dim=1)


def _reference_names(sd, prefix: str, names) -> dict:
    """The port's '<name>.weight' / '.bias' for each module name found in a
    reference state dict under prefix + '<name>.0.weight' (conv + activation
    Sequentials) or prefix + '<name>.weight' (bare modules); a missing bias
    is zero."""
    out = {}
    for name in names:
        for suffix in (f"{name}.0.weight", f"{name}.weight"):
            key = prefix + suffix
            if key in sd:
                w = torch.as_tensor(sd[key], dtype=torch.float32)
                bkey = key[:-len("weight")] + "bias"
                b = sd.get(bkey)
                nbias = w.shape[1] if name.startswith("upfeat") else w.shape[0]
                out[f"{prefix}{name}.weight"] = w
                out[f"{prefix}{name}.bias"] = (torch.zeros(nbias) if b is None else
                                               torch.as_tensor(b, dtype=torch.float32))
                break
    return out


def load_flow_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A reference-format torch MaskFlownet checkpoint -> a state_dict of
    flow.maskflownet.MaskFlownet (multiframe/main.py:203-214 loads the same
    file). Names map as the JAX package's convert_torch_state_dict maps
    them: '<name>.0.weight' or '<name>.weight', stage 1 under
    'MaskFlownet_S.'; a checkpoint of MaskFlownet_S alone (no prefix) gives
    the stage-1 entries only. The layouts are torch's already. The file is
    read with weights_only=True: a state dict, not a pickled module."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    with torch.device("meta"):
        net = mfn.MaskFlownet()
    s_names = [n for n, _ in net.MaskFlownet_S.named_children()]
    m_names = [n for n, _ in net.named_children() if n != "MaskFlownet_S"]
    out = _reference_names(sd, "MaskFlownet_S.", s_names)
    if not out:  # a checkpoint of MaskFlownet_S alone
        return {f"MaskFlownet_S.{k}": v for k, v in _reference_names(sd, "", s_names).items()}
    out.update(_reference_names(sd, "", m_names))
    return out


def graph_signature(net: mfn.MaskFlownet, imgs: torch.Tensor, image_size: int, net_hw) -> tuple:
    """(the clips' shape, dtype and device and the sizes, the net's
    parameters and buffers): make_flow_fn's part of its graphs' signature."""
    own = tuple(imgs.shape), str(imgs.dtype), str(imgs.device), image_size, tuple(net_hw)
    return own, graphs.read_tensors(net)


def make_flow_fn(net: mfn.MaskFlownet, image_size: int,
                 net_hw: tuple[int, int] = (NET_H, NET_W)):
    """Batch preprocessor: attach batch['optical_flows'] from a frozen
    MaskFlownet pass over every consecutive frame pair (reference set_input,
    multiframe/main.py:385-411), in the span `flow.infer`.

    On clips that are a CUDA tensor, `clip_flows` is replayed as a CUDA
    graph (utils/graphs.py; counters `flow.*`) on a static input that each
    call's clips are copied into, device to device: one launch for the
    pass's thousands, so the prefetch thread that runs it leaves the host to
    the step. A net keeps its graphs across the trainer's epochs."""

    def flow_fn(batch: dict) -> dict:
        with tracing.span("flow.infer"):
            imgs = batch["img"]
            flows = graphs.run(
                "flow", net, imgs.device if torch.is_tensor(imgs) else torch.device("cpu"),
                lambda: graph_signature(net, imgs, image_size, net_hw),
                eager=lambda: clip_flows(net, imgs, image_size, net_hw),
                static=lambda: torch.empty(imgs.shape, dtype=torch.float32, device=imgs.device),
                load=lambda inputs: inputs.copy_(imgs),
                fn=lambda inputs: clip_flows(net, inputs, image_size, net_hw))
            return dict(batch, optical_flows=flows)

    return flow_fn
