"""MaskFlownet optical flow network (PWC-style, two stacked stages), NCHW.

Counterpart of acfm_video_3d_reconstruction_tpu/flow/maskflownet.py (and of
the reference multiframe/data/optical_flow/model/MaskFlownet.py,
MaskFlownet_S :81-381, MaskFlownet :384-657), as nn.Modules with the
reference's module names: conv1a..conv6c (stage 2: conv1x..conv6z),
conv{l}_{i}, pred_flow{l}, pred_mask{l}, upfeat{l}, deform{l}, conv{l}f,
dc_conv1-7, and stage 1 under `MaskFlownet_S.`. A reference checkpoint's
'<name>.0.weight' (conv + activation Sequentials) is '<name>.weight' here
(flow/infer.py::load_flow_checkpoint maps it); the layouts are torch's.

The net runs frozen (no gradients): `build` returns it in eval mode with
requires_grad off. Each stage runs a 6-level siamese conv pyramid; per
level a cost volume (flow/ops.correlation: the CUDA kernel on the card),
deformable-conv warping of the second image's features by the upsampled
flow, a DenseNet-style decoder predicting a flow residual (and, in stage
1, an occlusion mask), and a dilated context network on the finest level.
Flows are in channel order (dy, dx).

Both forwards run with cuDNN off: in float32 with TF32 off, cuDNN's
heuristics give some of the 384x768 pass's level-2 convolutions (many
input channels at 96x192) an FFT-tiling algorithm that launches ~150k
small kernels per 12-pair call, and the whole net takes ~5x as long as
with PyTorch's own convolution (im2col + cuBLAS SGEMM). PERF.md gives the
measurements (tools/torch_flow_conv_backends.py).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import ops

LEAK = 0.1
SCALE = 20.0  # flow units of the predictions (reference flow_multiplier 1)
PYR_CH = [16, 32, 64, 96, 128, 196]  # feature pyramid channels, levels 1-6
GROW = [128, 128, 96, 64, 32]  # densenet growth
STRIDES = [64, 32, 16, 8, 4]  # of levels 6..2
UPFEAT_CH = 16
# dc_conv1-6: (out channels, dilation); dc_conv7 predicts the flow
DC_CONVS = [(128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1)]
# the forwards' convolutions run outside cuDNN (see the docstring)
_NO_CUDNN = torch.backends.cudnn.flags(enabled=False)


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAK)


def _conv(cin: int, cout: int, stride: int = 1, dilation: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=dilation, dilation=dilation)


class DeformConv3x3(nn.Module):
    """torchvision DeformConv2d(k=3, s=1, p=1): weight (Cout, Cin, 3, 3)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
        return ops.deform_conv3x3(x, offsets, self.weight, self.bias)


class _Stage(nn.Module):
    """The modules of one stage ('s' = MaskFlownet_S, 'm' = the second
    stage), with the widths of the JAX package's _stage_shapes."""

    def __init__(self, stage: str):
        super().__init__()
        nd = 81 if stage == "s" else 25
        self.md = 4 if stage == "s" else 2
        self.letters = "abc" if stage == "s" else "xyz"
        prev = 3 if stage == "s" else 4
        for lvl, ch in enumerate(PYR_CH, start=1):
            a, b, c = self.letters
            self.add_module(f"conv{lvl}{a}", _conv(prev, ch, stride=2))
            self.add_module(f"conv{lvl}{b}", _conv(ch, ch))
            self.add_module(f"conv{lvl}{c}", _conv(ch, ch))
            prev = ch
        for lvl in (6, 5, 4, 3, 2):
            if stage == "s":
                ch_in = nd if lvl == 6 else nd + PYR_CH[lvl - 1] + UPFEAT_CH + 2
            else:
                ch_in = 2 * nd + 2 if lvl == 6 else 2 * nd + PYR_CH[lvl - 1] + UPFEAT_CH + 4
            for i, g in enumerate(GROW):
                self.add_module(f"conv{lvl}_{i}", _conv(ch_in, g))
                ch_in += g
            self.add_module(f"pred_flow{lvl}", _conv(ch_in, 2))
            if stage == "s" and lvl > 2:
                self.add_module(f"pred_mask{lvl}", _conv(ch_in, 1))
            if lvl > 2:
                self.add_module(f"upfeat{lvl - 1}",
                                nn.ConvTranspose2d(ch_in, UPFEAT_CH, 4, stride=2, padding=1))
        for i, (cout, dil) in enumerate(DC_CONVS, start=1):
            self.add_module(f"dc_conv{i}", _conv(ch_in, cout, dilation=dil))
            ch_in = cout
        self.add_module("dc_conv7", _conv(ch_in, 2))
        for lvl in ((5, 4, 3, 2) if stage == "s" else (6, 5, 4, 3, 2)):
            self.add_module(f"deform{lvl}", DeformConv3x3(PYR_CH[lvl - 1], PYR_CH[lvl - 1]))
        if stage == "s":
            for lvl in (5, 4, 3, 2):
                self.add_module(f"conv{lvl}f", _conv(UPFEAT_CH, PYR_CH[lvl - 1]))

    def pyramid(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Three convs per level (stride 2 on the first), 6 levels."""
        feats = []
        for lvl in range(1, 7):
            for letter in self.letters:
                x = _leaky(getattr(self, f"conv{lvl}{letter}")(x))
            feats.append(x)
        return feats

    def densenet(self, lvl: int, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(GROW)):
            x = torch.cat([_leaky(getattr(self, f"conv{lvl}_{i}")(x)), x], dim=1)
        return x

    def context(self, x: torch.Tensor) -> torch.Tensor:
        """The dilated context network's flow residual."""
        for i in range(1, len(DC_CONVS) + 1):
            x = _leaky(getattr(self, f"dc_conv{i}")(x))
        return self.dc_conv7(x)

    def deform_warp(self, lvl: int, feat2: torch.Tensor, flow: torch.Tensor,
                    scale_over_stride: float) -> torch.Tensor:
        """Deformable-conv warping: offsets = flow (dy, dx) for all 9 taps
        (reference MaskFlownet.py:283-288)."""
        offsets = (flow * scale_over_stride).repeat(1, 9, 1, 1)
        return getattr(self, f"deform{lvl}")(feat2, offsets)


class MaskFlownetS(_Stage):
    """Stage 1."""

    def __init__(self):
        super().__init__("s")

    @_NO_CUDNN
    def forward(self, im1: torch.Tensor, im2: torch.Tensor):
        """im1, im2 (B, 3, H, W), H and W divisible by 64.

        Returns (predictions [flow6..flow2] * SCALE, [occlusion mask],
        (c1, c2, flows, c30, c40)), the last being stage 2's inputs.
        """
        c1 = self.pyramid(im1)
        c2 = self.pyramid(im2)
        x = self.densenet(6, _leaky(ops.correlation(c1[5], c2[5], self.md)))
        flows = [self.pred_flow6(x)]
        masks = [self.pred_mask6(x)]
        for lvl in (5, 4, 3, 2):
            feat = _leaky(getattr(self, f"upfeat{lvl}")(x))
            flow = ops.upsample2d_flow(flows[-1], 2)
            mask = ops.upsample2d_flow(masks[-1], 2)
            warp = self.deform_warp(lvl, c2[lvl - 1], flow, SCALE / STRIDES[6 - lvl])
            warp = _leaky(warp * torch.sigmoid(mask) + getattr(self, f"conv{lvl}f")(feat))
            corr = _leaky(ops.correlation(c1[lvl - 1], warp, self.md))
            x = self.densenet(lvl, torch.cat([corr, c1[lvl - 1], feat, flow], dim=1))
            flows.append(flow + getattr(self, f"pred_flow{lvl}")(x))
            if lvl > 2:
                masks.append(getattr(self, f"pred_mask{lvl}")(x))
        flows[-1] = flows[-1] + self.context(x)

        predictions = [f * SCALE for f in flows]
        # mask2: the level-2 iteration's upsampled mask (the reference has
        # no pred_mask2)
        occlusion_masks = [torch.sigmoid(mask)]
        mask0 = torch.sigmoid(ops.upsample2d_flow(mask, 4)) - 0.5
        c30 = torch.cat([im1, torch.zeros_like(mask0)], dim=1)
        # the net's (dy, dx) flipped to the warp's (u, v)
        warped_im2 = ops.backward_warp(im2, ops.upsample2d_flow(flows[-1], 4).flip(1) * SCALE)
        c40 = torch.cat([warped_im2, mask0], dim=1)
        return predictions, occlusion_masks, (c1, c2, flows, c30, c40)


class MaskFlownet(_Stage):
    """The full two-stage net; stage 1 is the submodule `MaskFlownet_S`."""

    def __init__(self):
        super().__init__("m")
        self.MaskFlownet_S = MaskFlownetS()

    @_NO_CUDNN
    def forward(self, im1: torch.Tensor, im2: torch.Tensor):
        """im1, im2 (B, 3, H, W) -> (predictions [flow6..flow2] * SCALE,
        [the finest flow's dy channel])."""
        _, _, (c1, c2, flows1, c30, c40) = self.MaskFlownet_S(im1, im2)
        c3 = self.pyramid(c30)
        c4 = self.pyramid(c40)

        flow6 = flows1[0]
        warp6u = _leaky(self.deform_warp(6, c2[5], flow6, SCALE / STRIDES[0]))
        corr6u = _leaky(ops.correlation(c1[5], warp6u, self.md))
        corr6v = _leaky(ops.correlation(c3[5], c4[5], self.md))
        x = self.densenet(6, torch.cat([corr6u, corr6v, flow6], dim=1))
        flows = [flow6 + self.pred_flow6(x)]
        for lvl in (5, 4, 3, 2):
            i = 6 - lvl
            feat = _leaky(getattr(self, f"upfeat{lvl}")(x))
            flow = ops.upsample2d_flow(flows[-1], 2)
            warpu = _leaky(self.deform_warp(lvl, c2[lvl - 1], flow, SCALE / STRIDES[i]))
            corru = _leaky(ops.correlation(c1[lvl - 1], warpu, self.md))
            corrv = _leaky(ops.correlation(c3[lvl - 1], c4[lvl - 1], self.md))
            x = self.densenet(lvl, torch.cat(
                [c1[lvl - 1], feat, corru, corrv, flow, flows1[i]], dim=1))
            flows.append(flow + getattr(self, f"pred_flow{lvl}")(x))
        flows[-1] = flows[-1] + self.context(x)
        return [f * SCALE for f in flows], [flows[-1][:, :1]]


def init_params(generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Random weights for MaskFlownet as a state_dict: kaiming fan-in normal
    (std sqrt(2 / fan_in), fan_in = kh * kw * input channels), zero biases,
    as the JAX package's init_params draws them (with other numbers)."""
    net = MaskFlownet()
    sd = {}
    for name, t in net.state_dict().items():
        if name.endswith(".bias"):
            sd[name] = torch.zeros_like(t)
            continue
        # Conv2d (O, I, kh, kw); ConvTranspose2d (I, O, kh, kw): its input is dim 0
        cin = t.shape[0] if ".upfeat" in f".{name}" else t.shape[1]
        std = math.sqrt(2.0 / (cin * t.shape[2] * t.shape[3]))
        sd[name] = torch.randn(t.shape, generator=generator) * std
    return sd


def build(state_dict: dict[str, torch.Tensor], device="cuda") -> MaskFlownet:
    """The frozen net (eval mode, no gradients) with `state_dict`, on
    `device`."""
    net = MaskFlownet()
    net.load_state_dict(state_dict)
    return net.to(device).eval().requires_grad_(False)
