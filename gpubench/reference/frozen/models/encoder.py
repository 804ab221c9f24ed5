"""ResNet-18 trunk + global-code encoder (NCHW), built from torch.nn.

Counterpart of acfm_video_3d_reconstruction_tpu/models/encoder.py:
torchvision resnet18 through layer4 (stride 32), a 4x4/stride-2 conv to
256 channels, and a 2-layer FC stack to the nz_feat code. Submodule names
follow the flax module names (resnet.layer1_0.conv1, ...).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .nn_blocks import BatchNorm2d, ConvBNLeaky, FCStack


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(cout)
        self.downsample = stride != 1 or cin != cout
        if self.downsample:
            self.downsample_conv = nn.Conv2d(cin, cout, 1, stride, bias=False)
            self.downsample_bn = BatchNorm2d(cout)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.downsample else x
        return F.relu(out + identity)


class ResNet18(nn.Module):
    """torchvision resnet18 conv trunk (through layer4)."""

    stage_features = (64, 128, 256, 512)

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.block_names = []
        cin = 64
        for i, feats in enumerate(self.stage_features):
            for j in range(2):
                name = f"layer{i + 1}_{j}"
                self.add_module(name, BasicBlock(cin, feats, 2 if (i > 0 and j == 0) else 1))
                self.block_names.append(name)
                cin = feats

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x


def res_feats_side(img_size: int) -> int:
    """Spatial side of res_feats for a square input (4 at 256^2)."""
    h = (img_size - 1) // 2 + 1          # conv1 7x7/2 pad 3
    h = (h - 1) // 2 + 1                 # max pool 3x3/2 pad 1
    for _ in range(3):                   # layer2..4 stride 2
        h = (h - 1) // 2 + 1
    return (h - 2) // 2 + 1              # enc_conv1 4x4/2 pad 1


class Encoder(nn.Module):
    """ResNet trunk -> 4x4/2 conv (512->256) -> NCHW flatten -> 2-layer FC code."""

    def __init__(self, img_size: int, nz_feat: int = 200):
        super().__init__()
        side = res_feats_side(img_size)
        self.resnet = ResNet18()
        self.enc_conv1 = ConvBNLeaky(512, 256, kernel_size=4, stride=2)
        self.enc_fc = FCStack(256 * side * side, nz_feat, 2)

    def forward(self, img: torch.Tensor):
        """img (B, 3, H, W) -> (code (B, nz_feat), res_feats (B, 256, s, s))."""
        res_feats = self.enc_conv1(self.resnet(img))
        return self.enc_fc(res_feats.flatten(1)), res_feats
