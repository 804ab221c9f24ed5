"""Shared building blocks (NCHW inside), mirroring the reference's
net_blocks.py / networks.py as the JAX package's models/nn_blocks.py does.

BatchNorm follows flax: momentum 0.99 (torch momentum 0.01), eps 1e-5,
and in train mode the running variance is updated with the biased batch
variance, the one it normalises with (BatchNorm1d/2d below). Under a
process group of more than one rank (parallel/mesh.py) the batch
statistics are those of the global batch, as in the JAX package's one
program over the data mesh.
Initialisation follows the JAX package's initialisers (`init_weights`):
flax's lecun_normal kernels and zero biases by default, N(0, 0.02) in
ConvBNLeaky / FCBNLeaky, and each head's own override.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh as pmesh

BN_MOMENTUM = 0.01  # flax BatchNorm momentum 0.99


class _FlaxStats:
    """Train-mode running statistics as flax's BatchNorm keeps them.

    torch normalises with the biased batch variance but updates the running
    variance with the unbiased one; flax uses the biased one for both. In
    train mode one F.batch_norm pass normalises and, at momentum 1, leaves
    the batch mean and unbiased variance in scratch buffers; the running
    buffers then take running = 0.99 * running + 0.01 * batch with the
    variance rescaled by (n - 1) / n. Eval mode is torch's own. With more
    than one rank, train mode takes the global statistics (`_global_forward`).
    """

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if pmesh.world_size() > 1:
            return self._global_forward(x)
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var * ((n - 1) / n), self.momentum)
        return y

    def _global_forward(self, x):
        """Train mode over the ranks' blocks of one global batch: the global
        mean and biased variance in two passes (the sum and count, then the
        sum of squared deviations; E[x^2] - E[x]^2 loses digits in f32), each
        summed by a differentiable all_reduce, so the backward sees the
        global statistics as the global program's does. The running buffers
        take flax's update with the global biased variance. (torch's
        SyncBatchNorm updates the running variance unbiased.)"""
        dims = [0] + list(range(2, x.ndim))
        shape = [1, -1] + [1] * (x.ndim - 2)
        xf = x.float()
        count = xf.new_full((1,), xf.numel() // xf.shape[1])
        s = pmesh.all_reduce_autograd(torch.cat([xf.sum(dims), count]))
        mean = s[:-1] / s[-1]
        xc = xf - mean.reshape(shape)
        var = pmesh.all_reduce_autograd((xc * xc).sum(dims)) / s[-1]
        y = xc * torch.rsqrt(var + self.eps).reshape(shape)
        y = y * self.weight.reshape(shape) + self.bias.reshape(shape)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return y.to(x.dtype)


class BatchNorm1d(_FlaxStats, nn.BatchNorm1d):
    def __init__(self, num_features: int):
        super().__init__(num_features, momentum=BN_MOMENTUM)


class BatchNorm2d(_FlaxStats, nn.BatchNorm2d):
    def __init__(self, num_features: int):
        super().__init__(num_features, momentum=BN_MOMENTUM)


def lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    """flax lecun_normal: truncated normal (+-2 std), variance 1/fan_in."""
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


@torch.no_grad()
def init_weights(module: nn.Module, gen: torch.Generator) -> None:
    """flax default initialisers over a module tree, then each submodule's
    own `init_override(gen)`."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            lecun_normal_(m.weight, gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d, nn.LayerNorm)):
            m.reset_parameters()
    for m in module.modules():
        if hasattr(m, "init_override"):
            m.init_override(gen)


class ConvBNLeaky(nn.Module):
    """Conv (padding (k-1)//2) -> BN -> LeakyReLU(0.2); N(0, 0.02) init."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, stride: int = 1):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride, pad)
        self.bn = BatchNorm2d(cout)

    def init_override(self, gen):
        nn.init.normal_(self.conv.weight, 0.0, 0.02, generator=gen)

    def forward(self, x):
        return F.leaky_relu(self.bn(self.conv(x)), 0.2)


class FCBNLeaky(nn.Module):
    """Linear -> BN1d -> LeakyReLU(0.2); N(0, 0.02) init."""

    def __init__(self, nin: int, nout: int):
        super().__init__()
        self.fc = nn.Linear(nin, nout)
        self.bn = BatchNorm1d(nout)

    def init_override(self, gen):
        nn.init.normal_(self.fc.weight, 0.0, 0.02, generator=gen)

    def forward(self, x):
        return F.leaky_relu(self.bn(self.fc(x)), 0.2)


class FCStack(nn.Sequential):
    """`nlayers` FCBNLeaky layers."""

    def __init__(self, nin: int, nout: int, nlayers: int = 2):
        super().__init__(*[FCBNLeaky(nin if i == 0 else nout, nout) for i in range(nlayers)])


def conv3x3(cin: int, cout: int) -> nn.Conv2d:
    """3x3 stride-1 conv with bias, padding 1."""
    return nn.Conv2d(cin, cout, 3, 1, 1)


class ResLayer2d(nn.Module):
    """conv3x3+BN, LeakyReLU(0.01), conv3x3+BN, identity skip when the
    channel count is unchanged, LeakyReLU(0.01). (The TPU package folds the
    narrow convs 2x2 space-to-depth; that is the same plain conv.)"""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = conv3x3(cin, cout)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = conv3x3(cout, cout)
        self.bn2 = BatchNorm2d(cout)
        self.skip = cin == cout

    def forward(self, x):
        out = F.leaky_relu(self.bn1(self.conv1(x)), 0.01)
        out = self.bn2(self.conv2(out))
        if self.skip:
            out = out + x
        return F.leaky_relu(out, 0.01)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """nn.Upsample(scale_factor=2, mode='bilinear'), align_corners=False."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
