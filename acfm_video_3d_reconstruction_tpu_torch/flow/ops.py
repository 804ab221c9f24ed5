"""Flow-network primitive ops: cost volume, deformable conv, triangle-kernel
up/downsampling, backward warping. NCHW.

Counterpart of acfm_video_3d_reconstruction_tpu/flow/ops.py (NHWC there).
`correlation` is the dispatch of flow/correlation_cuda.py: the CUDA kernel
for a CUDA tensor, `correlation_plain` for a CPU tensor.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.grid_sample import grid_sample
from .correlation_cuda import correlation, correlation_plain  # noqa: F401

# A warped all-ones mask below this marks a sample that left the image
# (the reference's warp(): a hard threshold, not a soft weight).
VALID_MASK_THRESHOLD = 0.9999


def _pixel_grid(like: torch.Tensor, H: int, W: int):
    """Pixel coordinates x (1, 1, W) and y (1, H, 1) in `like`'s dtype."""
    ys = torch.arange(H, dtype=like.dtype, device=like.device)
    xs = torch.arange(W, dtype=like.dtype, device=like.device)
    return xs[None, None, :], ys[None, :, None]


def _normalized(gx: torch.Tensor, gy: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Pixel coordinates -> align_corners=True grid (B, H, W, 2)."""
    gx = 2.0 * gx / max(W - 1, 1) - 1.0
    gy = 2.0 * gy / max(H - 1, 1) - 1.0
    return torch.stack([gx, gy], dim=-1)


def backward_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp x (B, C, H, W) by flow (B, 2, H, W) [u, v] in pixels.

    Samples x at (x + u, y + v), bilinear with align_corners=True, and
    zeroes every pixel whose warped all-ones mask falls below
    VALID_MASK_THRESHOLD.
    """
    B, C, H, W = x.shape
    xx, yy = _pixel_grid(flow, H, W)
    grid = _normalized(xx + flow[:, 0], yy + flow[:, 1], H, W)
    out = grid_sample(x, grid, align_corners=True)
    m = grid_sample(torch.ones_like(x[:, :1]), grid, align_corners=True)
    return out * torch.where(m < VALID_MASK_THRESHOLD, 0.0, 1.0)


def deform_conv3x3(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor | None) -> torch.Tensor:
    """torchvision DeformConv2d(k=3, s=1, p=1) equivalent.

    x (B, Cin, H, W); offsets (B, 18, H, W), per kernel tap k (row-major
    3x3) the pair (dy_k, dx_k) interleaved; weight (Cout, Cin, 3, 3). Each
    tap samples x bilinearly at p + p_k + offset_k (zeros outside), then
    one matmul contracts taps and channels.
    """
    B, Cin, H, W = x.shape
    Cout = weight.shape[0]
    xx, yy = _pixel_grid(x, H, W)
    taps = []
    for k in range(9):
        ky, kx = k // 3 - 1, k % 3 - 1
        gy = yy + ky + offsets[:, 2 * k]
        gx = xx + kx + offsets[:, 2 * k + 1]
        taps.append(grid_sample(x, _normalized(gx, gy, H, W), align_corners=True))
    sampled = torch.stack(taps, dim=2).reshape(B, Cin * 9, H * W)  # (c, k) rows
    out = torch.matmul(weight.reshape(Cout, Cin * 9), sampled).reshape(B, Cout, H, W)
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out


def _upsample_kernel2d(w: int, dtype, device) -> torch.Tensor:
    """Triangle kernel (reference MaskFlownet.py:40-44)."""
    c = w // 2
    k = 1.0 - torch.abs(c - torch.arange(w, dtype=dtype, device=device)) / (c + 1)
    return k[:, None] * k[None, :]


def _downsample_kernel2d(w: int, dtype, device) -> torch.Tensor:
    k = ((w + 1) - torch.abs(w - torch.arange(w * 2 + 1, dtype=dtype, device=device))) / (2 * w + 1)
    return k[:, None] * k[None, :]


def upsample2d_flow(img: torch.Tensor, factor: int) -> torch.Tensor:
    """MaskFlownet Upsample: edge pad, triangle-kernel transposed conv, crop.

    img (B, C, H, W) -> (B, C, H*factor, W*factor).
    """
    if factor == 1:
        return img
    B, C, H, W = img.shape
    x = F.pad(img.reshape(B * C, 1, H, W), (0, 1, 0, 1), mode="replicate")
    w = factor * 2 - 1
    kern = _upsample_kernel2d(w, img.dtype, img.device).reshape(1, 1, w, w)
    out = F.conv_transpose2d(x, kern, stride=factor, padding=factor - 1)[:, :, :-1, :-1]
    return out.reshape(B, C, out.shape[2], out.shape[3])


def downsample2d_flow(img: torch.Tensor, factor: int) -> torch.Tensor:
    """MaskFlownet Downsample: normalized triangle-kernel strided conv."""
    if factor == 1:
        return img
    B, C, H, W = img.shape
    x = img.reshape(B * C, 1, H, W)
    w2 = factor // 2
    kern = _downsample_kernel2d(w2, img.dtype, img.device).reshape(1, 1, 2 * w2 + 1, 2 * w2 + 1)
    num = F.conv2d(x, kern, stride=factor, padding=w2)
    den = F.conv2d(torch.ones_like(x), kern, stride=factor, padding=w2)
    out = num / den
    return out.reshape(B, C, out.shape[2], out.shape[3])
