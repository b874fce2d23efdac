"""ResNet34 feature pyramid (channels-last at the interface).

Port of ``patch2pix_tpu.models.resnet``: a torchvision-layout ResNet34
whose forward stops at layer3, returning the hypercolumn levels [im,
relu(bn1(conv1)), layer1, layer2, layer3]. ``change_stride`` makes
layer3's first block stride 1 (matching grid stride 8). ``layer4`` is
held, as in the reference checkpoint, but never run.

By default every BatchNorm runs on its running averages and is folded
into the preceding convolution: the per-channel scale ``s`` multiplies
the conv weights in float32 before the cast to the compute dtype, and
the shift ``t`` is added to the conv output in the compute dtype — the
rounding points of the JAX package. The JAX package's space-to-depth
stem is an exact re-expression of the 7x7/2 conv, so the port runs the
conv.

NHWC tensors enter cuDNN as ``channels_last`` views of (N, C, H, W):
no transposes.

``backbone_train_bn`` (``forward(..., stats=[])``): every conv runs
unfolded in the compute dtype and its BatchNorm normalises with the
batch's float32 statistics, mean and biased variance ``E[y^2] - mean^2``
(the JAX ``FoldableBatchNorm`` train path), appending ``(module, mean,
var)`` to ``stats`` for the caller to fold into the running averages.

A fresh model draws its conv kernels as flax's ``lecun_normal`` does
(:func:`lecun_normal_`); BatchNorms start at scale 1, bias 0, running
mean 0 and variance 1.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def lecun_normal_(weight: torch.Tensor) -> torch.Tensor:
    """flax ``lecun_normal``: a normal truncated at two standard
    deviations, scaled to variance ``1 / fan_in``; ``fan_in`` is every
    axis but the first (``in * kh * kw`` of an OIHW conv, ``in`` of a
    Linear). Draws outside the bounds are drawn again (an exact sampler
    of the truncated normal, several times faster than the inverse CDF
    of ``nn.init.trunc_normal_`` on the CPU)."""
    fan_in = weight[0].numel()
    # the standard deviation of a unit normal truncated at +-2
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        weight.normal_()
        out = weight.abs() > 2
        while bool(out.any()):
            weight[out] = torch.randn(int(out.sum()), dtype=weight.dtype, device=weight.device)
            out = weight.abs() > 2
        return weight.mul_(std)


def conv2d_nhwc(x, weight, stride: int = 1, padding: int = 0):
    """2D conv of NHWC ``x`` with OIHW ``weight`` -> NHWC, in x's dtype."""
    w = weight.contiguous(memory_format=torch.channels_last)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def bn_fold(bn: nn.BatchNorm2d):
    """Running-average BatchNorm as the f32 affine ``(s, t)``:
    ``bn(y) = y * s + t``."""
    s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    t = bn.bias.float() - bn.running_mean.float() * s
    return s, t


def conv_bn(x, conv: nn.Conv2d, bn: nn.BatchNorm2d, dtype, stats=None):
    """conv (no bias) + BatchNorm folded into the conv; with ``stats`` (a
    list) the BatchNorm runs on the batch's statistics instead."""
    if stats is not None:
        y = conv2d_nhwc(x.to(dtype), conv.weight.to(dtype), conv.stride[0], conv.padding[0])
        yf = y.float()
        mean = yf.mean(dim=(0, 1, 2))
        var = yf.square().mean(dim=(0, 1, 2)) - mean.square()
        stats.append((bn, mean.detach(), var.detach()))
        inv = torch.rsqrt(var + bn.eps) * bn.weight.float()
        return ((yf - mean) * inv + bn.bias.float()).to(y.dtype)
    s, t = bn_fold(bn)
    w = (conv.weight.float() * s[:, None, None, None]).to(dtype)
    y = conv2d_nhwc(x.to(dtype), w, conv.stride[0], conv.padding[0])
    return y + t.to(dtype)


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity/projection shortcut (ResNet-18/34)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, device=None):
        super().__init__()
        kw = dict(bias=False, device=device)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, stride, 1, **kw)
        self.bn1 = nn.BatchNorm2d(out_ch, device=device)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, 1, 1, **kw)
        self.bn2 = nn.BatchNorm2d(out_ch, device=device)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride, 0, **kw),
                nn.BatchNorm2d(out_ch, device=device),
            )

    def set_stride(self, stride: int) -> None:
        self.conv1.stride = (stride, stride)
        if self.downsample is not None:
            self.downsample[0].stride = (stride, stride)

    def forward(self, x, dtype, stats=None):
        y = torch.relu(conv_bn(x, self.conv1, self.bn1, dtype, stats))
        y = conv_bn(y, self.conv2, self.bn2, dtype, stats)
        if self.downsample is not None:
            x = conv_bn(x, self.downsample[0], self.downsample[1], dtype, stats)
        return torch.relu(y + x)


class ResNetFeatures(nn.Module):
    """ResNet34 trunk; ``forward`` returns the pyramid (or layer3)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 change_stride: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False, device=device)
        self.bn1 = nn.BatchNorm2d(64, device=device)
        in_ch = 64
        for si, (filters, n_blocks) in enumerate(zip((64, 128, 256, 512), stage_sizes)):
            stride = 1 if si == 0 else 2
            blocks = []
            for bi in range(n_blocks):
                blocks.append(BasicBlock(in_ch, filters, stride if bi == 0 else 1,
                                         device=device))
                in_ch = filters
            self.add_module(f"layer{si + 1}", nn.Sequential(*blocks))
        if change_stride:
            self.layer3[0].set_stride(1)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight)

    def forward(self, x, pyramid: bool = False, stats=None):
        """x: (B, H, W, 3) NHWC. Returns the tuple
        (im, conv1, layer1, layer2, layer3) if ``pyramid`` else layer3.
        ``stats``: a list to run every BatchNorm on batch statistics
        (module docstring)."""
        x = x.to(self.dtype)
        feats = [x]
        y = torch.relu(conv_bn(x, self.conv1, self.bn1, self.dtype, stats))
        feats.append(y)
        y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for layer in (self.layer1, self.layer2, self.layer3):
            for block in layer:
                y = block(y, self.dtype, stats)
            feats.append(y)
        return tuple(feats) if pyramid else y


def resnet34(change_stride: bool = False, dtype=torch.float32, device=None):
    return ResNetFeatures((3, 4, 6, 3), change_stride, dtype, device)


BACKBONES = {"ResNet34": resnet34}
