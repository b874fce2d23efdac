"""ResNet34 feature pyramid (channels-last at the interface).

Port of ``patch2pix_tpu.models.resnet`` for inference: a torchvision-
layout ResNet34 whose forward stops at layer3, returning the
hypercolumn levels [im, relu(bn1(conv1)), layer1, layer2, layer3].
``change_stride`` makes layer3's first block stride 1 (matching grid
stride 8). ``layer4`` is held, as in the reference checkpoint, but never
run.

Every BatchNorm runs on its running averages and is folded into the
preceding convolution: the per-channel scale ``s`` multiplies the conv
weights in float32 before the cast to the compute dtype, and the shift
``t`` is added to the conv output in the compute dtype — the rounding
points of the JAX package. The JAX package's space-to-depth stem is an
exact re-expression of the 7x7/2 conv, so the port runs the conv.

NHWC tensors enter cuDNN as ``channels_last`` views of (N, C, H, W):
no transposes.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


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


def conv_bn(x, conv: nn.Conv2d, bn: nn.BatchNorm2d, dtype):
    """conv (no bias) + BatchNorm folded into the conv."""
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

    def forward(self, x, dtype):
        y = torch.relu(conv_bn(x, self.conv1, self.bn1, dtype))
        y = conv_bn(y, self.conv2, self.bn2, dtype)
        if self.downsample is not None:
            x = conv_bn(x, self.downsample[0], self.downsample[1], dtype)
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

    def forward(self, x, pyramid: bool = False):
        """x: (B, H, W, 3) NHWC. Returns the tuple
        (im, conv1, layer1, layer2, layer3) if ``pyramid`` else layer3."""
        x = x.to(self.dtype)
        feats = [x]
        y = torch.relu(conv_bn(x, self.conv1, self.bn1, self.dtype))
        feats.append(y)
        y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for layer in (self.layer1, self.layer2, self.layer3):
            for block in layer:
                y = block(y, self.dtype)
            feats.append(y)
        return tuple(feats) if pyramid else y


def resnet34(change_stride: bool = False, dtype=torch.float32, device=None):
    return ResNetFeatures((3, 4, 6, 3), change_stride, dtype, device)


BACKBONES = {"ResNet34": resnet34}
