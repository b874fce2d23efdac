"""DenseNet201 feature trunk for the NCNet family (channels-last at the
interface).

Port of ``patch2pix_tpu.models.densenet``: torchvision's
``densenet201().features`` cut at ``transition2`` (conv0, norm0, relu0,
pool0, denseblock1, transition1, denseblock2, transition2): stride 16,
256 channels. Children keep torchvision's names (``conv0``, ``norm0``,
``denseblockB.denselayerL.{norm1,conv1,norm2,conv2}``,
``transitionT.{norm,conv}``), so a torchvision ``features.*`` dict loads
with its prefix dropped.

The BatchNorms run on their running averages, unfolded, as the JAX
``nn.BatchNorm`` does: ``(x - mean) * (rsqrt(var + eps) * scale) +
bias`` in float32, the result cast to the compute dtype. The stem's
max-pool pads with -inf. Dense connectivity is a channel concat per
layer.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from patch2pix_tpu_torch.config import resolve_device
from patch2pix_tpu_torch.models.resnet import conv2d_nhwc, lecun_normal_


def bn_running(x, bn: nn.BatchNorm2d, dtype):
    """Running-average BatchNorm of NHWC ``x``, in float32, cast to
    ``dtype``."""
    mul = torch.rsqrt(bn.running_var.float() + bn.eps) * bn.weight.float()
    return ((x.float() - bn.running_mean.float()) * mul + bn.bias.float()).to(dtype)


class DenseLayer(nn.Module):
    """torchvision ``_DenseLayer``: BN-ReLU-1x1 -> BN-ReLU-3x3, concat."""

    def __init__(self, cin: int, growth: int, bn_size: int, device=None):
        super().__init__()
        kw = dict(bias=False, device=device)
        self.norm1 = nn.BatchNorm2d(cin, device=device)
        self.conv1 = nn.Conv2d(cin, bn_size * growth, 1, **kw)
        self.norm2 = nn.BatchNorm2d(bn_size * growth, device=device)
        self.conv2 = nn.Conv2d(bn_size * growth, growth, 3, padding=1, **kw)

    def forward(self, x, dtype):
        y = conv2d_nhwc(torch.relu(bn_running(x, self.norm1, dtype)), self.conv1.weight.to(dtype))
        y = torch.relu(bn_running(y, self.norm2, dtype))
        y = conv2d_nhwc(y, self.conv2.weight.to(dtype), 1, 1)
        return torch.cat([x, y], dim=-1)


class Transition(nn.Module):
    """BN-ReLU-1x1 conv (half the channels)-2x2 average pool."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.norm = nn.BatchNorm2d(cin, device=device)
        self.conv = nn.Conv2d(cin, cout, 1, bias=False, device=device)

    def forward(self, x, dtype):
        y = conv2d_nhwc(torch.relu(bn_running(x, self.norm, dtype)), self.conv.weight.to(dtype))
        return F.avg_pool2d(y.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class DenseNetFeatures(nn.Module):
    """DenseNet trunk up to ``transition2``; defaults are DenseNet201's
    first two blocks (6 and 12 layers, growth 32, bn_size 4). ``forward``
    takes and returns NHWC. A fresh conv draws its kernel as flax's
    ``lecun_normal``; BatchNorms start at scale 1, bias 0, running mean
    0 and variance 1."""

    def __init__(self, block_config: Sequence[int] = (6, 12), growth: int = 32,
                 num_init_features: int = 64, bn_size: int = 4,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.conv0 = nn.Conv2d(3, num_init_features, 7, 2, 3, bias=False, device=device)
        self.norm0 = nn.BatchNorm2d(num_init_features, device=device)
        ch = num_init_features
        for bi, n_layers in enumerate(block_config):
            block = nn.Module()
            for li in range(n_layers):
                block.add_module(f"denselayer{li + 1}",
                                 DenseLayer(ch + li * growth, growth, bn_size, device))
            self.add_module(f"denseblock{bi + 1}", block)
            ch += n_layers * growth
            self.add_module(f"transition{bi + 1}", Transition(ch, ch // 2, device))
            ch //= 2
        self.n_blocks = len(block_config)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight)

    def forward(self, x):
        dtype = self.dtype
        y = conv2d_nhwc(x.to(dtype), self.conv0.weight.to(dtype), 2, 3)
        y = torch.relu(bn_running(y, self.norm0, dtype))
        # MaxPool2d(3, stride=2, padding=1): the padding never wins
        y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for bi in range(self.n_blocks):
            for layer in getattr(self, f"denseblock{bi + 1}").children():
                y = layer(y, dtype)
            y = getattr(self, f"transition{bi + 1}")(y, dtype)
        return y
