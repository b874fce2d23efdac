"""VGG16 feature trunk for the NCNet family (channels-last at the
interface).

Port of ``patch2pix_tpu.models.vgg``: torchvision's ``vgg16().features``
cut at a named layer (default ``pool4``: stride 16, 512 channels). The
layers keep torchvision's sequential indices, so ``N.weight`` /
``N.bias`` keys (``features.N.*`` in torchvision, ``model.N.*`` in an
NCNet checkpoint) load as they are. Convs run in the compute dtype on
``channels_last`` views of NHWC tensors, as the ResNet trunk's do.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from patch2pix_tpu_torch.config import resolve_device
from patch2pix_tpu_torch.models.resnet import conv2d_nhwc, lecun_normal_

# (name, kind, out_channels) of torchvision vgg16().features indices
# 0..30; kind: 'conv' | 'relu' | 'pool' (the JAX package's table)
VGG16_LAYERS: Tuple[Tuple[str, str, int], ...] = (
    ("conv1_1", "conv", 64), ("relu1_1", "relu", 64),
    ("conv1_2", "conv", 64), ("relu1_2", "relu", 64),
    ("pool1", "pool", 64),
    ("conv2_1", "conv", 128), ("relu2_1", "relu", 128),
    ("conv2_2", "conv", 128), ("relu2_2", "relu", 128),
    ("pool2", "pool", 128),
    ("conv3_1", "conv", 256), ("relu3_1", "relu", 256),
    ("conv3_2", "conv", 256), ("relu3_2", "relu", 256),
    ("conv3_3", "conv", 256), ("relu3_3", "relu", 256),
    ("pool3", "pool", 256),
    ("conv4_1", "conv", 512), ("relu4_1", "relu", 512),
    ("conv4_2", "conv", 512), ("relu4_2", "relu", 512),
    ("conv4_3", "conv", 512), ("relu4_3", "relu", 512),
    ("pool4", "pool", 512),
    ("conv5_1", "conv", 512), ("relu5_1", "relu", 512),
    ("conv5_2", "conv", 512), ("relu5_2", "relu", 512),
    ("conv5_3", "conv", 512), ("relu5_3", "relu", 512),
    ("pool5", "pool", 512),
)


class VGG16Features(nn.Sequential):
    """VGG16 trunk up to ``last_layer`` (inclusive); ``forward`` takes
    and returns NHWC. Raises ``ValueError`` on an unknown layer name. A
    fresh conv draws its kernel as flax's ``lecun_normal`` (the JAX
    ``nn.Conv`` default); biases start at zero."""

    def __init__(self, last_layer: str = "pool4", dtype: torch.dtype = torch.float32,
                 device=None):
        names = [n for n, _, _ in VGG16_LAYERS]
        if last_layer not in names:
            raise ValueError(f"unknown vgg16 layer {last_layer!r}")
        device = resolve_device(device)
        layers, cin = [], 3
        for _, kind, cout in VGG16_LAYERS[:names.index(last_layer) + 1]:
            if kind == "conv":
                conv = nn.Conv2d(cin, cout, 3, padding=1, device=device)
                lecun_normal_(conv.weight)
                nn.init.zeros_(conv.bias)
                layers.append(conv)
                cin = cout
            elif kind == "relu":
                layers.append(nn.ReLU())
            else:
                layers.append(nn.MaxPool2d(2, 2))
        super().__init__(*layers)
        self.dtype = dtype

    def forward(self, x):
        y = x.to(self.dtype)
        for layer in self:
            if isinstance(layer, nn.Conv2d):
                y = conv2d_nhwc(y, layer.weight.to(self.dtype), 1, 1) + layer.bias.to(self.dtype)
            elif isinstance(layer, nn.ReLU):
                y = torch.relu(y)
            else:
                y = F.max_pool2d(y.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        return y
