"""ImMatchNet: the NCNet family's matcher with a selectable trunk.

Port of ``patch2pix_tpu.models.immatch_net``: a feature trunk (VGG16 to
``pool4``, ResNet101 or ResNet34 to layer3, DenseNet201 to
``transition2``) with L2 normalisation, the un-normalised 4D
correlation, an optional relocalisation ``maxpool4d``, then mutual
matching -> NeighConsensus -> mutual matching, at any NCN depth (the
reference default (3, 3, 3) / (10, 10, 1)). Images and features are
NHWC; the volume is ``(B, h1, w1, h2, w2)`` float32.

Parameter keys: the VGG16 and DenseNet trunks sit under
``FeatureExtraction.model`` (an NCNet checkpoint's layout, VGG16 by
torchvision's sequential indices, DenseNet by torchvision's child
names), the ResNet trunks under ``extract`` (torchvision's names), the
NCN under ``NeighConsensus.conv.{0,2,...}`` (the reference's
pre-permuted conv4d layout). Kernels on this path: B1 in each symmetric
branch's fold-out, wherever the NCN's last layer has one or two output
channels.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from patch2pix_tpu_torch.config import resolve_device
from patch2pix_tpu_torch.models.densenet import DenseNetFeatures
from patch2pix_tpu_torch.models.ncn import NeighConsensus
from patch2pix_tpu_torch.models.resnet import BACKBONES
from patch2pix_tpu_torch.models.vgg import VGG16Features
from patch2pix_tpu_torch.ops.correlation import (
    feat_correlation,
    l2_normalize,
    maxpool4d,
    mutual_matching,
)
from patch2pix_tpu_torch.utils import profiling

TRUNKS = ("vgg", "resnet101", "resnet34", "densenet201")


class FeatureExtraction(nn.Module):
    """Holds a VGG16 or DenseNet trunk as ``model`` (the NCNet key
    layout)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x):
        return self.model(x)


class ImMatchNet(nn.Module):
    """imA, imB ``(B, H, W, 3)`` -> (filtered 4D correlation, the
    maxpool4d offset volumes or None). Built on CUDA unless ``device``
    is given; ``dtype`` is the compute dtype (parameters stay float32).
    ``last_layer`` '' takes the trunk's default (``pool4`` for VGG16;
    the ResNets stop at layer3 and DenseNet at ``transition2`` in any
    case)."""

    def __init__(self, feature_extraction_cnn: str = "vgg", last_layer: str = "",
                 ncons_kernel_sizes: Sequence[int] = (3, 3, 3),
                 ncons_channels: Sequence[int] = (10, 10, 1),
                 normalize_features: bool = True, relocalization_k_size: int = 0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        cnn = feature_extraction_cnn
        self.feature_extraction_cnn = cnn
        self.normalize_features = normalize_features
        self.relocalization_k_size = relocalization_k_size
        self.dtype = dtype
        with profiling.span("setup.construct"):
            if cnn == "vgg":
                self.FeatureExtraction = FeatureExtraction(
                    VGG16Features(last_layer or "pool4", dtype, device))
            elif cnn in ("resnet101", "ResNet101", "resnet34", "ResNet34"):
                key = "ResNet101" if "101" in cnn else "ResNet34"
                self.extract = BACKBONES[key](False, dtype, device)
            elif cnn == "densenet201":
                self.FeatureExtraction = FeatureExtraction(DenseNetFeatures(dtype=dtype,
                                                                            device=device))
            else:
                raise ValueError(f"unsupported feature_extraction_cnn {cnn!r}; "
                                 f"available: {', '.join(TRUNKS)}")
            self.NeighConsensus = NeighConsensus(tuple(ncons_kernel_sizes),
                                                 tuple(ncons_channels), dtype=dtype,
                                                 device=device)
        self.eval()

    def trunk(self) -> nn.Module:
        return self.extract if hasattr(self, "extract") else self.FeatureExtraction

    def features(self, im: torch.Tensor) -> torch.Tensor:
        f = self.trunk()(im)
        return l2_normalize(f) if self.normalize_features else f

    def forward(self, imA, imB) -> Tuple[torch.Tensor, Optional[Tuple]]:
        with profiling.span("immatch"):
            with profiling.span("backbone"):
                fa, fb = self.features(imA), self.features(imB)
            with profiling.span("coarse"):
                return self._match(fa, fb)

    def forward_feat(self, featA, featB, normalize: bool = True):
        """Match precomputed NHWC feature maps (the reference's
        ``forward_feat``)."""
        if normalize:
            featA, featB = l2_normalize(featA), l2_normalize(featB)
        return self._match(featA, featB)

    def _match(self, fa, fb):
        with profiling.span("coarse.corr"):
            corr = feat_correlation(fa, fb)
        delta4d = None
        if self.relocalization_k_size > 1:
            with profiling.span("coarse.reloc"):
                corr, delta4d = maxpool4d(corr, self.relocalization_k_size)
        corr = mutual_matching(corr)
        corr = self.NeighConsensus(corr)
        return mutual_matching(corr), delta4d
