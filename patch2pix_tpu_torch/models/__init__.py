"""patch2pix_tpu_torch.models: the backbones, the neighbourhood
consensus, the regressor and the Patch2Pix pipeline, under the JAX
package's names."""

from patch2pix_tpu_torch.models.ncn import NeighConsensus
from patch2pix_tpu_torch.models.patch2pix import Patch2Pix
from patch2pix_tpu_torch.models.regressor import FeatRegressNet
from patch2pix_tpu_torch.models.resnet import ResNetFeatures, resnet34, resnet50, resnet101

__all__ = [
    "ResNetFeatures",
    "resnet34",
    "resnet50",
    "resnet101",
    "NeighConsensus",
    "FeatRegressNet",
    "Patch2Pix",
]
