"""Load the PyTorch checkpoint layouts of the NCNet family into the port.

The JAX package converts these layouts into flax trees
(``patch2pix_tpu.utils.torch_import``); the port's modules keep the
PyTorch key names, so each loader here only renames prefixes and calls
``load_state_dict``, with no layout change:

  * an NCNet checkpoint (``ncn_ivd_5ep.pth`` and friends):
    ``FeatureExtraction.model.N.*`` (VGG16) and ``NeighConsensus.conv.M.*``,
    legacy ``.vgg.`` keys renamed to ``.model.``;
  * torchvision ``vgg16().features`` (``features.N.*``), cut at the
    trunk's ``last_layer``;
  * torchvision ``densenet201().features`` (``features.conv0.*``, ...),
    without what the trunk drops (``denseblock3+``, ``transition3``,
    ``norm5``);
  * a torchvision ResNet (``conv1.*``, ``layer1.0.*``, ...; ``fc`` is
    dropped).

A key that survives the cut but has no place in the model raises
``KeyError``; keys the dict does not hold keep their values (the JAX
package's partial-restore contract). There is no NCNet ResNet101
checkpoint layout: the JAX package has no converter for one either.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

_DENSENET_DROPPED = ("denseblock3", "denseblock4", "transition3", "norm5")


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` file (a state dict, or a dict holding one under
    ``state_dict``) -> {key: tensor} on the CPU."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def _tensors(sd: Mapping) -> Dict[str, torch.Tensor]:
    return {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
            for k, v in sd.items()}


def _load(module: nn.Module, sd: Mapping[str, torch.Tensor]) -> None:
    own = module.state_dict()
    unknown = [k for k in sd if k not in own]
    if unknown:
        raise KeyError(f"checkpoint keys not in the model: {unknown}")
    module.load_state_dict(sd, strict=False)


def load_ncnet_checkpoint(model: nn.Module, sd: Union[str, Mapping]) -> None:
    """An NCNet checkpoint (a path or a state dict) into an ``ImMatchNet``
    with the VGG16 trunk; keys outside ``FeatureExtraction`` and
    ``NeighConsensus`` are ignored."""
    if isinstance(sd, str):
        sd = load_torch_state_dict(sd)
    sd = {k.replace(".vgg.", ".model."): v for k, v in _tensors(sd).items()}
    _load(model, {k: v for k, v in sd.items()
                  if k.startswith(("FeatureExtraction.", "NeighConsensus."))})


def _trunk(model: nn.Module, attr: str) -> nn.Module:
    """The trunk a loader fills: ``model.FeatureExtraction.model`` or
    ``model.extract`` where the model holds one, else the model."""
    if attr == "FeatureExtraction" and hasattr(model, "FeatureExtraction"):
        return model.FeatureExtraction.model
    return getattr(model, attr, model)


def _strip(sd: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in _tensors(sd).items() if k.startswith(prefix)}


def load_torchvision_vgg16_features(model: nn.Module, sd: Mapping,
                                    prefix: str = "features.") -> None:
    """torchvision ``vgg16()`` keys into a ``VGG16Features`` (or the
    ``ImMatchNet`` holding one); layers past its ``last_layer`` are
    skipped."""
    trunk = _trunk(model, "FeatureExtraction")
    _load(trunk, {k: v for k, v in _strip(sd, prefix).items()
                  if int(k.split(".")[0]) < len(trunk)})


def load_torchvision_densenet_features(model: nn.Module, sd: Mapping,
                                       prefix: str = "features.") -> None:
    """torchvision ``densenet201()`` keys into a ``DenseNetFeatures`` (or
    the ``ImMatchNet`` holding one); ``denseblock3+``, ``transition3``
    and ``norm5`` are skipped."""
    _load(_trunk(model, "FeatureExtraction"),
          {k: v for k, v in _strip(sd, prefix).items()
           if k.split(".")[0] not in _DENSENET_DROPPED})


def load_torchvision_resnet(model: nn.Module, sd: Mapping) -> None:
    """torchvision ResNet keys into a ``ResNetFeatures`` (or the
    ``Patch2Pix`` / ``ImMatchNet`` holding one as ``extract``); ``fc``
    is skipped."""
    _load(_trunk(model, "extract"),
          {k: v for k, v in _tensors(sd).items() if not k.startswith("fc.")})
