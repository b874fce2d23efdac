"""Configuration dataclasses: the inference fields of
``patch2pix_tpu.config``'s ``ModelConfig`` and ``RegressorConfig``, with
the compute dtype as a torch dtype, and the device rule of the port's
entry points."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch


@dataclass
class RegressorConfig:
    """FeatRegressNet architecture (reference defaults)."""

    feat_comb: str = "pre"  # concat features before ('pre') or after ('post') conv
    conv_kers: Tuple[int, ...] = (3, 3)
    conv_dims: Tuple[int, ...] = (512, 512)
    conv_strs: Tuple[int, ...] = (2, 1)
    fc_dims: Tuple[int, ...] = (512, 256)
    psize: Tuple[int, int] = (16, 16)
    pshift: int = 8
    panc: int = 8  # anchor expansion at train; forced to 1 at eval
    shared: bool = False  # share mid/fine regressor weights
    feat_dim: int = 259  # filled from backbone dims + feat_idx


@dataclass
class ModelConfig:
    backbone: str = "ResNet34"
    change_stride: bool = False  # layer3 stride 2 -> 1 (upsample 16 -> 8)
    feat_idx: Tuple[int, ...] = (0, 1, 2, 3)
    regressor: Optional[RegressorConfig] = field(default_factory=RegressorConfig)
    # feature dims of the ResNet34 pyramid levels [im, conv1, layer1,
    # layer2] (+ layer3=256 for level 4)
    feat_dims: Tuple[int, ...] = (3, 64, 64, 128, 256)
    # compute dtype for conv/matmul activations ("float32" | "bfloat16");
    # params stay float32, correlation accumulates in float32
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.dtype]

    @property
    def upsample(self) -> int:
        return 8 if self.change_stride else 16

    @property
    def feats_downsample(self) -> Tuple[int, ...]:
        ds = [1, 2, 2, 2, 2]
        if self.change_stride:
            ds[-1] = 1
        return tuple(ds)

    def resolved(self) -> "ModelConfig":
        """Fill derived fields (regressor feat_dim from feat_idx)."""
        if self.regressor is not None:
            self.regressor.feat_dim = sum(self.feat_dims[i] for i in self.feat_idx)
        return self


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another device. With no device given and no CUDA present this
    raises — the port never carries on silently on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return torch.device("cuda")
