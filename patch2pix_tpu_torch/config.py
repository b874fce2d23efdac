"""Configuration dataclasses: ``patch2pix_tpu.config``'s
``ModelConfig`` (inference fields), ``RegressorConfig``, ``OptimConfig``
and ``TrainConfig`` with the JAX defaults and their JSON round trip, the
compute dtype as a torch dtype (parameters stay float32), and the device
rule of the port's entry points."""

from __future__ import annotations

import dataclasses
import json
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


GATHER_ROUTES = ("auto", "block")


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
    # the JAX config's patch-gather switch, kept so that a JAX run
    # directory's meta restores and round-trips. The port takes one route
    # whatever its value: "block" is a TPU performance choice in JAX,
    # and every gather is a copy, so the output is the same
    gather: str = "auto"

    def __post_init__(self):
        if self.gather not in GATHER_ROUTES:
            raise ValueError(f"gather={self.gather!r}; expected one of {GATHER_ROUTES}")

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


@dataclass
class OptimConfig:
    opt: str = "adam"  # "adam" | "sgd" (momentum 0.9)
    lr_init: float = 5e-4
    weight_decay: float = 0.0  # coupled: added to the gradient
    # ('step', factor, step) or ('multistep', factor, *steps) or None,
    # in epochs
    lr_decay: Optional[Tuple] = None
    epochs: int = 100


@dataclass
class TrainConfig:
    seed: int = 1
    epochs: int = 100
    save_step: int = 1
    batch: int = 4
    ksize: int = 2
    freeze_feat: int = 87  # the reference's parameter index; the whole backbone is frozen
    ptmax: int = 400
    cthres: float = 0.5
    cls_dthres: Tuple[int, int] = (50, 5)
    epi_dthres: Tuple[int, int] = (50, 5)
    weight_cls: float = 10.0
    weight_epi: Tuple[float, float] = (1.0, 1.0)  # (fine, mid)
    out_dir: str = "output/patch2pix"
    data_root: str = "data"
    pair_root: str = "data_pairs"
    match_npy: str = "megadepth_pairs.ov0.35_imrat1.5.pair500.excl_test.npy"
    # training pair size (the reference's 480x320)
    wt: int = 480
    ht: int = 320


def to_json(cfg) -> str:
    """A config dataclass as indented JSON (tuples as lists)."""
    return json.dumps(dataclasses.asdict(cfg), indent=2)


def from_dict(cls, d):
    """``cls`` from a dict of its fields: unknown keys are dropped,
    lists become tuples, and a ``regressor`` dict a
    ``RegressorConfig``. A ``gather`` other than ``"auto"`` or
    ``"block"`` raises."""
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in names:
            continue
        if k == "regressor" and v is not None:
            v = from_dict(RegressorConfig, v)
        elif isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        kwargs[k] = v
    return cls(**kwargs)


def from_json(cls, s: str):
    """Inverse of :func:`to_json` for config dataclass ``cls``."""
    return from_dict(cls, json.loads(s))


def model_config_from_json(s: str) -> ModelConfig:
    return from_json(ModelConfig, s)


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
