"""Train state: the model, its optimizer, the learning-rate schedule and
the step count.

Port of ``patch2pix_tpu.train.state``. The JAX package differentiates
every parameter and zeroes the frozen ones' updates (optax
``set_to_zero``); here a frozen parameter has ``requires_grad=False``,
so autograd computes no gradient for it and the optimizer never holds
it. Freezing uses the JAX package's ``fnmatch`` path prefixes over the
parameter names with '/' for '.' (``extract``, ``ncn``,
``extract/layer1*``). The optimizers are optax's: Adam (bias-corrected,
eps 1e-8 outside the square root), or SGD with momentum 0.9, each with
coupled weight decay (``add_decayed_weights`` before the optimizer adds
``wd * p`` to the gradient, as ``torch.optim``'s ``weight_decay`` does);
the learning rate at update ``count`` (0 for the first) is the
piecewise-constant :func:`lr_schedule`.
"""

from __future__ import annotations

import fnmatch
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from patch2pix_tpu_torch.config import OptimConfig


def lr_schedule(cfg: OptimConfig, steps_per_epoch: int = 1) -> Callable[[int], float]:
    """``count -> learning rate``: ``lr_init`` scaled by ``factor`` at
    every boundary ``count >= epoch * steps_per_epoch`` passed.
    ``lr_decay``: None, ('step', factor, step_size) or ('multistep',
    factor, *milestones), in epochs."""
    if cfg.lr_decay is None:
        bounds = []
    else:
        kind, factor = cfg.lr_decay[0], float(cfg.lr_decay[1])
        if kind == "step":
            step_size = int(cfg.lr_decay[2])
            epochs = range(step_size, cfg.epochs + 1, step_size)
        elif kind == "multistep":
            epochs = sorted({int(e) for e in cfg.lr_decay[2:]})
        else:
            raise ValueError(f"unknown lr_decay kind: {kind}")
        bounds = [(e * steps_per_epoch, factor) for e in epochs]

    def lr(count: int) -> float:
        v = cfg.lr_init
        for b, factor in bounds:
            if count >= b:
                v *= factor
        return v

    return lr


def frozen(name: str, freeze: Sequence[str]) -> bool:
    """True when a prefix of the parameter's '/'-joined path matches a
    ``freeze`` pattern."""
    parts = name.split(".")
    return any(fnmatch.fnmatchcase("/".join(parts[:i + 1]), pat)
               for pat in freeze for i in range(len(parts)))


class Optimizer:
    """A ``torch.optim`` optimizer over the trainable parameters and the
    learning-rate schedule. :meth:`step` applies update ``count``."""

    def __init__(self, inner: torch.optim.Optimizer, schedule: Callable[[int], float]):
        self.inner = inner
        self.schedule = schedule

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def step(self, count: int) -> None:
        for group in self.inner.param_groups:
            group["lr"] = self.schedule(count)
        self.inner.step()


def make_optimizer(cfg: OptimConfig, model: torch.nn.Module, steps_per_epoch: int = 1,
                   freeze: Sequence[str] = ("extract", "ncn")) -> Optimizer:
    """Freeze the parameters matching ``freeze`` (``requires_grad``
    False) and build Adam or SGD over the others. The default freezes
    the backbone and the NCN, as the reference's Patch2Pix training
    does."""
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(not frozen(name, freeze))
        if p.requires_grad:
            trainable.append(p)
    schedule = lr_schedule(cfg, steps_per_epoch)
    if cfg.opt == "adam":
        inner = torch.optim.Adam(trainable, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=cfg.weight_decay)
    elif cfg.opt == "sgd":
        inner = torch.optim.SGD(trainable, lr=schedule(0), momentum=0.9,
                                weight_decay=cfg.weight_decay)
    else:
        raise ValueError(f"unknown optimizer: {cfg.opt}")
    return Optimizer(inner, schedule)


@dataclass
class TrainState:
    """The step count (updates applied so far), the model (parameters
    and BatchNorm running averages) and its optimizer (None in a state
    written for evaluation only). A step updates the model and the
    optimizer in place and returns a state with the next count."""

    step: int
    model: torch.nn.Module
    optimizer: Optional[Optimizer]


def create_train_state(model: torch.nn.Module, optim_cfg: OptimConfig,
                       steps_per_epoch: int = 1,
                       freeze: Sequence[str] = ("extract", "ncn")) -> TrainState:
    """The state of a model whose weights are already loaded (a seeded
    or converted state dict, or :func:`..utils.jax_import.load_jax_train_state`)."""
    return TrainState(0, model, make_optimizer(optim_cfg, model, steps_per_epoch, freeze))
