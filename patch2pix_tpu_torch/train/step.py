"""The single-device training step.

Port of ``patch2pix_tpu.train.step.make_train_step``: forward (coarse
matching, proposal sampling, anchors, both regression stages on batch
statistics), the masked losses, backward and the optimizer update. The
mesh-sharded step is not ported.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, Tuple

import torch

from patch2pix_tpu_torch.train.losses import patch2pix_losses
from patch2pix_tpu_torch.train.state import Optimizer, TrainState

# the JAX package's ``remat="auto"`` bound on B * ptmax * panc proposals
# for running without recomputation (a measurement on a 16 GB TPU, kept
# as the rule of the API)
AUTO_REMAT_PROPOSALS = 12800


def resolve_remat(remat: str, batch: int, ptmax: int, panc: int) -> str:
    """``auto`` -> ``none`` while batch * ptmax * panc <= 12800, else
    ``both``; any other mode as given."""
    if remat != "auto":
        return remat
    return "none" if batch * ptmax * panc <= AUTO_REMAT_PROPOSALS else "both"


def make_train_step(
    model,
    optimizer: Optimizer,
    ksize: int = 2,
    ptmax: int = 400,
    cls_dthres=(50.0, 5.0),
    epi_dthres=(50.0, 5.0),
    weight_cls: float = 10.0,
    weight_epi=(1.0, 1.0),
    backbone_train_bn: bool = False,
    remat: str = "auto",
):
    """Build ``train_step(state, batch, generator=None, rand=None) ->
    (state, metrics)``. ``batch`` holds ``im1``/``im2`` ``(B, H, W, 3)``
    and ``F`` ``(B, 3, 3)`` on the model's device; ``generator`` draws the
    proposal order (``rand``, a ``(B, N)`` uniform draw, replaces it).
    The step updates ``model`` (its parameters and its regressors'
    running averages) and ``optimizer`` in place; ``state`` must hold
    them, and the returned state carries the next step count. Metrics
    are 0-d tensors on the device, not synchronised."""
    if backbone_train_bn:
        raise NotImplementedError("backbone_train_bn: batch-statistics BatchNorm in the "
                                  "backbone is not ported")

    def train_step(state: TrainState, batch, generator=None,
                   rand=None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("train_step: the state holds another model or optimizer")
        mode = resolve_remat(remat, batch["im1"].shape[0], ptmax,
                             model.config.regressor.panc)
        outputs = model(batch["im1"], batch["im2"], ksize=ksize, ptmax=ptmax, train=True,
                        remat=mode, generator=generator, rand=rand)
        loss, metrics = patch2pix_losses(outputs, batch["F"], cls_dthres=cls_dthres,
                                         epi_dthres=epi_dthres, weight_cls=weight_cls,
                                         weight_epi=weight_epi)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step(state.step)
        return replace(state, step=state.step + 1), metrics

    return train_step
