"""The training step, on one device or data-parallel over a mesh.

Port of ``patch2pix_tpu.train.step``: forward (coarse matching,
proposal sampling, anchors, both regression stages on batch
statistics), the masked losses, backward and the optimizer update.

The JAX sharded step is one jit over the GLOBAL batch, so it computes
what the single-device step computes on that batch. The port has one
step, :func:`make_train_step`, which takes a ``mesh``: over
``torch.distributed``, one rank per device, each rank holds its rows of
the batch and a replica of the model and optimizer. Plain DDP would
not do: it averages per-rank means, and this loss is a masked mean over
the pairs that pass its gates, whose count differs between ranks.
Instead:

  * proposals: the global ``(B, N)`` uniform draw, each rank its rows;
  * batch statistics: every batch-statistics BatchNorm takes the global
    moments, from per-channel sums, sums of squares and counts summed by
    a differentiable all-reduce (``models.resnet.global_batch_moments``);
    the running averages move by them;
  * losses and metrics: each mean over pairs is the global one (its
    numerators and counts summed over the ranks in one all-reduce); each
    rank's loss is its share of the global loss;
  * gradients: one SUM all-reduce of one flat buffer of the trainable
    gradients (the shares add up; frozen parameters send nothing); then
    the same optimizer step on every rank.

Its only collectives are all-reduces, as JAX's compiled step's are.
Without a mesh, or on a mesh of one rank without a process group, every
collective is the identity and the step is the same arithmetic.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, Optional, Tuple

import torch

from patch2pix_tpu_torch.models.resnet import global_batch_moments
from patch2pix_tpu_torch.parallel import comm_stats
from patch2pix_tpu_torch.parallel.mesh import Mesh, replicated_divergence
from patch2pix_tpu_torch.train.losses import patch2pix_losses
from patch2pix_tpu_torch.train.state import Optimizer, TrainState
from patch2pix_tpu_torch.utils import profiling

# the JAX package's ``remat="auto"`` bound on B * ptmax * panc proposals
# for running without recomputation (a measurement on a 16 GB TPU, kept
# as the rule of the API)
AUTO_REMAT_PROPOSALS = 12800


def resolve_remat(remat: str, batch: int, ptmax: int, panc: int,
                  n_data_shards: int = 1) -> str:
    """``auto`` -> ``none`` while the proposals on one device,
    batch * ptmax * panc // n_data_shards (``batch`` the global batch),
    stay <= 12800, else ``both``; any other mode as given."""
    if remat != "auto":
        return remat
    per_device = (batch * ptmax * panc) // max(n_data_shards, 1)
    return "none" if per_device <= AUTO_REMAT_PROPOSALS else "both"


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
    mesh: Optional[Mesh] = None,
    debug_checks: bool = False,
):
    """Build ``train_step(state, batch, generator=None, rand=None) ->
    (state, metrics)``. ``batch`` holds ``im1``/``im2`` ``(B, H, W, 3)``
    and ``F`` ``(B, 3, 3)`` on the model's device: the whole batch, or
    this rank's rows of it over ``mesh`` (``parallel.mesh.shard_batch``;
    every rank calls the step with the same state). ``generator`` (seeded
    alike on every rank) draws the global batch's proposal order, or
    ``rand`` is the global ``(B, N)`` uniform draw. The step updates
    ``model`` (its parameters and its regressors' running averages) and
    ``optimizer`` in place; ``state`` must hold them, and the returned
    state carries the next step count. Metrics are the global batch's,
    0-d tensors on the device, not synchronised.
    ``backbone_train_bn``: the backbone's BatchNorms run on batch
    statistics and their running averages move (its weights stay as
    ``optimizer`` leaves them). ``debug_checks``: after the update, a
    cross-rank divergence of the trainable parameters above 1e-5 raises
    (two more scalar all-reduces). B1-B3 run on every rank."""
    group = None if mesh is None else mesh.group
    ranks = 1 if mesh is None else mesh.size
    rank = 0 if mesh is None else mesh.rank
    params = [p for p in model.parameters() if p.requires_grad]

    def pair_sum(t):
        return comm_stats.all_reduce(t, group=group)

    def moment_sum(t):
        return comm_stats.all_reduce_sum(t, group=group)

    def train_step(state: TrainState, batch, generator=None,
                   rand=None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("train_step: the state holds another model or optimizer")
        b = batch["im1"].shape[0]
        total = b * ranks
        mode = resolve_remat(remat, total, ptmax, model.config.regressor.panc, ranks)
        if rand is not None:
            rand = rand[rank * b:(rank + 1) * b]
        with profiling.span("train.step"):
            with global_batch_moments(moment_sum, ranks):
                with profiling.span("train.forward"):
                    outputs = model(batch["im1"], batch["im2"], ksize=ksize, ptmax=ptmax,
                                    train=True, backbone_train_bn=backbone_train_bn,
                                    remat=mode, generator=generator, rand=rand,
                                    rand_rows=(rank * b, total))
                with profiling.span("train.loss"):
                    share, metrics = patch2pix_losses(
                        outputs, batch["F"], cls_dthres=cls_dthres, epi_dthres=epi_dthres,
                        weight_cls=weight_cls, weight_epi=weight_epi, pair_sum=pair_sum)
                with profiling.span("train.backward"):
                    optimizer.zero_grad()
                    share.backward()
            if group is not None:
                with profiling.span("train.allreduce"):
                    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
                    flat = comm_stats.all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                                                 group=group)
                    for p, g in zip(params, flat.split([p.numel() for p in params])):
                        p.grad = g.view_as(p)
            with profiling.span("train.optimizer"):
                optimizer.step(state.step)
        if debug_checks:
            div = float(replicated_divergence([p.detach() for p in params], group))
            if div > 1e-5:
                raise RuntimeError(f"train step: replicas diverged, max relative "
                                   f"parameter checksum divergence {div:.3e}")
        return replace(state, step=state.step + 1), metrics

    return train_step


def shard_batch_spec() -> Dict[str, str]:
    """The axis each training batch entry is split over: pairs over the
    ``data`` axis (the JAX package's PartitionSpecs, as axis names)."""
    return {"im1": "data", "im2": "data", "F": "data"}


def make_sharded_train_step(model, optimizer: Optimizer, mesh: Mesh, **kwargs):
    """The JAX package's name for :func:`make_train_step` over ``mesh``."""
    return make_train_step(model, optimizer, mesh=mesh, **kwargs)
