"""patch2pix_tpu_torch.train: the training step (single-device and
data-parallel over a mesh), NCN pretraining, checkpoints (``checkpoint.py``) and the training entry
point (``python -m patch2pix_tpu_torch.train.cli``)."""

from patch2pix_tpu_torch.train.checkpoint import (
    load_ckpt,
    read_meta,
    restore_for_eval,
    save_ckpt,
)
from patch2pix_tpu_torch.train.losses import patch2pix_losses
from patch2pix_tpu_torch.train.ncn_pretrain import make_ncn_pretrain_step, ncn_weak_loss
from patch2pix_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    lr_schedule,
    make_optimizer,
)
from patch2pix_tpu_torch.train.step import (
    make_sharded_train_step,
    make_train_step,
    shard_batch_spec,
)

__all__ = [
    "load_ckpt",
    "read_meta",
    "restore_for_eval",
    "save_ckpt",
    "patch2pix_losses",
    "make_ncn_pretrain_step",
    "ncn_weak_loss",
    "TrainState",
    "create_train_state",
    "lr_schedule",
    "make_optimizer",
    "make_sharded_train_step",
    "make_train_step",
    "shard_batch_spec",
]
