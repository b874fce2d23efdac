"""patch2pix_tpu_torch.train: the single-device training step and NCN
pretraining."""

from patch2pix_tpu_torch.train.losses import patch2pix_losses
from patch2pix_tpu_torch.train.ncn_pretrain import make_ncn_pretrain_step, ncn_weak_loss
from patch2pix_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    lr_schedule,
    make_optimizer,
)
from patch2pix_tpu_torch.train.step import make_train_step

__all__ = [
    "patch2pix_losses",
    "make_ncn_pretrain_step",
    "ncn_weak_loss",
    "TrainState",
    "create_train_state",
    "lr_schedule",
    "make_optimizer",
    "make_train_step",
]
