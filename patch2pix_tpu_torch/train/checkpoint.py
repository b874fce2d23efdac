"""Checkpoints with self-describing metadata.

Port of ``patch2pix_tpu.train.checkpoint`` in a torch format. A tag
(``last``, ``ep{N}``, ``immatch_best``) is two files in the run
directory:

  * ``{tag}.pt``: the step count, the model's ``state_dict`` (its
    parameters and every BatchNorm's running averages, the regressors'
    and the backbone's) and the optimizer's ``state_dict``;
  * ``{tag}.meta.json``: the JAX package's metadata, ``epoch``,
    ``best_vals`` and ``model_config`` (the config's JSON, as the JAX
    ``to_json`` writes it), so eval rebuilds the model from the
    directory alone.

Orbax directories written by the JAX package are not read here; JAX
weights come across through ``utils.jax_import.load_jax_train_state``.
"""

from __future__ import annotations

import json
import os
from dataclasses import replace
from typing import Optional, Sequence, Tuple

import torch

from patch2pix_tpu_torch.config import (
    ModelConfig,
    model_config_from_json,
    resolve_device,
    to_json,
)
from patch2pix_tpu_torch.models.patch2pix import Patch2Pix
from patch2pix_tpu_torch.train.state import TrainState

LAST = "last"


def _paths(ckpt_dir: str, tag: str) -> Tuple[str, str]:
    base = os.path.join(os.path.abspath(ckpt_dir), tag)
    return f"{base}.pt", f"{base}.meta.json"


def save_ckpt(ckpt_dir: str, state: TrainState, model_config: ModelConfig, epoch: int,
              best_vals: Optional[Sequence[float]] = None, tag: str = LAST) -> None:
    """Write the tag's weights and metadata, each through a temporary
    file renamed into place, so a run cut while saving keeps the
    previous checkpoint whole."""
    os.makedirs(os.path.abspath(ckpt_dir), exist_ok=True)
    pt, meta_path = _paths(ckpt_dir, tag)
    torch.save({"step": state.step, "model": state.model.state_dict(),
                "optimizer": state.optimizer.inner.state_dict()}, pt + ".tmp")
    os.replace(pt + ".tmp", pt)
    meta = {"epoch": epoch,
            "best_vals": list(best_vals) if best_vals is not None else None,
            "model_config": json.loads(to_json(model_config))}
    with open(meta_path + ".tmp", "w") as f:
        json.dump(meta, f, indent=2)
    os.replace(meta_path + ".tmp", meta_path)


def read_meta(ckpt_dir: str, tag: str = LAST) -> dict:
    with open(_paths(ckpt_dir, tag)[1]) as f:
        return json.load(f)


def _load(ckpt_dir: str, tag: str, device) -> dict:
    return torch.load(_paths(ckpt_dir, tag)[0], map_location=device, weights_only=True)


def load_ckpt(ckpt_dir: str, state: TrainState, tag: str = LAST) -> Tuple[TrainState, dict]:
    """Restore a checkpoint into ``state``'s model and optimizer (in
    place; the same architecture and trainable set). Returns the state
    with the checkpoint's step count, and the metadata."""
    device = next(state.model.parameters()).device
    payload = _load(ckpt_dir, tag, device)
    state.model.load_state_dict(payload["model"])
    state.optimizer.inner.load_state_dict(payload["optimizer"])
    return replace(state, step=int(payload["step"])), read_meta(ckpt_dir, tag)


def restore_for_eval(ckpt_dir: str, tag: str = LAST, device=None, dtype: Optional[str] = None):
    """Rebuild the model from a checkpoint directory alone: the meta's
    config with ``panc = 1`` (eval expands no anchors), the compute
    ``dtype`` it was trained in unless one is given, the tag's weights.
    Runs on CUDA unless ``device`` is given."""
    meta = read_meta(ckpt_dir, tag)
    cfg = model_config_from_json(json.dumps(meta["model_config"]))
    if cfg.regressor is not None:
        cfg.regressor.panc = 1
    if dtype is not None:
        cfg.dtype = dtype
    device = resolve_device(device)
    model = Patch2Pix(cfg.resolved(), device=device)
    model.load_state_dict(_load(ckpt_dir, tag, device)["model"])
    return model
