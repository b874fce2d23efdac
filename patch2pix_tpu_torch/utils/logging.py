"""Logging, metrics and memory telemetry.

Port of ``patch2pix_tpu.utils.logging``: the console + file logger, the
config printout, parameter counts, the epoch-mean metrics writer (the
reference's visdom metric names, one JSON line per epoch), device
memory, and seeding.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
from collections import defaultdict
from typing import Dict, Iterable, Optional, TextIO

import numpy as np
import torch


class Logger:
    """Console + append-mode file logging (the reference's ``lprint``)."""

    def __init__(self, log_path: Optional[str] = None):
        self._fh: Optional[TextIO] = None
        if log_path:
            os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
            self._fh = open(log_path, "a")

    def __call__(self, msg: str) -> None:
        print(msg, flush=True)
        if self._fh is not None:
            self._fh.write(msg + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def config2str(cfg) -> str:
    """Pretty-print a config (dataclass or argparse Namespace)."""
    d = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else vars(cfg)
    return "\n".join(["Configs:"] + [f"  {k}: {v}" for k, v in d.items()])


def count_parameters(module: Optional[torch.nn.Module]) -> int:
    """Total element count of a module's parameters; 0 for None."""
    return 0 if module is None else sum(p.numel() for p in module.parameters())


class MetricsWriter:
    """Epoch-mean metric accumulator + JSONL writer: values accumulate
    per epoch, ``flush`` writes ``{"epoch", "prefix", **means}`` and
    clears (the reference's ``VisMeter`` contract).

    ``append`` is lazy: a step's metrics (0-d device tensors from a train
    step that was not waited for) are queued as they are, and one
    ``torch.cat(...).cpu()`` of every queued value moves them to the host
    at ``means``/``flush``/``summary``. A per-step ``.item()`` would wait
    for every step. Values may also be 1-D (one value per element) or
    host numbers. Non-finite values are dropped."""

    def __init__(self, out_path: Optional[str] = None, prefix: str = "train"):
        self.prefix = prefix
        self._vals: Dict[str, list] = defaultdict(list)
        self._pending: list = []
        self._path = out_path
        if out_path:
            os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)

    def append(self, metrics: Dict) -> None:
        self._pending.append(dict(metrics))

    def _drain(self) -> None:
        if not self._pending:
            return
        # each step's keys in sorted order, as JAX's ``device_get`` of the
        # dicts gives them: the means' (and the JSON lines') key order
        pending = [sorted(m.items()) for m in self._pending]
        tensors = [v.detach().reshape(-1) for m in pending for _, v in m
                   if isinstance(v, torch.Tensor)]
        host = (torch.cat([t.double() for t in tensors]).cpu().numpy() if tensors
                else np.zeros(0))
        at = 0
        for m in pending:
            for k, v in m:
                if isinstance(v, torch.Tensor):
                    a = host[at:at + v.numel()]
                    at += v.numel()
                else:
                    a = np.ravel(np.asarray(v, np.float64))
                self._vals[k].extend(float(x) for x in a[np.isfinite(a)])
        self._pending.clear()

    def means(self) -> Dict[str, float]:
        self._drain()
        return {k: float(np.mean(v)) for k, v in self._vals.items() if v}

    def flush(self, epoch: float) -> Dict[str, float]:
        means = self.means()
        if self._path:
            with open(self._path, "a") as f:
                f.write(json.dumps({"epoch": epoch, "prefix": self.prefix, **means}) + "\n")
        self._vals.clear()
        return means

    def summary(self, keys: Optional[Iterable[str]] = None) -> str:
        means = self.means()
        keys = keys or sorted(means)
        return " ".join(f"{k}={means[k]:.4f}" for k in keys if k in means)


def get_device_mem() -> Dict[str, Dict[str, float]]:
    """Per-CUDA-device memory in GB: in use, peak, and the card's total
    (the JAX runtime's ``bytes_in_use``, ``peak_bytes_in_use`` and
    ``bytes_limit``). Empty without CUDA."""
    out = {}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            out[f"cuda:{i}"] = {
                "bytes_in_use": torch.cuda.memory_allocated(i) / 1e9,
                "peak_bytes_in_use": torch.cuda.max_memory_allocated(i) / 1e9,
                "bytes_limit": torch.cuda.get_device_properties(i).total_memory / 1e9,
            }
    return out


def make_deterministic(seed: int) -> None:
    """Seed Python's, numpy's and torch's generators (the CPU's and every
    CUDA device's). cuDNN's algorithm choice is left as it is, so CUDA
    results may still differ in rounding from run to run."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
