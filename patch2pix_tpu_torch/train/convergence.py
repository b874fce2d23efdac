"""The JAX package's ``tests/test_train_convergence.py`` workload on the
port: a fresh f32 Patch2Pix (ResNet34, upsample 16, ``seeded_patch2pix``
seed 0), Adam 2e-3, ptmax 48, one fixed batch of 2 synthetic pairs at
96x128 (``RandomState(0)``), 24 steps, under cuDNN's deterministic
algorithms with TF32 off, so that a run repeats.

The proposal order of step ``i`` is the ``i``-th uniform draw of a
generator seeded 100: on the model's device (``draw="device"``), or on
the CPU and then moved (``draw="cpu"``), which gives a CUDA run the
proposals of a CPU run. ``perturb`` scales every parameter by ``1 + perturb
* N(0, 1)`` before the first step: the workload's sensitivity to
rounding-sized changes of the weights.

The JAX test's rules on 6-step windows (last over first): loss/epi_fine
under 0.7, loss/epi_mid under 0.9, loss/pair under 0.5; every loss
finite and no pair skipped in the last 6 steps.

    python -m patch2pix_tpu_torch.train.convergence --device cpu --draw cpu

prints one JSON object: the ratios, the skipped counts of the last 6
steps and every step's metrics.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from patch2pix_tpu_torch.config import ModelConfig, OptimConfig, resolve_device
from patch2pix_tpu_torch.data.synthetic import synthetic_batch
from patch2pix_tpu_torch.models.patch2pix import seeded_patch2pix
from patch2pix_tpu_torch.train.state import create_train_state
from patch2pix_tpu_torch.train.step import make_train_step

STEPS, WINDOW = 24, 6
RULES = {"loss/epi_fine": 0.7, "loss/epi_mid": 0.9, "loss/pair": 0.5}


def run_convergence(device=None, draw: str = "device", perturb: float = 0.0,
                    steps: int = STEPS):
    """The workload (module docstring). Returns a dict: ``ratios`` (last
    over first ``WINDOW`` steps of each loss in ``RULES``),
    ``skipped_last`` (the last ``WINDOW`` steps' skipped pairs), ``hist``
    (every step's metrics as floats), ``n`` (coarse rows a pair),
    ``seconds`` (the steps' wall time)."""
    if draw not in ("device", "cpu"):
        raise ValueError(f"draw={draw!r}; expected 'device' or 'cpu'")
    dev = resolve_device(device)
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = seeded_patch2pix(ModelConfig().resolved(), 0, dev)
        if perturb:
            noise = torch.Generator().manual_seed(1)
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1 + perturb * torch.randn(p.shape, generator=noise).to(dev))
        state = create_train_state(model, OptimConfig(lr_init=2e-3))
        step = make_train_step(model, state.optimizer, ksize=2, ptmax=48)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in synthetic_batch(np.random.RandomState(0), 2, 96, 128).items()}
        with torch.no_grad():
            f1, f2 = model.extract_pyramid_pair(batch["im1"], batch["im2"])
            corr, delta4d = model.coarse_corr(f1[-1], f2[-1], 2)
            n = model.coarse_matches(corr, delta4d, 2, mutual=True).scores.shape[1]
        gen = torch.Generator(device=dev if draw == "device" else "cpu").manual_seed(100)
        hist = []
        t0 = time.perf_counter()
        for _ in range(steps):
            if draw == "device":
                state, met = step(state, batch, gen)
            else:
                state, met = step(state, batch, rand=torch.rand((2, n), generator=gen).to(dev))
            hist.append(met)
        hist = [{k: float(v) for k, v in h.items()} for h in hist]
        seconds = time.perf_counter() - t0
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags

    def ratio(key):
        return float(np.mean([h[key] for h in hist[-WINDOW:]])
                     / np.mean([h[key] for h in hist[:WINDOW]]))

    return {"ratios": {k: ratio(k) for k in RULES},
            "skipped_last": [int(h["skipped"]) for h in hist[-WINDOW:]],
            "hist": hist, "n": n, "seconds": seconds}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda unless given (e.g. cpu)")
    ap.add_argument("--draw", choices=("device", "cpu"), default="device")
    ap.add_argument("--perturb", type=float, default=0.0)
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    out = run_convergence(args.device, args.draw, args.perturb, args.steps)
    print(json.dumps(dict(device=args.device, draw=args.draw, perturb=args.perturb, **out)))
    return out


if __name__ == "__main__":
    main()
