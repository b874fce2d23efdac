"""Profiling and throughput utilities.

Port of ``patch2pix_tpu.utils.profiling``: a profiler trace around a
block, a streaming items/s counter and the marginal time of a loop.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Run ``torch.profiler`` (the CPU, and CUDA where present) over the
    block and write its Chrome trace to ``{log_dir}/trace.json``
    (viewable in Perfetto or chrome://tracing)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Throughput:
    """Streaming pairs/s (or items/s) counter with EMA smoothing."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.rate: Optional[float] = None
        self._t0: Optional[float] = None

    def tick(self, n_items: int) -> Optional[float]:
        now = time.perf_counter()
        if self._t0 is not None:
            inst = n_items / max(now - self._t0, 1e-9)
            self.rate = (
                inst if self.rate is None
                else self.alpha * inst + (1 - self.alpha) * self.rate
            )
        self._t0 = now
        return self.rate


def marginal_time(
    loop_fn: Callable[[int], object],
    iters_lo: int = 2,
    iters_hi: int = 10,
    repeats: int = 3,
    device=None,
) -> float:
    """Per-iteration seconds of ``loop_fn(iters)``, which runs ``iters``
    iterations: the best of ``repeats`` timings at ``iters_hi`` minus
    the best at ``iters_lo``, over the difference, so a fixed cost per
    call (launch, synchronisation) cancels. Where the work runs on a
    CUDA ``device`` (the current card when CUDA is present and it is
    None), the card is synchronised before and after each timed call."""
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda")
    sync = (lambda: torch.cuda.synchronize(device)) if (
        device is not None and torch.device(device).type == "cuda") else (lambda: None)

    def timed(it):
        loop_fn(it)  # warm up
        best = float("inf")
        for _ in range(repeats):
            sync()
            t0 = time.perf_counter()
            loop_fn(it)
            sync()
            best = min(best, time.perf_counter() - t0)
        return best

    return (timed(iters_hi) - timed(iters_lo)) / (iters_hi - iters_lo)
