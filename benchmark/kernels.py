"""Operations, bytes and the least time of each hand-written kernel on
the benchmarked paths, from the shapes it is called at (the derivations
of ``chip_smoke.py`` phase 2, copied so that they do not move with the
program). Each input byte counts as read once and each output byte as
written once; where the bytes depend on the data, the inputs' own.

Profiler kernel names are matched by substring: ``tap_sum_kernel``
(B1), ``corr_pool_bf16_kernel`` (B2's bf16 instance up to 384
channels), ``expand_kernel`` (B3).
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np

from benchmark import peaks

BF16 = 2
F32 = 4
I32 = 4

B1_NAME = "tap_sum_kernel"
B2_NAME = "corr_pool_bf16_kernel"
B3_NAME = "expand_kernel"


def b1_bound_s(bs: int, h1: int, w1: int, h2: int, w2: int, k: int = 3) -> float:
    """B1 ``tap_sum``: the fold-out's shift-add of z ``(bs*h1*w1, k*k,
    h2*w2)`` bf16 into ``(bs*h1*w1, h2*w2)`` float32 plus a bias. z is
    read only at the taps whose shifted cell lies inside the (h1, w1)
    grid: per axis, sum over the k shifts s of (side - |s|) cells. One
    add per kept tap and one bias add per output, at the float32 peak;
    bytes bound it."""
    p = k // 2
    taps = bs * sum(h1 - abs(s) for s in range(-p, p + 1)) * sum(
        w1 - abs(s) for s in range(-p, p + 1))
    hw = h2 * w2
    nbytes = taps * hw * BF16 + bs * h1 * w1 * hw * F32 + F32
    flops = (taps + bs * h1 * w1) * hw
    return peaks.bound_s(nbytes, flops, peaks.F32_FLOPS)


def b2_bound_s(b: int, h: int, w: int, c: int, pool: int = 2) -> float:
    """B2 ``corr_pool``: correlation of two ``(b, h, w, c)`` bf16 maps,
    2 * (h*w)^2 * c operations a pair at the bf16 peak, with its
    pool^4 max-pool; the pooled volume written once in float32."""
    flops = 2 * b * (h * w) * (h * w) * c
    out = b * ((h // pool) * (w // pool)) ** 2 * F32
    nbytes = 2 * b * h * w * c * BF16 + out
    return peaks.bound_s(nbytes, flops, peaks.BF16_FLOPS)


# the main path's hypercolumn levels (tile side t, channels) at psize 16
P2P_LEVELS = ((16, 3), (8, 64), (4, 64), (2, 128))


def window_cells(corner: np.ndarray, psize: int, t: int) -> np.ndarray:
    """Cells along one axis that a psize-pixel window from each padded
    corner covers at a level of tile side t (stride psize / t): t, or
    t + 1 where the window starts inside a cell."""
    ds = psize // t
    r = np.maximum(np.asarray(corner, dtype=np.int64), 0) % psize
    return (r + psize - 1) // ds - r // ds + 1


def padded_corners(points: np.ndarray, psize: int, h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """(..., 2) pixel points (x, y) -> padded patch corners (y, x), as the
    gather computes them: truncated, centred, one psize ring of padding,
    clipped."""
    pts = np.asarray(points, dtype=np.float32)
    x0 = pts[..., 0].astype(np.int64) - psize // 2
    y0 = pts[..., 1].astype(np.int64) - psize // 2
    return (np.clip(y0 + psize, 0, h + psize - 1).reshape(-1),
            np.clip(x0 + psize, 0, w + psize - 1).reshape(-1))


def b3_bound_s(corners: Sequence[np.ndarray], psize: int = 16,
               levels: Iterable[Tuple[int, int]] = P2P_LEVELS, elsize: int = BF16) -> float:
    """B3 ``expand_scale_pair`` on M proposals: ``corners`` (y1, x1, y2,
    x2) int32 arrays of M. Reads each side's window cells of every
    level (``window_cells`` squared, C channels each) and the corners;
    writes both sides' ``(M, p, p, sum C)`` patches. 3 operations per
    output value a side (square, add, scale) at the float32 peak."""
    levels = tuple(levels)
    m = len(corners[0])
    csum = sum(c for _, c in levels)
    window = 0
    for t, c in levels:
        for y0, x0 in zip(corners[0::2], corners[1::2]):
            cells = window_cells(y0, psize, t) * window_cells(x0, psize, t)
            window += int(cells.sum()) * c * elsize
    out = 2 * m * psize * psize * csum * elsize
    flops = 3 * 2 * m * psize * psize * csum
    return peaks.bound_s(window + 4 * m * I32 + out, flops, peaks.F32_FLOPS)
