"""4D feature correlation, mutual-matching gating and 4D max-pooling.

Port of ``patch2pix_tpu.ops.correlation``: features are channels-last
``(B, H, W, C)`` and the correlation volume is ``(B, h1, w1, h2, w2)``.
"""

from __future__ import annotations

import torch


def l2_normalize(feat: torch.Tensor, dim: int = -1, eps: float = 1e-6) -> torch.Tensor:
    """``x / sqrt(sum(x^2) + eps)`` along ``dim``; the square-sum
    accumulates in float32, the output keeps the input dtype."""
    sq = torch.sum(torch.square(feat.float()), dim=dim, keepdim=True)
    return feat * torch.rsqrt(sq + eps).to(feat.dtype)


def feat_correlation(feat1: torch.Tensor, feat2: torch.Tensor) -> torch.Tensor:
    """``corr[b, i, j, k, l] = <feat1[b, i, j], feat2[b, k, l]>`` in
    float32 (products of the input dtype, f32 sums)."""
    b, h1, w1, c = feat1.shape
    _, h2, w2, _ = feat2.shape
    a = feat1.reshape(b, h1 * w1, c).float()
    m = feat2.reshape(b, h2 * w2, c).float()
    return torch.bmm(a, m.transpose(1, 2)).reshape(b, h1, w1, h2, w2)


def mutual_matching(corr: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``corr * (corr / max_A corr) * (corr / max_B corr)`` — soft
    mutual-nearest-neighbour gating over the flat ``(B, na, nb)`` view."""
    b, h1, w1, h2, w2 = corr.shape
    flat = corr.reshape(b, h1 * w1, h2 * w2)
    max_a = torch.amax(flat, dim=1, keepdim=True)
    max_b = torch.amax(flat, dim=2, keepdim=True)
    out = flat * (flat / (max_a + eps)) * (flat / (max_b + eps))
    return out.reshape(corr.shape)


def maxpool4d_values(corr: torch.Tensor, ksize: int = 2) -> torch.Tensor:
    """Values-only 4D max-pool over (h1, w1, h2, w2) with window
    ``ksize`` along each axis, as the JAX package computes it: axis by
    axis (h1 first), a cascade of pairwise ``torch.maximum`` over the
    strided slices. The values are those of one max over the window;
    the cascade's gradient, like ``jnp.maximum``'s, sends half to each
    side of a pairwise tie."""
    if ksize == 1:
        return corr
    x = corr
    for axis in (1, 2, 3, 4):
        best = None
        for i in range(ksize):
            idx = [slice(None)] * x.dim()
            idx[axis] = slice(i, None, ksize)
            best = x[tuple(idx)] if best is None else torch.maximum(best, x[tuple(idx)])
        x = best
    return x


def maxpool4d(corr: torch.Tensor, ksize: int = 2):
    """4D max-pool with the within-window offsets: ``(pooled, (di, dj,
    dk, dl))``, each offset an int32 volume of ``pooled``'s shape in
    ``[0, ksize)``. The axes are pooled from minor to major (w2, h2, w1,
    h1) with a strict ``>``, so the first maximum in row-major (di, dj,
    dk, dl) order wins, and the offsets already decoded are carried
    along (``patch2pix_tpu.ops.correlation.maxpool4d``); every spatial
    side must be a multiple of ``ksize``. The values
    equal :func:`maxpool4d_values`'s, the offsets :func:`decode_delta_at`'s
    at every cell. ``ksize == 1`` returns the volume and zero offsets."""
    if ksize == 1:
        z = torch.zeros(corr.shape, dtype=torch.int32, device=corr.device)
        return corr, (z, z, z, z)
    k = ksize

    def views(x, axis):
        return [x.unflatten(axis, (-1, k)).select(axis + 1, i) for i in range(k)]

    def pool_axis(x, carried, axis):
        vs = views(x, axis)
        best = vs[0]
        arg = torch.zeros(best.shape, dtype=torch.int32, device=x.device)
        for i in range(1, k):
            gt = vs[i] > best
            best = torch.where(gt, vs[i], best)
            arg = arg.masked_fill(gt, i)
        out = []
        for d in carried:
            dv = views(d, axis)
            cur = dv[0]
            for i in range(1, k):
                cur = torch.where(arg == i, dv[i], cur)
            out.append(cur)
        return best, arg, out

    x, dl, _ = pool_axis(corr, [], 4)
    x, dk, (dl,) = pool_axis(x, [dl], 3)
    x, dj, (dl, dk) = pool_axis(x, [dl, dk], 2)
    x, di, (dl, dk, dj) = pool_axis(x, [dl, dk, dj], 1)
    return x, (di, dj, dk, dl)


def window_argmax(vals: torch.Tensor, k: int):
    """Flat first-max argmax over the last axis of ``k^4`` row-major
    (di, dj, dk, dl) window values -> the four int32 offsets."""
    arg = torch.argmax(vals, dim=-1).to(torch.int32)  # first max wins
    return (torch.div(arg, k ** 3, rounding_mode="floor"),
            torch.div(arg, k ** 2, rounding_mode="floor") % k,
            torch.div(arg, k, rounding_mode="floor") % k,
            arg % k)


def decode_delta_at(corr, ia, ja, ib, jb, ksize: int):
    """Within-window argmax offsets of the PRE-POOL volume ``corr`` at
    the selected pooled cells ``(B, N)`` ia/ja/ib/jb; first-max
    tie-break in row-major (di, dj, dk, dl) order."""
    k = ksize
    b, h1, w1, h2, w2 = corr.shape
    d = torch.arange(k, device=corr.device)
    di, dj, dk, dl = torch.meshgrid(d, d, d, d, indexing="ij")
    i1 = (ia * k)[..., None] + di.reshape(-1)
    j1 = (ja * k)[..., None] + dj.reshape(-1)
    i2 = (ib * k)[..., None] + dk.reshape(-1)
    j2 = (jb * k)[..., None] + dl.reshape(-1)
    lin = ((i1 * w1 + j1) * h2 + i2) * w2 + j2  # (B, N, k^4)
    vals = torch.gather(corr.reshape(b, -1), 1, lin.reshape(b, -1).long())
    return window_argmax(vals.reshape(*ia.shape, k ** 4), k)
