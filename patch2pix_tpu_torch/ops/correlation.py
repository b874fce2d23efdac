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
    ``ksize`` along each axis."""
    if ksize == 1:
        return corr
    b, h1, w1, h2, w2 = corr.shape
    k = ksize
    v = corr.reshape(b, h1 // k, k, w1 // k, k, h2 // k, k, w2 // k, k)
    return torch.amax(v, dim=(2, 4, 6, 8))


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
