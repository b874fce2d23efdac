"""Correlation fused with the 2x2x2x2 max-pool (kernel B2).

``corr_pool(f1, f2)`` equals ``maxpool4d_values(feat_correlation(f1,
f2), 2)`` without the pre-pool volume (port of
``patch2pix_tpu.ops.corr_pool_pallas.corr_pool_fused``). On CUDA tensors
it launches ``csrc/corr_pool.cu``; on CPU tensors it runs
:func:`corr_pool_plain`. The within-window argmax offsets are not
produced: :func:`decode_delta_from_feats` recomputes them from the
features for the few selected cells.
"""

from __future__ import annotations

import torch

from patch2pix_tpu_torch.ops import _build
from patch2pix_tpu_torch.ops.correlation import (
    feat_correlation,
    maxpool4d_values,
    window_argmax,
)

KSIZE = 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {"p2p_corr_pool": "pppiiiiiiip"}


def corr_pool_supported(feat1: torch.Tensor, feat2: torch.Tensor, ksize: int) -> bool:
    """Shape condition of the fused path: ksize 2, even spatial dims,
    equal channel counts."""
    _, h1, w1, c1 = feat1.shape
    _, h2, w2, c2 = feat2.shape
    return (ksize == KSIZE and c1 == c2
            and h1 % 2 == 0 and w1 % 2 == 0 and h2 % 2 == 0 and w2 % 2 == 0)


def corr_pool_plain(feat1: torch.Tensor, feat2: torch.Tensor) -> torch.Tensor:
    """The plain version: f32 correlation (bmm) then the values pool."""
    return maxpool4d_values(feat_correlation(feat1, feat2), KSIZE)


def corr_pool(feat1: torch.Tensor, feat2: torch.Tensor) -> torch.Tensor:
    """``(B, h1, w1, C)``, ``(B, h2, w2, C)`` even spatial dims ->
    ``(B, h1/2, w1/2, h2/2, w2/2)`` float32 pooled correlation."""
    if feat1.device.type == "cpu" and feat2.device.type == "cpu":
        return corr_pool_plain(feat1, feat2)
    b, h1, w1, c = feat1.shape
    _, h2, w2, _ = feat2.shape
    if feat1.device.type != "cuda" or feat2.device != feat1.device:
        raise ValueError(f"corr_pool: tensors on {feat1.device} and {feat2.device}")
    if feat1.dtype != feat2.dtype or feat1.dtype not in _DTYPES:
        raise TypeError(f"corr_pool: dtypes {feat1.dtype}, {feat2.dtype}")
    if not corr_pool_supported(feat1, feat2, KSIZE) or feat2.shape[0] != b:
        raise ValueError(f"corr_pool: shapes {tuple(feat1.shape)}, {tuple(feat2.shape)}")
    if not (feat1.is_contiguous() and feat2.is_contiguous()):
        raise ValueError("corr_pool: inputs must be contiguous")
    out = torch.empty((b, h1 // 2, w1 // 2, h2 // 2, w2 // 2),
                      dtype=torch.float32, device=feat1.device)
    lib = _build.library("corr_pool", _SIGNATURES)
    rc = lib.p2p_corr_pool(
        feat1.data_ptr(), feat2.data_ptr(), out.data_ptr(),
        b, h1, w1, h2, w2, c, _DTYPES[feat1.dtype],
        _build.current_stream(feat1.device),
    )
    _build.check_launch(rc, "corr_pool")
    corr_pool.launches += 1
    return out


corr_pool.launches = 0


def decode_delta_from_feats(feat1, feat2, ia, ja, ib, jb, ksize: int):
    """Within-window argmax offsets for SELECTED pooled cells, by
    recomputing the ``k^4`` window correlations from the (normalised)
    features. ia/ja/ib/jb: ``(B, N)`` pooled-grid indices. Returns
    (di, dj, dk, dl) int32 ``(B, N)``, first max in row-major
    (di, dj, dk, dl) order."""
    k = ksize
    b, h1, w1, c = feat1.shape
    _, h2, w2, _ = feat2.shape
    n = ia.shape[1]
    d = torch.arange(k, device=feat1.device)
    dd, ee = torch.meshgrid(d, d, indexing="ij")
    dd, ee = dd.reshape(-1), ee.reshape(-1)  # (k^2,) row-major (d, e)

    def window_rows(feat, ii, jj, w):
        rows = feat.reshape(b, -1, c)
        idx = (ii * k)[..., None] * w + (jj * k)[..., None] + dd * w + ee
        got = rows[torch.arange(b, device=feat.device)[:, None],
                   idx.reshape(b, n * k * k).long()]
        return got.reshape(b, n, k * k, c).float()

    p1 = window_rows(feat1, ia, ja, w1)  # (B, N, k^2, C)
    p2 = window_rows(feat2, ib, jb, w2)
    vals = torch.sum(p1[:, :, :, None, :] * p2[:, :, None, :, :], dim=-1)
    return window_argmax(vals.reshape(b, n, k ** 4), k)
