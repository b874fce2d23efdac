"""Correlation fused with the 2x2x2x2 max-pool (kernel B2).

``corr_pool(f1, f2)`` equals ``maxpool4d_values(feat_correlation(f1,
f2), 2)`` without the pre-pool volume (port of
``patch2pix_tpu.ops.corr_pool_pallas.corr_pool_fused``). On CUDA tensors
it lays the features out for the kernel that :func:`kernel_instance`
names (:func:`cell_parity_rows`, :func:`layout`) and launches it
(``csrc/corr_pool.cu``); on CPU tensors it runs
:func:`corr_pool_plain`. The within-window argmax offsets are not
produced: :func:`decode_delta_from_feats` recomputes them from the
features for the few selected cells.

Differentiable: the backward is the JAX custom VJP's
(``_corr_pool_bwd``, ``patch2pix_tpu/ops/corr_pool_pallas.py:178-181``)
in plain PyTorch, :func:`corr_pool_backward`: the correlation and the
pool's ``torch.maximum`` cascade replayed from the saved features, so
the pre-pool volume exists only inside the backward.
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
# the kernels' operand layouts by (dtype, kernel): (image-1 row multiple,
# image-2 row multiple, channel multiple, K-major); see csrc/corr_pool.cu:
# float32 the SIMT kernel (F_TILE, F_KC), bf16 the resident-panel kernel
# (H_BM, H_BN, H_KB) up to RESIDENT_MAX_C channels and the streamed one
# (H_BM, S_ROWS2, H_KB) beyond
LAYOUTS = {
    (torch.float32, "simt"): (128, 128, 16, True),
    (torch.bfloat16, "resident"): (256, 64, 64, False),
    (torch.bfloat16, "streamed"): (256, 384, 64, False),
}
RESIDENT_MAX_C = 384  # H_MAX_CP
STREAM_CLUSTER = 2  # S_CLUSTER: CTAs a cluster of the streamed kernel


def kernel_instance(dtype: torch.dtype, c: int) -> str:
    """The kernel a call on ``c``-channel features of ``dtype`` takes:
    "simt" (float32), "resident" (bf16, ``c`` rounded up to the channel
    multiple at most RESIDENT_MAX_C) or "streamed" (bf16, wider)."""
    if dtype == torch.float32:
        return "simt"
    chans = LAYOUTS[(torch.bfloat16, "resident")][2]
    return "resident" if _round_up(c, chans) <= RESIDENT_MAX_C else "streamed"


def layout(dtype: torch.dtype, c: int):
    """The operand layout (LAYOUTS' value) of that call's kernel."""
    return LAYOUTS[(dtype, kernel_instance(dtype, c))]


def corr_pool_supported(feat1: torch.Tensor, feat2: torch.Tensor, ksize: int) -> bool:
    """Condition of the fused path: ksize 2, even spatial dims and equal
    channel counts, any width (bf16 features wider than RESIDENT_MAX_C
    channels run the streamed kernel, ``csrc/corr_pool.cu``)."""
    _, h1, w1, c1 = feat1.shape
    _, h2, w2, c2 = feat2.shape
    return (ksize == KSIZE and c1 == c2
            and h1 % 2 == 0 and w1 % 2 == 0 and h2 % 2 == 0 and w2 % 2 == 0)


def corr_pool_plain(feat1: torch.Tensor, feat2: torch.Tensor) -> torch.Tensor:
    """The plain version: f32 correlation (bmm) then the values pool."""
    return maxpool4d_values(feat_correlation(feat1, feat2), KSIZE)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def cell_parity_rows(feat: torch.Tensor, row_mult: int, chan_mult: int,
                     k_major: bool = False) -> torch.Tensor:
    """The kernels' operand layout of ``(B, h, w, C)`` features (h, w
    even): ``(B, R, Cp)``, or ``(B, Cp, R)`` if ``k_major``, whose row
    ``4*p + s`` is feature ``(2*i + d, 2*j + e)`` of pooled cell
    ``p = i*(w/2) + j`` at window parity ``s = 2*d + e``. R is ``h*w``
    rounded up to a multiple of ``row_mult``, Cp is C rounded up to a
    multiple of ``chan_mult``; the padding is zero, which leaves every
    dot product as it is and only adds cells past the end."""
    b, h, w, c = feat.shape
    v = feat.reshape(b, h // 2, 2, w // 2, 2, c)
    rows = (v.permute(0, 5, 1, 3, 2, 4).reshape(b, c, h * w) if k_major
            else v.permute(0, 1, 3, 2, 4, 5).reshape(b, h * w, c))
    rp, cp = _round_up(h * w, row_mult), _round_up(c, chan_mult)
    if (rp, cp) == (h * w, c):
        return rows.contiguous()
    out = feat.new_zeros((b, cp, rp) if k_major else (b, rp, cp))
    if k_major:
        out[:, :c, :h * w] = rows
    else:
        out[:, :h * w, :c] = rows
    return out


def corr_pool_backward(feat1: torch.Tensor, feat2: torch.Tensor, g: torch.Tensor):
    """The adjoint of :func:`corr_pool`: the vector-Jacobian product of
    :func:`corr_pool_plain` at (feat1, feat2) with the pooled gradient
    ``g``, replayed from the features -> (dfeat1, dfeat2) in the
    features' dtypes. A pairwise tie in the pool sends half the gradient
    to each side, as ``jnp.maximum`` does."""
    corr_pool_backward.calls += 1
    with torch.enable_grad():
        f1 = feat1.detach().requires_grad_()
        f2 = feat2.detach().requires_grad_()
        return torch.autograd.grad(corr_pool_plain(f1, f2), (f1, f2), g)


corr_pool_backward.calls = 0


def _launch(feat1, feat2):
    b, h1, w1, c = feat1.shape
    _, h2, w2, _ = feat2.shape
    if feat1.device.type != "cuda" or feat2.device != feat1.device:
        raise ValueError(f"corr_pool: tensors on {feat1.device} and {feat2.device}")
    if feat1.dtype != feat2.dtype or feat1.dtype not in _DTYPES:
        raise TypeError(f"corr_pool: dtypes {feat1.dtype}, {feat2.dtype}")
    if not corr_pool_supported(feat1, feat2, KSIZE) or feat2.shape[0] != b:
        raise ValueError(f"corr_pool: shapes {tuple(feat1.shape)}, {tuple(feat2.shape)}")
    rows1, rows2, chans, k_major = layout(feat1.dtype, c)
    a = cell_parity_rows(feat1, rows1, chans, k_major)
    m = cell_parity_rows(feat2, rows2, chans, k_major)
    rdim, cdim = (2, 1) if k_major else (1, 2)
    out = torch.empty((b, h1 // 2, w1 // 2, h2 // 2, w2 // 2),
                      dtype=torch.float32, device=feat1.device)
    lib = _build.library("corr_pool", _SIGNATURES)
    rc = lib.p2p_corr_pool(
        a.data_ptr(), m.data_ptr(), out.data_ptr(), b, (h1 // 2) * (w1 // 2),
        (h2 // 2) * (w2 // 2), a.shape[rdim], m.shape[rdim], a.shape[cdim],
        _DTYPES[feat1.dtype], _build.current_stream(feat1.device),
    )
    _build.check_launch(rc, "corr_pool")
    corr_pool.launches += 1
    return out


class _CorrPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat1, feat2):
        ctx.save_for_backward(feat1, feat2)
        if feat1.device.type == "cpu" and feat2.device.type == "cpu":
            return corr_pool_plain(feat1, feat2)
        return _launch(feat1, feat2)

    @staticmethod
    def backward(ctx, g):
        return corr_pool_backward(*ctx.saved_tensors, g)


def corr_pool(feat1: torch.Tensor, feat2: torch.Tensor) -> torch.Tensor:
    """``(B, h1, w1, C)``, ``(B, h2, w2, C)`` even spatial dims ->
    ``(B, h1/2, w1/2, h2/2, w2/2)`` float32 pooled correlation. On CPU
    tensors it runs :func:`corr_pool_plain`, on CUDA tensors the
    kernel."""
    return _CorrPool.apply(feat1, feat2)


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
