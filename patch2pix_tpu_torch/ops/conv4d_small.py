"""Direct SAME 3^4 conv4d for small channel counts (kernel B4).

Port of ``patch2pix_tpu.ops.conv4d_pallas.conv4d_pallas``: the path
:func:`..conv4d.conv4d` takes for k=3 layers with cin > 2, cout > 2 and
cin*cout <= 16 (after fold-in and fold-out), i.e. any NeighConsensus
whose ``channels`` put a middle layer in that range.

    out[b, i, j, k, l, co] = bias[co] + sum_{di, dj, dk, dl, ci}
        x[b, i+di-1, j+dj-1, k+dk-1, l+dl-1, ci] * w[di, dj, dk, dl, ci, co]

with zero padding. The filter is rounded to ``x.dtype`` first; products
and sums are float32; the output is float32 unless ``out_dtype`` is
given. On CUDA tensors the forward launches ``csrc/conv4d.cu``, on CPU
tensors it runs :func:`conv4d_small_plain`. The two add the 81*cin
products in different orders, so they agree to float32 rounding.

Differentiable: the backward is the JAX custom VJP's
(``conv4d_pallas.py:268-302``) in plain PyTorch — dx is the conv4d of g
with the spatially flipped, in/out-swapped filter on the per-tap conv
path, dw the per-tap float32 contraction, db the float32 sum of g.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from patch2pix_tpu_torch.ops import _build

K = 3
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {"p2p_conv4d_small": "ppppiiiiiiilllliip"}


def conv4d_small_plain(x, w, b=None, out_dtype=None):
    """The plain version: 81 shifted float32 matmuls over a padded x."""
    bs, h1, w1, h2, w2, cin = x.shape
    cout = w.shape[-1]
    wf = w.to(x.dtype).float()
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1, 1, 1))
    acc = torch.zeros((bs, h1, w1, h2, w2, cout), dtype=torch.float32, device=x.device)
    for di in range(K):
        for dj in range(K):
            for dk in range(K):
                for dl in range(K):
                    xs = xp[:, di:di + h1, dj:dj + w1, dk:dk + h2, dl:dl + w2]
                    acc = acc + torch.matmul(xs.float(), wf[di, dj, dk, dl])
    if b is not None:
        acc = acc + b.float()
    return acc if out_dtype is None else acc.to(out_dtype)


def _launch(x, w, b, out_dtype):
    bs, h1, w1, h2, w2, cin = x.shape
    cout = w.shape[-1]
    dev = x.device
    if dev.type != "cuda" or w.device != dev or (b is not None and b.device != dev):
        raise ValueError("conv4d_small: tensors must share one CUDA device")
    odt = torch.float32 if out_dtype is None else out_dtype
    if x.dtype not in _DTYPES or odt not in _DTYPES:
        raise TypeError(f"conv4d_small: x {x.dtype}, out_dtype {odt}")
    if w.shape[:4] != (K,) * 4 or w.shape[4] != cin or cin * cout > 16 or min(cin, cout) < 3:
        raise ValueError(f"conv4d_small: filter {tuple(w.shape)}")
    sb, si, sj, sk, sl, sc = x.stride()
    if si != w1 * sj or sb != h1 * si:
        # the kernel walks the cells (b, i, j) with one stride
        x = x.contiguous()
        sb, si, sj, sk, sl, sc = x.stride()
    # the filter rounded to x.dtype, handed over in float32 (<= 5 KB);
    # any layout in (a permuted filter from the transposed branch)
    wf = w.to(x.dtype).float().contiguous()
    bias = (torch.zeros(cout, dtype=torch.float32, device=dev) if b is None
            else b.float().contiguous())
    # written NCHW per cell, (B*h1*w1, Cout, h2, w2), the layout the
    # NCN's next cuDNN conv reads; returned as the 6D channels-last view
    out = torch.empty((bs * h1 * w1, cout, h2, w2), dtype=odt, device=dev)
    lib = _build.library("conv4d", _SIGNATURES)
    rc = lib.p2p_conv4d_small(
        x.data_ptr(), wf.data_ptr(), bias.data_ptr(), out.data_ptr(),
        bs, h1, w1, h2, w2, cin, cout, sj, sc, sk, sl,
        _DTYPES[x.dtype], _DTYPES[odt], _build.current_stream(dev),
    )
    _build.check_launch(rc, "conv4d_small")
    conv4d_small.launches += 1
    return out.view(bs, h1, w1, cout, h2, w2).permute(0, 1, 2, 4, 5, 3)


class _Conv4dSmall(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, out_dtype):
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        if x.device.type == "cpu":
            return conv4d_small_plain(x, w, b, out_dtype)
        return _launch(x, w, b, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        from patch2pix_tpu_torch.ops.conv4d import conv4d_xla_taps

        g = g.to(x.dtype)
        # dx: the adjoint conv, w flipped on all four spatial axes with
        # cin/cout swapped, on the per-tap conv path
        w_rev = torch.flip(w, dims=(0, 1, 2, 3)).transpose(4, 5)
        dx = conv4d_xla_taps(g, w_rev).to(x.dtype)
        bs, h1, w1, h2, w2, _ = g.shape
        xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1, 1, 1)).float()
        gf = g.float().reshape(-1, g.shape[-1])
        dw = torch.empty(w.shape, dtype=torch.float32, device=w.device)
        for di in range(K):
            for dj in range(K):
                for dk in range(K):
                    for dl in range(K):
                        xt = xp[:, di:di + h1, dj:dj + w1, dk:dk + h2, dl:dl + w2]
                        dw[di, dj, dk, dl] = xt.reshape(-1, x.shape[-1]).T @ gf
        db = gf.sum(dim=0) if ctx.has_bias else None
        return dx, dw.to(w.dtype), db, None


def conv4d_small(x, w, b=None, out_dtype=None):
    """x ``(B, h1, w1, h2, w2, Cin)`` float32 or bfloat16, w
    ``(3, 3, 3, 3, Cin, Cout)`` with Cin, Cout > 2 and Cin*Cout <= 16
    (any layout), bias ``(Cout,)`` -> ``(B, h1, w1, h2, w2, Cout)``
    float32 or ``out_dtype``. On the card x may be any view whose cells
    (b, i, j) share one stride, and the result is a permuted view of an
    NCHW-per-cell tensor."""
    return _Conv4dSmall.apply(x, w, b, out_dtype)


conv4d_small.launches = 0
