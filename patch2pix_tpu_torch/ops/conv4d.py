"""4D convolution for neighbourhood consensus.

Port of ``patch2pix_tpu.ops.conv4d``. Shapes at the public functions
are channels-last 6D, ``(B, h1, w1, h2, w2, C)``; filters are
``(k, k, k, k, Cin, Cout)``:

    conv4d(x, w)[b, i, j, k, l, co] =
        sum_{di, dj, dk, dl, ci} x[b, i+di-p, j+dj-p, k+dk-p, l+dl-p, ci]
                                 * w[di, dj, dk, dl, ci, co]

with SAME zero padding p = k // 2. The outer (h1, w1) taps are folded
into the channels of ONE ordinary 2D convolution over (h2, w2): into
Cin for tiny Cin (:func:`conv4d_fold_in`), into Cout for tiny Cout
(:func:`conv4d_fold_out`, whose shift-add is kernel B1). The 2D convs
run in PyTorch's NCHW layout on the flat ``(B*h1*w1, C, h2, w2)`` view:
for the NCN's 1- and 16-channel volumes this is the layout cuDNN gives
naturally, and the 6D channels-last tensors the functions return are
permuted views of it, never copies.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from patch2pix_tpu_torch.ops.tap_sum import flat_shift_masks, tap_sum

K_FOLD = 3  # kernel size of the fold formulations


def conv4d(x, w, b=None, out_dtype=None):
    """SAME 4D convolution, stride 1; output in float32 unless
    ``out_dtype`` is given (accumulation is float32)."""
    k = w.shape[0]
    cin, cout = w.shape[4], w.shape[5]
    if k == K_FOLD and cin <= 2:
        return conv4d_fold_in(x, w, b, out_dtype)
    if k == K_FOLD and cout <= 2:
        return conv4d_fold_out(x, w, b, out_dtype)
    out = conv4d_xla_taps(x, w, b)
    return out if out_dtype is None else out.to(out_dtype)


def _flat_nchw(x):
    """(B, h1, w1, h2, w2, C) -> (B*h1*w1, C, h2, w2) view."""
    bs, h1, w1, h2, w2, c = x.shape
    return x.reshape(bs * h1 * w1, h2, w2, c).permute(0, 3, 1, 2)


def _from_flat_nchw(y, bs, h1, w1):
    """(B*h1*w1, C, h2, w2) -> (B, h1, w1, h2, w2, C) view."""
    n, c, h2, w2 = y.shape
    return y.reshape(bs, h1, w1, c, h2, w2).permute(0, 1, 2, 4, 5, 3)


def conv4d_fold_in(x, w, b=None, out_dtype=None):
    """conv4d (k=3) with the OUTER (h1, w1) taps folded into Cin:

        xs9[n, (t, ci), k, l] = mask_t[n] * x[n + s_t, ci, k, l]
        W[co, (t, ci), dk, dl] = w[di(t), dj(t), dk, dl, ci, co]
        out = conv2d(xs9, W) (+ b)

    Exact (the same contraction, reassociated); materialises the
    9-fold shifted stack, meant for Cin=1 (the NCN's first layer)."""
    k = w.shape[0]
    bs, h1, w1, h2, w2, cin = x.shape
    cout = w.shape[-1]
    n = bs * h1 * w1
    p = w1 + 1
    xf = _flat_nchw(x)
    xp = F.pad(xf, (0, 0, 0, 0, 0, 0, p, p))
    views = [xp[p + s:p + s + n] * mask[:, None, None, None].to(x.dtype)
             for s, mask in flat_shift_masks(bs, h1, w1, x.device)]
    xs9 = torch.stack(views, dim=1).reshape(n, k * k * cin, h2, w2)
    wf = w.permute(5, 0, 1, 4, 2, 3).reshape(cout, k * k * cin, k, k)
    # the conv emits the operand dtype (f32 accumulation inside)
    y = F.conv2d(xs9, wf.to(x.dtype), padding=k // 2).float()
    if b is not None:
        y = y + b.float()[None, :, None, None]
    if out_dtype is not None:
        y = y.to(out_dtype)
    return _from_flat_nchw(y, bs, h1, w1)


def conv4d_fold_out(x, w, b=None, out_dtype=None):
    """conv4d (k=3) with the OUTER (h1, w1) taps folded into Cout:

        z[n, (t, co), k, l] = conv2d(x, V)
        V[(t, co), ci, dk, dl] = w[di(t), dj(t), dk, dl, ci, co]
        out[n, co] = b[co] + sum_t mask_t[n] * z[n + s_t, (t, co)]

    z is rounded to the input dtype; the shift-add (kernel B1,
    :func:`..tap_sum.tap_sum`) accumulates in float32. Exact
    (reassociation only)."""
    k = w.shape[0]
    bs, h1, w1, h2, w2, cin = x.shape
    cout = w.shape[-1]
    n = bs * h1 * w1
    vf = w.permute(0, 1, 5, 4, 2, 3).reshape(k * k * cout, cin, k, k)
    z = F.conv2d(_flat_nchw(x), vf.to(x.dtype), padding=k // 2)
    z = z.contiguous().reshape(n, k * k, cout * h2 * w2)
    bias = (torch.zeros(cout, dtype=torch.float32, device=x.device)
            if b is None else b.float().contiguous())
    out = tap_sum(z, bias, bs, h1, w1).reshape(n, cout, h2, w2)
    if out_dtype is not None:
        out = out.to(out_dtype)
    return _from_flat_nchw(out, bs, h1, w1)


def conv4d_xla_taps(x, w, b=None):
    """One 2D conv over (h2, w2) per outer (di, dj) tap, accumulated in
    float32 — the general path (never materialises the shifted stack)."""
    k = w.shape[0]
    pad = k // 2
    bs, h1, w1, h2, w2, cin = x.shape
    cout = w.shape[-1]
    xp = F.pad(x, (0, 0, 0, 0, 0, 0, pad, pad, pad, pad))
    out = None
    for di in range(k):
        for dj in range(k):
            xs = _flat_nchw(xp[:, di:di + h1, dj:dj + w1])
            wt = w[di, dj].permute(3, 2, 0, 1).to(x.dtype)
            y = F.conv2d(xs, wt, padding=pad).float()
            out = y if out is None else out + y
    if b is not None:
        out = out + b.float()[None, :, None, None]
    return _from_flat_nchw(out, bs, h1, w1)


def conv4d_transpose_symmetric(x, w, b=None, out_dtype=None):
    """conv4d of the A<->B transposed volume, transposed back — by the
    axis-pair symmetry of the 4D convolution this is ``conv4d(x, w')``
    with ``w'[a, b, c, d] = w[c, d, a, b]``."""
    return conv4d(x, w.permute(2, 3, 0, 1, 4, 5), b, out_dtype=out_dtype)
