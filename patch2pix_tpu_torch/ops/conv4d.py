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
(:func:`conv4d_fold_out`, whose shift-add is kernel B1). Other k=3
layers with cin*cout <= 16 go to the direct kernel B4
(:mod:`.conv4d_small`); the rest accumulate one 2D conv per outer tap
(:func:`conv4d_xla_taps`). That is the JAX package's dispatch order, and
the port's everywhere but on the card in bfloat16 where no gradient is
wanted (:func:`conv4d_route`): there a k=3 layer with Cin 1 and a Cout
B4 is built for (the NCN's first layer) runs on B4's Cin-1 kernel
instead of the fold-in, and one with Cin = Cout in
:data:`.conv4d_mid.MID_CHANNELS` (the NCN's middle layer) on B4's C -> C
kernel (:mod:`.conv4d_mid`) instead of the per-tap convs, still through
:func:`conv4d_xla_taps`, the per-tap layer's one entry. The 2D convs run
in PyTorch's NCHW layout on the flat ``(B*h1*w1, C, h2, w2)`` view: for
the NCN's 1- and 16-channel volumes this is the layout cuDNN gives
naturally, and the 6D channels-last tensors the functions return are
permuted views of it, never copies.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from patch2pix_tpu_torch.ops.conv4d_mid import MID_CHANNELS, conv4d_mid
from patch2pix_tpu_torch.ops.conv4d_small import CIN1_COUTS, conv4d_small
from patch2pix_tpu_torch.ops.tap_sum import flat_shift_masks, tap_sum
from patch2pix_tpu_torch.utils import profiling

K_FOLD = 3  # kernel size of the fold and small-channel formulations


def conv4d_route(k: int, cin: int, cout: int, device_type: str,
                 dtype: torch.dtype = torch.float32, needs_grad: bool = False) -> str:
    """The formulation :func:`conv4d` takes. For a bfloat16 CUDA input
    whose k=3 conv needs no gradient: ``first_layer_kernel`` (B4's Cin-1
    kernel) with Cin 1 and a Cout in :data:`.conv4d_small.CIN1_COUTS`,
    ``mid_layer_kernel`` (B4's C -> C kernel) with Cin = Cout in
    :data:`.conv4d_mid.MID_CHANNELS`. Else, in the JAX package's dispatch
    order (``patch2pix_tpu/ops/conv4d.py:80-90``), ``fold_in``,
    ``fold_out``, ``small_kernel`` (B4 on a CUDA tensor), ``small_plain``
    (its plain version on a CPU tensor) or ``xla_taps``. A gradient keeps
    the fold-in and the per-tap convs, whose backwards are cuDNN's."""
    card_bf16 = (k == K_FOLD and device_type == "cuda" and dtype == torch.bfloat16
                 and not needs_grad)
    if card_bf16 and cin == 1 and cout in CIN1_COUTS:
        return "first_layer_kernel"
    if card_bf16 and cin == cout and cin in MID_CHANNELS:
        return "mid_layer_kernel"
    if k == K_FOLD and cin <= 2:
        return "fold_in"
    if k == K_FOLD and cout <= 2:
        return "fold_out"
    if k == K_FOLD and cin * cout <= 16:
        return "small_kernel" if device_type == "cuda" else "small_plain"
    return "xla_taps"


def route_of(x, w, b=None) -> str:
    """:func:`conv4d_route` of the call ``conv4d(x, w, b)``."""
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, w, b))
    return conv4d_route(w.shape[0], w.shape[4], w.shape[5], x.device.type, x.dtype, needs_grad)


def conv4d(x, w, b=None, out_dtype=None, route=None):
    """SAME 4D convolution, stride 1; output in float32 unless
    ``out_dtype`` is given (accumulation is float32). ``route``: the
    caller's :func:`route_of` of this call, if it has one."""
    route = route or route_of(x, w, b)
    if route == "fold_in":
        return conv4d_fold_in(x, w, b, out_dtype)
    if route == "fold_out":
        return conv4d_fold_out(x, w, b, out_dtype)
    if route in ("first_layer_kernel", "small_kernel", "small_plain"):
        return conv4d_small(x, w, b, out_dtype)
    # looked up at call time: the per-tap layer's one entry, by name
    return conv4d_xla_taps(x, w, b, out_dtype=out_dtype, route=route)


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
    profiling.count("conv4d.fold_in", 1)
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


def conv4d_xla_taps(x, w, b=None, out_dtype=None, route="xla_taps"):
    """The per-tap layer's one entry: every :func:`conv4d` call routed
    ``mid_layer_kernel`` or ``xla_taps`` comes through here, by this name.
    ``mid_layer_kernel`` launches B4's C -> C kernel
    (:func:`.conv4d_mid.conv4d_mid`: all 81 taps in one pass, float32
    sums, one rounding to ``out_dtype``). Any other route runs the JAX
    package's per-tap path: one 2D conv over (h2, w2) per outer (di, dj)
    tap on a padded copy of x, each rounded to x's dtype and accumulated
    in float32 (never materialising the shifted stack), then the bias;
    the output float32 unless ``out_dtype`` is given."""
    if route == "mid_layer_kernel":
        return conv4d_mid(x, w, b, out_dtype)
    profiling.count("conv4d.xla_taps", 1)
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
    if out_dtype is not None:
        out = out.to(out_dtype)
    return _from_flat_nchw(out, bs, h1, w1)


def conv4d_transpose_symmetric(x, w, b=None, out_dtype=None, route=None):
    """conv4d of the A<->B transposed volume, transposed back — by the
    axis-pair symmetry of the 4D convolution this is ``conv4d(x, w')``
    with ``w'[a, b, c, d] = w[c, d, a, b]`` (the same route)."""
    return conv4d(x, w.permute(2, 3, 0, 1, 4, 5), b, out_dtype=out_dtype, route=route)
