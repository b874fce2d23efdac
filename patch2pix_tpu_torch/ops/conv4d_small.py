"""Direct SAME 3^4 conv4d for small channel counts (kernel B4).

Port of ``patch2pix_tpu.ops.conv4d_pallas.conv4d_pallas``: the path
:func:`..conv4d.conv4d` takes for k=3 layers with cin > 2, cout > 2 and
cin*cout <= 16 (after fold-in and fold-out), i.e. any NeighConsensus
whose ``channels`` put a middle layer in that range; and, on the card,
the NCN's one-channel first layer in bfloat16 where no gradient is
wanted (Cin 1, Cout in :data:`CIN1_COUTS`), which the JAX package folds
into Cin (``conv4d_fold_in``).

    out[b, i, j, k, l, co] = bias[co] + sum_{di, dj, dk, dl, ci}
        x[b, i+di-1, j+dj-1, k+dk-1, l+dl-1, ci] * w[di, dj, dk, dl, ci, co]

with zero padding. The filter is rounded to ``x.dtype`` first; products
and sums are float32; the output is float32 unless ``out_dtype`` is
given. On CUDA tensors the forward launches ``csrc/conv4d.cu``, on CPU
tensors it runs :func:`conv4d_small_plain`. The two add the 81*cin
products in different orders, so they agree to float32 rounding.

Three kernels, all on the tensor cores with one design: for
each outer tap (di, dj) the (dk, dl, ci) -> co contraction of two output
rows is one product with a banded filter,
``B[tap][(r, dl, ci), (ro, co)] = w[di, dj, r - ro, dl, ci, co]`` for
0 <= r - ro <= 2 (r one of the four input rows k-1 .. k+2 under output
rows k, k+1), else 0. bfloat16 runs it on ``mma.sync.m16n8k16`` with the
channels paired, or at Cin 1 with K packed as (row, dl) in one k-step
(:func:`cin1_k_entry`; that kernel writes its output channels-last);
float32 on ``mma.sync.m16n8k8`` in TF32, each float32
product formed from three TF32 products (3xTF32: both operands split by
``ops.fine_stage.tf32_split``, the filter here once a call, the input in
the kernel's registers), which keeps the float32 rule of 1e-4 with
room (a single TF32 product would miss it). :func:`band_index` and
:func:`banded_filter` build the band; :func:`mma_fragments` (bf16) and
:func:`tf32_fragments` (float32, hi and lo) lay it out as the kernels' B
fragments; all run here, so the CPU tests hold the packing, as they
hold :func:`staging_mode`, the wrapper's choice of how the kernel loads
the input's planes, and :func:`tf32_smem_bytes`, the float32 kernel's
shared-memory plan.

Differentiable: the backward is the JAX custom VJP's
(``conv4d_pallas.py:268-302``) in plain PyTorch — dx is the conv4d of g
with the spatially flipped, in/out-swapped filter on the per-tap conv
path, dw the per-tap float32 contraction, db the float32 sum of g.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from patch2pix_tpu_torch.ops import _build
from patch2pix_tpu_torch.utils import profiling

K = 3
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {"p2p_conv4d_small_mma": "ppppiiiiiiilllliiip",
               "p2p_conv4d_small_tf32": "ppppiiiiiiilllliiip",
               "p2p_conv4d_cin1": "ppppiiiiiillliip",
               "p2p_conv4d_small_mma_attrs": "iiiippp",
               "p2p_conv4d_small_tf32_attrs": "iiiipppp",
               "p2p_conv4d_cin1_attrs": "iiippp"}
# the Cout csrc/conv4d.cu's Cin-1 kernel is built for: those the port's NCN
# configurations put after the one-channel input (Patch2Pix 16, ImMatchNet
# 10, the (4, 4, 1) NCN 4)
CIN1_COUTS = (4, 10, 16)
ROWS_IN = 4  # input rows k-1 .. k+2 under the output row pair (k, k+1)
# the float32 kernel's shared-memory plan, csrc/conv4d.cu's constants (a
# CPU test holds the two together): a staged plane is ROWS input rows of
# PITCH_F positions of cin words, in a ring of NBUF_F planes
TF32_PLAN = {"ROWS": 18, "PITCH_F": 34, "NBUF_F": 4}


def mma_dims(cin, cout, pairs=True):
    """(channels as staged, k-steps, n-tiles of 8) of the banded filter:
    K = (4 rows, 3 dl, channels), N = (2 rows, cout), each padded to the
    MMA tile. bf16 (``pairs``) pairs the channels (cin padded to even)
    in k-steps of 16 (m16n8k16), except cin 1, whose 12 (row, dl)
    entries fill one k-step (:func:`cin1_k_entry`); float32 keeps cin in
    k-steps of 8 (m16n8k8 TF32)."""
    if pairs and cin == 1:
        return 1, 1, -(-2 * cout // 8)
    cinp, depth = (cin + cin % 2, 16) if pairs else (cin, 8)
    return cinp, -(-ROWS_IN * K * cinp // depth), -(-2 * cout // 8)


def cin1_k_entry(k):
    """The (input row r, dl) of entry k of the Cin-1 kernel's K, or None
    past its 12: the pair 2q, 2q + 1 (q = 3h + dl) is rows 2h and 2h + 1
    of the four under an output row pair at column dl, the two halves of
    one staged 32-bit word."""
    q, rr = divmod(k, 2)
    return None if q >= 6 else (2 * (q // 3) + rr, q % 3)


def tf32_smem_bytes(cin, cout):
    """Dynamic shared memory a block of the float32 kernel launches with:
    the hi and lo B tiles of all nine taps (16 bytes a lane), then the
    ring of staged planes."""
    _, ks, nt = mma_dims(cin, cout, pairs=False)
    p = TF32_PLAN
    return 9 * ks * nt * 32 * 16 + p["NBUF_F"] * p["ROWS"] * p["PITCH_F"] * cin * 4


@functools.lru_cache(maxsize=None)
def band_index(cin, cout, pairs=True):
    """int64 ``(9, KS * depth, NT * 8)`` (:func:`mma_dims`): for each
    outer tap di*3 + dj and entry ``((r * 3 + dl) * cinp + ci, ro * cout
    + co)`` of the banded filter, its flat index in ``w.reshape(-1)``
    (``w`` of shape (3, 3, 3, 3, cin, cout)), that of ``w[di, dj, r - ro,
    dl, ci, co]``, or -1 where the entry is zero (outside the band, a pad
    channel, row or column). bf16 at cin 1 orders K by
    :func:`cin1_k_entry` instead."""
    cinp, ks, nt = mma_dims(cin, cout, pairs)
    idx = np.full((K * K, ks * (16 if pairs else 8), nt * 8), -1, np.int64)
    flat = np.arange(K ** 4 * cin * cout).reshape(K * K, K, K, cin, cout)
    if pairs and cin == 1:
        for k in range(16):
            if (entry := cin1_k_entry(k)) is not None:
                r, dl = entry
                for ro in range(2):
                    if 0 <= r - ro < K:
                        idx[:, k, ro * cout:(ro + 1) * cout] = flat[:, r - ro, dl, 0]
        return idx
    for r in range(ROWS_IN):
        for ro in range(2):
            if 0 <= r - ro < K:
                for dl in range(K):
                    rows = (r * K + dl) * cinp + np.arange(cin)
                    cols = ro * cout + np.arange(cout)
                    idx[:, rows[:, None], cols[None, :]] = flat[:, r - ro, dl]
    return idx


_BAND_INDEX = {}  # (cin, cout, pairs, device) -> band_index on that device


def banded_filter(w, pairs=True):
    """``(3, 3, 3, 3, cin, cout)`` -> the banded filter ``(9, KS * depth,
    NT * 8)`` of :func:`band_index`, in w's dtype."""
    key = (w.shape[4], w.shape[5], pairs, w.device)
    idx = _BAND_INDEX.get(key)
    if idx is None:  # one host-to-device copy per shape and device
        idx = _BAND_INDEX[key] = torch.from_numpy(band_index(*key[:3])).to(w.device)
    return torch.cat([w.reshape(-1), w.new_zeros(1)])[idx]


def mma_fragments(band):
    """Banded filter ``(9, KS * 16, NT * 8)`` -> the kernel's B fragments,
    int32 ``(9, KS, NT, 2, 32)`` of bf16 pairs: register j of lane
    4 * g + t holds rows ``ks * 16 + 8 * j + 2 * t`` (low half) and ``+ 1``
    (high half) of column ``nt * 8 + g``, the m16n8k16 B layout."""
    taps, kp, npad = band.shape
    ks, nt = kp // 16, npad // 8
    f = band.to(torch.bfloat16).reshape(taps, ks, 2, 4, 2, nt, 8)  # (., ks, j, t, half, nt, g)
    f = f.permute(0, 1, 5, 2, 6, 3, 4).contiguous()  # (., ks, nt, j, g, t, half)
    return f.view(torch.int32).reshape(taps, ks, nt, 2, 32)


def tf32_fragments(band):
    """float32 banded filter ``(9, KS * 8, NT * 8)`` -> the float32
    kernel's B fragments, float32 ``(9, KS, NT, 32, 4)``: lane 4 * g + t
    holds ``hi`` at rows ``ks * 8 + t`` and ``+ 4`` of column ``nt * 8 +
    g`` (the m16n8k8 TF32 B registers b0, b1), then ``lo`` at the same
    two, for :func:`..fine_stage.tf32_split`'s ``(hi, lo)``."""
    # imported here: ops.fine_stage imports the models, whose NCN imports this module
    from patch2pix_tpu_torch.ops.fine_stage import tf32_split

    taps, kp, npad = band.shape
    ks, nt = kp // 8, npad // 8
    parts = []
    for p in tf32_split(band.float()):
        f = p.reshape(taps, ks, 2, 4, nt, 8)  # (., ks, j, t, nt, g)
        parts.append(f.permute(0, 1, 4, 5, 3, 2).reshape(taps, ks, nt, 32, 2))
    return torch.cat(parts, dim=-1).contiguous()


def staging_mode(x):
    """How the kernel stages the planes of x ``(B, h1, w1, h2, w2, Cin)``,
    whose cells share one stride: 1 (one load a position: 8 bytes in
    bf16, 16 in float32) where x is channels-last with Cin 4 (ci
    contiguous, l stride 4, the j and k strides multiples of 4, a
    position's 4 elements aligned to their size), as the volume the NCN's
    first layer leaves on the card; 2 (16-byte loads of 8 positions along
    l) where x is bf16 with Cin 1, l stride 1, the j and k strides and w2
    multiples of 8 and x 16-byte aligned, as the NCN's input volume; else
    0 (any strides, one load an element)."""
    _, _, sj, sk, sl, sc = x.stride()
    if x.shape[5] == 1:
        return 2 * int(x.dtype == torch.bfloat16 and sl == 1 and sj % 8 == 0 and sk % 8 == 0
                       and x.shape[4] % 8 == 0 and x.data_ptr() % 16 == 0)
    cl4 = (x.shape[5] == 4 and sc == 1 and sl == 4 and sj % 4 == 0 and sk % 4 == 0
           and x.data_ptr() % (4 * x.element_size()) == 0)
    return int(cl4)


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
    cin1 = cin == 1 and cout in CIN1_COUTS and x.dtype == torch.bfloat16
    if w.shape[:4] != (K,) * 4 or w.shape[4] != cin or not (
            cin1 or (cin * cout <= 16 and min(cin, cout) >= 3)):
        raise ValueError(f"conv4d_small: filter {tuple(w.shape)} on {x.dtype}")
    sb, si, sj, sk, sl, sc = x.stride()
    if si != w1 * sj or sb != h1 * si:
        # the kernel walks the cells (b, i, j) with one stride
        x = x.contiguous()
        sb, si, sj, sk, sl, sc = x.stride()
    mma = x.dtype == torch.bfloat16
    mode = staging_mode(x)
    # the banded filter as the kernel's B fragments, from any filter
    # layout (a permuted one from the transposed branch): bf16 9 * KS * NT
    # * 256 B; float32 its TF32 hi and lo, 9 * KS * NT * 512 B
    if mma:
        wf = mma_fragments(banded_filter(w.to(torch.bfloat16)))
    else:
        wf = tf32_fragments(banded_filter(w.float(), pairs=False))
    bias = (torch.zeros(cout, dtype=torch.float32, device=dev) if b is None
            else b.float().contiguous())
    lib = _build.library("conv4d", _SIGNATURES)
    stream = _build.current_stream(dev)
    ptrs = (x.data_ptr(), wf.data_ptr(), bias.data_ptr())
    if cin1:
        # written channels-last, the layout the next layer's cuDNN conv
        # takes as it is
        out = torch.empty((bs, h1, w1, h2, w2, cout), dtype=odt, device=dev)
        rc = lib.p2p_conv4d_cin1(*ptrs, out.data_ptr(), bs, h1, w1, h2, w2, cout, sj, sk, sl,
                                 _DTYPES[odt], mode, stream)
        _build.check_launch(rc, "conv4d_small (Cin 1)")
        conv4d_small.launches += 1
        conv4d_small.cin1_launches += 1
        profiling.count("conv4d.first_layer_kernel", 1)
        return out
    # written NCHW per cell, (B*h1*w1, Cout, h2, w2); returned as the 6D
    # channels-last view
    out = torch.empty((bs * h1 * w1, cout, h2, w2), dtype=odt, device=dev)
    args = (*ptrs, out.data_ptr(), bs, h1, w1, h2, w2, cin, cout, sj, sc, sk, sl,
            _DTYPES[x.dtype], _DTYPES[odt])
    entry = lib.p2p_conv4d_small_mma if mma else lib.p2p_conv4d_small_tf32
    _build.check_launch(entry(*args, mode, stream), "conv4d_small")
    conv4d_small.launches += 1
    conv4d_small.mma_launches += mma
    conv4d_small.tf32_launches += not mma
    conv4d_small.channels_last_launches += mode
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
    ``(3, 3, 3, 3, Cin, Cout)`` with Cin, Cout > 2 and Cin*Cout <= 16, or
    (bfloat16 x on the card) Cin 1 and Cout in :data:`CIN1_COUTS` (any
    layout), bias ``(Cout,)`` -> ``(B, h1, w1, h2, w2, Cout)`` float32 or
    ``out_dtype``. On the card x may be any view whose cells (b, i, j)
    share one stride; the result of Cin 1 is contiguous (channels-last),
    any other a permuted view of an NCHW-per-cell tensor."""
    return _Conv4dSmall.apply(x, w, b, out_dtype)


conv4d_small.launches = 0
conv4d_small.mma_launches = 0  # of those, the bf16 kernel's (m16n8k16)
conv4d_small.tf32_launches = 0  # of those, the float32 kernel's (3xTF32 m16n8k8)
conv4d_small.channels_last_launches = 0  # of those, staging channels-last Cin 4
conv4d_small.cin1_launches = 0  # the Cin-1 kernel's (bf16 m16n8k16), counted in launches too
