"""Fused fine-stage head: superblock rows -> pooled regressor features.

Port of ``patch2pix_tpu.ops.fine_stage_pallas``. The unfused fine stage
expands the superblock rows into scaled patches (B3, 636.5 MB of bf16
patches per stage at M=2400) that the regressor's conv0 then reads back.
The fused head keeps the heavy levels on the chip:

:func:`head_prolog` (plain PyTorch around kernel B7):
  * the inverse hypercolumn norms from the expansion (B7, C=1) of each
    level's per-pixel channel square-sums, added in level order — the
    expansion is a copy, so this equals the square-sum of the expanded
    patch;
  * the C=3 image level's conv0 contribution: its expansion (B7), scaled,
    through a cuDNN stride-2 conv.

:func:`fused_fine_head` (kernel B5, ``csrc/fine_head.cu``), per proposal:
    window expansion of the C >= 64 levels (both sides) -> scale by inv
    -> conv0 3x3/2 per level segment, seeded with ``partial0`` -> BN0
    affine -> conv1 3x3/1 -> BN1 affine -> ReLU -> global max,
writing only the (M, F) pooled features. On CPU tensors it runs
:func:`fused_fine_head_plain`. :func:`fused_fine_stage` chains the two
(:func:`head_args` prepares a regressor's weights) with
:meth:`FeatRegressNet.fc_head` into the (M, 5) outputs, the port's
counterpart of ``tools/try_fine_stage.py``.

Rounding points, as in ``_head_kernel``: the expansion in the rows'
dtype, times ``inv`` rounded to ``out_dtype``, rounded to ``out_dtype``;
conv0 sums in float32 from ``partial0``; BN0, then rounded; conv1 sums in
float32; BN1, ReLU and the max in ``out_dtype``. The float32 kernel
forms each product from TF32 parts (three tensor-core products of
:func:`tf32_split`'s hi and lo, about 2^-20 of the product away from
the float32 one). Inference only, and never dispatched by
``Patch2Pix.predict_fine``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from patch2pix_tpu_torch.models.resnet import conv2d_nhwc
from patch2pix_tpu_torch.ops import _build
from patch2pix_tpu_torch.ops.patch_expand import EPS, expand_level, expand_level_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {"p2p_fine_head": "ppppp" "i" "pppp" "ppp" "pppp" "pppp" "pp" "ii" "p",
               "p2p_fine_head_bf16": "ppppp" "i" "pppp" "ppp" "pp" "pppp" "pp" "iii" "p",
               "p2p_fine_head_smem": "", "p2p_fine_head_bf16_smem": ""}
PAIRED_C = 64  # levels whose two sides share one 2C-channel conv0 segment

# The kernels' blocks (csrc/fine_head.cu: KB, BN, STAGES; KBF, BNF,
# STAGES_F): K-block channels (one 128-byte row), output channels, ring
# stages and weight tiles a stage (float32: the TF32 hi and lo parts).
# Each of the two consumer warpgroups has a 64 KB A tile: conv0's
# windows and both sides' (16, 16) float32 inverse norms.
KERNEL_PLAN = {torch.bfloat16: (64, 256, 3, 1), torch.float32: (32, 128, 3, 2)}
A_TILE_BYTES = 64 * 1024
WINDOW_BYTES = A_TILE_BYTES - 2 * 16 * 16 * 4


def bn_affine(scale, bias, mean, var, eps: float = 1e-5):
    """Inference BatchNorm -> per-channel (scale, shift) float32."""
    s = scale.float() * torch.rsqrt(var.float() + eps)
    return s, bias.float() - mean.float() * s


def segment_weights(kernel: torch.Tensor, cs: Sequence[int], dtype):
    """Regressor conv0 kernel ``(3, 3, 2D, F)`` (HWIO, the JAX layout)
    -> per-segment ``(9, C', F)`` slices for the C >= 64 levels, in
    pyramid order: a C=64 level concatenates both sides' slices (one
    paired segment), a wider level gives one segment per side."""
    d = sum(cs)
    f = kernel.shape[-1]
    segs, off = [], 0
    for c in cs:
        if c >= PAIRED_C:
            s1 = kernel[:, :, off:off + c, :]
            s2 = kernel[:, :, d + off:d + off + c, :]
            parts = [torch.cat([s1, s2], dim=2)] if c == PAIRED_C else [s1, s2]
            segs += [p.reshape(9, p.shape[2], f).to(dtype).contiguous() for p in parts]
        off += c
    return segs


def head_prolog(rows1, rows2, y1, x1, y2, x2, conv0_kernel, psize: int,
                out_dtype) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """rows*: ALL pyramid levels' ``(M, 4, t, t*C)`` superblock rows;
    y*/x*: ``(M,)`` int32 padded corners; conv0_kernel: the regressor's
    ``(3, 3, 2D, F)`` kernel. Returns ``(inv1, inv2, partial0)``: the
    per-side ``(M, p, p)`` float32 inverse hypercolumn norms and the image
    level's ``(M, p/2, p/2, F)`` float32 conv0 contribution."""
    cs = [r.shape[3] // r.shape[2] for r in rows1]
    d = sum(cs)
    invs, e0s = [], []
    for rows, y0, x0 in ((rows1, y1, x1), (rows2, y2, x2)):
        sq = None
        for r, c in zip(rows, cs):
            m, _, t, _ = r.shape
            rsq = r.reshape(m, 4, t, t, c).float().square().sum(dim=-1)
            s = expand_level(rsq, y0, x0, psize)[..., 0]
            sq = s if sq is None else sq + s
        invs.append(torch.rsqrt(sq + EPS))
        e0s.append(expand_level(rows[0], y0, x0, psize))
    partial0 = None
    for side, (e0, inv) in enumerate(zip(e0s, invs)):
        scaled = e0.to(out_dtype) * inv.to(out_dtype)[..., None]
        ks = conv0_kernel[:, :, side * d:side * d + cs[0], :].to(out_dtype)
        y = conv2d_nhwc(scaled, ks.permute(3, 2, 0, 1), 2, 1).float()
        partial0 = y if partial0 is None else partial0 + y
    return invs[0], invs[1], partial0


def _conv_taps(acc, x, w9, stride: int, oh: int):
    """acc + the 3x3 conv (zero padding 1) of NHWC ``x`` with the
    im2col'd ``w9 (9, C, F)``: one float32 matmul per tap, added to acc
    in tap order."""
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    span = stride * (oh - 1) + 1
    for dy in range(3):
        for dx in range(3):
            xt = xp[:, dy:dy + span:stride, dx:dx + span:stride, :]
            y = torch.matmul(xt.float(), w9[3 * dy + dx].float())
            acc = y if acc is None else acc + y
    return acc


def fused_fine_head_plain(rows1, rows2, y1, x1, y2, x2, inv1, inv2, partial0,
                          w0_segs, wc1, bn0, bn1, psize: int, out_dtype):
    """The plain version of :func:`fused_fine_head`, the same arithmetic
    in whole-tensor PyTorch ops."""
    oh = psize // 2
    acc = partial0.float()
    inv_od = [inv.to(out_dtype).float()[..., None] for inv in (inv1, inv2)]
    segs = iter(w0_segs)
    for r1, r2 in zip(rows1, rows2):
        scaled = [(expand_level_plain(r, y, x, psize).float() * iv).to(out_dtype)
                  for r, y, x, iv in ((r1, y1, x1, inv_od[0]), (r2, y2, x2, inv_od[1]))]
        c = r1.shape[3] // r1.shape[2]
        for x in ([torch.cat(scaled, dim=-1)] if c == PAIRED_C else scaled):
            acc = _conv_taps(acc, x, next(segs), 2, oh)
    x1b = (acc * bn0[0] + bn0[1]).to(out_dtype)
    y = (_conv_taps(None, x1b, wc1, 1, oh) * bn1[0] + bn1[1]).to(out_dtype)
    return torch.clamp_min(y, 0).amax(dim=(1, 2))


def smem_bytes(dtype) -> int:
    """Dynamic shared memory a block of the ``dtype`` kernel asks for: 1 KB
    of slack that aligns the ring to the swizzle's 1024 bytes, the ring,
    both consumer warpgroups' A tiles and a zero row."""
    kb, bn, stages, tiles = KERNEL_PLAN[dtype]
    row = kb * dtype.itemsize
    return 1024 + stages * tiles * bn * row + 2 * A_TILE_BYTES + row


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Finite float32 ``x`` (below the largest float's TF32 rounding
    point) -> ``(hi, lo)``: ``hi`` is x rounded to TF32, its 13 low
    mantissa bits zero (to nearest, ties away from zero, as
    ``cvt.rna.tf32.f32``); ``lo = x - hi``, exact, so ``hi + lo == x``
    bit for bit (a zero's ``lo`` carries its sign)."""
    hi = ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    lo = x - hi
    return hi, torch.where(lo == 0, torch.copysign(torch.zeros_like(x), x), lo)


def fused_fine_head(rows1, rows2, y1, x1, y2, x2, inv1, inv2, partial0,
                    w0_segs, wc1, bn0, bn1, psize: int, out_dtype=torch.bfloat16):
    """rows*: the C >= 64 levels' ``(M, 4, t, t*C)`` superblock rows in
    ``out_dtype``; y*/x*: ``(M,)`` int32 padded corners; inv1/inv2,
    partial0: from :func:`head_prolog`; w0_segs: :func:`segment_weights`;
    wc1: ``(9, F, F)`` im2col'd conv1 kernel; bn0/bn1: (scale, shift)
    float32 pairs. Returns the pooled ``(M, F)`` features in
    ``out_dtype``. The card's kernels take psize 16, F up to 512 (in
    bf16 a multiple of 8, in float32 of 32), levels whose channels are a
    multiple of the K block (bf16 64, float32 32), at most 1024 conv0
    channels, and one proposal's windows in 62 KB (``WINDOW_BYTES``;
    the fine stage's levels take 31 KB in bf16, all 62 in float32)."""
    rows1, rows2 = tuple(rows1), tuple(rows2)
    args = (rows1, rows2, y1, x1, y2, x2, inv1, inv2, partial0, w0_segs, wc1, bn0, bn1)
    tensors = (rows1 + rows2 + (y1, x1, y2, x2, inv1, inv2, partial0) + tuple(w0_segs)
               + (wc1,) + tuple(bn0) + tuple(bn1))
    if all(t.device.type == "cpu" for t in tensors):
        return fused_fine_head_plain(*args, psize, out_dtype)
    dev = y1.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("fused_fine_head: tensors must share one CUDA device")
    if out_dtype not in _DTYPES or any(r.dtype != out_dtype for r in rows1 + rows2):
        raise TypeError(f"fused_fine_head: rows must be {out_dtype} in {list(_DTYPES)}")
    m = y1.shape[0]
    f = wc1.shape[-1]
    fmult = 8 if out_dtype == torch.bfloat16 else 32
    if psize != 16 or f % fmult or f > 512 or wc1.shape != (9, f, f):
        raise ValueError(f"fused_fine_head: psize {psize}, wc1 {tuple(wc1.shape)}")
    for v in (y1, x1, y2, x2):
        if v.dtype != torch.int32 or v.shape != (m,) or not v.is_contiguous():
            raise ValueError("fused_fine_head: corners must be contiguous (M,) int32")
    _build.refuse_grad("fused_fine_head", *tensors)
    inv1, inv2 = (_dense(t, torch.float32, (m, psize, psize)) for t in (inv1, inv2))
    partial0 = _dense(partial0, torch.float32, (m, psize // 2, psize // 2, f))
    bns = [_dense(t, torch.float32, (f,)) for t in (*bn0, *bn1)]
    levels = []  # (rows1, rows2, t, c), each level's weight segments checked
    w_iter = iter(w0_segs)
    for r1, r2 in zip(rows1, rows2):
        _, four, t, tc = r1.shape
        c = tc // t
        if (r2.shape != r1.shape or r1.shape[0] != m or four != 4 or tc != t * c
                or psize % t or not (r1.is_contiguous() and r2.is_contiguous())):
            raise ValueError(f"fused_fine_head: rows {tuple(r1.shape)}, {tuple(r2.shape)}")
        for cseg in ((2 * c,) if c == PAIRED_C else (c, c)):
            w = next(w_iter, None)
            if w is None or tuple(w.shape) != (9, cseg, f):
                raise ValueError(f"fused_fine_head: weight segment for rows "
                                 f"{tuple(r1.shape)} is not (9, {cseg}, {f})")
        levels.append((r1, r2, t, c))
    if next(w_iter, None) is not None:
        raise ValueError("fused_fine_head: more weight segments than row segments")
    out = _launch(levels, y1, x1, y2, x2, inv1, inv2, partial0, w0_segs, wc1, bns, m, f,
                  out_dtype)
    fused_fine_head.launches += 1
    return out


def _dense(t, dtype, shape):
    if tuple(t.shape) != shape:
        raise ValueError(f"fused_fine_head: {tuple(t.shape)}, expected {shape}")
    t = t.to(dtype).contiguous()
    # fresh storage: the kernels' vector loads need it aligned
    return t if t.data_ptr() % 256 == 0 else t.clone()


def head_chunks(levels, width: int = 64):
    """The kernels' conv0 K chunks, in :func:`segment_weights`' channel
    order: ``[(level, side, first channel)]``, ``width`` channels each
    (bf16 64, float32 32): each side's runs of its level, a paired C=64
    level's first side first."""
    out = []
    for li, (_, _, _, c) in enumerate(levels):
        if c % width:
            raise ValueError(f"fused_fine_head: the kernel takes levels of a multiple of "
                             f"{width} channels, not {c}")
        out += [(li, side, off) for side in (0, 1) for off in range(0, c, width)]
    return out


def kmajor_weights(w9: torch.Tensor, cin_pad: int, width: int = 64) -> torch.Tensor:
    """``(9, C, F)`` im2col'd conv weights -> the kernels' ``(F, 9 *
    Cp)``: K ordered (``width``-channel chunk, tap, channel), the channels
    zero-padded to ``cin_pad`` (a multiple of ``width``)."""
    _, c, f = w9.shape
    if cin_pad != c:
        w9 = torch.cat([w9, w9.new_zeros((9, cin_pad - c, f))], dim=1)
    return (w9.reshape(9, cin_pad // width, width, f).permute(3, 1, 0, 2)
            .reshape(f, 9 * cin_pad).contiguous())


def _launch(levels, y1, x1, y2, x2, inv1, inv2, partial0, w0_segs, wc1, bns, m, f, dtype):
    kb = KERNEL_PLAN[dtype][0]
    chunks = head_chunks(levels, kb)
    window_bytes = sum((levels[li][2] + 1) ** 2 * 128 for li, _, _ in chunks)
    if kb * len(chunks) > 1024 or window_bytes > WINDOW_BYTES:
        raise ValueError(f"fused_fine_head: {kb * len(chunks)} conv0 channels (at most 1024) "
                         f"in {window_bytes} B of windows (at most {WINDOW_BYTES})")
    rows = []
    for li, side, off in chunks:
        r = levels[li][side]
        rows.append(r if r.data_ptr() % 16 == 0 else r.clone())
    fp = -(-f // kb) * kb
    wt0 = kmajor_weights(torch.cat([w.to(dtype) for w in w0_segs], dim=1), kb * len(chunks), kb)
    wt1 = kmajor_weights(wc1.to(dtype), fp, kb)
    # bf16: one weight tensor a conv; float32: its TF32 hi and lo parts
    weights = (wt0, wt1) if dtype == torch.bfloat16 else (*tf32_split(wt0), *tf32_split(wt1))
    x1buf = torch.empty((m, 64, fp), dtype=dtype, device=y1.device)
    out = torch.empty((m, f), dtype=dtype, device=y1.device)
    n = len(chunks)
    cols = ([r.data_ptr() for r in rows],
            [levels[li][2].bit_length() - 1 for li, _, _ in chunks],
            [levels[li][3] for li, _, _ in chunks], [off for _, _, off in chunks],
            [side for _, side, _ in chunks])
    arrays = [(ctypes.c_void_p * n)(*cols[0])] + [(ctypes.c_int * n)(*c) for c in cols[1:]]
    lib = _build.library("fine_head", _SIGNATURES)
    entry = lib.p2p_fine_head_bf16 if dtype == torch.bfloat16 else lib.p2p_fine_head
    sizes = (m, f, fp) if dtype == torch.bfloat16 else (m, f)
    rc = entry(
        *(ctypes.addressof(a) for a in arrays), n,
        y1.data_ptr(), x1.data_ptr(), y2.data_ptr(), x2.data_ptr(),
        inv1.data_ptr(), inv2.data_ptr(), partial0.data_ptr(), *(w.data_ptr() for w in weights),
        *(b.data_ptr() for b in bns), x1buf.data_ptr(), out.data_ptr(), *sizes,
        _build.current_stream(y1.device),
    )
    _build.check_launch(rc, "fused_fine_head")
    return out


fused_fine_head.launches = 0


def head_args(net, rows1, rows2, y1, x1, y2, x2, psize: int):
    """The prolog of a ``FeatRegressNet``'s (feat_comb ``pre``, two
    convs) fused fine stage: :func:`head_prolog` and the weights in
    :func:`fused_fine_head`'s layout. rows*: all pyramid levels'
    superblock rows in ``net.dtype``. Returns fused_fine_head's
    arguments."""
    if net.feat_comb != "pre":
        raise ValueError(f"the fused fine head takes feat_comb 'pre', not {net.feat_comb!r}")
    dtype = net.dtype
    conv0, bn0, conv1, bn1 = list(net.conv)
    kernel0 = conv0.weight.permute(2, 3, 1, 0)  # (3, 3, 2D, F)
    f = conv1.weight.shape[0]
    inv1, inv2, partial0 = head_prolog(rows1, rows2, y1, x1, y2, x2, kernel0.to(dtype),
                                       psize, dtype)
    return (rows1[1:], rows2[1:], y1, x1, y2, x2, inv1, inv2, partial0,
            segment_weights(kernel0, [r.shape[3] // r.shape[2] for r in rows1], dtype),
            conv1.weight.permute(2, 3, 1, 0).reshape(9, f, f).to(dtype),
            bn_affine(bn0.weight, bn0.bias, bn0.running_mean, bn0.running_var, bn0.eps),
            bn_affine(bn1.weight, bn1.bias, bn1.running_mean, bn1.running_var, bn1.eps),
            psize, dtype)


def fused_fine_stage(net, rows1, rows2, y1, x1, y2, x2, psize: int):
    """The fine stage of a ``FeatRegressNet`` through the fused head:
    :func:`head_args`, then :func:`fused_fine_head`, then
    ``net.fc_head``. Returns (pooled (M, F), outputs (M, 5))."""
    pooled = fused_fine_head(*head_args(net, rows1, rows2, y1, x1, y2, x2, psize))
    return pooled, net.fc_head(pooled)
