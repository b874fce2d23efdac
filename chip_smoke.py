#!/usr/bin/env python3
"""Drive the PyTorch port (``patch2pix_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

  1. print the card's name and power limit, build the five CUDA sources
     (one ``nvcc`` per source, in parallel) and print the build time;
  2. for each kernel (B1 tap_sum, B2 corr_pool, B3 expand_scale_pair, B4
     conv4d_small, B5 fused_fine_head, B7 expand_level), at the shapes of
     its path (change_stride, 1024x768, B=2: the NCN volume, M = 2400
     proposals, F = 512; B2 also at upsample 16), in bf16 and in float32:
     hold the kernel against its plain PyTorch version on the card, time
     kernel, plain version and library yardstick, and compute the bound
     from the bytes and operations this run's inputs need (B3 also
     prints its share of the bound);
  3. golden parity in float32 with TF32 off: rebuild the seeded weights
     and reproduce ``tests/fixtures/pipeline_golden_{s16,cs}_1024.npz``
     (identical coarse set, coords 0.05 px, scores 5e-3) — every kernel's
     launch count must rise;
  4. the main path in bf16 at 1024x768: ``Matcher.match_arrays`` on one
     pair, then ``Patch2Pix.predict_fine`` at B=2, fine_cap 1200, for
     change_stride and upsample 16: output checks, kernel launches per
     call, pairs/s over 10 calls back to back, the median latency of 10
     calls each waited for, peak device memory; then, per stride, the
     top device kernels (and the port's own wherever they rank) and the
     device busy share over 3 calls under torch.profiler (after the
     launch counts are read);
  5. the conv4d path: a symmetric NeighConsensus with channels (4, 4, 1)
     in bf16 on the change_stride volume — B4 twice and B1 twice per
     call, output held against the same NCN with B4's plain version;
     then one B4 layer's backward through the kernel against the CPU's;
  6. the fine-head path (the port's ``tools/try_fine_stage.py``): a
     full-width fine FeatRegressNet, M = 2400 seeded bf16 rows, (M, 5)
     outputs fused (prolog with B7, B5, fc_head) and unfused (B3,
     ``forward``), held to the rules below, both timed;
  7. one JSON line of per-kernel numbers, then the result line.

Each path's launches are counted from zero just before it runs: phase 4
for B1-B3, phase 5 for B4, phase 6 for B5 and B7.

Needs one CUDA card, ``nvcc`` and the repository checkout; imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from patch2pix_tpu_torch.config import ModelConfig
from patch2pix_tpu_torch.evaluation.matcher import Matcher
from patch2pix_tpu_torch.models.ncn import NeighConsensus
from patch2pix_tpu_torch.models.patch2pix import Patch2Pix
from patch2pix_tpu_torch.models.regressor import FeatRegressNet
from patch2pix_tpu_torch.ops import _build
from patch2pix_tpu_torch.ops import conv4d as conv4d_module
from patch2pix_tpu_torch.ops.conv4d_small import conv4d_small, conv4d_small_plain
from patch2pix_tpu_torch.ops.corr_pool import LAYOUTS as CORR_POOL_LAYOUTS
from patch2pix_tpu_torch.ops.corr_pool import cell_parity_rows, corr_pool, corr_pool_plain
from patch2pix_tpu_torch.ops.correlation import l2_normalize
from patch2pix_tpu_torch.ops.fine_stage import _SIGNATURES as FINE_HEAD_SIGNATURES
from patch2pix_tpu_torch.ops.fine_stage import (
    fused_fine_head,
    fused_fine_head_plain,
    fused_fine_stage,
    head_args,
    head_prolog,
    segment_weights,
)
from patch2pix_tpu_torch.ops.patch_expand import (
    _window_indices,
    expand_level,
    expand_level_plain,
    expand_scale_pair,
    expand_scale_pair_plain,
    output_slice_map,
    window_extent,
)
from patch2pix_tpu_torch.ops.patch_expand import plan as expand_plan
from patch2pix_tpu_torch.ops.tap_sum import flat_shift_masks, tap_sum, tap_sum_plain
from tests.ref_loader import seeded_state_dict

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXDIR = os.path.join(ROOT, "tests", "fixtures")

# published H100 SXM peaks (dense): HBM bytes/s, bf16 tensor-core and
# f32 (non-tensor) FLOP/s
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

KERNELS = {  # wrapper -> (name, source, TPU kernel it replaces)
    tap_sum: ("tap_sum", "patch2pix_tpu_torch/csrc/tap_sum.cu",
              "patch2pix_tpu/ops/tap_sum_pallas.py:123"),
    corr_pool: ("corr_pool", "patch2pix_tpu_torch/csrc/corr_pool.cu",
                "patch2pix_tpu/ops/corr_pool_pallas.py:126"),
    expand_scale_pair: ("expand_scale_pair", "patch2pix_tpu_torch/csrc/patch_expand.cu",
                        "patch2pix_tpu/ops/patch_expand_pallas.py:436"),
    conv4d_small: ("conv4d_small", "patch2pix_tpu_torch/csrc/conv4d.cu",
                   "patch2pix_tpu/ops/conv4d_pallas.py:169"),
    fused_fine_head: ("fused_fine_head", "patch2pix_tpu_torch/csrc/fine_head.cu",
                      "patch2pix_tpu/ops/fine_stage_pallas.py:332"),
    expand_level: ("expand_level", "patch2pix_tpu_torch/csrc/patch_expand.cu",
                   "tools/try_expand_kernels.py:93"),
}

# the device functions of csrc/*.cu, as the profiler names them
PORT_KERNEL_NAMES = ("tap_sum_kernel", "corr_pool_bf16_kernel", "corr_pool_f32_kernel",
                     "expand_kernel", "expand_level_kernel", "conv4d_small_kernel",
                     "fine_head_bf16_kernel", "fine_head_f32_kernel")

# the main path's setting: 1024x768, B=2, fine_cap 1200
H, W, BATCH, FINE_CAP = 768, 1024, 2, 1200
PSIZE = 16
# the change_stride fine stage: (t, C) per pyramid level, regressor width
LEVELS = ((16, 3), (8, 64), (4, 64), (2, 128))
F_REG = 512


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise SystemExit(f"FAIL: {msg}")


def time_ms(fn, iters=20, warmup=3):
    """Mean ms per call over ``iters`` calls, CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn):
    """{device kernel name: ms} of one call of fn, from torch.profiler."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.name] = out.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
    return out


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bf16_ulps(got, want, atol=0.0):
    """(|got - want| - atol)+ in units of one bf16 ulp of ``want`` (float32
    tensors holding bf16 values). ``atol`` absorbs the float32 rounding of
    a sum whose value is small beside its terms, where one bf16 ulp of the
    value is below the sum's own rounding error."""
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    return ((got - want).abs() - atol).clamp_min(0) / ulp


def reset_counts():
    for fn in KERNELS:
        fn.launches = 0


def counts():
    return {KERNELS[fn][0]: fn.launches for fn in KERNELS}


# ------------------------------------------------------------ phase 2


def check_tap_sum(dtype, gen, dev):
    """B1 at the cs main-path shape: N = B*48*64 cells, HW = 48*64."""
    bs, h1, w1, hw = BATCH, H // 16, W // 16, (H // 16) * (W // 16)
    n = bs * h1 * w1
    z = torch.randn((n, 9, hw), generator=gen, device=dev).to(dtype)
    bias = torch.randn((1,), generator=gen, device=dev)
    got = tap_sum(z, bias, bs, h1, w1)
    want = tap_sum_plain(z, bias, bs, h1, w1)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"tap_sum {dtype}: not bit-identical to the plain version "
             f"(max err {(got - want).abs().max().item()})")
    err = (got - want).abs().max().item()
    ms = time_ms(lambda: tap_sum(z, bias, bs, h1, w1))
    plain_ms = time_ms(lambda: tap_sum_plain(z, bias, bs, h1, w1), iters=5)
    # the function reads z only at the taps its masks keep
    taps = sum(int(mask.sum()) for _, mask in flat_shift_masks(bs, h1, w1, dev))
    z_bytes = taps * hw * z.element_size()
    b_ms, b_by = bound(z_bytes + nbytes(bias, got), (taps + n) * hw, torch.float32)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                shape=f"z {tuple(z.shape)} {dtype} -> {tuple(got.shape)} f32")


def bmm_amax(f1, f2, out_dtype=None):
    """The library yardstick: one cuBLAS bmm then the 2^4 values pool."""
    b, h1, w1, c = f1.shape
    _, h2, w2, _ = f2.shape
    a, m = f1.reshape(b, h1 * w1, c), f2.reshape(b, h2 * w2, c).transpose(1, 2)
    c4 = torch.bmm(a, m) if out_dtype is None else torch.bmm(a, m, out_dtype=out_dtype)
    return c4.reshape(b, h1 // 2, 2, w1 // 2, 2, h2 // 2, 2, w2 // 2, 2).amax(dim=(2, 4, 6, 8))


def corr_pool_library(f1, f2):
    """(call, label): for bf16, ``torch.bmm(..., out_dtype=torch.float32)``
    computes the kernel's function (f32 sums and output) where this torch
    has that overload; else the bf16-output bmm, labelled so."""
    if f1.dtype == torch.float32:
        return (lambda: bmm_amax(f1, f2)), "bmm + amax"
    try:
        bmm_amax(f1[:1, :2, :2], f2[:1, :2, :2], torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        return (lambda: bmm_amax(f1, f2)), "bf16-output bmm + amax"
    return (lambda: bmm_amax(f1, f2, torch.float32)), "bmm (f32 out) + amax"


def corr_pool_case(dtype, gen, dev, h, w):
    """B2 on 2x (BATCH, h, w, 256) unit-norm features (layer3): held
    against the plain version (max abs err <= 1e-4), timed beside it and
    the library yardstick."""
    c = 256
    f1 = l2_normalize(torch.randn((BATCH, h, w, c), generator=gen, device=dev)).to(dtype)
    f2 = l2_normalize(torch.randn((BATCH, h, w, c), generator=gen, device=dev)).to(dtype)
    got = corr_pool(f1, f2)
    want = corr_pool_plain(f1, f2)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not err <= 1e-4:
        fail(f"corr_pool {dtype} {tuple(f1.shape)}: max abs err {err} > 1e-4")
    ms = time_ms(lambda: corr_pool(f1, f2))
    plain_ms = time_ms(lambda: corr_pool_plain(f1, f2), iters=5)
    library, label = corr_pool_library(f1, f2)
    library_ms = time_ms(library, iters=5)
    # the wrapper's share: the two operand layout copies
    rows1, rows2, chans, k_major = CORR_POOL_LAYOUTS[dtype]
    layout_ms = time_ms(lambda: (cell_parity_rows(f1, rows1, chans, k_major),
                                 cell_parity_rows(f2, rows2, chans, k_major)))
    flops = 2 * BATCH * (h * w) * (h * w) * c
    b_ms, b_by = bound(nbytes(f1, f2, got), flops, dtype)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms,
                shape=f"2x {tuple(f1.shape)} {dtype} -> {tuple(got.shape)} f32, "
                      f"library = {label}, of ms the layout copies {layout_ms:.4f}")


def check_corr_pool(dtype, gen, dev):
    """B2 at the cs main-path shape, layer3 (B, 96, 128, 256); first the
    upsample-16 shape (B, 48, 64, 256), which runs it too, is checked and
    its numbers logged."""
    u = corr_pool_case(dtype, gen, dev, H // 16, W // 16)
    log(f"kernel corr_pool [{str(dtype)[6:]}] upsample 16, {u['shape']}: max_abs_err "
        f"{u['max_abs_err']:.3g} ms {u['ms']:.4f} plain_ms {u['plain_ms']:.4f} library_ms "
        f"{u['library_ms']:.4f} bound_ms {u['bound_ms']:.4f} ({u['bound_by']})")
    return corr_pool_case(dtype, gen, dev, H // 8, W // 8)


def check_expand(dtype, gen, dev):
    """B3 at the cs main-path shape: M = B*fine_cap proposals, levels
    (t, C) = (16, 3), (8, 64), (4, 64), (2, 128)."""
    m, psize = BATCH * FINE_CAP, 16
    levels = ((16, 3), (8, 64), (4, 64), (2, 128))
    rows = [[torch.randn((m, 4, t, t * c), generator=gen, device=dev).to(dtype)
             for t, c in levels] for _ in range(2)]
    # (y1, x1, y2, x2): padded corners in [0, H + psize) and [0, W + psize)
    corners = [torch.randint(0, lim + psize, (m,), generator=gen, device=dev,
                             dtype=torch.int32) for lim in (H, W, H, W)]
    args = (rows[0], rows[1], *corners, psize, dtype)
    got = expand_scale_pair(*args)
    want = expand_scale_pair_plain(*args)
    torch.cuda.synchronize()
    err = 0.0
    for g, w_ in zip(got, want):
        if g.shape != w_.shape or g.dtype != w_.dtype:
            fail(f"expand_scale_pair {dtype}: output {g.shape} vs {w_.shape}")
        diff = (g.float() - w_.float()).abs()
        err = max(err, diff.max().item())
        if dtype == torch.float32 and (diff > 1e-6 * w_.abs()).any():
            fail(f"expand_scale_pair f32: {int((diff > 1e-6 * w_.abs()).sum())} "
                 f"values beyond rtol 1e-6 (max rel err "
                 f"{(diff / w_.abs().clamp_min(1e-30)).max().item():.3g})")
    note = ""
    if dtype == torch.bfloat16:
        # a flip needs the two f32 inverse norms, a few f32 ulps apart, to
        # straddle a bf16 rounding midpoint; a bf16 ulp is 2^16 f32 ulps,
        # so flips are rare: one pixel in 10^4 at most
        flipped, pixels, max_ulps = expand_bf16_mismatch(got, want, levels, psize)
        if flipped * 1e4 > pixels:
            fail(f"expand_scale_pair bf16: {flipped} of {pixels} patch pixels "
                 f"disagree with the plain version")
        note = f", {flipped} of {pixels} pixels flipped inv (max {max_ulps:.3g} ulps off)"
    ms = time_ms(lambda: expand_scale_pair(*args))
    plain_ms = time_ms(lambda: expand_scale_pair_plain(*args), iters=5)
    flops = 3 * 2 * m * psize * psize * sum(c for _, c in levels)
    rows_bytes = window_bytes(levels, corners, psize, rows[0][0].element_size())
    b_ms, b_by = bound(rows_bytes + nbytes(*corners, *got), flops, torch.float32)
    smem = expand_plan(levels, psize, rows[0][0].element_size()).smem
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                shape=f"M={m} rows {[tuple(r.shape) for r in rows[0]]} {dtype}{note}, "
                      f"window reads {rows_bytes / 1e6:.1f} MB of "
                      f"{nbytes(*rows[0], *rows[1]) / 1e6:.1f} MB rows, "
                      f"{smem} B shared memory a block, {100 * b_ms / ms:.1f}% of its bound")


def expand_bf16_mismatch(got, want, levels, psize):
    """Hold B3's bf16 outputs against the plain version's, patch pixel by
    patch pixel. Both round the f32 inverse norm to bf16 and multiply the
    same operands, so a pixel whose rounded inverse norm agrees must agree
    bit for bit. The two sum the squares in different orders, so a
    rounding may flip to the neighbouring bf16 value, 2^-7 of it at most;
    each value of such a pixel may then be off by 2^-7 of it plus two
    ulps. Returns (pixels that disagree, pixels, most ulps off); fails on
    a value beyond the bound."""
    cs = [c for _, c in levels]
    d = sum(cs)  # side 2's channels start here in output_slice_map
    slices = output_slice_map([psize // t for t, _ in levels], cs, psize)
    flipped = [None, None]
    max_ulps = 0.0
    for g, w_, sl in zip(got, want, slices):
        k = 0
        for off, c in sl:
            side = int(off >= d)
            gs, ws = g[..., k:k + c].float(), w_[..., k:k + c].float()
            k += c
            ulp = torch.exp2(torch.floor(torch.log2(ws.abs().clamp_min(1e-30))) - 7)
            diff = (gs - ws).abs()
            if (diff > 2 ** -7 * ws.abs() + 2 * ulp).any():
                fail("expand_scale_pair bf16: a value beyond an inverse norm's flip")
            max_ulps = max(max_ulps, (diff / ulp).max().item())
            differs = (gs != ws).any(dim=-1)
            flipped[side] = differs if flipped[side] is None else flipped[side] | differs
    return (sum(int(f.sum()) for f in flipped), sum(f.numel() for f in flipped), max_ulps)


def window_bytes(levels, corners, psize, elsize):
    """Bytes of superblock rows that an expansion's outputs depend on:
    for each proposal, side (corners (y, x) in pairs) and level, the cells
    its patch window covers (t or t+1 along each axis, by the corner's
    alignment), C channels each."""
    total = 0
    for t, c in levels:
        for y0, x0 in zip(corners[0::2], corners[1::2]):
            cells = window_extent(y0, psize, t)[1] * window_extent(x0, psize, t)[1]
            total += int(cells.sum()) * c * elsize
    return total


def check_conv4d_small(dtype, gen, dev):
    """B4 at the change_stride NCN volume: a 4->4 layer on (2, 48, 64, 48,
    64, 4); bf16 in and out (the NCN's intermediate), or float32."""
    cin = cout = 4
    dims = (BATCH, H // 16, W // 16, H // 16, W // 16)
    x = torch.randn(dims + (cin,), generator=gen, device=dev).to(dtype)
    w = torch.randn((3, 3, 3, 3, cin, cout), generator=gen, device=dev) / (81 * cin) ** 0.5
    b = torch.randn((cout,), generator=gen, device=dev) * 0.1
    got = conv4d_small(x, w, b, dtype)
    want = conv4d_small_plain(x, w, b, dtype)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    note = ""
    if dtype == torch.float32:
        if not err <= 1e-4:
            fail(f"conv4d_small f32: max abs err {err} > 1e-4")
    else:
        ulps = bf16_ulps(got.float(), want.float(), atol=1e-5)
        if ulps.max().item() > 1:
            fail(f"conv4d_small bf16: {int((ulps > 1).sum())} values beyond one bf16 ulp "
                 f"+ 1e-5")
        note = f", {int((diff > 0).sum())} of {diff.numel()} values one ulp off"
    ms = time_ms(lambda: conv4d_small(x, w, b, dtype))
    plain_ms = time_ms(lambda: conv4d_small_plain(x, w, b, dtype), iters=2, warmup=1)
    flops = 2 * (x.numel() // cin) * 81 * cin * cout
    b_ms, b_by = bound(nbytes(x, w, b, got), flops, dtype)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None,
                shape=f"x {tuple(x.shape)} {dtype} -> 4 channels {got.dtype}{note}")


def check_expand_level(dtype, gen, dev):
    """B7 at the fine stage: M = B*fine_cap, each level of one side (one
    launch per level; times are for the four together)."""
    m = BATCH * FINE_CAP
    rows = [torch.randn((m, 4, t, t * c), generator=gen, device=dev).to(dtype)
            for t, c in LEVELS]
    y0, x0 = (torch.randint(0, W + PSIZE, (m,), generator=gen, device=dev, dtype=torch.int32)
              for _ in range(2))
    got = [expand_level(r, y0, x0, PSIZE) for r in rows]
    want = [expand_level_plain(r, y0, x0, PSIZE) for r in rows]
    # the yardstick: one advanced-indexing gather per level, the indices
    # made beforehand (not timed)
    mi = torch.arange(m, device=dev)[:, None, None]
    gathers = []
    for r, (t, c) in zip(rows, LEVELS):
        iy = _window_indices(y0, PSIZE, PSIZE // t)[:, :, None]
        ix = _window_indices(x0, PSIZE, PSIZE // t)[:, None, :]
        gathers.append((r.view(m, 2, 2, t, t, c), (mi, iy // t, ix // t, iy % t, ix % t)))
    lib = [r6[idx] for r6, idx in gathers]
    torch.cuda.synchronize()
    for g, w_, l_, (t, c) in zip(got, want, lib, LEVELS):
        if not (torch.equal(g, w_) and torch.equal(l_, w_)):
            fail(f"expand_level {dtype} (t={t}, C={c}): not bit-identical")
    ms = time_ms(lambda: [expand_level(r, y0, x0, PSIZE) for r in rows])
    plain_ms = time_ms(lambda: [expand_level_plain(r, y0, x0, PSIZE) for r in rows], iters=5)
    library_ms = time_ms(lambda: [r6[idx] for r6, idx in gathers], iters=5)
    per_level = [time_ms(lambda r=r: expand_level(r, y0, x0, PSIZE)) for r in rows]
    rows_bytes = window_bytes(LEVELS, (y0, x0), PSIZE, rows[0].element_size())
    b_ms, b_by = bound(rows_bytes + nbytes(y0, x0, *got), 0, torch.float32)
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms,
                shape=f"M={m} one side, levels {LEVELS} {dtype}, per level ms "
                      + "/".join(f"{t:.4f}" for t in per_level)
                      + f", window reads {rows_bytes / 1e6:.1f} MB")


def fine_head_inputs(dtype, gen, dev, m):
    """Seeded rows, in-range corners and a full-width head's weights.
    Returns (B5's arguments, a call of the cuDNN-chain yardstick)."""
    rows = [[torch.randn((m, 4, t, t * c), generator=gen, device=dev).to(dtype)
             for t, c in LEVELS] for _ in range(2)]
    corners = [torch.randint(0, 2 * PSIZE, (m,), generator=gen, device=dev, dtype=torch.int32)
               for _ in range(4)]
    cs = [c for _, c in LEVELS]
    cin = 2 * sum(cs)
    k0 = torch.randn((3, 3, cin, F_REG), generator=gen, device=dev) * (2 / (9 * cin)) ** 0.5
    k1 = torch.randn((3, 3, F_REG, F_REG), generator=gen, device=dev) * (2 / (9 * F_REG)) ** 0.5
    bns = [(torch.rand(F_REG, generator=gen, device=dev) + 0.5,
            torch.randn(F_REG, generator=gen, device=dev) * 0.1) for _ in range(2)]
    inv1, inv2, partial0 = head_prolog(rows[0], rows[1], *corners, k0.to(dtype), PSIZE, dtype)
    args = (rows[0][1:], rows[1][1:], *corners, inv1, inv2, partial0,
            segment_weights(k0, cs, dtype), k1.reshape(9, F_REG, F_REG).to(dtype),
            bns[0], bns[1], PSIZE, dtype)
    return args, cudnn_chain(dtype, rows, corners, k0, k1, bns, dev)


def cudnn_chain(dtype, rows, corners, k0, k1, bns, dev):
    """The yardstick the port never calls: cuDNN conv0 -> BN0 -> conv1
    -> BN1 -> ReLU -> max (``FeatRegressNet.pooled``) on B3's expanded
    patches of the same rows, with the same weights (the patches made
    beforehand, not timed)."""
    net = FeatRegressNet(feat_dim=sum(c for _, c in LEVELS), dtype=dtype, device=dev)
    with torch.no_grad():
        net.conv[0].weight.copy_(k0.permute(3, 2, 0, 1))
        net.conv[2].weight.copy_(k1.permute(3, 2, 0, 1))
        for bn, (scale, shift) in ((net.conv[1], bns[0]), (net.conv[3], bns[1])):
            bn.weight.copy_(scale)
            bn.bias.copy_(shift)
            bn.running_mean.zero_()
            bn.running_var.fill_(1 - bn.eps)
    net.eval()
    patches = expand_scale_pair(rows[0], rows[1], *corners, PSIZE, dtype)
    smap = output_slice_map([PSIZE // t for t, _ in LEVELS], [c for _, c in LEVELS], PSIZE)
    return lambda: net.pooled(patches, None, slice_map=smap)


def check_fine_head(dtype, gen, dev):
    """B5 at the change_stride fine stage: M = 2400, F = 512."""
    m = BATCH * FINE_CAP
    args, chain = fine_head_inputs(dtype, gen, dev, m)
    got = fused_fine_head(*args)
    want = fused_fine_head_plain(*args)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    note = ""
    if dtype == torch.float32:
        bad = diff > 2e-4 + 2e-4 * want.abs()
        if bad.any():
            fail(f"fused_fine_head f32: {int(bad.sum())} values beyond rtol/atol 2e-4 "
                 f"(max abs err {err})")
    else:
        ulps = bf16_ulps(got.float(), want.float(), atol=1e-3)
        if ulps.max().item() > 2:
            fail(f"fused_fine_head bf16: {int((ulps > 2).sum())} values beyond two bf16 ulps "
                 f"+ 1e-3")
        note = (f", {int((diff > 0).sum())} of {diff.numel()} values differ, "
                f"{int((ulps > 0).sum())} by more than 1e-3 (max {ulps.max().item():.2f} "
                f"ulps beyond it)")
    ms = time_ms(lambda: fused_fine_head(*args), iters=10)
    plain_ms = time_ms(lambda: fused_fine_head_plain(*args), iters=2, warmup=1)
    with torch.no_grad():
        chain_err = (chain().float() - want.float()).abs().max().item()
        chain_ms = time_ms(chain, iters=10)
    rows1, rows2, y1, x1, y2, x2, inv1, inv2, partial0, w0, wc1, bn0, bn1 = args[:13]
    segs = sum(w.shape[1] for w in w0)
    flops = 2 * m * (PSIZE // 2) ** 2 * F_REG * 9 * (segs + F_REG)
    rows_bytes = window_bytes(LEVELS[1:], (y1, x1, y2, x2), PSIZE, rows1[0].element_size())
    b_ms, b_by = bound(rows_bytes + nbytes(y1, x1, y2, x2, inv1, inv2, partial0, *w0, wc1,
                                           *bn0, *bn1, got), flops, dtype)
    # the wrapper's device time by kernel: conv0 and conv1 launches, the
    # weights' layout copies
    split = device_ms(lambda: fused_fine_head(*args))
    note += ", device ms " + ", ".join(
        f"{'conv1' if '<true>' in k else 'conv0' if '<false>' in k else k[:40]} {v:.4f}"
        for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
    if dtype == torch.bfloat16:
        lib = _build.library("fine_head", FINE_HEAD_SIGNATURES)
        note += f", {lib.p2p_fine_head_bf16_smem()} B shared memory a block"
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None,
                shape=f"M={m} levels {LEVELS[1:]} F={F_REG} {dtype}{note}, "
                      f"{flops / 1e12:.3f} TFLOP, {100 * b_ms / ms:.1f}% of its bound; "
                      f"library: none (no one PyTorch call computes it); yardstick cuDNN "
                      f"chain (FeatRegressNet.pooled on B3's patches) {chain_ms:.4f} ms, "
                      f"max abs diff to the plain version {chain_err:.3g}")


# ------------------------------------------------------------ phase 3/4


def seeded_images(batch, h, w, seed):
    rs = np.random.RandomState(seed)
    return (rs.rand(batch, h, w, 3).astype(np.float32) - 0.45) / 0.25


def load_golden(tag):
    g = np.load(os.path.join(FIXDIR, f"pipeline_golden_{tag}.npz"), allow_pickle=True)
    meta = json.loads(str(g["meta"]))
    sd = seeded_state_dict({k: tuple(s) for k, s in meta["shapes"].items()},
                           seed=meta["seed"])
    return g, meta, sd


def build_model(change_stride, sd, dtype, dev):
    cfg = ModelConfig(change_stride=change_stride, dtype=dtype).resolved()
    cfg.regressor.panc = 1
    model = Patch2Pix(cfg, device=dev)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    return model


def row_key(row):
    return tuple(int(round(float(v))) for v in row)


def assert_match_parity(b, ref_coarse, ref_mid, ref_mid_scores, ref_fine,
                        ref_fine_scores, fine, mid, cm, coord_tol, score_tol):
    """Align by coarse-row identity, then compare the regressed outputs
    (the rule of tests/test_pipeline_e2e_parity.py)."""
    ref_index = {row_key(r): i for i, r in enumerate(ref_coarse)}
    valid = np.where(cm.valid[b])[0]
    mine = {row_key(cm.coords[b, j]): j for j in valid}
    if set(mine) != set(ref_index):
        fail(f"batch {b}: coarse match sets differ (mine {len(mine)}, ref "
             f"{len(ref_index)}, common {len(set(mine) & set(ref_index))})")
    ri = np.asarray([ref_index[k] for k in ref_index])
    mi = np.asarray([mine[k] for k in ref_index])
    errs = {}
    for name, got, ref, tol in (
        ("mid", mid.coords[b][mi], ref_mid[ri], coord_tol),
        ("mid_scores", mid.scores[b][mi], ref_mid_scores[ri], score_tol),
        ("fine", fine.coords[b][mi], ref_fine[ri], coord_tol),
        ("fine_scores", fine.scores[b][mi], ref_fine_scores[ri], score_tol),
    ):
        errs[name] = float(np.abs(got - ref).max())
        if not errs[name] <= tol:
            fail(f"batch {b}: {name} err {errs[name]} > {tol}")
    return len(ri), errs


def to_numpy(matches):
    return type(matches)(*(t.cpu().numpy() for t in matches))


def check_outputs(tag, fine, mid, cm, b, h, w):
    n = cm.coords.shape[1]
    for name, mt in (("fine", fine), ("mid", mid), ("coarse", cm)):
        if mt.coords.shape != (b, n, 4) or mt.scores.shape != (b, n):
            fail(f"{tag}: {name} shapes {mt.coords.shape}, {mt.scores.shape}")
        if not (torch.isfinite(mt.coords).all() and torch.isfinite(mt.scores).all()):
            fail(f"{tag}: {name} has non-finite values")
    lims = torch.tensor([w, h, w, h], dtype=torch.float32, device=fine.coords.device)
    if (fine.coords < 0).any() or (fine.coords > lims).any():
        fail(f"{tag}: fine matches outside the image")
    if (fine.scores < 0).any() or (fine.scores > 1).any():
        fail(f"{tag}: confidences outside [0, 1]")
    return fine.valid.sum(dim=1).tolist()


def profile_main_path(tag, call, iters=3):
    """The top device kernels, the port's kernels wherever they rank,
    and the device busy share over ``iters`` main-path calls
    (torch.profiler)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us, n = kernels.get(ev.name, (0.0, 0))
            kernels[ev.name] = (us + ev.time_range.elapsed_us(), n + 1)
    busy = sum(us for us, _ in kernels.values())
    if not kernels:
        log(f"profile {tag}: the profiler recorded no device time")
        return
    log(f"profile {tag}: device busy {100 * busy / wall_us:.1f}% of "
        f"{wall_us / iters / 1e3:.2f} ms/call wall, {sum(n for _, n in kernels.values()) / iters:.0f}"
        f" device ops/call")
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    for rank, (name, (us, n)) in enumerate(ranked):
        # the top 15, and the port's own kernels wherever they rank
        if rank < 15 or any(k in name for k in PORT_KERNEL_NAMES):
            log(f"  kernel {us / iters / 1e3:8.3f} ms/call x{n // iters:<4d} #{rank + 1:<3d} "
                f"{name[:110]}")


# ------------------------------------------------------------ phase 5/6


class plain_b4:
    """Within the block, the port's conv4d sends B4's layers to the plain
    version (the reference the conv4d path is held against)."""

    def __enter__(self):
        self.saved = conv4d_module.conv4d_small
        conv4d_module.conv4d_small = conv4d_small_plain

    def __exit__(self, *exc):
        conv4d_module.conv4d_small = self.saved


def seeded_ncn(dev, channels=(4, 4, 1), seed=3):
    """A symmetric bf16 NeighConsensus with seeded fan-in-scaled weights."""
    rs = np.random.RandomState(seed)
    ncn = NeighConsensus(kernel_sizes=(3,) * len(channels), channels=channels,
                         dtype=torch.bfloat16, device=dev)
    sd, cin = {}, 1
    for li, cout in enumerate(channels):
        w = rs.randn(3, cout, cin, 3, 3, 3) * (2.0 / (81 * cin)) ** 0.5
        sd[f"conv.{2 * li}.weight"] = torch.from_numpy(w.astype(np.float32))
        sd[f"conv.{2 * li}.bias"] = torch.from_numpy((rs.randn(cout) * 0.05).astype(np.float32))
        cin = cout
    ncn.load_state_dict(sd)
    return ncn


def conv4d_path(dev):
    """Phase 5: NCN (4, 4, 1) on the change_stride volume, bf16. Rule for
    the kernel run against the plain-B4 run (the final layer is float32):
    max abs err <= 2^-4 of max |ref|, and at most 1e-4 of the values off
    by more than 2^-7 of it (a bf16 rounding flip in B4's output moves
    the next layer's bf16 z by one ulp at a few cells)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    ncn = seeded_ncn(dev)
    dims = (BATCH, H // 16, W // 16, H // 16, W // 16)
    corr = torch.rand(dims, generator=gen, device=dev) * 2 - 1
    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad():
        got = ncn(corr)
    torch.cuda.synchronize()
    launches = counts()
    expect = {**{k: 0 for k in launches}, "conv4d_small": 2, "tap_sum": 2}
    if launches != expect:
        fail(f"conv4d path launches {launches}, expected {expect}")
    if got.shape != dims or not torch.isfinite(got).all():
        fail(f"conv4d path: output {tuple(got.shape)} or non-finite values")
    with torch.no_grad(), plain_b4():
        want = ncn(corr)
    scale = want.abs().max().item()
    diff = (got - want).abs()
    err = diff.max().item()
    off = int((diff > 2 ** -7 * scale).sum())
    if not err <= 2 ** -4 * scale or off > 1e-4 * diff.numel():
        fail(f"conv4d path: max abs err {err} (max |ref| {scale}), {off} values off "
             f"by more than 2^-7 of it")
    with torch.no_grad():
        ms = time_ms(lambda: ncn(corr), iters=5)
        with plain_b4():
            plain_ms = time_ms(lambda: ncn(corr), iters=2, warmup=1)
    log(f"conv4d path [NCN (4, 4, 1) symmetric bf16 on {dims}]: launches per call "
        f"{launches}; max abs err to the plain-B4 run {err:.3g} (max |ref| {scale:.3g}), "
        f"{off} of {diff.numel()} values off by more than 2^-7 of it; "
        f"{ms:.3f} ms per call (plain B4 {plain_ms:.3f} ms)")

    # one B4 layer's backward through the kernel against the CPU's
    rs = np.random.RandomState(6)
    x, w, b = (rs.randn(*shape).astype(np.float32) * sc for shape, sc in
               (((1, 4, 5, 6, 4, 4), 1.0), ((3, 3, 3, 3, 4, 3), 0.1), ((3,), 1.0)))
    g = torch.from_numpy(rs.randn(1, 4, 5, 6, 4, 3).astype(np.float32))
    grads = []
    for d in ("cpu", dev):
        ts = [torch.from_numpy(a).to(d).requires_grad_() for a in (x, w, b)]
        conv4d_small(*ts).backward(g.to(d))
        grads.append([t.grad.cpu() for t in ts])
    berr = max((a - c).abs().max().item() for a, c in zip(grads[1], grads[0]))
    for a, c, name in zip(grads[1], grads[0], ("dx", "dw", "db")):
        if ((a - c).abs() > 1e-4 + 1e-5 * c.abs()).any():
            fail(f"conv4d_small backward: {name} differs from the CPU's (max {berr})")
    log(f"conv4d_small backward [(1, 4, 5, 6, 4, 4) f32, 4->3]: dx, dw, db against "
        f"the CPU autograd, max abs err {berr:.3g}")
    return launches


def fine_head_path(dev):
    """Phase 6: the fine stage of a full-width FeatRegressNet with the
    seeded ``regress_fine`` weights, fused and unfused. Rules: float32
    pooled features within rtol/atol 2e-4 of each other; in bf16, against
    the float32 unfused outputs on the same rows, the fused (M, 5) error
    is at most twice the unfused one's at the median and the 99th
    percentile, and at most four times at the maximum."""
    _, _, sd = load_golden("cs_1024")
    sub = {k[len("regress_fine."):]: torch.from_numpy(np.asarray(v))
           for k, v in sd.items() if k.startswith("regress_fine.")}
    nets = {}
    for dt in (torch.bfloat16, torch.float32):
        nets[dt] = FeatRegressNet(feat_dim=sum(c for _, c in LEVELS), dtype=dt, device=dev)
        nets[dt].load_state_dict(sub)
        nets[dt].eval()
    m = BATCH * FINE_CAP
    rs = np.random.RandomState(7)
    rows = [[torch.from_numpy(rs.standard_normal((m, 4, t, t * c)).astype(np.float32))
             .to(dev, torch.bfloat16) for t, c in LEVELS] for _ in range(2)]
    corners = [torch.from_numpy(rs.randint(0, 2 * PSIZE, (m,)).astype(np.int32)).to(dev)
               for _ in range(4)]
    smap = output_slice_map([PSIZE // t for t, _ in LEVELS], [c for _, c in LEVELS], PSIZE)

    def fused(dt):
        r = [[x.to(dt) for x in side] for side in rows]
        return fused_fine_stage(nets[dt], r[0], r[1], *corners, PSIZE)

    def unfused(dt):
        r = [[x.to(dt) for x in side] for side in rows]
        patches = expand_scale_pair(r[0], r[1], *corners, PSIZE, dt)
        pooled = nets[dt].pooled(patches, None, slice_map=smap)
        return pooled, nets[dt].fc_head(pooled)

    with torch.no_grad():
        torch.cuda.synchronize()
        reset_counts()
        fp, fo = fused(torch.bfloat16)
        torch.cuda.synchronize()
        launches = counts()
        reset_counts()
        up, uo = unfused(torch.bfloat16)
        torch.cuda.synchronize()
        unfused_launches = counts()
        fp32, fo32 = fused(torch.float32)
        up32, uo32 = unfused(torch.float32)
        torch.cuda.synchronize()
    expect = {**{k: 0 for k in launches}, "expand_level": 10, "fused_fine_head": 1}
    expect_u = {**{k: 0 for k in launches}, "expand_scale_pair": 1}
    if launches != expect or unfused_launches != expect_u:
        fail(f"fine-head path launches {launches} / {unfused_launches}, expected "
             f"{expect} / {expect_u}")
    for name, t in (("fused", fo), ("unfused", uo), ("fused f32", fo32)):
        if t.shape != (m, 5) or not torch.isfinite(t).all():
            fail(f"fine-head path: {name} outputs {tuple(t.shape)} or non-finite")
    bad = (fp32 - up32).abs() > 2e-4 + 2e-4 * up32.abs()
    if bad.any():
        fail(f"fine-head path f32: {int(bad.sum())} pooled values beyond rtol/atol 2e-4 "
             f"(max abs err {(fp32 - up32).abs().max().item()})")
    e_f, e_u = (fo.float() - uo32).abs().flatten(), (uo.float() - uo32).abs().flatten()
    stats = {}
    for name, q in (("median", 0.5), ("p99", 0.99), ("max", 1.0)):
        stats[name] = (torch.quantile(e_f, q).item(), torch.quantile(e_u, q).item())
    limits = {"median": 2, "p99": 2, "max": 4}
    for name, (a, b) in stats.items():
        if not a <= limits[name] * b:
            fail(f"fine-head path bf16: fused {name} error {a} > {limits[name]} x unfused {b}")
    # the fused stage's split: prolog (B7 + cuDNN image-level conv0 + the
    # weights' layouts), B5, fc_head
    with torch.no_grad():
        ms_f = time_ms(lambda: fused(torch.bfloat16), iters=5)
        ms_u = time_ms(lambda: unfused(torch.bfloat16), iters=5)
        hargs = head_args(nets[torch.bfloat16], *rows, *corners, PSIZE)
        split = (time_ms(lambda: head_args(nets[torch.bfloat16], *rows, *corners, PSIZE),
                         iters=5),
                 time_ms(lambda: fused_fine_head(*hargs), iters=5),
                 time_ms(lambda: nets[torch.bfloat16].fc_head(fp), iters=5))
    log(f"fine-head path [M={m}, F={F_REG}, bf16]: launches fused {launches}, unfused "
        f"{unfused_launches}; f32 pooled fused vs unfused max abs err "
        f"{(fp32 - up32).abs().max().item():.3g}, (M, 5) {(fo32 - uo32).abs().max().item():.3g}; "
        f"bf16 (M, 5) error to the f32 unfused outputs, fused / unfused: "
        + ", ".join(f"{k} {a:.4g} / {b:.4g}" for k, (a, b) in stats.items())
        + f"; fused - unfused bf16 max {(fo.float() - uo.float()).abs().max().item():.4g}; "
        f"{ms_f:.3f} ms per call fused (prolog {split[0]:.3f} + B5 {split[1]:.3f} + fc_head "
        f"{split[2]:.3f}), {ms_u:.3f} ms unfused (B3 + forward)")
    return launches


def main():
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # phase 1: build
    secs, reports = _build.build()
    log(f"kernel build: {secs:.1f} s ({len(reports)} sources compiled)")
    for name, rep in reports.items():
        for line in rep.splitlines():
            # every kernel's registers and spills; the wgmma kernels' entry names too
            if ("registers" in line or "spill" in line
                    or (name in ("corr_pool", "fine_head") and "Compiling entry" in line)):
                log(f"  {name}: {line.strip()}")

    # phase 2: kernels against their plain versions
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    checks = {tap_sum: check_tap_sum, corr_pool: check_corr_pool,
              expand_scale_pair: check_expand, conv4d_small: check_conv4d_small,
              fused_fine_head: check_fine_head, expand_level: check_expand_level}
    results = {}
    for fn, check in checks.items():
        name = KERNELS[fn][0]
        for dtype in (torch.bfloat16, torch.float32):
            r = check(dtype, gen, dev)
            lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            log(f"kernel {name} [{str(dtype)[6:]}] {r['shape']}: max_abs_err "
                f"{r['max_abs_err']:.3g} ms {r['ms']:.4f} plain_ms "
                f"{r['plain_ms']:.4f} library_ms {lib} bound_ms "
                f"{r['bound_ms']:.4f} ({r['bound_by']})")
            if dtype == torch.bfloat16:
                results[fn] = r
        torch.cuda.empty_cache()

    # phase 3: golden parity, f32, TF32 off
    reset_counts()
    for tag in ("s16_1024", "cs_1024"):
        g, meta, sd = load_golden(tag)
        model = build_model(meta["change_stride"], sd, "float32", dev)
        im1 = torch.from_numpy(seeded_images(meta["batch"], meta["h"], meta["w"],
                                             meta["im_seed"])).to(dev)
        im2 = torch.from_numpy(seeded_images(meta["batch"], meta["h"], meta["w"],
                                             meta["im_seed"] + 1)).to(dev)
        fine, mid, cm = (to_numpy(x) for x in model.predict_fine(im1, im2, ksize=2))
        for b in range(meta["batch"]):
            n, errs = assert_match_parity(
                b, g[f"coarse_{b}"], g[f"mid_{b}"], g[f"mid_scores_{b}"],
                g[f"fine_{b}"], g[f"fine_scores_{b}"], fine, mid, cm,
                coord_tol=0.05, score_tol=5e-3)
            log(f"golden {tag} [{meta['h']}x{meta['w']} f32] batch {b}: {n} "
                f"matches, max errs " + " ".join(f"{k} {v:.3g}" for k, v in errs.items()))
        del model
    golden_counts = {k: counts()[k] for k in ("tap_sum", "corr_pool", "expand_scale_pair")}
    log(f"golden launches: {golden_counts}")
    if min(golden_counts.values()) == 0:
        fail(f"a kernel was not launched by the golden runs: {golden_counts}")

    # phase 4: the main path, bf16, 1024x768
    _, _, sd = load_golden("cs_1024")
    ims = [torch.from_numpy(seeded_images(BATCH, H, W, seed)).to(dev) for seed in (1, 2)]
    models = {cs: build_model(cs, sd, "bfloat16", dev) for cs in (True, False)}
    torch.cuda.synchronize()
    reset_counts()
    per_call = {}
    for cs, model in models.items():
        tag = "change_stride (upsample 8)" if cs else "upsample 16"
        matcher = Matcher(model, ksize=2, fine_cap=FINE_CAP)
        fm, fs, cmat = matcher.match_arrays(ims[0][0].cpu().numpy(), ims[1][0].cpu().numpy())
        if not (np.isfinite(fm).all() and np.isfinite(fs).all()) or fm.shape[1:] != (4,):
            fail(f"{tag}: Matcher returned bad matches {fm.shape}")
        log(f"main {tag}: Matcher.match_arrays -> {len(fm)} matches")

        def call():
            return model.predict_fine(ims[0], ims[1], ksize=2, fine_cap=FINE_CAP)

        before = counts()
        fine, mid, cm = call()
        torch.cuda.synchronize()
        per_call[tag] = {k: v - before[k] for k, v in counts().items()}
        n_valid = check_outputs(tag, fine, mid, cm, BATCH, H, W)
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # latency: each call waited for; throughput: calls back to back,
        # so the host enqueues a call while the card runs the previous one
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        for _ in range(10):
            call()
        torch.cuda.synchronize()
        pairs_s = BATCH * 10 / (time.perf_counter() - t0)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"main {tag} [{H}x{W} bf16 B={BATCH} fine_cap={FINE_CAP}]: "
            f"{pairs_s:.2f} pairs/s over 10 calls back to back; latency median "
            f"{np.median(times):.2f} ms/call of 10 (min {min(times):.2f}, max "
            f"{max(times):.2f}); peak device memory {peak_gb:.2f} GB; valid "
            f"matches per pair {n_valid}; launches per call {per_call[tag]}")
    main_counts = {k: counts()[k] for k in ("tap_sum", "corr_pool", "expand_scale_pair")}
    log(f"main-path launches: {main_counts}")
    if min(main_counts.values()) == 0:
        fail(f"a kernel was not launched on the main path: {main_counts}")
    # B4, B5 and B7 are off predict_fine: zero launches there
    off_path = {"conv4d_small": 0, "fused_fine_head": 0, "expand_level": 0}
    expect = {"change_stride (upsample 8)": {"tap_sum": 2, "corr_pool": 1,
                                             "expand_scale_pair": 2, **off_path},
              "upsample 16": {"tap_sum": 2, "corr_pool": 1,
                              "expand_scale_pair": 1, **off_path}}
    if per_call != expect:
        fail(f"launches per call {per_call}, expected {expect}")
    for cs, model in models.items():
        profile_main_path(
            "change_stride (upsample 8)" if cs else "upsample 16",
            lambda: model.predict_fine(ims[0], ims[1], ksize=2, fine_cap=FINE_CAP))

    del models
    torch.cuda.empty_cache()

    # phase 5: the conv4d path; phase 6: the fine-head path
    path_counts = {**main_counts}
    path_counts["conv4d_small"] = conv4d_path(dev)["conv4d_small"]
    torch.cuda.empty_cache()
    fine_counts = fine_head_path(dev)
    path_counts.update({k: fine_counts[k] for k in ("fused_fine_head", "expand_level")})

    # phase 7: report
    line = {"kernels": [
        dict(name=KERNELS[fn][0], route="cuda", source=KERNELS[fn][1],
             replaces=KERNELS[fn][2], launches=path_counts[KERNELS[fn][0]],
             max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
             bound_ms=r["bound_ms"], bound_by=r["bound_by"],
             library_ms=r["library_ms"])
        for fn, r in results.items()
    ]}
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
