"""Fused patch expansion + hypercolumn-normalise + scale (kernel B3).

Port of ``patch2pix_tpu.ops.patch_expand_pallas``. Input: for both
images of each proposal pair, the per-level superblock rows
``(M, 4, t_l, t_l*C_l)`` (2x2 space-to-depth tiles around the patch)
and the padded patch corners ``(M,)``. Output, per
:func:`output_slice_map`: each C=64 level channel-paired
``(M, p, p, 2*C)`` (side 1 then side 2), every other level one
``(M, p, p, C)`` tensor per side, all scaled by the cross-level inverse
hypercolumn norm ``rsqrt(sum sq + 1e-6)``.

Order of work: square-sums in float32 per level, levels added in
pyramid order; ``inv`` rounded once to ``out_dtype``; then the float32
product of the rounded operands, rounded once. On CUDA tensors
:func:`expand_scale_pair` launches ``csrc/patch_expand.cu``; on CPU
tensors it runs :func:`expand_scale_pair_plain`. The kernel stages each
proposal's windows in shared memory; :func:`plan` lays that memory out
and gives the kernel its divisor constants.

:func:`expand_level` (kernel B7, a second entry point of the same
source) is the one-level, one-sided, unscaled expansion that the fused
fine-stage head's prolog needs; it is a pure gather, bit-identical to
:func:`expand_level_plain`, written in 16-byte stores by the plan of
:func:`level_plan`.

:func:`expand_scale_pair` is differentiable with respect to both sides'
rows: the backward is the JAX custom VJP's (``_bwd``,
``patch2pix_tpu/ops/patch_expand_pallas.py:458-467``) in plain PyTorch,
:func:`expand_scale_pair_backward`; the int32 corners get none. B7 has
no backward, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from patch2pix_tpu_torch.ops import _build

EPS = 1e-6
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {"p2p_patch_expand": "pip",
               "p2p_expand_args_size": "",
               "p2p_expand_level": "pppppiip",
               "p2p_expand_level_plan_size": "",
               "p2p_expand_level_attrs": "ippp"}
MAX_LEVELS = 8
SMEM_LIMIT = 232448  # bytes of shared memory one block may take on the H100
LEVEL_THREADS = 256  # threads of a B7 block


def _paired(c: int) -> bool:
    """Levels whose two sides share one channel-paired output."""
    return 2 * c == 128


def output_slice_map(ds_list: Sequence[int], cs: Sequence[int],
                     psize: int) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
    """Regressor kernel-channel slices for each output, in output
    order. The regressor's cin layout is [side-1 levels | side-2
    levels]; a paired output covers both sides' slices of its level,
    per-side outputs one each."""
    d = sum(cs)
    out, off = [], 0
    for c in cs:
        if _paired(c):
            out.append(((off, c), (d + off, c)))
        else:
            out.append(((off, c),))
            out.append(((d + off, c),))
        off += c
    return tuple(out)


def _window_indices(base: torch.Tensor, psize: int, ds: int) -> torch.Tensor:
    """(M,) padded corners -> (M, psize) within-superblock indices, in
    [0, 2t) for every corner >= 0; a negative corner counts as 0."""
    t = psize // ds
    d = torch.arange(psize, device=base.device)
    b = base.long().clamp_min(0)[:, None]
    return torch.div(b + d, ds, rounding_mode="floor") - torch.div(
        b, psize, rounding_mode="floor") * t


def window_extent(base: torch.Tensor, psize: int, t: int):
    """(M,) padded corners -> (first cell, cells) of each patch's window
    along one axis of a level with tile side ``t``: the span of
    :func:`_window_indices`, as the kernel computes it."""
    ds = psize // t
    r = base.long().clamp_min(0) % psize
    first = r // ds
    return first, (r + psize - 1) // ds - first + 1


def window_side(t: int, psize: int) -> int:
    """Cells a side of the window the kernel stages: psize pixels at
    stride ds = psize / t cover t cells, or t + 1 where they start inside
    a cell, which needs ds > 1. It never leaves the superblock: the first
    cell is at most t - 1."""
    return t + (psize // t > 1)


def fast_div(d: int) -> Tuple[int, int]:
    """(m, s) with x // d == (umulhi(x, m) + x) >> s for 0 <= x < 2**31,
    where umulhi(x, m) = (x * m) >> 32: the kernel's divisions."""
    s = (d - 1).bit_length()
    return ((1 << 32) * ((1 << s) - d)) // d + 1, s


def _cell_stride(c: int, elsize: int) -> int:
    """Staged elements per window cell: C, padded where a cell is whole
    16-byte units to an odd count of them, so that threads reading
    neighbouring cells at one offset hit different banks."""
    units, rest = divmod(c * elsize, 16)
    return c if rest else (units | 1) * 16 // elsize


class _FastDiv(ctypes.Structure):
    _fields_ = [("m", ctypes.c_uint32), ("s", ctypes.c_uint32)]


class _Level(ctypes.Structure):
    """``Level`` of ``csrc/patch_expand.cu``, field for field."""
    _fields_ = [("rows", ctypes.c_void_p * 2), ("out", ctypes.c_void_p * 2),
                ("t", ctypes.c_int32), ("c", ctypes.c_int32), ("ostride", ctypes.c_int32),
                ("w", ctypes.c_int32), ("cstride", ctypes.c_int32),
                ("win", ctypes.c_int32 * 2), ("sq", ctypes.c_int32 * 2),
                ("vec", ctypes.c_int32),
                ("by_w", _FastDiv), ("by_chunks", _FastDiv), ("by_c", _FastDiv),
                ("by_pixel_chunks", _FastDiv)]


class _Args(ctypes.Structure):
    """``Args`` of ``csrc/patch_expand.cu``, field for field."""
    _fields_ = [("lv", _Level * MAX_LEVELS),
                ("y", ctypes.c_void_p * 2), ("x", ctypes.c_void_p * 2),
                ("n_levels", ctypes.c_int32), ("psize", ctypes.c_int32),
                ("m", ctypes.c_int32), ("elsize", ctypes.c_int32),
                ("by_psize", _FastDiv),
                ("inv_off", ctypes.c_int32), ("tab_off", ctypes.c_int32),
                ("geo_off", ctypes.c_int32), ("smem", ctypes.c_int32)]


@functools.lru_cache(maxsize=None)
def plan(shapes: Tuple[Tuple[int, int], ...], psize: int, elsize: int) -> _Args:
    """B3's launch plan for levels ``shapes`` = ((t, C), ...) at ``psize``
    and ``elsize`` bytes per value, pointers unset: window sides, staged
    cell strides, divisor constants and the shared-memory layout (bytes):
    both sides' windows, 16-byte aligned; each window cell's square-sum
    (float32); ``inv`` per side and pixel (float32); the cell tables
    (int32, per side, level and axis, psize each); the first window cells
    (int32, per side, level and axis). Raises ValueError on shapes the
    kernel does not take."""
    if not 0 < len(shapes) <= MAX_LEVELS:
        raise ValueError(f"expand_scale_pair: {len(shapes)} levels, at most {MAX_LEVELS}")
    if psize <= 0 or psize * psize > 4096 or any(
            t <= 0 or c <= 0 or psize % t for t, c in shapes):
        raise ValueError(f"expand_scale_pair: levels {shapes} at psize {psize}")
    vec = 16 // elsize
    a = _Args(n_levels=len(shapes), psize=psize, elsize=elsize,
              by_psize=_FastDiv(*fast_div(psize)))
    off = 0
    for side in (0, 1):
        for lv, (t, c) in zip(a.lv, shapes):
            lv.win[side] = off
            off += -(-window_side(t, psize) ** 2 * _cell_stride(c, elsize) * elsize // 16) * 16
    sq = off // 4
    for side in (0, 1):
        for lv, (t, _) in zip(a.lv, shapes):
            lv.sq[side] = sq
            sq += window_side(t, psize) ** 2
    a.inv_off = 4 * sq
    a.tab_off = a.inv_off + 4 * 2 * psize * psize
    a.geo_off = a.tab_off + 4 * 4 * len(shapes) * psize
    a.smem = a.geo_off + 4 * 4 * len(shapes)
    if a.smem > SMEM_LIMIT:
        raise ValueError(f"expand_scale_pair: levels {shapes} at psize {psize} need "
                         f"{a.smem} bytes of shared memory, more than {SMEM_LIMIT}")
    for lv, (t, c) in zip(a.lv, shapes):
        w = window_side(t, psize)
        lv.t, lv.c, lv.w, lv.cstride = t, c, w, _cell_stride(c, elsize)
        lv.ostride = 2 * c if _paired(c) else c
        lv.vec = int(c % vec == 0)
        for name, d in (("by_w", w), ("by_chunks", max(c // vec, 1)), ("by_c", c),
                        ("by_pixel_chunks", max(2 * c // vec, 1))):
            setattr(lv, name, _FastDiv(*fast_div(d)))
    return a


class _WindowGather(torch.autograd.Function):
    """One axis of a window expansion: ``x`` holds 2t cells along
    ``dim``; output pixel d of proposal m reads cell ``(r[m] + d) // ds``
    (r = the padded corner mod psize, which is :func:`_window_indices`).
    The gather copies values; its backward sums each cell's run of ds
    pixel gradients by a shift and a reshape, not by scattered adds, so
    it is deterministic on every device."""

    @staticmethod
    def forward(ctx, x, r, psize, ds, dim):
        ctx.geometry = (r, psize, ds, dim, x.shape[dim])
        d = torch.arange(psize, device=x.device)
        idx = torch.div(r[:, None] + d, ds, rounding_mode="floor")
        shape = [1] * x.dim()
        shape[0], shape[dim] = x.shape[0], psize
        out_shape = list(x.shape)
        out_shape[dim] = psize
        return torch.gather(x, dim, idx.view(shape).expand(out_shape))

    @staticmethod
    def backward(ctx, g):
        r, psize, ds, dim, cells = ctx.geometry
        # pixel d of proposal m lands at q = r[m] + d of cells * ds slots
        q = torch.arange(cells * ds, device=g.device)
        src = q - r[:, None]
        keep = (src >= 0) & (src < psize)
        shape = [1] * g.dim()
        shape[0], shape[dim] = g.shape[0], cells * ds
        slot_shape = list(g.shape)
        slot_shape[dim] = cells * ds
        slots = torch.gather(g, dim, src.clamp(0, psize - 1).view(shape).expand(slot_shape))
        slots = torch.where(keep.view(shape), slots, torch.zeros((), dtype=g.dtype,
                                                                  device=g.device))
        split = list(g.shape)
        split[dim:dim + 1] = [cells, ds]
        return slots.reshape(split).sum(dim=dim + 1), None, None, None, None


class _LevelPlan(ctypes.Structure):
    """``LevelPlan`` of ``csrc/patch_expand.cu``, field for field."""
    _fields_ = [("psize", ctypes.c_int32), ("t", ctypes.c_int32), ("c", ctypes.c_int32),
                ("vec", ctypes.c_int32), ("per_block", ctypes.c_int32),
                ("per_pixel", ctypes.c_int32),
                ("by_psize", _FastDiv), ("by_ds", _FastDiv), ("by_pixel", _FastDiv),
                ("by_row", _FastDiv)]


@functools.lru_cache(maxsize=None)
def level_plan(psize: int, t: int, c: int, elsize: int, aligned: bool) -> _LevelPlan:
    """B7's launch plan for one level of tile side ``t`` and ``c``
    channels at ``psize``, ``elsize`` bytes per value, rows 16-byte
    ``aligned`` or not. The kernel moves a pixel's cell in 16-byte units
    (``vec``) where the cell is whole units and the rows are aligned,
    else flat 16-byte runs of values; ``per_pixel`` is its work items a
    pixel (units or values). ``per_block`` proposals share a block where a
    proposal's output is smaller than the block's 16-byte stores. Divisor
    constants for psize, ds = psize / t, per_pixel and a patch row's
    items. Raises ValueError on shapes the kernel does not take."""
    if psize <= 0 or t <= 0 or c <= 0 or psize % t or elsize not in (2, 4):
        raise ValueError(f"expand_level: t {t}, C {c} at psize {psize}, {elsize}-byte values")
    if 4 * t * t * c >= 2 ** 31 or psize * psize * c >= 2 ** 31:
        raise ValueError(f"expand_level: t {t}, C {c} at psize {psize} overflow int32 offsets")
    vec = aligned and c * elsize % 16 == 0
    per_pixel = c * elsize // 16 if vec else c
    per_block = 1
    while per_block < 8 and 2 * per_block * psize * psize * c * elsize <= 16 * LEVEL_THREADS:
        per_block *= 2
    if 2 * per_block * psize * 4 > 48 * 1024:
        raise ValueError(f"expand_level: psize {psize} beyond the tables' shared memory")
    return _LevelPlan(psize=psize, t=t, c=c, vec=int(vec), per_block=per_block,
                      per_pixel=per_pixel, by_psize=_FastDiv(*fast_div(psize)),
                      by_ds=_FastDiv(*fast_div(psize // t)),
                      by_pixel=_FastDiv(*fast_div(per_pixel)),
                      by_row=_FastDiv(*fast_div(psize * per_pixel)))


def expand_level_plain(rows: torch.Tensor, y0, x0, psize: int) -> torch.Tensor:
    """One level, one side: (M, 4, t, t*C) rows -> (M, p, p, C) window
    values by plain gathers (differentiable with respect to rows)."""
    m, _, t, tc = rows.shape
    c = tc // t
    ds = psize // t
    # (M, ty, tx, wy, wx, C) -> superblock (M, 2t, 2t, C)
    sb = rows.reshape(m, 2, 2, t, t, c).permute(0, 1, 3, 2, 4, 5).reshape(
        m, 2 * t, 2 * t, c)
    ry = y0.long().clamp_min(0) % psize
    rx = x0.long().clamp_min(0) % psize
    return _WindowGather.apply(_WindowGather.apply(sb, ry, psize, ds, 1), rx, psize, ds, 2)


def expand_scale_pair_plain(rows1, rows2, y1, x1, y2, x2, psize: int,
                            out_dtype) -> Tuple[torch.Tensor, ...]:
    """The plain version of :func:`expand_scale_pair`. Each level's
    square-sum is one ``torch.sum`` over its channels, whose order of
    adds differs from the kernel's; levels are added in pyramid order."""
    sides = []
    for rows, y0, x0 in ((rows1, y1, x1), (rows2, y2, x2)):
        es = [expand_level_plain(r, y0, x0, psize) for r in rows]
        sq = None
        for e in es:
            s = e.float().square().sum(dim=-1)
            sq = s if sq is None else sq + s
        inv = torch.rsqrt(sq + EPS).to(out_dtype)[..., None]
        sides.append([(e.to(out_dtype).float() * inv.float()).to(out_dtype)
                      for e in es])
    outs = []
    for li, r in enumerate(rows1):
        if _paired(r.shape[3] // r.shape[2]):
            outs.append(torch.cat([sides[0][li], sides[1][li]], dim=-1))
        else:
            outs += [sides[0][li], sides[1][li]]
    return tuple(outs)


def expand_level(rows: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                 psize: int) -> torch.Tensor:
    """rows ``(M, 4, t, t*C)`` of any 2- or 4-byte dtype, y0/x0 ``(M,)``
    int32 padded corners (a negative corner counts as 0) -> ``(M, psize,
    psize, C)`` window values in rows' dtype."""
    if all(v.device.type == "cpu" for v in (rows, y0, x0)):
        return expand_level_plain(rows, y0, x0, psize)
    dev = rows.device
    if dev.type != "cuda" or y0.device != dev or x0.device != dev:
        raise ValueError("expand_level: tensors must share one CUDA device")
    m, four, t, tc = rows.shape
    c = tc // t
    if four != 4 or tc != t * c or psize % t or not rows.is_contiguous():
        raise ValueError(f"expand_level: rows {tuple(rows.shape)} for psize {psize}")
    if rows.element_size() not in (2, 4):
        raise TypeError(f"expand_level: rows {rows.dtype}")
    for v in (y0, x0):
        if v.dtype != torch.int32 or v.shape != (m,) or not v.is_contiguous():
            raise ValueError("expand_level: corners must be contiguous (M,) int32")
    _build.refuse_grad("expand_level", rows)
    elsize = rows.element_size()
    pl = level_plan(psize, t, c, elsize, rows.data_ptr() % 16 == 0)
    out = torch.empty((m, psize, psize, c), dtype=rows.dtype, device=dev)
    lib = _build.library("patch_expand", _SIGNATURES)
    if lib.p2p_expand_level_plan_size() != ctypes.sizeof(_LevelPlan):
        raise RuntimeError("expand_level: _LevelPlan does not match the kernel's LevelPlan")
    rc = lib.p2p_expand_level(
        ctypes.addressof(pl), rows.data_ptr(), y0.data_ptr(), x0.data_ptr(), out.data_ptr(),
        m, elsize, _build.current_stream(dev),
    )
    _build.check_launch(rc, "expand_level")
    expand_level.launches += 1
    return out


expand_level.launches = 0


def expand_scale_pair_backward(rows1, rows2, y1, x1, y2, x2, psize: int, out_dtype,
                               grads) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """The adjoint of :func:`expand_scale_pair` with respect to both
    sides' rows: the vector-Jacobian product of
    :func:`expand_scale_pair_plain`, recomputed from the rows, with the
    outputs' gradients ``grads`` (in output order). Returns (drows1,
    drows2), one gradient per level and side in the rows' dtype."""
    expand_scale_pair_backward.calls += 1
    n = len(rows1)
    with torch.enable_grad():
        rows = [r.detach().requires_grad_() for r in (*rows1, *rows2)]
        outs = expand_scale_pair_plain(rows[:n], rows[n:], y1, x1, y2, x2, psize,
                                       out_dtype)
        drows = torch.autograd.grad(outs, rows, grads)
    return drows[:n], drows[n:]


expand_scale_pair_backward.calls = 0


def _launch_pair(rows1, rows2, y1, x1, y2, x2, psize, out_dtype):
    tensors = rows1 + rows2 + (y1, x1, y2, x2)
    dev = y1.device
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError("expand_scale_pair: tensors must share one CUDA device")
    if out_dtype not in _DTYPES or any(r.dtype != out_dtype for r in rows1 + rows2):
        raise TypeError(f"expand_scale_pair: rows must be {out_dtype} "
                        f"in {list(_DTYPES)}")
    m = y1.shape[0]
    for c in (y1, x1, y2, x2):
        if c.dtype != torch.int32 or c.shape != (m,) or not c.is_contiguous():
            raise ValueError("expand_scale_pair: corners must be contiguous "
                             "(M,) int32")
    shapes = []
    for r1, r2 in zip(rows1, rows2):
        m_, four, t, tc = r1.shape
        if (r2.shape != r1.shape or m_ != m or four != 4 or tc % t
                or not (r1.is_contiguous() and r2.is_contiguous())):
            raise ValueError(f"expand_scale_pair: rows {tuple(r1.shape)}, "
                             f"{tuple(r2.shape)}")
        shapes.append((t, tc // t))
    elsize = out_dtype.itemsize
    a = _Args.from_buffer_copy(plan(tuple(shapes), psize, elsize))
    outs = []
    for lv, r1, r2, (_, c) in zip(a.lv, rows1, rows2, shapes):
        if _paired(c):
            o = torch.empty((m, psize, psize, 2 * c), dtype=out_dtype, device=dev)
            outs.append(o)
            lv.out[0], lv.out[1] = o.data_ptr(), o.data_ptr() + c * elsize
        else:
            oa = torch.empty((m, psize, psize, c), dtype=out_dtype, device=dev)
            ob = torch.empty_like(oa)
            outs += [oa, ob]
            lv.out[0], lv.out[1] = oa.data_ptr(), ob.data_ptr()
        lv.rows[0], lv.rows[1] = r1.data_ptr(), r2.data_ptr()
    a.y[0], a.x[0], a.y[1], a.x[1] = (v.data_ptr() for v in (y1, x1, y2, x2))
    a.m = m
    lib = _build.library("patch_expand", _SIGNATURES)
    if lib.p2p_expand_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError("expand_scale_pair: _Args does not match the kernel's Args")
    rc = lib.p2p_patch_expand(ctypes.addressof(a), _DTYPES[out_dtype],
                              _build.current_stream(dev))
    _build.check_launch(rc, "expand_scale_pair")
    expand_scale_pair.launches += 1
    return tuple(outs)


class _ExpandScalePair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, psize, out_dtype, n_levels, *tensors):
        ctx.save_for_backward(*tensors)
        ctx.geometry = (psize, out_dtype, n_levels)
        rows1, rows2 = tensors[:n_levels], tensors[n_levels:2 * n_levels]
        corners = tensors[2 * n_levels:]
        if all(x.device.type == "cpu" for x in tensors):
            return expand_scale_pair_plain(rows1, rows2, *corners, psize, out_dtype)
        return _launch_pair(rows1, rows2, *corners, psize, out_dtype)

    @staticmethod
    def backward(ctx, *grads):
        psize, out_dtype, n = ctx.geometry
        tensors = ctx.saved_tensors
        d1, d2 = expand_scale_pair_backward(tensors[:n], tensors[n:2 * n],
                                            *tensors[2 * n:], psize, out_dtype, grads)
        return (None, None, None, *d1, *d2, None, None, None, None)


def expand_scale_pair(rows1, rows2, y1, x1, y2, x2, psize: int,
                      out_dtype) -> Tuple[torch.Tensor, ...]:
    """rows1/rows2: per-level ``(M, 4, t_l, t_l*C_l)``; y*/x*: ``(M,)``
    int32 padded corners (clipped at 0 by the gather; a negative corner
    counts as 0). Returns the scaled patch tensors in
    :func:`output_slice_map` order: the plain version on CPU tensors,
    the kernel's on CUDA tensors."""
    rows1, rows2 = tuple(rows1), tuple(rows2)
    if len(rows1) != len(rows2):
        raise ValueError(f"expand_scale_pair: {len(rows1)} levels of side 1, "
                         f"{len(rows2)} of side 2")
    return _ExpandScalePair.apply(psize, out_dtype, len(rows1), *rows1, *rows2,
                                  y1, x1, y2, x2)


expand_scale_pair.launches = 0
