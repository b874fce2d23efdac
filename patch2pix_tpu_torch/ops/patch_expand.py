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
tensors it runs :func:`expand_scale_pair_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from patch2pix_tpu_torch.ops import _build

EPS = 1e-6
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {"p2p_patch_expand": "pppppppippppiiip"}


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


def _expand_side(rows: torch.Tensor, y0, x0, psize: int) -> torch.Tensor:
    """One level, one side: (M, 4, t, t*C) rows -> (M, p, p, C) window
    values by plain indexed reads."""
    m, _, t, tc = rows.shape
    c = tc // t
    ds = psize // t
    # (M, ty, tx, wy, wx, C) -> superblock (M, 2t, 2t, C)
    sb = rows.reshape(m, 2, 2, t, t, c).permute(0, 1, 3, 2, 4, 5).reshape(
        m, 2 * t, 2 * t, c)
    iy = _window_indices(y0, psize, ds)
    ix = _window_indices(x0, psize, ds)
    mi = torch.arange(m, device=rows.device)[:, None, None]
    return sb[mi, iy[:, :, None], ix[:, None, :]]


def expand_scale_pair_plain(rows1, rows2, y1, x1, y2, x2, psize: int,
                            out_dtype) -> Tuple[torch.Tensor, ...]:
    """The plain version of :func:`expand_scale_pair`. Each level's
    square-sum is one ``torch.sum`` over its channels, whose order of
    adds differs from the kernel's; levels are added in pyramid order."""
    sides = []
    for rows, y0, x0 in ((rows1, y1, x1), (rows2, y2, x2)):
        es = [_expand_side(r, y0, x0, psize) for r in rows]
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


def expand_scale_pair(rows1, rows2, y1, x1, y2, x2, psize: int,
                      out_dtype) -> Tuple[torch.Tensor, ...]:
    """rows1/rows2: per-level ``(M, 4, t_l, t_l*C_l)``; y*/x*: ``(M,)``
    int32 padded corners (clipped at 0 by the gather; a negative corner
    counts as 0). Returns the scaled patch tensors in
    :func:`output_slice_map` order."""
    rows1, rows2 = tuple(rows1), tuple(rows2)
    tensors = rows1 + rows2 + (y1, x1, y2, x2)
    if all(x.device.type == "cpu" for x in tensors):
        return expand_scale_pair_plain(rows1, rows2, y1, x1, y2, x2, psize,
                                       out_dtype)
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
    outs, levels = [], []  # per level: rows1, rows2, out1, out2, t, c, stride
    for r1, r2 in zip(rows1, rows2):
        m_, four, t, tc = r1.shape
        c = tc // t
        if (r2.shape != r1.shape or m_ != m or four != 4 or tc != t * c
                or psize % t or not (r1.is_contiguous() and r2.is_contiguous())):
            raise ValueError(f"expand_scale_pair: rows {tuple(r1.shape)}, "
                             f"{tuple(r2.shape)}")
        if _paired(c):
            o = torch.empty((m, psize, psize, 2 * c), dtype=out_dtype, device=dev)
            outs.append(o)
            o1, o2, stride = o.data_ptr(), o.data_ptr() + c * o.element_size(), 2 * c
        else:
            oa = torch.empty((m, psize, psize, c), dtype=out_dtype, device=dev)
            ob = torch.empty_like(oa)
            outs += [oa, ob]
            o1, o2, stride = oa.data_ptr(), ob.data_ptr(), c
        levels.append((r1.data_ptr(), r2.data_ptr(), o1, o2, t, c, stride))
    n = len(levels)
    cols = list(zip(*levels))
    arrays = ([(ctypes.c_void_p * n)(*col) for col in cols[:4]]
              + [(ctypes.c_int * n)(*col) for col in cols[4:]])
    lib = _build.library("patch_expand", _SIGNATURES)
    rc = lib.p2p_patch_expand(
        *(ctypes.addressof(a) for a in arrays), n,
        y1.data_ptr(), x1.data_ptr(), y2.data_ptr(), x2.data_ptr(),
        m, psize, _DTYPES[out_dtype], _build.current_stream(dev),
    )
    _build.check_launch(rc, "expand_scale_pair")
    expand_scale_pair.launches += 1
    return tuple(outs)


expand_scale_pair.launches = 0
