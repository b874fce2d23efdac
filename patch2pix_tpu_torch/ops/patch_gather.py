"""Hypercolumn local-patch gathering around match endpoints.

Port of ``patch2pix_tpu.ops.patch_gather``: the per-pixel block gather
that takes any map size (:func:`gather_local_patches`, its per-level
form :func:`gather_local_patches_levels`), the superblock row-gather of
padded tiles (:func:`gather_local_patches_tiled`,
:func:`gather_local_patches_tiled_levels`, and the two-sided
:func:`gather_scaled_patch_pairs_fused` feeding kernel B3), the
grid-aligned gather (eval mid stage when the coarse stride equals the
patch size) and the naive per-pixel oracle
:func:`gather_local_patches_ref`. Sampling reproduces the reference's
per-pixel ``clip((base + d) // ds, 0, dim - 1)`` exactly, so every
route gives the same values. ``ptype="center"`` (the default) centres
the patch on the point; any other value puts the point at its top-left
corner, as in JAX. The superblock gathers need every map dimension to be
a multiple of psize and at least 2*psize (:func:`tileable`; true at the
Matcher's snapped sizes) and raise ``NotImplementedError`` on other
shapes; the block gather is the route there.
"""

from __future__ import annotations

from typing import Sequence

import torch

from patch2pix_tpu_torch.ops.correlation import l2_normalize
from patch2pix_tpu_torch.ops.patch_expand import (
    expand_level_plain,
    expand_scale_pair,
    output_slice_map,
)


def level_downsamples(feats_downsample: Sequence[int]):
    """Cumulative downsample factor of every pyramid level."""
    out, ds = [], 1
    for j, f in enumerate(feats_downsample):
        ds = ds * f if j > 0 else f
        out.append(ds)
    return out


def tileable(feats, psize: int) -> bool:
    """Every pyramid level supports the 2x2-superblock row-gather: input
    dims multiples of psize and at least 2*psize."""
    h, w = feats[0].shape[1], feats[0].shape[2]
    return h % psize == 0 and w % psize == 0 and h >= 2 * psize and w >= 2 * psize


def _require_tileable(feats, psize: int):
    if not tileable(feats, psize):
        raise NotImplementedError(
            f"patch gather for map {tuple(feats[0].shape[1:3])} with psize "
            f"{psize}: only psize-tileable sizes are ported")


def levels_inv_norm(gathered, eps: float = 1e-6) -> torch.Tensor:
    """Per-pixel inverse hypercolumn L2 norm from UNCONCATENATED levels
    (f32 square-sums, levels added in order) -> (..., 1) float32."""
    sq = None
    for g in gathered:
        s = torch.sum(torch.square(g.float()), dim=-1, keepdim=True)
        sq = s if sq is None else sq + s
    return torch.rsqrt(sq + eps)


def make_padded_tiles(fmap: torch.Tensor, psize: int, ds: int) -> torch.Tensor:
    """Edge-pad one psize-px ring and space-to-depth into FLAT tile rows
    ``(B, nty*ntx, t*t*C)`` with t = psize // ds, nty/ntx = dim//t + 2."""
    b, h, w, c = fmap.shape
    t = psize // ds
    yi = torch.arange(-t, h + t, device=fmap.device).clamp(0, h - 1)
    xi = torch.arange(-t, w + t, device=fmap.device).clamp(0, w - 1)
    fp = fmap[:, yi][:, :, xi]  # (B, h+2t, w+2t, C), edge replicated
    nty, ntx = h // t + 2, w // t + 2
    tiles = fp.reshape(b, nty, t, ntx, t * c).permute(0, 1, 3, 2, 4)
    return tiles.reshape(b, nty * ntx, t * t * c)


def make_padded_tiles_levels(feats, feat_idx, feats_downsample, psize: int):
    """:func:`make_padded_tiles` for every gathered level, in
    ``feat_idx`` order — built once per image and shared by the mid and
    fine stages."""
    _require_tileable(feats, psize)
    level_ds = level_downsamples(feats_downsample)
    return tuple(make_padded_tiles(f, psize, level_ds[j])
                 for j, f in enumerate(feats) if j in feat_idx)


def _superblock_rows(tiles, y0p, x0p, psize: int, t: int, ntx: int):
    """The 2x2 superblock of flat tile rows per proposal ->
    ``(B*N, 4, t, t*C)``."""
    b, n = y0p.shape
    ky = torch.div(y0p, psize, rounding_mode="floor")
    kx = torch.div(x0p, psize, rounding_mode="floor")
    dy = torch.tensor([0, 0, 1, 1], device=y0p.device)
    dx = torch.tensor([0, 1, 0, 1], device=y0p.device)
    lin = (ky[..., None] + dy) * ntx + (kx[..., None] + dx)  # (B, N, 4)
    bi = torch.arange(b, device=y0p.device)[:, None]
    rows = tiles[bi, lin.reshape(b, n * 4)]  # (B, N*4, t*t*C)
    return rows.reshape(b * n, 4, t, rows.shape[-1] // t)


def _corners(points, psize: int, ptype: str = "center"):
    """(B, N, 2) float (x, y) points -> int32 patch top-left corners
    ``(y0, x0)``, truncated like the reference's ``.long()``."""
    x0 = points[..., 0].to(torch.int32)
    y0 = points[..., 1].to(torch.int32)
    if ptype == "center":
        x0, y0 = x0 - psize // 2, y0 - psize // 2
    return y0, x0


def _padded_corners(points, psize: int, h_im: int, w_im: int, ptype: str = "center"):
    """Patch top-left corners in PADDED pixel coords (one psize ring),
    clipped as the reference's per-pixel border clamp requires."""
    y0, x0 = _corners(points, psize, ptype)
    x0p = torch.clamp(x0 + psize, 0, w_im + psize - 1)
    y0p = torch.clamp(y0 + psize, 0, h_im + psize - 1)
    return y0p, x0p


def _side_rows(feats, tiles, points, feat_idx, feats_downsample, psize: int, ptype: str):
    """One side's superblock rows per gathered level ``(B*N, 4, t, t*C)``
    and its flat padded corners ``(B*N,)``."""
    _require_tileable(feats, psize)
    h_im, w_im = feats[0].shape[1], feats[0].shape[2]
    y0p, x0p = _padded_corners(points, psize, h_im, w_im, ptype)
    level_ds = level_downsamples(feats_downsample)
    rows = []
    for j, fmap in enumerate(feats):
        if j not in feat_idx:
            continue
        t = psize // level_ds[j]
        rows.append(_superblock_rows(tiles[len(rows)], y0p, x0p, psize, t,
                                     fmap.shape[2] // t + 2))
    return rows, y0p.reshape(-1).contiguous(), x0p.reshape(-1).contiguous()


def gather_scaled_patch_pairs_fused(
    feats1, feats2, coords, feat_idx, feats_downsample, psize: int,
    out_dtype, ptype: str = "center", tiles1=None, tiles2=None,
):
    """Two-sided superblock gather + expansion/normalise/scale (kernel
    B3). ``coords``: (B, N, 4) match endpoints (x1, y1, x2, y2). Returns
    ``(patches, slice_map)``: the flat tuple of scaled ``(B*N, psize,
    psize, .)`` tensors and their regressor kernel-channel slices
    (:func:`..patch_expand.output_slice_map`)."""
    if tiles1 is None:
        tiles1 = make_padded_tiles_levels(feats1, feat_idx, feats_downsample, psize)
    if tiles2 is None:
        tiles2 = make_padded_tiles_levels(feats2, feat_idx, feats_downsample, psize)
    rows1, y1, x1 = _side_rows(feats1, tiles1, coords[..., 0:2], feat_idx,
                               feats_downsample, psize, ptype)
    rows2, y2, x2 = _side_rows(feats2, tiles2, coords[..., 2:4], feat_idx,
                               feats_downsample, psize, ptype)
    outs = expand_scale_pair(rows1, rows2, y1, x1, y2, x2, psize, out_dtype)
    level_ds = level_downsamples(feats_downsample)
    ds_list = [level_ds[j] for j in range(len(feats1)) if j in feat_idx]
    cs = [r.shape[3] // r.shape[2] for r in rows1]
    return outs, output_slice_map(ds_list, cs, psize)


def gather_local_patches_tiled_levels(feats, points, feat_idx, feats_downsample, psize: int,
                                      ptype: str = "center", tiles=None):
    """Superblock row-gather of one side's patches. Returns ``(levels,
    inv_norm)``: per-level ``(B, N, p, p, C_l)`` in the maps' dtype and
    the ``(B, N, p, p, 1)`` f32 hypercolumn normaliser. ``tiles``: the
    side's :func:`make_padded_tiles_levels`, built here when not given.
    The expansion is B7's plain version, differentiable with respect to
    the maps."""
    if tiles is None:
        tiles = make_padded_tiles_levels(feats, feat_idx, feats_downsample, psize)
    b, n, _ = points.shape
    rows, y0p, x0p = _side_rows(feats, tiles, points, feat_idx, feats_downsample,
                                psize, ptype)
    gathered = tuple(expand_level_plain(r, y0p, x0p, psize).reshape(b, n, psize, psize, -1)
                     for r in rows)
    return gathered, levels_inv_norm(gathered)


def gather_local_patches_tiled(feats, points, feat_idx, feats_downsample, psize: int,
                               ptype: str = "center"):
    """Superblock row-gather variant of :func:`gather_local_patches`
    (the same output) -> ``(B, N, p, p, D)``, L2-normalised over D."""
    levels, _ = gather_local_patches_tiled_levels(feats, points, feat_idx, feats_downsample,
                                                  psize, ptype)
    return l2_normalize(torch.cat(levels, dim=-1))


def gather_local_patches_grid_levels(feats, points, feat_idx, feats_downsample,
                                     psize: int):
    """Patch gather for GRID-ALIGNED centres ``g*psize + psize//2``:
    every patch is one space-to-depth tile per level. Returns
    ``(levels, inv_norm)``: per-level ``(B, N, p, p, C_l)`` and the
    ``(B, N, p, p, 1)`` f32 hypercolumn normaliser."""
    b, n, _ = points.shape
    gx = torch.div(points[..., 0].to(torch.int32) - psize // 2, psize,
                   rounding_mode="floor")
    gy = torch.div(points[..., 1].to(torch.int32) - psize // 2, psize,
                   rounding_mode="floor")
    level_ds = level_downsamples(feats_downsample)
    bi = torch.arange(b, device=points.device)[:, None]
    gathered = []
    for j, fmap in enumerate(feats):
        if j not in feat_idx:
            continue
        ds = level_ds[j]
        t = psize // ds
        _, h, w, c = fmap.shape
        gxc = torch.clamp(gx, 0, w // t - 1)
        gyc = torch.clamp(gy, 0, h // t - 1)
        tiles = fmap.reshape(b, h // t, t, w // t, t * c).permute(0, 1, 3, 2, 4)
        tiles = tiles.reshape(b, (h // t) * (w // t), t * t * c)
        rows = tiles[bi, (gyc * (w // t) + gxc).long()]  # (B, N, t*t*C)
        patch = rows.reshape(b, n, t, 1, t, 1, c).expand(b, n, t, ds, t, ds, c)
        gathered.append(patch.reshape(b, n, psize, psize, c))
    return tuple(gathered), levels_inv_norm(gathered)


def gather_local_patches_grid(feats, points, feat_idx, feats_downsample, psize: int):
    """:func:`gather_local_patches_grid_levels`, concatenated and
    L2-normalised over the hypercolumn -> ``(B, N, p, p, D)``; equal to
    :func:`gather_local_patches` where every point is a cell centre
    ``g*psize + psize//2``."""
    levels, _ = gather_local_patches_grid_levels(feats, points, feat_idx, feats_downsample,
                                                 psize)
    return l2_normalize(torch.cat(levels, dim=-1))


def _gather_level_blocks(fmap: torch.Tensor, y_base: torch.Tensor, x_base: torch.Tensor,
                         psize: int, ds: int) -> torch.Tensor:
    """One level's patches at any map size: fmap ``(B, H, W, C)`` (stride
    ``ds``), y_base/x_base ``(B, N)`` int patch corners in input pixels
    -> ``(B, N, psize, psize, C)`` sampled at
    ``clip((base + d) // ds, 0, dim - 1)``. The JAX version slices a block
    per proposal and indexes inside it; the indices land on the same
    pixels, so one indexed read gives the same values."""
    b, h, w, _ = fmap.shape
    d = torch.arange(psize, device=fmap.device)
    iy = torch.clamp(torch.div(y_base[..., None] + d, ds, rounding_mode="floor"), 0, h - 1)
    ix = torch.clamp(torch.div(x_base[..., None] + d, ds, rounding_mode="floor"), 0, w - 1)
    bi = torch.arange(b, device=fmap.device)[:, None, None, None]
    return fmap[bi, iy[:, :, :, None].long(), ix[:, :, None, :].long()]


def gather_local_patches_levels(feats, points, feat_idx, feats_downsample, psize: int,
                                ptype: str = "center"):
    """Per-pixel block gather at any map size (the route where the
    superblock gather does not apply, or that ``gather="block"``
    forces). Returns ``(levels, inv_norm)``: per-level ``(B, N, p, p,
    C_l)`` and the ``(B, N, p, p, 1)`` f32 hypercolumn normaliser."""
    y0, x0 = _corners(points, psize, ptype)
    level_ds = level_downsamples(feats_downsample)
    gathered = tuple(_gather_level_blocks(f, y0, x0, psize, level_ds[j])
                     for j, f in enumerate(feats) if j in feat_idx)
    return gathered, levels_inv_norm(gathered)


def gather_local_patches(feats, points, feat_idx, feats_downsample, psize: int,
                         ptype: str = "center"):
    """Normalised hypercolumn patches around 2D points.

    ``feats``: the channels-last pyramid, ``feats[0]`` the input image
    ``(B, H, W, 3)``, deeper levels downsampled by the cumulative
    product of ``feats_downsample``; ``points``: ``(B, N, 2)`` float (x,
    y) pixel coordinates (truncated to int); ``feat_idx``: the levels
    of the hypercolumn. Returns ``(B, N, psize, psize, D)``,
    L2-normalised over D."""
    levels, _ = gather_local_patches_levels(feats, points, feat_idx, feats_downsample,
                                            psize, ptype)
    return l2_normalize(torch.cat(levels, dim=-1))


def gather_local_patches_ref(feats, points, feat_idx, feats_downsample, psize: int,
                             ptype: str = "center"):
    """The naive per-pixel gather (the reference's formulation): one
    flat index per patch pixel and level. Kept as the oracle of the
    other gathers."""
    b, n, _ = points.shape
    y0, x0 = _corners(points, psize, ptype)
    d = torch.arange(psize, device=points.device)
    ys = (y0[..., None, None] + d[:, None]).expand(b, n, psize, psize).reshape(b, -1)
    xs = (x0[..., None, None] + d[None, :]).expand(b, n, psize, psize).reshape(b, -1)
    level_ds = level_downsamples(feats_downsample)
    gathered = []
    for j, fmap in enumerate(feats):
        if j not in feat_idx:
            continue
        _, h, w, c = fmap.shape
        ds = level_ds[j]
        lin = (torch.clamp(torch.div(ys, ds, rounding_mode="floor"), 0, h - 1) * w
               + torch.clamp(torch.div(xs, ds, rounding_mode="floor"), 0, w - 1))
        flat = fmap.reshape(b, h * w, c)
        gathered.append(torch.gather(flat, 1, lin.long()[..., None].expand(-1, -1, c)))
    hyper = l2_normalize(torch.cat(gathered, dim=-1))
    return hyper.reshape(b, n, psize, psize, -1)
