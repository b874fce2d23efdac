"""Hypercolumn local-patch gathering around match endpoints.

Port of the tileable paths of ``patch2pix_tpu.ops.patch_gather``: the
grid-aligned gather (eval mid stage when the coarse stride equals the
patch size) and the two-sided superblock gather feeding kernel B3.
Sampling reproduces the reference's per-pixel
``clip((base + d) // ds, 0, dim - 1)`` exactly. Both need every map
dimension to be a multiple of psize and at least 2*psize (true at the
Matcher's snapped sizes); other shapes raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from patch2pix_tpu_torch.ops.patch_expand import (
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


def _require_tileable(feats, psize: int):
    """Every pyramid level must support the 2x2-superblock row-gather."""
    h, w = feats[0].shape[1], feats[0].shape[2]
    if not (h % psize == 0 and w % psize == 0 and h >= 2 * psize and w >= 2 * psize):
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


def _padded_corners(points, psize: int, h_im: int, w_im: int):
    """Patch top-left corners in PADDED pixel coords (one psize ring),
    clipped as the reference's per-pixel border clamp requires."""
    x0 = points[..., 0].to(torch.int32) - psize // 2
    y0 = points[..., 1].to(torch.int32) - psize // 2
    x0p = torch.clamp(x0 + psize, 0, w_im + psize - 1)
    y0p = torch.clamp(y0 + psize, 0, h_im + psize - 1)
    return y0p, x0p


def gather_scaled_patch_pairs_fused(
    feats1, feats2, coords, feat_idx, feats_downsample, psize: int,
    out_dtype, tiles1=None, tiles2=None,
):
    """Two-sided superblock gather + expansion/normalise/scale (kernel
    B3). ``coords``: (B, N, 4) match endpoints (x1, y1, x2, y2), 'center'
    patches. Returns ``(patches, slice_map)``: the flat tuple of scaled
    ``(B*N, psize, psize, .)`` tensors and their regressor kernel-channel
    slices (:func:`..patch_expand.output_slice_map`)."""
    _require_tileable(feats1, psize)
    _require_tileable(feats2, psize)
    level_ds = level_downsamples(feats_downsample)
    if tiles1 is None:
        tiles1 = make_padded_tiles_levels(feats1, feat_idx, feats_downsample, psize)
    if tiles2 is None:
        tiles2 = make_padded_tiles_levels(feats2, feat_idx, feats_downsample, psize)
    sides = []
    for feats, tiles, pts in ((feats1, tiles1, coords[..., 0:2]),
                              (feats2, tiles2, coords[..., 2:4])):
        h_im, w_im = feats[0].shape[1], feats[0].shape[2]
        y0p, x0p = _padded_corners(pts, psize, h_im, w_im)
        rows = []
        li = 0
        for j, fmap in enumerate(feats):
            if j not in feat_idx:
                continue
            t = psize // level_ds[j]
            rows.append(_superblock_rows(tiles[li], y0p, x0p, psize, t,
                                         fmap.shape[2] // t + 2))
            li += 1
        sides.append((rows, y0p.reshape(-1).contiguous(), x0p.reshape(-1).contiguous()))
    (rows1, y1, x1), (rows2, y2, x2) = sides
    outs = expand_scale_pair(rows1, rows2, y1, x1, y2, x2, psize, out_dtype)
    ds_list = [level_ds[j] for j in range(len(feats1)) if j in feat_idx]
    cs = [r.shape[3] // r.shape[2] for r in rows1]
    return outs, output_slice_map(ds_list, cs, psize)


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
