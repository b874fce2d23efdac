"""The coarse stage with the 4D correlation volume sharded over ``h1``.

Port of ``patch2pix_tpu.parallel.volume_sharding``. At large image sizes
the volume ``(B, h1, w1, h2, w2)``, not the features, is what outgrows
one device; here each rank of a mesh holds ``1/n`` of its ``h1`` rows
and never more:

  * correlation and pooling: this rank's h1 slice of ``feat1`` against
    the whole ``feat2`` — kernel B2 (``corr_pool``) where
    ``corr_pool_supported`` says so, else the plain correlation and
    ``maxpool4d_values``; no communication;
  * mutual matching: the source-side max is a MAX all-reduce of the
    ``(B, nb)`` row of local maxima;
  * the NCN: a one-row h1 halo is exchanged with the neighbour ranks
    before EVERY conv layer, with zeros at the global edges. A conv's
    SAME padding zero-pads each layer's input at the image boundary, so
    the next layer must see literal zeros there; one wider slab sent up
    front would feed it the first layer evaluated on zeros (bias + ReLU
    is not zero). B1 runs in each rank's fold-out. On one rank nothing
    is sent: a rank never sends to itself;
  * extraction: the A->B direction is local; the B->A argmax over all
    source cells is a MAX all-reduce of the local maxima and a MIN
    all-reduce of the winning global indices (the single-device
    first-max tie-break, since ranks hold the rows in order); its
    softmax score is 1 / the SUM all-reduce of local exp-sums against
    the global max;
  * relocalisation: each direction's within-window offsets are decoded
    from the features (``ops/corr_pool.decode_delta_from_feats``) on the
    rank that owns the winning source row, then summed over the ranks;
    no pre-pool volume is kept anywhere (JAX keeps the pre-pool slice);
  * all-gathers build the replicated grid, scores and mutual flags.

Per pair, the ranks exchange O(nb) scalars and the halo rows; no
collective moves a volume-sized tensor. The Matches equal
``Patch2Pix.coarse_matches`` of the same features on one device.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from patch2pix_tpu_torch.models.ncn import Conv4dParams
from patch2pix_tpu_torch.ops.conv4d import conv4d, conv4d_transpose_symmetric
from patch2pix_tpu_torch.ops.corr_pool import (
    corr_pool,
    corr_pool_supported,
    decode_delta_from_feats,
)
from patch2pix_tpu_torch.ops.correlation import (
    feat_correlation,
    l2_normalize,
    maxpool4d_values,
)
from patch2pix_tpu_torch.ops.match_extract import (
    Matches,
    grid_to_pixel,
    mutual_consistency_mask,
    score_threshold_mask,
)
from patch2pix_tpu_torch.parallel import comm_stats
from patch2pix_tpu_torch.parallel.mesh import Mesh


def _mutual_matching_sharded(corr, group, eps: float = 1e-5):
    """``mutual_matching`` with the source-axis max reduced over ranks."""
    b, h1l, w1, h2, w2 = corr.shape
    flat = corr.reshape(b, h1l * w1, h2 * w2)
    max_a = comm_stats.all_reduce(torch.amax(flat, dim=1, keepdim=True),
                                  op=dist.ReduceOp.MAX, group=group)
    max_b = torch.amax(flat, dim=2, keepdim=True)
    out = flat * (flat / (max_a + eps)) * (flat / (max_b + eps))
    return out.reshape(corr.shape)


def _with_h1_halo(x, group):
    """``x`` with one h1 row from each neighbour rank on either side
    (zeros at the global edges)."""
    top, bottom = x[:, :1], x[:, -1:]
    from_prev, from_next = comm_stats.exchange_halo(top.contiguous(), bottom.contiguous(),
                                                    group)
    from_prev = torch.zeros_like(bottom) if from_prev is None else from_prev
    from_next = torch.zeros_like(top) if from_next is None else from_next
    return torch.cat([from_prev, x, from_next], dim=1)


def _ncn_sharded(ncn, corr, group):
    """The symmetric NCN over an h1-sharded volume, one halo exchange
    per layer (module docstring); mirrors ``NeighConsensus.forward``,
    its compute and output dtypes included."""
    convs = [m for m in ncn.conv if isinstance(m, Conv4dParams)]

    def stack(x, transpose: bool):
        op = conv4d_transpose_symmetric if transpose else conv4d
        for li, layer in enumerate(convs):
            ext = _with_h1_halo(x, group)
            od = ncn.dtype if li < len(convs) - 1 else None
            y = torch.relu(op(ext.to(ncn.dtype), layer.kernel().to(ncn.dtype), layer.bias,
                              out_dtype=od))
            x = y[:, 1:-1]
        return x

    x = corr[..., None]
    y = stack(x, False)
    if ncn.symmetric_mode:
        y = y + stack(x, True)
    return y[..., 0].float()


def _gather_rows(t, group):
    """Every rank's ``(..., rows)`` slice of the last axis, in rank order."""
    return torch.cat(comm_stats.all_gather(t.contiguous(), group), dim=-1)


def _sharded_coarse(ncn, feat1_local, feat2, ksize: int, mesh: Mesh):
    """One rank's part: replicated (grid, scores, mutual) in the row
    order of the single-device ``corr_to_matches``."""
    group, n, p = mesh.group, mesh.size, mesh.rank
    f1 = l2_normalize(feat1_local.contiguous())
    f2 = l2_normalize(feat2.contiguous())
    if ksize > 1 and corr_pool_supported(f1, f2, ksize):
        corr = corr_pool(f1, f2)
    elif ksize > 1:
        corr = maxpool4d_values(feat_correlation(f1, f2), ksize)
    else:
        corr = feat_correlation(f1, f2)
    corr = _mutual_matching_sharded(corr, group)
    corr = _ncn_sharded(ncn, corr, group)
    corr = _mutual_matching_sharded(corr, group)

    b, h1l, w1, h2, w2 = corr.shape
    nal, nb = h1l * w1, h2 * w2
    na = n * nal
    flat = corr.reshape(b, nal, nb)
    dev = flat.device

    # direction 2 (A->B): the source cells are this rank's
    arg2 = torch.argmax(flat, dim=2)
    score2 = torch.exp(torch.amax(flat, dim=2) - torch.logsumexp(flat, dim=2))

    # direction 1 (B->A): the argmax over every rank's source cells
    lm = torch.amax(flat, dim=1)
    la = torch.argmax(flat, dim=1)
    gmax = comm_stats.all_reduce(lm.clone(), op=dist.ReduceOp.MAX, group=group)
    cand = torch.where(lm >= gmax, p * nal + la, torch.full_like(la, na + 1))
    arg1 = comm_stats.all_reduce(cand, op=dist.ReduceOp.MIN, group=group)
    # exp(max - logsumexp) = 1 / sum(exp(x - max)), the sum over ranks
    z = comm_stats.all_reduce(torch.sum(torch.exp(flat - gmax[:, None, :]), dim=1),
                              group=group)
    score1 = 1.0 / z

    ids_b = torch.arange(nb, device=dev)[None, :]
    ids_a = p * nal + torch.arange(nal, device=dev)[None, :]
    arg2_full = _gather_rows(arg2, group)
    mutual1 = torch.gather(arg2_full, 1, arg1) == ids_b
    mutual2 = torch.gather(arg1, 1, arg2) == ids_a

    ia1, ja1 = torch.div(arg1, w1, rounding_mode="floor"), arg1 % w1
    ib1, jb1 = (ids_b // w2).expand(b, nb), (ids_b % w2).expand(b, nb)
    ia2, ja2 = (ids_a // w1).expand(b, nal), (ids_a % w1).expand(b, nal)
    ib2, jb2 = torch.div(arg2, w2, rounding_mode="floor"), arg2 % w2
    if ksize > 1:
        own1 = (ia1 >= p * h1l) & (ia1 < (p + 1) * h1l)
        d1 = decode_delta_from_feats(f1, f2, torch.where(own1, ia1 - p * h1l, 0), ja1,
                                     ib1, jb1, ksize)
        d1 = comm_stats.all_reduce(torch.stack([torch.where(own1, d, 0) for d in d1]),
                                   group=group)
        d2 = decode_delta_from_feats(f1, f2, ia2 - p * h1l, ja2, ib2, jb2, ksize)
        ia1, ja1, ib1, jb1 = (v * ksize + d for v, d in zip((ia1, ja1, ib1, jb1), d1))
        ia2, ja2, ib2, jb2 = (v * ksize + d for v, d in zip((ia2, ja2, ib2, jb2), d2))

    local = torch.stack([ja2, ia2, jb2, ib2, mutual2.to(ja2.dtype)]).to(torch.int64)
    full = _gather_rows(local, group)  # (5, B, na)
    grid = torch.stack([torch.cat([ja1, full[0]], dim=1), torch.cat([ia1, full[1]], dim=1),
                        torch.cat([jb1, full[2]], dim=1), torch.cat([ib1, full[3]], dim=1)],
                       dim=-1).to(torch.int32)
    scores = torch.cat([score1, _gather_rows(score2, group)], dim=1)
    mutual = torch.cat([mutual1, full[4] > 0], dim=1)
    return grid, scores, mutual


def make_sharded_coarse_matcher(model, mesh: Mesh, ksize: int = 2, mutual: bool = True,
                                ncn_thres: float = 0.0, axis: str = "cp"):
    """``fn(feat1, feat2) -> Matches``, called on every rank of ``mesh``
    with the same stride-16/8 features ``(B, h1, w1, C)`` /
    ``(B, h2, w2, C)`` (``axis`` names the mesh axis, as in JAX). Each
    rank correlates its h1 slice; the Matches are replicated and equal
    ``model.coarse_matches(*model.coarse_corr(feat1, feat2, ksize),
    ksize, mutual, ncn_thres)`` on one device. ``h1`` must split into
    ``mesh.size * ksize`` blocks."""
    del axis

    @torch.inference_mode()
    def fn(feat1, feat2) -> Matches:
        h1 = feat1.shape[1]
        if h1 % (mesh.size * ksize):
            raise ValueError(f"h1 = {h1} does not split into {mesh.size} ranks x ksize "
                             f"{ksize} blocks")
        rows = h1 // mesh.size
        grid, scores, mut = _sharded_coarse(
            model.ncn, feat1[:, mesh.rank * rows:(mesh.rank + 1) * rows], feat2, ksize, mesh)
        nb = (feat2.shape[1] // ksize) * (feat2.shape[2] // ksize)
        valid = mutual_consistency_mask(mut, nb, keep_mutual_only=mutual)
        valid = score_threshold_mask(valid, scores, ncn_thres)
        coords = grid_to_pixel(grid, upsample=model.config.upsample, center=True)
        return Matches(coords, scores, valid)

    return fn
