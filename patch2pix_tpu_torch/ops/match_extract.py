"""Fixed-shape match extraction from correlation volumes.

Port of ``patch2pix_tpu.ops.match_extract`` (inference, the NCNet
family's :func:`corr_to_matches_topk`, and the training step's
:func:`select_ptmax`): both matching directions in one pass, mutual
filtering as an argmax round-trip test, ``N = h2*w2 + h1*w1`` rows with
a validity mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from patch2pix_tpu_torch.ops.correlation import decode_delta_at
from patch2pix_tpu_torch.utils import profiling


class Matches(NamedTuple):
    """coords ``(B, N, 4)`` float32 pixel (x1, y1, x2, y2); scores
    ``(B, N)`` float32; valid ``(B, N)`` bool."""

    coords: torch.Tensor
    scores: torch.Tensor
    valid: torch.Tensor

    @property
    def n(self) -> int:
        """Rows per pair (valid or not)."""
        return self.coords.shape[1]


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def corr_to_matches(corr, delta4d=None, ksize: int = 1, do_softmax: bool = True):
    """Per-cell best matches of a ``(B, h1, w1, h2, w2)`` volume.

    Rows: first the B->A direction (one per target cell, ``h2*w2``),
    then A->B (one per source cell, ``h1*w1``). ``delta4d``: None, the
    PRE-POOL volume, the 4-tuple of offset volumes from
    :func:`..correlation.maxpool4d`, or ``("feats", f1, f2)`` from the
    fused corr+pool path; with one, indices are relocated to the
    pre-pool grid (``i*ksize + di``). Returns grid ``(B, N, 4)`` int32 (xA, yA, xB,
    yB), scores ``(B, N)`` and the mutual flags ``(B, N)``.
    """
    with profiling.span("coarse.extract"):
        b, h1, w1, h2, w2 = corr.shape
        na, nb = h1 * w1, h2 * w2
        flat = corr.reshape(b, na, nb)
        # argmax returns the first maximum (torch.max's index need not)
        arg1 = torch.argmax(flat, dim=1)  # (B, nb) -> index into na
        arg2 = torch.argmax(flat, dim=2)  # (B, na) -> index into nb
        m1 = torch.amax(flat, dim=1)
        m2 = torch.amax(flat, dim=2)
        if do_softmax:
            score1 = torch.exp(m1 - torch.logsumexp(flat, dim=1))
            score2 = torch.exp(m2 - torch.logsumexp(flat, dim=2))
        else:
            score1, score2 = m1, m2

        ids_b = torch.arange(nb, device=corr.device)[None, :]
        ids_a = torch.arange(na, device=corr.device)[None, :]
        mutual1 = torch.gather(arg2, 1, arg1) == ids_b
        mutual2 = torch.gather(arg1, 1, arg2) == ids_a

        ia = torch.cat([_fdiv(arg1, w1), (ids_a // w1).expand(b, na)], dim=1)
        ja = torch.cat([arg1 % w1, (ids_a % w1).expand(b, na)], dim=1)
        ib = torch.cat([(ids_b // w2).expand(b, nb), _fdiv(arg2, w2)], dim=1)
        jb = torch.cat([(ids_b % w2).expand(b, nb), arg2 % w2], dim=1)
        ia, ja, ib, jb = _relocate(delta4d, ia, ja, ib, jb, ksize)

        grid = torch.stack([ja, ia, jb, ib], dim=-1).to(torch.int32)
        scores = torch.cat([score1, score2], dim=1)
        mutual = torch.cat([mutual1, mutual2], dim=1)
        return grid, scores, mutual


def _relocate(delta4d, ia, ja, ib, jb, ksize):
    """Relocate pooled-grid indices to the pre-pool grid."""
    if isinstance(delta4d, (tuple, list)) and len(delta4d) == 3 and delta4d[0] == "feats":
        from patch2pix_tpu_torch.ops.corr_pool import decode_delta_from_feats

        di, dj, dk, dl = decode_delta_from_feats(
            delta4d[1], delta4d[2], ia, ja, ib, jb, ksize)
    elif isinstance(delta4d, (tuple, list)) and len(delta4d) == 4:
        # maxpool4d's offset volumes, gathered at the selected cells
        b, _, w1, h2, w2 = delta4d[0].shape
        lin = (((ia * w1 + ja) * h2 + ib) * w2 + jb).long()
        di, dj, dk, dl = (torch.gather(d.reshape(b, -1), 1, lin) for d in delta4d)
    elif isinstance(delta4d, torch.Tensor):
        di, dj, dk, dl = decode_delta_at(delta4d, ia, ja, ib, jb, ksize)
    elif delta4d is None:
        return ia * ksize, ja * ksize, ib * ksize, jb * ksize
    else:
        raise ValueError(f"unsupported delta4d {type(delta4d)}")
    return ia * ksize + di, ja * ksize + dj, ib * ksize + dk, jb * ksize + dl


def _topk_lower_index_first(vals, k: int):
    """Top ``k`` along the last axis, equal values in index order (the
    order ``lax.top_k`` gives; ``torch.topk`` promises none): a stable
    descending sort, cut at ``k``."""
    v, i = torch.sort(vals, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def corr_to_matches_topk(corr, delta4d=None, topk: int = 1, ksize: int = 1,
                         do_softmax: bool = True, invert_matching_direction: bool = False):
    """The ``topk`` best cells per anchor, one direction: per target
    cell the best source cells (default; rows k-major, ``N = topk *
    h2*w2``) or, inverted, per source cell the best target cells (rows
    anchor-major, ``N = h1*w1 * topk``). Scores are softmax values over
    the reduced axis when ``do_softmax``. ``delta4d`` relocates as in
    :func:`corr_to_matches`. Returns grid ``(B, N, 4)`` int32 (xA, yA,
    xB, yB) and scores ``(B, N)`` float32."""
    b, h1, w1, h2, w2 = corr.shape
    na, nb = h1 * w1, h2 * w2
    flat = corr.reshape(b, na, nb)
    if invert_matching_direction:
        vals = torch.softmax(flat, dim=2) if do_softmax else flat
        top_v, top_i = _topk_lower_index_first(vals, topk)  # (B, na, k)
        ib, jb = _fdiv(top_i, w2).reshape(b, -1), (top_i % w2).reshape(b, -1)
        ids_a = torch.arange(na, device=corr.device)[None, :, None].expand(b, na, topk)
        ia, ja = (ids_a // w1).reshape(b, -1), (ids_a % w1).reshape(b, -1)
    else:
        vals = torch.softmax(flat, dim=1) if do_softmax else flat
        top_v, top_i = _topk_lower_index_first(vals.transpose(1, 2), topk)  # (B, nb, k)
        top_v, top_i = top_v.transpose(1, 2), top_i.transpose(1, 2)  # (B, k, nb)
        ia, ja = _fdiv(top_i, w1).reshape(b, -1), (top_i % w1).reshape(b, -1)
        ids_b = torch.arange(nb, device=corr.device)[None, None, :].expand(b, topk, nb)
        ib, jb = (ids_b // w2).reshape(b, -1), (ids_b % w2).reshape(b, -1)
    scores = top_v.reshape(b, -1).float()
    ia, ja, ib, jb = _relocate(delta4d, ia, ja, ib, jb, ksize)
    return torch.stack([ja, ia, jb, ib], dim=-1).to(torch.int32), scores


def mutual_consistency_mask(mutual, nb: int, keep_mutual_only: bool):
    """The reference's unique/mutual filter: mutual=True keeps the
    direction-1 mutual rows; mutual=False keeps all direction-1 rows and
    the non-mutual direction-2 rows."""
    m1, m2 = mutual[:, :nb], mutual[:, nb:]
    if keep_mutual_only:
        return torch.cat([m1, torch.zeros_like(m2)], dim=1)
    return torch.cat([torch.ones_like(m1), ~m2], dim=1)


def score_threshold_mask(valid, scores, thres: float):
    """NC-score threshold with the reference's keep-all fallback."""
    passed = valid & (scores > thres)
    any_passed = torch.any(passed, dim=1, keepdim=True)
    return torch.where(any_passed, passed, valid)


def grid_to_pixel(grid, upsample: int, center: bool = True):
    """Feature-grid indices -> input-image pixel coordinates."""
    pix = grid.float() * float(upsample)
    if center:
        pix = pix + float(upsample // 2)
    return pix


def select_ptmax(coords, scores, valid, ptmax: int, generator=None, rand=None,
                 rand_rows=None) -> Matches:
    """Resample the valid rows to exactly ``ptmax`` proposals per pair:
    valid rows in a random order, cycled until ``ptmax`` slots are
    filled; a pair with no valid row repeats row 0. The order comes from
    ``rand``, a ``(B, N)`` uniform draw, or else one drawn with
    ``generator`` (``torch.rand`` on the scores' device); with
    ``rand_rows`` ``(offset, total)`` the draw is the global batch's
    ``(total, N)`` and these pairs take rows ``offset:offset + B``.
    Returns :class:`Matches` with an all-True valid mask."""
    b, n = scores.shape
    if rand is None and rand_rows is not None:
        lo, total = rand_rows
        rand = torch.rand((total, n), generator=generator, device=scores.device)[lo:lo + b]
    elif rand is None:
        rand = torch.rand((b, n), generator=generator, device=scores.device)
    # invalid rows sort to the back; valid rows in the draw's order
    order = torch.argsort(torch.where(valid, rand, torch.full_like(rand, 2.0)),
                          dim=1, stable=True)
    n_valid = torch.clamp(valid.sum(dim=1), min=1)
    slots = torch.arange(ptmax, device=scores.device)[None, :] % n_valid[:, None]
    ids = torch.gather(order, 1, slots)
    return Matches(torch.gather(coords, 1, ids[..., None].expand(-1, -1, coords.shape[-1])),
                   torch.gather(scores, 1, ids),
                   torch.ones((b, ptmax), dtype=torch.bool, device=scores.device))
