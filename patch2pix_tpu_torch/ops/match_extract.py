"""Fixed-shape match extraction from correlation volumes.

Port of ``patch2pix_tpu.ops.match_extract`` (inference subset): both
matching directions in one pass, mutual filtering as an argmax
round-trip test, ``N = h2*w2 + h1*w1`` rows with a validity mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from patch2pix_tpu_torch.ops.correlation import decode_delta_at


class Matches(NamedTuple):
    """coords ``(B, N, 4)`` float32 pixel (x1, y1, x2, y2); scores
    ``(B, N)`` float32; valid ``(B, N)`` bool."""

    coords: torch.Tensor
    scores: torch.Tensor
    valid: torch.Tensor


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def corr_to_matches(corr, delta4d=None, ksize: int = 1, do_softmax: bool = True):
    """Per-cell best matches of a ``(B, h1, w1, h2, w2)`` volume.

    Rows: first the B->A direction (one per target cell, ``h2*w2``),
    then A->B (one per source cell, ``h1*w1``). ``delta4d``: None, the
    PRE-POOL volume, or ``("feats", f1, f2)`` from the fused corr+pool
    path; with one, indices are relocated to the pre-pool grid
    (``i*ksize + di``). Returns grid ``(B, N, 4)`` int32 (xA, yA, xB,
    yB), scores ``(B, N)`` and the mutual flags ``(B, N)``.
    """
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
    if isinstance(delta4d, tuple) and len(delta4d) == 3 and delta4d[0] == "feats":
        from patch2pix_tpu_torch.ops.corr_pool import decode_delta_from_feats

        di, dj, dk, dl = decode_delta_from_feats(
            delta4d[1], delta4d[2], ia, ja, ib, jb, ksize)
    elif isinstance(delta4d, torch.Tensor):
        di, dj, dk, dl = decode_delta_at(delta4d, ia, ja, ib, jb, ksize)
    elif delta4d is None:
        return ia * ksize, ja * ksize, ib * ksize, jb * ksize
    else:
        raise ValueError(f"unsupported delta4d {type(delta4d)}")
    return ia * ksize + di, ja * ksize + dj, ib * ksize + dk, jb * ksize + dl


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
