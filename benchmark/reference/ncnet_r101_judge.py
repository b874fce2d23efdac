"""The judge of NCNet's InLoc model: a program's relocated matches held
against the float32 reference (:mod:`benchmark.reference.ncnet_r101`).

As :mod:`benchmark.reference.matching`'s judges, it never asks the
reference to pick the program's cell (seeded weights on noise images
leave near-ties that a rounding may break the other way). It reads the
rules every pick obeys; over every row of both halves, how far below the
best of its column or row the program's pooled pick lies in the
reference's filtered volume, and how far the program's score lies from
the reference's softmax at that pick; and how far below the best of its
2^4 window the program's relocated cell lies in the reference's pre-pool
volume.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference import nets
from benchmark.reference import ncnet_r101 as ref
from benchmark.reference.matching import _window_argmax

NUMBERS = ("grid_malformed", "mutual_unpaired", "pick_gap", "score_err", "reloc_gap")


def judge(P, cfg, opts, im1, im2, out) -> Dict[str, float]:
    """Hold one call's outputs (host arrays: ``grid`` (B, N, 4) (xA, yA,
    xB, yB) on the pre-pool grid, ``scores``, ``mutual``) against the
    reference. Numbers:

    * ``grid_malformed``: a row count other than the pooled volume's
      cells of both images, rows off the pre-pool grid, or a row whose
      anchor (its pooled target cell in the first half, its pooled source
      cell in the second) is not its own. Where a pair has one, every
      other number reads infinite;
    * ``mutual_unpaired``: mutual rows of either half whose relocated
      match is not a mutual row of the other half (a mutual pick is one
      to one, and both halves relocate it by the same window);
    * ``pick_gap``: over every row, the widest gap between the best of
      the anchor's column (first half) or row (second half) in the
      reference's filtered pooled volume and its value at the program's
      pooled pick, over the volume's largest value;
    * ``score_err``: over every row, the widest distance between the log
      of the program's score and the log of the reference's softmax of
      that column or row at the program's pick, over the volume's
      largest value. A log softmax is the value less the column's or
      row's log-sum-exp, so this reads the error of the NCN's filtered
      values, and of the softmax, in units of the volume's largest value;
    * ``reloc_gap``: over every row, the widest gap between the best
      value of the pick's 2^4 window of the reference's pre-pool volume
      (cosines of unit layer3 features) and its value at the program's
      relocated cell.
    """
    dev = im1.device
    k = cfg["relocalization_k_size"]
    with torch.no_grad(), nets.strict_float32():
        pre, offsets, corr = ref.volumes(P, cfg, im1, im2)
    del offsets
    b, h1, w1, h2, w2 = corr.shape
    na, nb = h1 * w1, h2 * w2
    flat = corr.reshape(b, na, nb)
    res = {n: 0.0 for n in NUMBERS}
    anchors = torch.cat([torch.arange(nb, device=dev), torch.arange(na, device=dev)])
    for p in range(b):
        g = torch.as_tensor(np.asarray(out["grid"][p]), dtype=torch.long, device=dev)
        bad = g.dim() != 2 or g.shape != (na + nb, 4)
        if not bad:
            inside = ((g >= 0).all(dim=1) & (g[:, 0] < w1 * k) & (g[:, 1] < h1 * k)
                      & (g[:, 2] < w2 * k) & (g[:, 3] < h2 * k))
            gp = torch.div(g, k, rounding_mode="floor")
            a = gp[:, 1] * w1 + gp[:, 0]
            bcell = gp[:, 3] * w2 + gp[:, 2]
            own = torch.cat([bcell[:nb], a[nb:]]) == anchors
            bad = int((~(inside & own)).sum())
        if bad:
            res["grid_malformed"] += int(bad)
            for name in NUMBERS[1:]:
                res[name] = float("inf")
            continue
        m = torch.as_tensor(np.asarray(out["mutual"][p]), dtype=torch.bool, device=dev)
        rows = [tuple(r) for r in g.tolist()]
        pairs1 = {r for r, keep in zip(rows[:nb], m[:nb].tolist()) if keep}
        pairs2 = {r for r, keep in zip(rows[nb:], m[nb:].tolist()) if keep}
        res["mutual_unpaired"] += len(pairs1 ^ pairs2)
        f = flat[p]
        scale = f.max().clamp_min(1e-30)
        val = f[a, bcell]
        best = torch.cat([f.amax(dim=0)[bcell[:nb]], f.amax(dim=1)[a[nb:]]])
        res["pick_gap"] = max(res["pick_gap"], float(((best - val) / scale).max()))
        lse = torch.cat([torch.logsumexp(f, dim=0)[bcell[:nb]],
                         torch.logsumexp(f, dim=1)[a[nb:]]])
        score = torch.as_tensor(np.asarray(out["scores"][p]), device=dev).double()
        err = (torch.log(score) - (val - lse).double()).abs() / float(scale)
        err = err.nan_to_num(nan=float("inf"), posinf=float("inf"))
        res["score_err"] = max(res["score_err"], float(err.max()))
        _, win = _window_argmax(pre, torch.full_like(a, p), gp[:, 1], gp[:, 0], gp[:, 3],
                                gp[:, 2], k)
        reloc = win.amax(dim=1) - pre[p, g[:, 1], g[:, 0], g[:, 3], g[:, 2]]
        res["reloc_gap"] = max(res["reloc_gap"], float(reloc.max()))
    return res
