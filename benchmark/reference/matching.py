"""Match extraction by the plain references, and the judges that hold a
program's matches against them.

The judges never ask the reference to pick the same cell as the program:
with seeded weights on noise images many rows of a volume hold near-ties,
and a rounding of the program's may pick the runner-up. Each judge reads
instead the rules a pick obeys whatever the rounding (rows on the grid,
each anchor its own, mutual picks one to one), how far below the best of
its window or row the program's pick lies in the reference's float32
volumes, and, stage by stage, how far each regressed match lies from the
reference's regression at the program's own input to that stage.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference import nets


def _first_argmax(x, dim):
    return torch.argmax(x, dim=dim)


def _window_argmax(pre, b, ia, ja, ib, jb, k: int):
    """Per pooled cell, the row-major first argmax (di, dj, dk, dl) of
    the pre-pool volume's k^4 window, and the window's values."""
    d = torch.arange(k, device=pre.device)
    di, dj, dk, dl = (t.reshape(-1) for t in torch.meshgrid(d, d, d, d, indexing="ij"))
    vals = pre[b[:, None], ia[:, None] * k + di, ja[:, None] * k + dj,
               ib[:, None] * k + dk, jb[:, None] * k + dl]
    arg = torch.argmax(vals, dim=1)
    return (di[arg], dj[arg], dk[arg], dl[arg]), vals


# ------------------------------------------------------------ Patch2Pix


def p2p_predict(P, cfg, opts, im1, im2, prec=nets.F32) -> Dict[str, torch.Tensor]:
    """The reference's ``predict_fine``: coarse matches (mutual, the
    A->B rows of each target cell), ``fine_cap`` rows by score, then the
    mid and fine regressions. Returns the program's output layout."""
    vol = nets.patch2pix_volume(P, cfg, im1, im2, prec)
    return _p2p_from_volume(P, cfg, opts, vol, im1.shape[1], prec)


def _p2p_from_volume(P, cfg, opts, vol, height, prec=nets.F32):
    pyr1, pyr2, pre, corr = vol
    k = cfg["ksize"]
    b, h1, w1, h2, w2 = corr.shape
    na, nb = h1 * w1, h2 * w2
    up = height // pre.shape[1]
    flat = corr.reshape(b, na, nb)
    arg1 = _first_argmax(flat, 1)  # (B, nb)
    arg2 = _first_argmax(flat, 2)  # (B, na)
    ids_b = torch.arange(nb, device=corr.device)
    valid = torch.gather(arg2, 1, arg1) == ids_b[None]
    scores = torch.exp(flat.amax(dim=1) - torch.logsumexp(flat, dim=1))
    passed = valid & (scores > opts["ncn_thres"])
    valid = torch.where(passed.any(dim=1, keepdim=True), passed, valid)
    bi = torch.arange(b, device=corr.device)[:, None].expand(b, nb).reshape(-1)
    ia, ja = (arg1 // w1).reshape(-1), (arg1 % w1).reshape(-1)
    ib, jb = (ids_b // w2).repeat(b), (ids_b % w2).repeat(b)
    (di, dj, dk, dl), _ = _window_argmax(pre, bi, ia, ja, ib, jb, k)
    grid = torch.stack([ja * k + dj, ia * k + di, jb * k + dl, ib * k + dk], dim=-1)
    coords = (grid.float() * up + up // 2).reshape(b, nb, 4)
    cap = opts["fine_cap"]
    if cap < nb:
        rank = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
        order = torch.argsort(-rank, dim=1, stable=True)[:, :cap]
        coords = torch.gather(coords, 1, order[..., None].expand(-1, -1, 4))
        scores, valid = torch.gather(scores, 1, order), torch.gather(valid, 1, order)
    mid, mid_p = nets.regress(P, "regress_mid", pyr1, pyr2, coords, cfg, prec)
    fine, fine_p = nets.regress(P, "regress_fine", pyr1, pyr2, mid, cfg, prec)
    return {"coarse": coords, "scores": scores, "valid": valid, "mid": mid,
            "mid_probs": mid_p, "fine": fine, "fine_probs": fine_p}


P2P_NUMBERS = ("coarse_malformed", "valid_unpaired", "reloc_gap", "regress_err_px",
               "mid_prob_err", "fine_prob_err")


def p2p_judge(P, cfg, opts, im1, im2, out) -> Dict[str, float]:
    """Hold one call's outputs (host arrays in :func:`p2p_predict`'s
    layout, every row the program returns: each row is the pick of one
    target cell, valid or not) against the float32 reference. Numbers:

    * ``coarse_malformed``: rows off the coarse grid, or naming a target
      cell that another row names too. Where a pair has one, every other
      number of the call reads infinite;
    * ``valid_unpaired``: valid rows whose source pooled cell another
      valid row names too (a mutual pick is one to one);
    * ``reloc_gap``: within the chosen pooled cell's 2^4 window of the
      pre-pool correlation (cosines of unit layer3 features), the best
      minus the value at the program's relocated cell, widest;
    * ``regress_err_px``: the widest distance, along any coordinate,
      between a regressed match and the reference's regression at the
      program's own input to that stage: the mid stage at the program's
      coarse matches, the fine stage at its mid matches;
    * ``mid_prob_err``, ``fine_prob_err``: the same for the two stages'
      confidences.
    """
    dev = im1.device
    with torch.no_grad(), nets.strict_float32():
        pyr1, pyr2, pre, corr = nets.patch2pix_volume(P, cfg, im1, im2)
    k = cfg["ksize"]
    b, h1, w1, h2, w2 = corr.shape
    up = im1.shape[1] // pre.shape[1]
    res = {n: 0.0 for n in P2P_NUMBERS}
    for p in range(b):
        v = np.asarray(out["valid"][p], dtype=bool)
        c = np.asarray(out["coarse"][p], dtype=np.float64)
        g = (c - up // 2) / up
        rg = np.rint(g)
        on_grid = ((np.abs(g - rg) == 0.0).all(axis=1) & (rg >= 0).all(axis=1)
                   & (rg[:, [0, 2]] < w1 * k).all(axis=1) & (rg[:, [1, 3]] < h1 * k).all(axis=1))
        cells = np.where(on_grid, (rg[:, 3] // k) * w2 + rg[:, 2] // k, -1 - np.arange(len(rg)))
        bad = int((~on_grid).sum()) + len(cells) - len(np.unique(cells))
        if bad:
            res["coarse_malformed"] += bad
            for name in P2P_NUMBERS[1:]:
                res[name] = float("inf")
            continue
        sources = (rg[v, 1] // k) * w1 + rg[v, 0] // k
        res["valid_unpaired"] += int(v.sum()) - len(np.unique(sources))
        gi = torch.as_tensor(rg, dtype=torch.long, device=dev)
        xa, ya, xb, yb = gi.unbind(-1)
        ia, ja, ib, jb = ya // k, xa // k, yb // k, xb // k
        _, win = _window_argmax(pre, torch.full_like(ia, p), ia, ja, ib, jb, k)
        reloc = win.amax(dim=1) - pre[p, ya, xa, yb, xb]
        res["reloc_gap"] = max(res["reloc_gap"], float(reloc.max()))
        with torch.no_grad(), nets.strict_float32():
            py1 = [f[p:p + 1] for f in pyr1]
            py2 = [f[p:p + 1] for f in pyr2]
            cin = torch.as_tensor(c, dtype=torch.float32, device=dev)[None]
            mid_in = torch.as_tensor(np.asarray(out["mid"][p]), dtype=torch.float32,
                                     device=dev)[None]
            rmid, rmid_p = nets.regress(P, "regress_mid", py1, py2, cin, cfg)
            rfine, rfine_p = nets.regress(P, "regress_fine", py1, py2, mid_in, cfg)
        for name, key, want in (("regress_err_px", "mid", rmid[0]),
                                ("mid_prob_err", "mid_probs", rmid_p[0]),
                                ("regress_err_px", "fine", rfine[0]),
                                ("fine_prob_err", "fine_probs", rfine_p[0])):
            got = torch.as_tensor(np.asarray(out[key][p]), dtype=torch.float32, device=dev)
            err = float((got - want).abs().max())
            res[name] = max(res[name], err if np.isfinite(err) else float("inf"))
    return res


# --------------------------------------------------------------- NCNet


def ncnet_predict(P, cfg, opts, im1, im2, prec=nets.F32) -> Dict[str, torch.Tensor]:
    """The reference's ``corr_to_matches`` on its volume: rows of each
    target cell's best source cell, then each source cell's best target
    cell; softmax scores; mutual flags."""
    corr = nets.ncnet_volume(P, cfg, im1, im2, prec)
    b, h1, w1, h2, w2 = corr.shape
    na, nb = h1 * w1, h2 * w2
    flat = corr.reshape(b, na, nb)
    arg1, arg2 = _first_argmax(flat, 1), _first_argmax(flat, 2)
    s1 = torch.exp(flat.amax(dim=1) - torch.logsumexp(flat, dim=1))
    s2 = torch.exp(flat.amax(dim=2) - torch.logsumexp(flat, dim=2))
    ids_a = torch.arange(na, device=corr.device)[None].expand(b, na)
    ids_b = torch.arange(nb, device=corr.device)[None].expand(b, nb)
    m1 = torch.gather(arg2, 1, arg1) == ids_b
    m2 = torch.gather(arg1, 1, arg2) == ids_a
    a = torch.cat([arg1, ids_a], dim=1)
    bb = torch.cat([ids_b, arg2], dim=1)
    grid = torch.stack([a % w1, a // w1, bb % w2, bb // w2], dim=-1)
    return {"grid": grid, "scores": torch.cat([s1, s2], dim=1),
            "mutual": torch.cat([m1, m2], dim=1)}


NCNET_NUMBERS = ("grid_malformed", "mutual_unpaired", "pick_gap_mean")


def ncnet_judge(P, cfg, opts, im1, im2, out) -> Dict[str, float]:
    """Numbers:

    * ``grid_malformed``: rows off the grid, a row count other than the
      volume's cells of both images, or a row whose anchor (its target
      cell in the first half, its source cell in the second) is not its
      own. Where a pair has one, every other number reads infinite;
    * ``mutual_unpaired``: mutual rows of either half whose pick is not a
      mutual row of the other half (a mutual pick is one to one);
    * ``pick_gap_mean``: over the mutual rows (the matches a caller
      keeps), the mean of the best of the anchor's column or row in the
      reference's volume minus its value at the program's pick, over the
      volume's largest value.
    """
    dev = im1.device
    with torch.no_grad(), nets.strict_float32():
        corr = nets.ncnet_volume(P, cfg, im1, im2)
    b, h1, w1, h2, w2 = corr.shape
    na, nb = h1 * w1, h2 * w2
    flat = corr.reshape(b, na, nb)
    res = {n: 0.0 for n in NCNET_NUMBERS}
    anchors = torch.cat([torch.arange(nb, device=dev), torch.arange(na, device=dev)])
    for p in range(b):
        g = torch.as_tensor(np.asarray(out["grid"][p]), dtype=torch.long, device=dev)
        bad = g.dim() != 2 or g.shape != (na + nb, 4)
        if not bad:
            a = g[:, 1] * w1 + g[:, 0]
            bcell = g[:, 3] * w2 + g[:, 2]
            inside = ((g >= 0).all(dim=1) & (g[:, 0] < w1) & (g[:, 1] < h1) & (g[:, 2] < w2)
                      & (g[:, 3] < h2))
            own = torch.cat([bcell[:nb], a[nb:]]) == anchors
            bad = int((~(inside & own)).sum())
        if bad:
            res["grid_malformed"] += int(bad)
            for name in NCNET_NUMBERS[1:]:
                res[name] = float("inf")
            continue
        m = torch.as_tensor(np.asarray(out["mutual"][p]), dtype=torch.bool, device=dev)
        pairs1 = set(zip(a[:nb][m[:nb]].tolist(), bcell[:nb][m[:nb]].tolist()))
        pairs2 = set(zip(a[nb:][m[nb:]].tolist(), bcell[nb:][m[nb:]].tolist()))
        res["mutual_unpaired"] += len(pairs1 ^ pairs2)
        if bool(m.any()):
            f = flat[p]
            best = torch.cat([f.amax(dim=0)[bcell[:nb]], f.amax(dim=1)[a[nb:]]])
            gap = (best - f[a, bcell]) / f.max().clamp_min(1e-30)
            res["pick_gap_mean"] = max(res["pick_gap_mean"], float(gap[m].mean()))
    return res
