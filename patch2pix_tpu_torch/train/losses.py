"""Epipolar-guided classification and regression losses.

Port of ``patch2pix_tpu.train.losses``: masked reductions over the
fixed ``(B, N)`` proposals of one training forward, with the
reference's semantics:

  * labels: mid positives = sampson(coarse, F) < cls_dthres[0], fine
    positives = sampson(mid, F) < cls_dthres[1];
  * class balance: positives weighted by neg_sum / pos_sum;
  * a pair with no mid or no fine positive contributes nothing; a pair
    with no epipolar inlier keeps its classification term but adds no
    epipolar term;
  * epi loss = emid_weight * mean(mdist[cdist < epi_dthres[0]])
             + efine_weight * mean(fdist[mdist < epi_dthres[1]]);
  * total = weight_cls * mean_pairs(cls) + mean_pairs(epi).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from patch2pix_tpu_torch.ops.geometry import sampson_dist_batched


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None) -> torch.Tensor:
    """Mean of ``x`` where ``mask``; 0 where the mask is empty."""
    mask = mask.to(x.dtype)
    s = torch.sum(x * mask) if dim is None else torch.sum(x * mask, dim=dim)
    c = torch.sum(mask) if dim is None else torch.sum(mask, dim=dim)
    return torch.where(c > 0, s / torch.clamp(c, min=1.0), torch.zeros_like(s))


def _bce(probs: torch.Tensor, labels: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Elementwise binary cross entropy on clipped probabilities."""
    p = torch.clamp(probs, eps, 1.0 - eps)
    return -(labels * torch.log(p) + (1.0 - labels) * torch.log1p(-p))


def patch2pix_losses(
    outputs: Dict[str, torch.Tensor],
    Fs: torch.Tensor,
    cls_dthres: Tuple[float, float] = (50.0, 5.0),
    epi_dthres: Tuple[float, float] = (50.0, 5.0),
    weight_cls: float = 10.0,
    weight_epi: Tuple[float, float] = (1.0, 1.0),
    pair_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The total loss and the metrics dict of a ``Patch2Pix.forward``
    output (``coarse``/``mid``/``fine`` ``(B, N, 4)``,
    ``mid_probs``/``fine_probs`` ``(B, N)``) under the ground-truth
    fundamental matrices ``Fs`` ``(B, 3, 3)``. ``weight_epi`` is
    (fine, mid). The metrics carry every key of the JAX package's dict
    (0-d float32 tensors).

    ``pair_sum``: where these pairs are one rank's rows of a global
    batch, a function summing a 1-D float32 tensor over the ranks (the
    sharded step's all-reduce). Every mean over pairs is then the
    global one: its numerator and its count are summed over the ranks
    in one call. The metrics are the global batch's, and the returned
    loss is this rank's SHARE of the global loss (its numerators over
    the global counts), so that the ranks' shares sum to it and their
    gradients add up to its gradient."""
    efine_w, emid_w = float(weight_epi[0]), float(weight_epi[1])

    cdist = sampson_dist_batched(outputs["coarse"], Fs)  # (B, N)
    mdist = sampson_dist_batched(outputs["mid"], Fs)
    fdist = sampson_dist_batched(outputs["fine"], Fs)

    mcls_pos = (cdist < cls_dthres[0]).float()
    fcls_pos = (mdist < cls_dthres[1]).float()
    mpos_sum = mcls_pos.sum(dim=1)  # (B,)
    fpos_sum = fcls_pos.sum(dim=1)
    n = float(cdist.shape[1])

    # a pair takes part only if it has both mid and fine positives
    pair_cls_valid = (mpos_sum > 0) & (fpos_sum > 0)

    def balanced_bce(probs, pos, pos_sum):
        neg = 1.0 - pos
        w = ((n - pos_sum) / torch.clamp(pos_sum, min=1.0))[:, None] * pos + neg
        return torch.mean(w * _bce(probs, pos), dim=1)

    mcls_lss = balanced_bce(outputs["mid_probs"], mcls_pos, mpos_sum)
    fcls_lss = balanced_bce(outputs["fine_probs"], fcls_pos, fpos_sum)
    cls_pair = mcls_lss + fcls_lss

    mids = cdist < epi_dthres[0]
    fids = mdist < epi_dthres[1]
    epi_mid = _masked_mean(mdist, mids, dim=1)
    epi_fine = _masked_mean(fdist, fids, dim=1)
    pair_epi_valid = pair_cls_valid & (mids.any(dim=1) | fids.any(dim=1))
    epi_pair = emid_w * epi_mid + efine_w * epi_fine

    with torch.no_grad():
        mpred = (outputs["mid_probs"] > 0.5).float()
        fpred = (outputs["fine_probs"] > 0.5).float()
        mid_epi_mask = pair_epi_valid & mids.any(dim=1)
        fine_epi_mask = pair_epi_valid & fids.any(dim=1)
        every = torch.ones_like(mpos_sum, dtype=torch.bool)
        # the means over pairs: name -> (per-pair value, pair mask)
        means = {
            "loss/cls_mid": (mcls_lss, pair_cls_valid),
            "loss/cls_fine": (fcls_lss, pair_cls_valid),
            "loss/epi_mid": (epi_mid, mid_epi_mask),
            "loss/epi_fine": (epi_fine, fine_epi_mask),
            "cls_ratios/mpos_gt": (mpos_sum / n, every),
            "cls_ratios/fpos_gt": (fpos_sum / n, every),
            "cls_ratios/mpos_pred": (mpred.sum(dim=1) / n, every),
            "cls_ratios/fpos_pred": (fpred.sum(dim=1) / n, every),
            # a pair skips at either gate: no cls positives or no epi inliers
            "skipped": ((~pair_epi_valid).float(), None),
            # distances over GT-thresholded (*_gt) and predicted-positive
            # (*_pred) sets
            "match_dist/cmid_gt": (_masked_mean(cdist, mids, 1), mid_epi_mask),
            "match_dist/mmid_gt": (epi_mid, mid_epi_mask),
            "match_dist/mfid_gt": (_masked_mean(mdist, fids, 1), fine_epi_mask),
            "match_dist/ffid_gt": (epi_fine, fine_epi_mask),
            "match_dist/cmid_pred": (_masked_mean(cdist, mpred, 1), pair_cls_valid),
            "match_dist/mmid_pred": (_masked_mean(mdist, mpred, 1), pair_cls_valid),
            "match_dist/mfid_pred": (_masked_mean(mdist, fpred, 1), pair_cls_valid),
            "match_dist/ffid_pred": (_masked_mean(fdist, fpred, 1), pair_cls_valid),
        }
        # per-pair rec/prec/spec/acc/f1 over the pairs past the cls gate
        for tag, pred, gt, pos_sum in (("cls_mid", mpred, mcls_pos, mpos_sum),
                                       ("cls_fine", fpred, fcls_pos, fpos_sum)):
            tp = torch.sum(pred * gt, dim=1)
            tn = torch.sum((1.0 - pred) * (1.0 - gt), dim=1)
            ppred = torch.sum(pred, dim=1)
            ngt = n - pos_sum
            rec = torch.where(pos_sum > 0, tp / torch.clamp(pos_sum, min=1.0),
                              (ppred == 0).float())
            spec = torch.where(ngt > 0, tn / torch.clamp(ngt, min=1.0), (ppred == n).float())
            prec = torch.where(ppred > 0, tp / torch.clamp(ppred, min=1.0),
                               torch.zeros_like(tp))
            acc = torch.mean((pred == gt).float(), dim=1)
            f1 = torch.where(prec + rec > 0,
                             2.0 * prec * rec / torch.clamp(prec + rec, min=1e-12),
                             torch.zeros_like(prec))
            for name, v in (("rec", rec), ("prec", prec), ("spec", spec), ("acc", acc),
                            ("f1", f1)):
                means[f"{tag}/{name}"] = (v, pair_cls_valid)

    # the loss terms' numerators keep their gradient; every count is a
    # constant
    cls_num = torch.sum(cls_pair * pair_cls_valid.to(cls_pair.dtype))
    epi_num = torch.sum(epi_pair * pair_epi_valid.to(epi_pair.dtype))
    with torch.no_grad():
        nums = [cls_num.detach(), epi_num.detach()]
        counts = [pair_cls_valid.float().sum(), pair_epi_valid.float().sum()]
        for v, mask in means.values():
            m = torch.ones_like(v) if mask is None else mask.to(v.dtype)
            nums.append(torch.sum(v * m))
            counts.append(torch.sum(m))
        sums = torch.cat([torch.stack(nums), torch.stack(counts)])
        if pair_sum is not None:
            sums = pair_sum(sums)
        gnum, gcnt = sums.split(len(nums))

    def ratio(num, cnt):
        return torch.where(cnt > 0, num / torch.clamp(cnt, min=1.0), torch.zeros_like(num))

    loss = weight_cls * ratio(cls_num, gcnt[0]) + ratio(epi_num, gcnt[1])
    with torch.no_grad():
        metrics = {"loss/pair": weight_cls * ratio(gnum[0], gcnt[0]) + ratio(gnum[1], gcnt[1])}
        for i, (name, (_, mask)) in enumerate(means.items(), start=2):
            metrics[name] = gnum[i] if mask is None else ratio(gnum[i], gcnt[i])
    return loss, metrics
