"""NCNet weak-supervision pretraining of the neighbourhood consensus.

Port of ``patch2pix_tpu.train.ncn_pretrain``: maximise the mean matching
score on matching pairs and minimise it on non-matching ones,

    L = mean_s(src, neg) - mean_s(src, pos),
    mean_s = the mean over both matching directions of each cell's
             max softmax score of the filtered correlation,

with Adam over the NCN's parameters only. The loss reaches them through
the NCN's fold-out shift-add (B1's backward). The backbone stays frozen
(``requires_grad=False``), so autograd stops at the correlation and B2's
backward does not run on this path.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from patch2pix_tpu_torch.ops.match_extract import corr_to_matches


def mean_match_score(model, im1, im2, ksize: int = 1) -> torch.Tensor:
    """Mean of both directions' per-cell max softmax scores."""
    feat1, feat2 = model.extract(im1), model.extract(im2)
    corr, delta4d = model.coarse_corr(feat1, feat2, ksize)
    _, scores, _ = corr_to_matches(corr, delta4d, ksize=ksize)
    return torch.mean(scores)


def ncn_weak_loss(model, batch: Dict[str, torch.Tensor],
                  ksize: int = 1) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: ``im_src`` / ``im_pos`` / ``im_neg``, each ``(B, H, W, 3)``."""
    s_pos = mean_match_score(model, batch["im_src"], batch["im_pos"], ksize)
    s_neg = mean_match_score(model, batch["im_src"], batch["im_neg"], ksize)
    loss = s_neg - s_pos
    return loss, {"loss/nc": loss.detach(), "score/pos": s_pos.detach(),
                  "score/neg": s_neg.detach()}


def make_ncn_pretrain_step(model, lr: float = 5e-4, ksize: int = 1):
    """Returns ``(step, init_opt)``: ``init_opt()`` freezes every
    parameter outside the NCN and builds Adam over the NCN's; ``step(opt,
    batch) -> metrics`` takes one update of ``model`` in place."""

    def init_opt() -> torch.optim.Adam:
        params = []
        for name, p in model.named_parameters():
            trainable = name.split(".")[0] == "ncn"
            p.requires_grad_(trainable)
            if trainable:
                params.append(p)
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def step(opt: torch.optim.Adam, batch) -> Dict[str, torch.Tensor]:
        loss, metrics = ncn_weak_loss(model, batch, ksize)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return metrics

    return step, init_opt
