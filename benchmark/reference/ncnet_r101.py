"""Plain float32 reference of NCNet's InLoc model (``ncnet_ivd``).

Written from the published model (Rocco et al., Neighbourhood Consensus
Networks, NeurIPS 2018; ignacio-rocco/ncnet ``lib/model.py`` with
``eval_inloc.py``'s settings), NCHW, with ``torch.nn.functional`` alone
and the layers of :mod:`benchmark.reference.nets`: nothing of the
program under test. Parameter names are torchvision's ResNet101 under
``extract.*`` and NCNet's ``NeighConsensus.conv.{0,2,4}``, so one state
dict feeds both the program and this reference.

The model:

* ResNet101 to layer3 (1024 channels at stride 16), every BatchNorm on
  its stored statistics, then L2 normalisation over the channels;
* the correlation of the two maps (the pre-pool volume);
* a 2^4 max-pool of it whose within-window offsets are the row-major
  first maximum of each window (relocalisation, ``k_size`` 2);
* mutual matching, the symmetric NCN (``nets.neigh_consensus``), mutual
  matching;
* extraction in both directions: per target cell the best source cell,
  then per source cell the best target cell, softmax scores, mutual
  flags, each pick relocated to the pre-pool grid by the offsets of its
  pooled cell.

Departures from NCNet's code:

* float32 throughout, with TF32 off (:func:`nets.strict_float32`, set by
  the callers); NCNet's ``half_precision`` runs in float16, the program
  under test in bfloat16;
* NCNet's ``maxpool4d`` takes ``torch.max`` over the flattened window,
  which promises no tie order; here the first maximum in row-major (di,
  dj, dk, dl) order wins;
* NCNet relocates the matches and rescales them to [-1, 1] image
  coordinates; here they stay cells of the pre-pool grid (stride 16),
  the program's output;
* seeded weights: no checkpoint is used.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import nets
from benchmark.reference.nets import F32

RESNET101_STAGES = ((64, 3), (128, 4), (256, 23), (512, 3))
EXPANSION = 4


def resnet101_shapes(prefix: str = "extract") -> Dict[str, tuple]:
    """torchvision ResNet101's convolution and BatchNorm entries (no fc),
    layer4 included: the published checkpoints hold it."""
    s = {f"{prefix}.conv1.weight": (64, 3, 7, 7), **nets._bn_shapes(f"{prefix}.bn1", 64)}
    cin = 64
    for li, (c, n) in enumerate(RESNET101_STAGES):
        for bi in range(n):
            p = f"{prefix}.layer{li + 1}.{bi}"
            s[f"{p}.conv1.weight"] = (c, cin, 1, 1)
            s.update(nets._bn_shapes(f"{p}.bn1", c))
            s[f"{p}.conv2.weight"] = (c, c, 3, 3)
            s.update(nets._bn_shapes(f"{p}.bn2", c))
            s[f"{p}.conv3.weight"] = (c * EXPANSION, c, 1, 1)
            s.update(nets._bn_shapes(f"{p}.bn3", c * EXPANSION))
            if bi == 0:
                s[f"{p}.downsample.0.weight"] = (c * EXPANSION, cin, 1, 1)
                s.update(nets._bn_shapes(f"{p}.downsample.1", c * EXPANSION))
            cin = c * EXPANSION
    return s


def ncnet_r101_shapes(cfg) -> Dict[str, tuple]:
    s = resnet101_shapes("extract")
    s.update(nets.ncn_shapes("NeighConsensus", cfg["ncn_kernel_sizes"], cfg["ncn_channels"]))
    return s


def resnet101_layer3(P, x, prec=F32, prefix: str = "extract"):
    """NCHW images -> layer3 (B, 1024, H/16, W/16). The stride of a
    bottleneck sits on its 3x3 conv (torchvision)."""
    y = torch.relu(nets.batchnorm(nets.conv(x, P[f"{prefix}.conv1.weight"], None, 2, 3, prec),
                                  P, f"{prefix}.bn1"))
    y = F.max_pool2d(y, 3, 2, 1)
    for li, (_, n) in enumerate(RESNET101_STAGES[:3]):
        for bi in range(n):
            p = f"{prefix}.layer{li + 1}.{bi}"
            s = 2 if bi == 0 and li > 0 else 1
            out = torch.relu(nets.batchnorm(nets.conv(y, P[f"{p}.conv1.weight"], None, 1, 0,
                                                      prec), P, f"{p}.bn1"))
            out = torch.relu(nets.batchnorm(nets.conv(out, P[f"{p}.conv2.weight"], None, s, 1,
                                                      prec), P, f"{p}.bn2"))
            out = nets.batchnorm(nets.conv(out, P[f"{p}.conv3.weight"], None, 1, 0, prec),
                                 P, f"{p}.bn3")
            if bi == 0:
                y = nets.batchnorm(nets.conv(y, P[f"{p}.downsample.0.weight"], None, s, 0, prec),
                                   P, f"{p}.downsample.1")
            y = torch.relu(out + y)
    return y


def maxpool4d_offsets(pre, k: int):
    """(B, h1, w1, h2, w2) -> (pooled, offsets (B, h1/k, w1/k, h2/k, w2/k,
    4) int64 (di, dj, dk, dl)): each window's maximum and the row-major
    first position of it."""
    b, h1, w1, h2, w2 = pre.shape
    win = pre.reshape(b, h1 // k, k, w1 // k, k, h2 // k, k, w2 // k, k)
    win = win.permute(0, 1, 3, 5, 7, 2, 4, 6, 8).reshape(b, h1 // k, w1 // k, h2 // k, w2 // k,
                                                         k ** 4)
    pooled = win.amax(dim=-1)
    arg = torch.argmax(win, dim=-1)  # the first maximum (max's index need not be)
    offsets = torch.stack([arg // k ** 3, arg // k ** 2 % k, arg // k % k, arg % k], dim=-1)
    return pooled, offsets


def volumes(P, cfg, im1, im2, prec=F32, ncn_prec=None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """NHWC images -> (pre-pool correlation, pooled offsets, filtered
    pooled volume). ``ncn_prec``: the NCN's own precision, if it is not
    ``prec`` (the NCN alone in float8 is a control of its own)."""
    f1 = nets.l2_normalize(resnet101_layer3(P, nets.nhwc_to_nchw(im1), prec))
    f2 = nets.l2_normalize(resnet101_layer3(P, nets.nhwc_to_nchw(im2), prec))
    pre = nets.correlation(f1, f2, prec)
    del f1, f2
    pooled, offsets = maxpool4d_offsets(pre, cfg["relocalization_k_size"])
    corr = prec(nets.mutual_matching(pooled))
    del pooled
    corr = prec(nets.mutual_matching(nets.neigh_consensus(
        P, corr, "NeighConsensus", len(cfg["ncn_channels"]), ncn_prec or prec)))
    return pre, offsets, corr


def extract(corr, offsets, k: int) -> Dict[str, torch.Tensor]:
    """Both directions' picks of the filtered pooled volume, relocated:
    grid (B, h2*w2 + h1*w1, 4) (xA, yA, xB, yB) on the pre-pool grid,
    softmax scores, mutual flags."""
    b, h1, w1, h2, w2 = corr.shape
    na, nb = h1 * w1, h2 * w2
    flat = corr.reshape(b, na, nb)
    arg1, arg2 = torch.argmax(flat, dim=1), torch.argmax(flat, dim=2)
    s1 = torch.exp(flat.amax(dim=1) - torch.logsumexp(flat, dim=1))
    s2 = torch.exp(flat.amax(dim=2) - torch.logsumexp(flat, dim=2))
    ids_a = torch.arange(na, device=corr.device)[None].expand(b, na)
    ids_b = torch.arange(nb, device=corr.device)[None].expand(b, nb)
    m1 = torch.gather(arg2, 1, arg1) == ids_b
    m2 = torch.gather(arg1, 1, arg2) == ids_a
    a = torch.cat([arg1, ids_a], dim=1)
    bb = torch.cat([ids_b, arg2], dim=1)
    d = offsets.reshape(b, na * nb, 4)
    d = torch.gather(d, 1, (a * nb + bb)[..., None].expand(-1, -1, 4))
    grid = torch.stack([(a % w1) * k + d[..., 1], (a // w1) * k + d[..., 0],
                        (bb % w2) * k + d[..., 3], (bb // w2) * k + d[..., 2]], dim=-1)
    return {"grid": grid, "scores": torch.cat([s1, s2], dim=1),
            "mutual": torch.cat([m1, m2], dim=1)}


def predict(P, cfg, im1, im2, prec=F32, ncn_prec=None) -> Dict[str, torch.Tensor]:
    """The model's matches: ImMatchNet's volume, then ``corr_to_matches``
    relocated by ``k_size``."""
    _, offsets, corr = volumes(P, cfg, im1, im2, prec, ncn_prec)
    return extract(corr, offsets, cfg["relocalization_k_size"])
