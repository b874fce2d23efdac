"""Model operations per call of NCNet's InLoc model (ResNet101 to
layer3, relocalisation, the NCN), counted from shapes as
:mod:`benchmark.flops` counts them: every convolution, correlation and
product at 2 operations a multiply-add; pools, BatchNorm, ReLU, mutual
matching and extraction left out."""

from __future__ import annotations

from typing import Tuple

from benchmark.flops import _out, conv_flops, ncn_flops
from benchmark.reference.ncnet_r101 import EXPANSION, RESNET101_STAGES


def resnet101_layer3_flops(h: int, w: int) -> Tuple[float, int, int]:
    """One image through ResNet101 to layer3 (the stride on each stage's
    first 3x3 conv). Returns (operations, layer3 h, layer3 w)."""
    total, h, w = conv_flops(h, w, 3, 64, 7, 2, 3)
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)  # max-pool
    cin = 64
    for li, (c, n) in enumerate(RESNET101_STAGES[:3]):
        for bi in range(n):
            s = 2 if bi == 0 and li > 0 else 1
            total += conv_flops(h, w, cin, c, 1)[0]
            f, ho, wo = conv_flops(h, w, c, c, 3, s, 1)
            total += f + conv_flops(ho, wo, c, c * EXPANSION, 1)[0]
            if bi == 0:
                total += conv_flops(h, w, cin, c * EXPANSION, 1, s, 0)[0]
            h, w, cin = ho, wo, c * EXPANSION
    return total, h, w


def ncnet_r101_match_flops(cfg, batch: int, h: int, w: int) -> float:
    """One ImMatchNet call: the trunk on both images, the correlation of
    layer3 (before its k^4 pool), the NCN on the pooled volume."""
    bb, fh, fw = resnet101_layer3_flops(h, w)
    k = cfg["relocalization_k_size"]
    cells = batch * ((fh // k) * (fw // k)) ** 2
    return (2 * batch * bb + 2.0 * batch * (fh * fw) ** 2 * 1024
            + ncn_flops(cells, cfg["ncn_kernel_sizes"], cfg["ncn_channels"]))
