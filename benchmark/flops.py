"""Model operations per call, counted from shapes: every
convolution, correlation and product the published model computes, at 2
operations a multiply-add. Elementwise work (BatchNorm, ReLU, mutual
matching, softmax, gathers) is left out: it is a few percent at most and
no tensor core runs it. The count is the model's, whatever implements
it, so a program that skips work reads a lower share, never a higher.
"""

from __future__ import annotations

from typing import Dict, Tuple

from benchmark.reference.nets import feat_dim


def _out(side: int, k: int, s: int, p: int) -> int:
    return (side + 2 * p - k) // s + 1


def conv_flops(h: int, w: int, cin: int, cout: int, k: int, s: int = 1,
               p: int = 0) -> Tuple[float, int, int]:
    """(operations, out h, out w) of one image's 2D convolution."""
    ho, wo = _out(h, k, s, p), _out(w, k, s, p)
    return 2.0 * ho * wo * cin * cout * k * k, ho, wo


def resnet34_flops(h: int, w: int, change_stride: bool) -> Tuple[float, int, int]:
    """One image through ResNet34 to layer3 (layer3 at stride 1 with
    ``change_stride``). Returns (operations, layer3 h, layer3 w)."""
    total, h, w = conv_flops(h, w, 3, 64, 7, 2, 3)
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)  # max-pool
    cin = 64
    for li, (c, n) in enumerate(zip((64, 128, 256), (3, 4, 6))):
        stride = 1 if li == 0 or (li == 2 and change_stride) else 2
        for bi in range(n):
            s = stride if bi == 0 else 1
            f, ho, wo = conv_flops(h, w, cin, c, 3, s, 1)
            total += f
            total += conv_flops(ho, wo, c, c, 3, 1, 1)[0]
            if bi == 0 and li > 0:
                total += conv_flops(h, w, cin, c, 1, s, 0)[0]
            h, w, cin = ho, wo, c
    return total, h, w


def vgg16_pool4_flops(h: int, w: int) -> Tuple[float, int, int]:
    """One image through VGG16 to pool4."""
    total, cin = 0.0, 3
    for block in ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512)):
        for c in block:
            total += conv_flops(h, w, cin, c, 3, 1, 1)[0]
            cin = c
        h, w = h // 2, w // 2
    return total, h, w


def ncn_flops(cells: int, kernel_sizes, channels, symmetric: bool = True) -> float:
    """The NCN's 4D convolutions over ``cells`` volume cells."""
    total, cin = 0.0, 1
    for k, c in zip(kernel_sizes, channels):
        total += 2.0 * cells * cin * c * k ** 4
        cin = c
    return total * (2 if symmetric else 1)


def regressor_flops(rows: int, feat_dim: int, r: Dict) -> float:
    """One regression stage over ``rows`` proposals: the convolutions
    (the first over both sides' hypercolumns) and the fcs."""
    p = r["psize"][0]
    h = w = p
    cin = 2 * feat_dim
    total = 0.0
    for c, k, s in zip(r["conv_dims"], r["conv_kers"], r["conv_strs"]):
        f, h, w = conv_flops(h, w, cin, c, k, s, k // 2)
        total += f
        cin = c
    for c in list(r["fc_dims"]) + [5]:
        total += 2.0 * cin * c
        cin = c
    return rows * total


def p2p_coarse_flops(cfg, batch: int, h: int, w: int) -> Dict[str, float]:
    """Backbone on both images of ``batch`` pairs, the correlation of
    layer3 (before its ksize^4 pool) and the NCN on the pooled volume."""
    bb, fh, fw = resnet34_flops(h, w, cfg["change_stride"])
    k = cfg["ksize"]
    cells = batch * ((fh // k) * (fw // k)) ** 2
    return {"backbone": 2 * batch * bb,
            "correlation": 2.0 * batch * (fh * fw) ** 2 * 256,
            "ncn": ncn_flops(cells, cfg["ncn_kernel_sizes"], cfg["ncn_channels"])}


def p2p_match_flops(cfg, batch: int, h: int, w: int, fine_cap: int) -> float:
    """One ``predict_fine`` call: the coarse stage, then both regression
    stages over ``batch * fine_cap`` rows (every capped row runs, valid
    or not)."""
    reg = regressor_flops(batch * fine_cap, feat_dim(cfg), cfg["regressor"])
    return sum(p2p_coarse_flops(cfg, batch, h, w).values()) + 2 * reg


def ncnet_match_flops(cfg, batch: int, h: int, w: int) -> float:
    """One ImMatchNet call: VGG16 to pool4 on both images, the
    correlation, the NCN."""
    bb, fh, fw = vgg16_pool4_flops(h, w)
    cells = batch * (fh * fw) ** 2
    return (2 * batch * bb + 2.0 * batch * (fh * fw) ** 2 * 512
            + ncn_flops(cells, cfg["ncn_kernel_sizes"], cfg["ncn_channels"]))
