"""Plain float32 PyTorch references of the benchmarked models.

Written from the published architectures (Patch2Pix, GrumpyZhou/patch2pix
``networks/``; NCNet, ignacio-rocco/ncnet ``lib/model.py``), NCHW, with
``torch.nn.functional`` alone: no kernel, layout trick or folding of the
program under test, and nothing imported from it. The parameter names
are the published checkpoints' names, so one state dict made by the
benchmark feeds both the program and this reference.

``Precision`` says how a contraction's operands, and the volumes and
outputs the models store, are rounded: float32 (the reference proper),
bfloat16 (a yardstick of the configurations' own precision: bfloat16
activations), or float8 e4m3 with one scale per tensor (the control:
float8 activations, one precision below the configurations' bfloat16).
Callers set ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False (:func:`strict_float32`).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3 value
BN_EPS = 1e-5
L2_EPS = 1e-6
MUTUAL_EPS = 1e-5


class Precision:
    """Rounding applied to each operand of a convolution or product and
    to each correlation volume and model output as it is stored:
    ``float32`` leaves it, ``bfloat16`` rounds it to bfloat16 (a
    yardstick of the configurations' own precision), ``fp8`` to float8
    e4m3 scaled by the tensor's largest magnitude (per-tensor scaling, as
    fp8 inference runs)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "bfloat16", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return x
        if self.name == "bfloat16":
            return x.to(torch.bfloat16).to(torch.float32)
        scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


F32 = Precision("float32")


@contextlib.contextmanager
def strict_float32():
    """TF32 off for cuBLAS and cuDNN inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


# ---------------------------------------------------------------- shapes


def _bn_shapes(prefix: str, c: int) -> Dict[str, tuple]:
    return {f"{prefix}.weight": (c,), f"{prefix}.bias": (c,),
            f"{prefix}.running_mean": (c,), f"{prefix}.running_var": (c,),
            f"{prefix}.num_batches_tracked": ()}


def resnet34_shapes(prefix: str = "extract") -> Dict[str, tuple]:
    """torchvision ResNet34's convolution and BatchNorm entries (no fc),
    layer4 included: the published checkpoints hold it."""
    s = {f"{prefix}.conv1.weight": (64, 3, 7, 7), **_bn_shapes(f"{prefix}.bn1", 64)}
    cin = 64
    for li, (c, n) in enumerate(zip((64, 128, 256, 512), (3, 4, 6, 3))):
        for bi in range(n):
            p = f"{prefix}.layer{li + 1}.{bi}"
            s[f"{p}.conv1.weight"] = (c, cin, 3, 3)
            s.update(_bn_shapes(f"{p}.bn1", c))
            s[f"{p}.conv2.weight"] = (c, c, 3, 3)
            s.update(_bn_shapes(f"{p}.bn2", c))
            if bi == 0 and li > 0:
                s[f"{p}.downsample.0.weight"] = (c, cin, 1, 1)
                s.update(_bn_shapes(f"{p}.downsample.1", c))
            cin = c
    return s


def ncn_shapes(prefix: str, kernel_sizes: Sequence[int], channels: Sequence[int]):
    """NCNet's Conv4d layers, stored pre-permuted ``(k1, out, in, k2, k3,
    k4)`` at ``{prefix}.conv.{2i}``."""
    s, cin = {}, 1
    for i, (k, c) in enumerate(zip(kernel_sizes, channels)):
        s[f"{prefix}.conv.{2 * i}.weight"] = (k, c, cin, k, k, k)
        s[f"{prefix}.conv.{2 * i}.bias"] = (c,)
        cin = c
    return s


def regressor_shapes(prefix: str, feat_dim: int, conv_dims, conv_kers, fc_dims,
                     out_dim: int = 5):
    """Patch2Pix's ``FeatRegressNet`` ('pre' feature combination):
    ``conv.{0,2}`` convs without bias, ``conv.{1,3}`` BatchNorm2d,
    ``fc.{0,3}`` Linear, ``fc.{1,4}`` BatchNorm1d, ``fc.6`` the output."""
    s, cin = {}, 2 * feat_dim
    for i, (c, k) in enumerate(zip(conv_dims, conv_kers)):
        s[f"{prefix}.conv.{2 * i}.weight"] = (c, cin, k, k)
        s.update(_bn_shapes(f"{prefix}.conv.{2 * i + 1}", c))
        cin = c
    for i, c in enumerate(fc_dims):
        s[f"{prefix}.fc.{3 * i}.weight"] = (c, cin)
        s[f"{prefix}.fc.{3 * i}.bias"] = (c,)
        s.update(_bn_shapes(f"{prefix}.fc.{3 * i + 1}", c))
        cin = c
    s[f"{prefix}.fc.{3 * len(fc_dims)}.weight"] = (out_dim, cin)
    s[f"{prefix}.fc.{3 * len(fc_dims)}.bias"] = (out_dim,)
    return s


def patch2pix_shapes(cfg) -> Dict[str, tuple]:
    r = cfg["regressor"]
    s = resnet34_shapes("extract")
    s.update(ncn_shapes("ncn", cfg["ncn_kernel_sizes"], cfg["ncn_channels"]))
    for stage in ("regress_mid", "regress_fine"):
        s.update(regressor_shapes(stage, feat_dim(cfg), r["conv_dims"], r["conv_kers"],
                                  r["fc_dims"]))
    return s


VGG16_POOL4 = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512))


def vgg16_pool4_indices() -> List[Tuple[int, int, int]]:
    """(torchvision ``features`` index, in, out) of each conv up to pool4."""
    out, idx, cin = [], 0, 3
    for block in VGG16_POOL4:
        for c in block:
            out.append((idx, cin, c))
            idx += 2  # conv, relu
            cin = c
        idx += 1  # pool
    return out


def ncnet_shapes(cfg) -> Dict[str, tuple]:
    s = {}
    for idx, cin, c in vgg16_pool4_indices():
        s[f"FeatureExtraction.model.{idx}.weight"] = (c, cin, 3, 3)
        s[f"FeatureExtraction.model.{idx}.bias"] = (c,)
    s.update(ncn_shapes("NeighConsensus", cfg["ncn_kernel_sizes"], cfg["ncn_channels"]))
    return s


def feat_dim(cfg) -> int:
    """Hypercolumn channels of one side: the pyramid levels in feat_idx."""
    dims = (3, 64, 64, 128, 256)
    return sum(dims[i] for i in cfg["feat_idx"])


# --------------------------------------------------------------- layers


def conv(x, w, b=None, stride=1, padding=0, prec=F32):
    return F.conv2d(prec(x), prec(w), b, stride=stride, padding=padding)


def batchnorm(x, P, prefix):
    """Eval BatchNorm on the running averages, over dim 1."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    inv = torch.rsqrt(P[f"{prefix}.running_var"] + BN_EPS) * P[f"{prefix}.weight"]
    return ((x - P[f"{prefix}.running_mean"].reshape(shape)) * inv.reshape(shape)
            + P[f"{prefix}.bias"].reshape(shape))


def resnet34_pyramid(P, x, change_stride: bool, prec=F32, prefix="extract"):
    """NCHW images -> [image, conv1, layer1, layer2, layer3]."""
    feats = [x]
    y = torch.relu(batchnorm(conv(x, P[f"{prefix}.conv1.weight"], None, 2, 3, prec),
                             P, f"{prefix}.bn1"))
    feats.append(y)
    y = F.max_pool2d(y, 3, 2, 1)
    for li, (n, stride) in enumerate(zip((3, 4, 6), (1, 2, 2))):
        if li == 2 and change_stride:
            stride = 1
        for bi in range(n):
            p = f"{prefix}.layer{li + 1}.{bi}"
            s = stride if bi == 0 else 1
            out = torch.relu(batchnorm(conv(y, P[f"{p}.conv1.weight"], None, s, 1, prec),
                                       P, f"{p}.bn1"))
            out = batchnorm(conv(out, P[f"{p}.conv2.weight"], None, 1, 1, prec), P, f"{p}.bn2")
            if f"{p}.downsample.0.weight" in P:
                y = batchnorm(conv(y, P[f"{p}.downsample.0.weight"], None, s, 0, prec),
                              P, f"{p}.downsample.1")
            y = torch.relu(out + y)
        feats.append(y)
    return feats


def vgg16_pool4(P, x, prec=F32, prefix="FeatureExtraction.model"):
    y = x
    convs = iter(vgg16_pool4_indices())
    for block in VGG16_POOL4:
        for _ in block:
            idx, _, _ = next(convs)
            y = torch.relu(conv(y, P[f"{prefix}.{idx}.weight"], P[f"{prefix}.{idx}.bias"],
                                1, 1, prec))
        y = F.max_pool2d(y, 2, 2)
    return y


def l2_normalize(f, dim=1):
    return f * torch.rsqrt((f * f).sum(dim, keepdim=True) + L2_EPS)


def correlation(f1, f2, prec=F32):
    """NCHW features -> (B, h1, w1, h2, w2) dot products."""
    b, c, h1, w1 = f1.shape
    h2, w2 = f2.shape[2:]
    a = prec(f1).reshape(b, c, h1 * w1).transpose(1, 2)
    m = prec(f2).reshape(b, c, h2 * w2)
    return prec(torch.bmm(a, m)).reshape(b, h1, w1, h2, w2)


def maxpool4d(corr, k: int):
    b, h1, w1, h2, w2 = corr.shape
    return corr.reshape(b, h1 // k, k, w1 // k, k, h2 // k, k, w2 // k, k).amax(dim=(2, 4, 6, 8))


def mutual_matching(corr):
    b = corr.shape[0]
    flat = corr.reshape(b, corr.shape[1] * corr.shape[2], -1)
    max_a = flat.amax(dim=1, keepdim=True)
    max_b = flat.amax(dim=2, keepdim=True)
    return (flat * (flat / (max_a + MUTUAL_EPS)) * (flat / (max_b + MUTUAL_EPS))).reshape(
        corr.shape)


def conv4d(x, w, b, prec=F32):
    """NCNet's Conv4d: x ``(B, Cin, h1, w1, h2, w2)``, w ``(k1, Cout,
    Cin, k2, k3, k4)``: one conv3d over (w1, h2, w2) per h1 tap, SAME
    zero padding."""
    bs, cin, h1, w1, h2, w2 = x.shape
    k = w.shape[0]
    p = k // 2
    xp = F.pad(prec(x), (0, 0, 0, 0, 0, 0, p, p))
    wq = prec(w)
    out = None
    for t in range(k):
        xs = xp[:, :, t:t + h1].permute(0, 2, 1, 3, 4, 5).reshape(bs * h1, cin, w1, h2, w2)
        y = F.conv3d(xs, wq[t], padding=p)
        out = y if out is None else out + y
    out = prec(out + b[None, :, None, None, None])
    return out.reshape(bs, h1, -1, w1, h2, w2).permute(0, 2, 1, 3, 4, 5)


def neigh_consensus(P, corr, prefix: str, n_layers: int, prec=F32):
    """Symmetric NCN: the stack on the volume plus the stack on its A<->B
    transpose, transposed back."""

    def stack(x):
        for i in range(n_layers):
            x = torch.relu(conv4d(x, P[f"{prefix}.conv.{2 * i}.weight"],
                                  P[f"{prefix}.conv.{2 * i}.bias"], prec))
        return x

    x = corr[:, None]
    xt = x.permute(0, 1, 4, 5, 2, 3)
    y = prec(stack(x) + stack(xt).permute(0, 1, 4, 5, 2, 3))
    return y[:, 0]


# ------------------------------------------------------------ regressor


def hypercolumn_patches(pyramid, points, feat_idx, psize: int):
    """NCHW pyramid, (B, N, 2) float (x, y) points -> (B*N, D, p, p)
    patches centred on the truncated points, each level sampled at
    ``clip((corner + d) // ds, 0, side - 1)``, L2-normalised over D."""
    b, n, _ = points.shape
    x0 = points[..., 0].to(torch.int64) - psize // 2
    y0 = points[..., 1].to(torch.int64) - psize // 2
    d = torch.arange(psize, device=points.device)
    levels = []
    for j in feat_idx:
        fmap = pyramid[j]
        _, c, h, w = fmap.shape
        ds = pyramid[0].shape[2] // h
        iy = torch.clamp(torch.div(y0[..., None] + d, ds, rounding_mode="floor"), 0, h - 1)
        ix = torch.clamp(torch.div(x0[..., None] + d, ds, rounding_mode="floor"), 0, w - 1)
        bi = torch.arange(b, device=points.device)[:, None, None, None]
        g = fmap.permute(0, 2, 3, 1)[bi, iy[:, :, :, None], ix[:, :, None, :]]
        levels.append(g)  # (B, N, p, p, C)
    hyper = torch.cat(levels, dim=-1)
    hyper = l2_normalize(hyper, dim=-1)
    return hyper.reshape(b * n, psize, psize, -1).permute(0, 3, 1, 2)


def regress(P, prefix, pyr1, pyr2, coords, cfg, prec=F32):
    """One regression stage at ``coords`` (B, N, 4): (refined coords,
    confidences), each offset ``psize * tanh(relu(o)) - psize / 2``,
    clamped to the image, inclusive."""
    r = cfg["regressor"]
    psize = r["psize"][0 if prefix.endswith("mid") else 1]
    b, n, _ = coords.shape
    x = torch.cat([hypercolumn_patches(pyr1, coords[..., 0:2], cfg["feat_idx"], psize),
                   hypercolumn_patches(pyr2, coords[..., 2:4], cfg["feat_idx"], psize)], dim=1)
    for i, s in enumerate(r["conv_strs"]):
        x = conv(x, P[f"{prefix}.conv.{2 * i}.weight"], None, s, r["conv_kers"][i] // 2, prec)
        x = batchnorm(x, P, f"{prefix}.conv.{2 * i + 1}")
    x = torch.relu(x).amax(dim=(2, 3))
    nfc = len(r["fc_dims"])
    for i in range(nfc):
        x = F.linear(prec(x), prec(P[f"{prefix}.fc.{3 * i}.weight"]), P[f"{prefix}.fc.{3 * i}.bias"])
        x = torch.relu(batchnorm(x, P, f"{prefix}.fc.{3 * i + 1}"))
    out = prec(F.linear(prec(x), prec(P[f"{prefix}.fc.{3 * nfc}.weight"]),
                        P[f"{prefix}.fc.{3 * nfc}.bias"])).reshape(b, n, 5)
    h1, w1 = pyr1[0].shape[2:]
    h2, w2 = pyr2[0].shape[2:]
    offset = psize * torch.tanh(torch.relu(out[..., :4])) - psize // 2
    lims = torch.tensor([w1, h1, w2, h2], dtype=torch.float32, device=coords.device)
    matches = torch.minimum(torch.clamp(coords + offset, min=0.0), lims)
    return matches, torch.sigmoid(out[..., 4])


# -------------------------------------------------------- whole models


def nhwc_to_nchw(im):
    return im.permute(0, 3, 1, 2).contiguous()


def patch2pix_volume(P, cfg, im1, im2, prec=F32):
    """NHWC images -> (pyramid1, pyramid2, pre-pool correlation, filtered
    pooled volume)."""
    x1, x2 = nhwc_to_nchw(im1), nhwc_to_nchw(im2)
    pyr1 = resnet34_pyramid(P, x1, cfg["change_stride"], prec)
    pyr2 = resnet34_pyramid(P, x2, cfg["change_stride"], prec)
    f1, f2 = l2_normalize(pyr1[-1]), l2_normalize(pyr2[-1])
    pre = correlation(f1, f2, prec)
    corr = prec(mutual_matching(maxpool4d(pre, cfg["ksize"])))
    corr = prec(mutual_matching(neigh_consensus(P, corr, "ncn", len(cfg["ncn_channels"]),
                                                prec)))
    return pyr1, pyr2, pre, corr


def ncnet_volume(P, cfg, im1, im2, prec=F32):
    """NHWC images -> filtered volume (B, h1, w1, h2, w2)."""
    f1 = l2_normalize(vgg16_pool4(P, nhwc_to_nchw(im1), prec))
    f2 = l2_normalize(vgg16_pool4(P, nhwc_to_nchw(im2), prec))
    corr = prec(mutual_matching(correlation(f1, f2, prec)))
    return prec(mutual_matching(neigh_consensus(P, corr, "NeighConsensus",
                                                len(cfg["ncn_channels"]), prec)))
