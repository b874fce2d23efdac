"""Mid/fine local-patch regressor.

Port of ``patch2pix_tpu.models.regressor.FeatRegressNet``: a small CNN
over psize x psize hypercolumn patches of both images giving 4 offset
logits + 1 confidence logit per proposal. ``feat_comb='pre'`` runs one
conv stack over both sides' channels; ``'post'`` runs one conv stack
(input ``feat_dim`` channels) over each side's patches and concatenates
the two pooled features before the fcs. In ``'post'`` the fused-gather
layout (B3's outputs, channel-paired levels included) is split back into
its sides, so the stage keeps B3.
Parameters keep the reference key names: ``conv.{0,2}`` convs,
``conv.{1,3}`` BatchNorm2d, ``fc.{0,3}`` Linear, ``fc.{1,4}``
BatchNorm1d, ``fc.6`` the output Linear.

Inference arithmetic, as in the JAX package:

  * the first conv contracts per input segment (pyramid level or
    channel-paired level) against its kernel-channel slice and sums the
    segments in float32 (:func:`segmented_conv`) — the hypercolumn
    concat never exists;
  * every conv BN except the last folds into the next conv's weights
    (``conv(x*s + t) = conv_{k*s}(x) + conv_k(t_map)``), the last BN +
    ReLU + global max folds into per-channel max/min reductions;
  * the fc BatchNorms normalise in float32 and cast back.

``forward`` is ``fc_head(pooled(...))``: the conv part and the fc part
are separate methods so that the fused fine-stage head
(``ops/fine_stage.py``) can feed its pooled features to the same fc
layers.

Training (``stats``, a list, given to ``forward``, ``pooled`` or
``fc_head``): every BatchNorm normalises with the batch's statistics, as
the JAX package's ``BNAffine`` and flax ``nn.BatchNorm`` do — float32
mean and biased variance ``E[x^2] - mean^2`` clamped at 0, the conv BNs
still folded as affines — and appends ``(module, mean, var)`` to
``stats``; :func:`update_running_stats` then folds them into the running
averages, ``0.9 * old + 0.1 * batch``. The caller applies the update, so
a stage recomputed under activation checkpointing counts once. In
``'post'`` the shared conv BatchNorms see each side's batch in turn, and
their running averages take both updates in that order, as flax's do.

A fresh regressor draws its conv and Linear weights with flax's
``lecun_normal`` (the JAX ``nn.Conv`` and ``nn.Dense`` default); Linear
biases start at zero, BatchNorms at scale 1 and bias 0.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from patch2pix_tpu_torch.models.resnet import bn_fold, conv2d_nhwc, lecun_normal_


def _as_tuple(x):
    return tuple(x) if isinstance(x, (list, tuple)) else (x,)


def segmented_conv(xs, weight, stride: int, dtype, slice_map=None):
    """Conv (padding 1, no bias) of the channel concat of NHWC ``xs``
    WITHOUT concatenating. ``slice_map``: per input, the (offset, size)
    kernel-channel slices whose concat matches that input's channels;
    default: the inputs cover the kernel channels in order."""
    xs = _as_tuple(xs)
    if slice_map is None:
        slice_map, off = [], 0
        for x in xs:
            slice_map.append(((off, x.shape[-1]),))
            off += x.shape[-1]
    acc = None
    for x, sl in zip(xs, slice_map):
        ks = torch.cat([weight[:, o:o + s] for o, s in sl], dim=1)
        y = conv2d_nhwc(x.to(dtype), ks.to(dtype), stride, 1).float()
        acc = y if acc is None else acc + y
    return acc.to(dtype)


def batch_moments(x):
    """Float32 mean and biased variance over every axis but the last,
    from one sum / sum-of-squares pass: ``E[x^2] - mean^2`` clamped at 0
    (``BNAffine``'s and flax ``nn.BatchNorm``'s fast variance)."""
    xf = x.float().reshape(-1, x.shape[-1])
    n = xf.shape[0]
    mean = xf.sum(dim=0) / n
    var = torch.clamp(xf.square().sum(dim=0) / n - mean.square(), min=0.0)
    return mean, var


def bn_affine(bn, mean, var):
    """BatchNorm with the given statistics as the f32 affine ``(s, t)``."""
    s = bn.weight.float() * torch.rsqrt(var + bn.eps)
    return s, bn.bias.float() - mean * s


@torch.no_grad()
def update_running_stats(stats, momentum: float = 0.9) -> None:
    """Fold ``[(BatchNorm, batch mean, batch var), ...]`` into the running
    averages, in order: ``momentum * old + (1 - momentum) * batch``."""
    for bn, mean, var in stats:
        bn.running_mean.copy_(momentum * bn.running_mean + (1 - momentum) * mean)
        bn.running_var.copy_(momentum * bn.running_var + (1 - momentum) * var)


def scaled_kernel_conv(x, weight, stride: int, dtype, in_affine=None):
    """Conv (padding 1, no bias) of ``x * s + t`` with the per-input-
    channel affine ``(s, t)`` folded into the weights."""
    if in_affine is None:
        return conv2d_nhwc(x.to(dtype), weight.to(dtype), stride, 1)
    s, t = in_affine
    ks = (weight.float() * s[None, :, None, None]).to(dtype)
    tmap = t.to(dtype).expand(1, x.shape[1], x.shape[2], x.shape[3]).contiguous()
    return (conv2d_nhwc(x.to(dtype), ks, stride, 1)
            + conv2d_nhwc(tmap, weight.to(dtype), stride, 1))


class FeatRegressNet(nn.Module):
    """(M, psize, psize, D) patches -> (M, 5) raw regressor outputs."""

    def __init__(self, feat_dim: int, conv_dims: Sequence[int] = (512, 512),
                 conv_kers: Sequence[int] = (3, 3),
                 conv_strs: Sequence[int] = (2, 1),
                 fc_dims: Sequence[int] = (512, 256), feat_comb: str = "pre",
                 psize: int = 16, out_dim: int = 5,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if feat_comb not in ("pre", "post"):
            raise ValueError(f"unknown feat_comb {feat_comb!r}")
        self.feat_comb = feat_comb
        self.feat_dim = feat_dim
        self.conv_strs = tuple(conv_strs)
        self.dtype = dtype
        convs, cin = [], feat_dim if feat_comb == "post" else 2 * feat_dim
        for dim, k, s in zip(conv_dims, conv_kers, conv_strs):
            convs += [nn.Conv2d(cin, dim, k, s, 1, bias=False, device=device),
                      nn.BatchNorm2d(dim, device=device)]
            cin = dim
        self.conv = nn.Sequential(*convs)
        if feat_comb == "post":
            cin *= 2
        fcs = []
        for dim in fc_dims:
            fcs += [nn.Linear(cin, dim, device=device),
                    nn.BatchNorm1d(dim, device=device), nn.ReLU()]
            cin = dim
        fcs.append(nn.Linear(cin, out_dim, device=device))
        self.fc = nn.Sequential(*fcs)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                lecun_normal_(m.weight)
            if isinstance(m, nn.Linear):
                nn.init.zeros_(m.bias)

    def forward(self, f1, f2=None, slice_map=None, stats=None):
        """``f1``/``f2``: each a hypercolumn tensor or a sequence of
        per-level tensors. ``f2=None`` marks ``f1`` as the fused-gather
        layout: a flat tuple of patch tensors whose kernel-channel
        slices are given by ``slice_map``. ``stats``: a list to train
        with batch statistics (module docstring). Returns (M, 5)
        float32."""
        return self.fc_head(self.pooled(f1, f2, slice_map, stats), stats)

    def _affine(self, bn, y, stats):
        if stats is None:
            return bn_fold(bn)
        mean, var = batch_moments(y)
        stats.append((bn, mean.detach(), var.detach()))
        return bn_affine(bn, mean, var)

    def _split_sides(self, xs, slice_map):
        """The fused-gather layout -> each side's (tensors, slice map),
        kernel-channel offsets relative to that side's ``feat_dim``
        channels. A channel-paired output holds side 1's channels then
        side 2's."""
        d = self.feat_dim
        sides = (([], []), ([], []))
        for x, sl in zip(xs, slice_map):
            if len(sl) == 2:
                c = sl[0][1]
                parts = ((x[..., :c], sl[0]), (x[..., c:], sl[1]))
            else:
                parts = ((x, sl[0]),)
            for part, (off, size) in parts:
                side = 0 if off < d else 1
                sides[side][0].append(part)
                sides[side][1].append(((off - side * d, size),))
        return sides

    def pooled(self, f1, f2=None, slice_map=None, stats=None):
        """The conv layers, their BatchNorms and the global max-pool:
        (M, F) features in the compute dtype (arguments as
        :meth:`forward`)."""
        if self.feat_comb == "pre":
            if f2 is None:
                return self._conv_stack(_as_tuple(f1), list(slice_map), stats)
            return self._conv_stack(_as_tuple(f1) + _as_tuple(f2), None, stats)
        if f2 is None:
            (x1, m1), (x2, m2) = self._split_sides(_as_tuple(f1), slice_map)
        else:
            (x1, m1), (x2, m2) = (_as_tuple(f1), None), (_as_tuple(f2), None)
        return torch.cat([self._conv_stack(x1, m1, stats),
                          self._conv_stack(x2, m2, stats)], dim=-1)

    def _conv_stack(self, xs, slice_map, stats):
        dtype = self.dtype
        convs = list(self.conv)
        y = segmented_conv(xs, convs[0].weight, self.conv_strs[0], dtype, slice_map)
        affine = self._affine(convs[1], y, stats)
        for li in range(1, len(convs) // 2):
            y = scaled_kernel_conv(y, convs[2 * li].weight, self.conv_strs[li],
                                   dtype, in_affine=affine)
            affine = self._affine(convs[2 * li + 1], y, stats)
        sa, ta = affine
        xmax = torch.amax(y, dim=(1, 2)).float()
        xmin = torch.amin(y, dim=(1, 2)).float()
        return torch.relu(sa * torch.where(sa > 0, xmax, xmin) + ta).to(dtype)

    def fc_head(self, feat, stats=None):
        """(M, F) pooled features -> (M, 5) float32: the fc layers with
        their BatchNorms and ReLUs, then the output layer (``stats`` as
        :meth:`forward`)."""
        dtype = self.dtype
        fcs = list(self.fc)
        for li in range(len(fcs) // 3):
            lin, bn = fcs[3 * li], fcs[3 * li + 1]
            feat = F.linear(feat.to(dtype), lin.weight.to(dtype)) + lin.bias.to(dtype)
            if stats is None:
                mean, var = bn.running_mean, bn.running_var
            else:
                mean, var = batch_moments(feat)
                stats.append((bn, mean.detach(), var.detach()))
            feat = ((feat.float() - mean)
                    * (torch.rsqrt(var + bn.eps) * bn.weight)
                    + bn.bias).to(dtype)
            feat = torch.relu(feat)
        out = fcs[-1]
        return F.linear(feat.float(), out.weight, out.bias)
