"""Mid/fine local-patch regressor (inference).

Port of ``patch2pix_tpu.models.regressor.FeatRegressNet`` with feat_comb
``pre``: a small CNN over psize x psize hypercolumn patches of both
images giving 4 offset logits + 1 confidence logit per proposal.
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
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from patch2pix_tpu_torch.models.resnet import bn_fold, conv2d_nhwc


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
        if feat_comb != "pre":
            raise NotImplementedError(
                f"feat_comb {feat_comb!r}: only 'pre' is ported")
        self.conv_strs = tuple(conv_strs)
        self.dtype = dtype
        convs, cin = [], 2 * feat_dim
        for dim, k, s in zip(conv_dims, conv_kers, conv_strs):
            convs += [nn.Conv2d(cin, dim, k, s, 1, bias=False, device=device),
                      nn.BatchNorm2d(dim, device=device)]
            cin = dim
        self.conv = nn.Sequential(*convs)
        fcs = []
        for dim in fc_dims:
            fcs += [nn.Linear(cin, dim, device=device),
                    nn.BatchNorm1d(dim, device=device), nn.ReLU()]
            cin = dim
        fcs.append(nn.Linear(cin, out_dim, device=device))
        self.fc = nn.Sequential(*fcs)

    def forward(self, f1, f2=None, slice_map=None):
        """``f1``/``f2``: each a hypercolumn tensor or a sequence of
        per-level tensors. ``f2=None`` marks ``f1`` as the fused-gather
        layout: a flat tuple of patch tensors whose kernel-channel
        slices are given by ``slice_map``."""
        dtype = self.dtype
        convs = list(self.conv)
        xs = _as_tuple(f1) if f2 is None else _as_tuple(f1) + _as_tuple(f2)
        y = segmented_conv(xs, convs[0].weight, self.conv_strs[0], dtype,
                           None if f2 is not None else list(slice_map))
        affine = bn_fold(convs[1])
        for li in range(1, len(convs) // 2):
            y = scaled_kernel_conv(y, convs[2 * li].weight, self.conv_strs[li],
                                   dtype, in_affine=affine)
            affine = bn_fold(convs[2 * li + 1])
        sa, ta = affine
        xmax = torch.amax(y, dim=(1, 2)).float()
        xmin = torch.amin(y, dim=(1, 2)).float()
        feat = torch.relu(sa * torch.where(sa > 0, xmax, xmin) + ta).to(dtype)

        fcs = list(self.fc)
        for li in range(len(fcs) // 3):
            lin, bn = fcs[3 * li], fcs[3 * li + 1]
            feat = F.linear(feat.to(dtype), lin.weight.to(dtype)) + lin.bias.to(dtype)
            feat = ((feat.float() - bn.running_mean)
                    * (torch.rsqrt(bn.running_var + bn.eps) * bn.weight)
                    + bn.bias).to(dtype)
            feat = torch.relu(feat)
        out = fcs[-1]
        return F.linear(feat.float(), out.weight, out.bias)
