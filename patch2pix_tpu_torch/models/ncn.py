"""Neighbourhood-consensus network: stacked 4D convs with ReLU.

Port of ``patch2pix_tpu.models.ncn``. Symmetric mode convolves the
volume and its A<->B transpose and sums (two independent ReLU stacks).
Parameters keep the reference layout and key names
(``ncn.conv.{0,2}.weight`` stored ``(k1, out, in, k2, k3, k4)``). A
fresh layer draws its weight as flax's ``xavier_uniform`` draws the JAX
kernel ``(k, k, k, k, in, out)``: uniform within ``sqrt(6 / (fan_in +
fan_out))``, fan_in = in * k^4 and fan_out = out * k^4 (torch's
``xavier_uniform_`` on the stored layout would take other fans); biases
start at zero.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from patch2pix_tpu_torch.ops.conv4d import conv4d, conv4d_transpose_symmetric


class Conv4dParams(nn.Module):
    """Holds one conv4d layer's weight (reference pre-permuted layout)
    and bias."""

    def __init__(self, cin: int, cout: int, k: int, device=None):
        super().__init__()
        limit = (6.0 / ((cin + cout) * k ** 4)) ** 0.5
        kernel = torch.empty(k, k, k, k, cin, cout, device=device).uniform_(-limit, limit)
        self.weight = nn.Parameter(kernel.permute(0, 5, 4, 1, 2, 3).contiguous())
        self.bias = nn.Parameter(torch.zeros(cout, device=device))

    def kernel(self) -> torch.Tensor:
        """(k1, out, in, k2, k3, k4) -> (k1, k2, k3, k4, in, out)."""
        return self.weight.permute(0, 3, 4, 5, 2, 1)


class NeighConsensus(nn.Module):
    """corr (B, h1, w1, h2, w2) -> filtered corr, same shape, float32."""

    def __init__(self, kernel_sizes: Sequence[int] = (3, 3),
                 channels: Sequence[int] = (16, 1), symmetric_mode: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        layers = []
        cin = 1
        for k, cout in zip(kernel_sizes, channels):
            layers += [Conv4dParams(cin, cout, k, device=device), nn.ReLU()]
            cin = cout
        self.conv = nn.Sequential(*layers)
        self.symmetric_mode = symmetric_mode
        self.dtype = dtype

    def forward(self, corr: torch.Tensor) -> torch.Tensor:
        convs = [m for m in self.conv if isinstance(m, Conv4dParams)]

        def stack(x, transpose: bool):
            op = conv4d_transpose_symmetric if transpose else conv4d
            for li, layer in enumerate(convs):
                # intermediate volumes are stored in the compute dtype;
                # the final layer keeps the f32 accumulator
                od = self.dtype if li < len(convs) - 1 else None
                x = torch.relu(op(x.to(self.dtype), layer.kernel().to(self.dtype),
                                  layer.bias, out_dtype=od))
            return x

        x = corr[..., None]
        y = stack(x, False)
        if self.symmetric_mode:
            y = y + stack(x, True)
        return y[..., 0].float()
