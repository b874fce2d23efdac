"""The least time of the NCN's per-tap layers, from shapes.

The per-tap layers are, by this metric's definition, every layer of the
NCN with more than two input and more than two output channels, at any
kernel size (NCNet's 16 -> 16). Their least time is the larger of their
operations at the bf16 peak and their input read once plus their output
written once, both in the compute dtype (bfloat16), at HBM bandwidth.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from benchmark import peaks

BF16 = 2


def per_tap_layers(kernel_sizes: Sequence[int], channels: Sequence[int]) -> List[Tuple[int, int, int]]:
    """(k, cin, cout) of each layer with more than two input and output
    channels."""
    out, cin = [], 1
    for k, cout in zip(kernel_sizes, channels):
        if cin > 2 and cout > 2:
            out.append((k, cin, cout))
        cin = cout
    return out


def ncn_taps_bound_s(volume: Sequence[int], kernel_sizes: Sequence[int],
                     channels: Sequence[int], symmetric: bool = True) -> float:
    """Least seconds a call of the per-tap layers on a ``(B, h1, w1, h2,
    w2)`` volume, both symmetric directions."""
    cells = 1
    for side in volume:
        cells *= side
    total = 0.0
    for k, cin, cout in per_tap_layers(kernel_sizes, channels):
        flops = 2.0 * cells * cin * cout * k ** 4
        nbytes = cells * (cin + cout) * BF16
        total += peaks.bound_s(nbytes, flops, peaks.BF16_FLOPS)
    return total * (2 if symmetric else 1)
