"""Outer-tap masked shift-add of the fold-out conv4d (kernel B1).

Port of ``patch2pix_tpu.ops.tap_sum_pallas`` (``tap_sum_pallas_t`` and
``tap_sum_pallas`` compute the same function). Given the fold-out 2D
conv's output z in PyTorch's NCHW layout, ``(N, 9*cout, h2, w2)`` viewed
as ``(N, 9, m)`` with ``m = cout * h2 * w2``:

    out[f, col] = bias[col // hw] + sum_{t<9} mask_t(f) * z[f + s_t, t, col]

over the flat cell index f = (b*h1 + i)*w1 + j, s_t = (di-1)*w1 + (dj-1)
for tap t = di*3 + dj, mask_t(f) true iff (i+di-1, j+dj-1) is inside the
grid. Adds are float32 in tap order, then the bias; the kernel is
bit-identical to :func:`tap_sum_plain`.
"""

from __future__ import annotations

import torch

from patch2pix_tpu_torch.ops import _build

K = 3  # NCN kernel size; taps = K*K
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {"p2p_tap_sum": "pppiiiiiip"}


def flat_shift_masks(bs: int, h1: int, w1: int, device=None):
    """``[(s_t, mask_t)]`` for the 9 outer taps over the flat cell
    index: mask_t is a ``(bs*h1*w1,)`` bool tensor."""
    i = torch.arange(h1, device=device)[:, None]
    j = torch.arange(w1, device=device)[None, :]
    out = []
    for di in range(K):
        for dj in range(K):
            ok = ((i + di - 1 >= 0) & (i + di - 1 < h1)
                  & (j + dj - 1 >= 0) & (j + dj - 1 < w1))
            out.append(((di - 1) * w1 + (dj - 1), ok.reshape(-1).repeat(bs)))
    return out


def tap_sum_plain(z: torch.Tensor, bias: torch.Tensor, bs: int, h1: int,
                  w1: int) -> torch.Tensor:
    """The plain version: nine masked shifted slices of a padded z."""
    n, t9, m = z.shape
    cout = bias.numel()
    p = w1 + 1
    zp = torch.nn.functional.pad(z, (0, 0, 0, 0, p, p))
    acc = torch.zeros((n, m), dtype=torch.float32, device=z.device)
    for t, (s, mask) in enumerate(flat_shift_masks(bs, h1, w1, z.device)):
        v = zp[p + s:p + s + n, t].float()
        acc = acc + torch.where(mask[:, None], v, torch.zeros((), device=z.device))
    b = bias.float().repeat_interleave(m // cout)
    return acc + b


def tap_sum(z: torch.Tensor, bias: torch.Tensor, bs: int, h1: int,
            w1: int) -> torch.Tensor:
    """z ``(N, 9, m)`` (N = bs*h1*w1, m = cout*h2*w2) and bias
    ``(cout,)`` float32 -> ``(N, m)`` float32."""
    if z.device.type == "cpu":
        return tap_sum_plain(z, bias, bs, h1, w1)
    n, t9, m = z.shape
    cout = bias.numel()
    if z.device.type != "cuda" or bias.device != z.device:
        raise ValueError(f"tap_sum: z on {z.device}, bias on {bias.device}")
    if z.dtype not in _DTYPES or bias.dtype != torch.float32:
        raise TypeError(f"tap_sum: z {z.dtype}, bias {bias.dtype}")
    if t9 != K * K or n != bs * h1 * w1 or m % cout != 0:
        raise ValueError(f"tap_sum: z {tuple(z.shape)} for bs={bs} h1={h1} w1={w1}")
    if not (z.is_contiguous() and bias.is_contiguous()):
        raise ValueError("tap_sum: inputs must be contiguous")
    out = torch.empty((n, m), dtype=torch.float32, device=z.device)
    lib = _build.library("tap_sum", _SIGNATURES)
    rc = lib.p2p_tap_sum(
        z.data_ptr(), bias.data_ptr(), out.data_ptr(),
        n, m, h1, w1, m // cout, _DTYPES[z.dtype],
        _build.current_stream(z.device),
    )
    _build.check_launch(rc, "tap_sum")
    tap_sum.launches += 1
    return out


tap_sum.launches = 0
