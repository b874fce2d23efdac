"""B4's C -> C instances: the NCN's middle 4D conv on the card.

The route :func:`..conv4d.conv4d_route` names ``mid_layer_kernel``: a
bfloat16 k=3 layer with Cin = Cout = C in :data:`MID_CHANNELS` (NCNet's
10 -> 10, its InLoc model's 16 -> 16) whose conv needs no gradient.
The JAX package runs such a layer as XLA's per-tap convs
(``patch2pix_tpu/ops/conv4d.py`` ``conv4d_xla_taps``); so did the port,
as nine cuDNN convs a direction, until ``csrc/conv4d_mid.cu`` (its note
says why and what bounds it):

    out[b, i, j, k, l, co] = bias[co] + sum_{di, dj, dk, dl, ci}
        x[b, i+di-1, j+dj-1, k+dk-1, l+dl-1, ci] * w[di, dj, dk, dl, ci, co]

with zero padding; x and the output channels-last. The filter is rounded
to bfloat16 first; products and sums are float32, then the bias, then
one rounding to ``out_dtype`` (float32 when None). On a CPU tensor the
wrapper runs B4's plain version, :func:`.conv4d_small.conv4d_small_plain`,
which takes any channel count; the two add the 81 * C products in
different orders, so they agree to float32 rounding.

:func:`mid_fragments` lays the filter out as the kernel's m16n8k16 B
fragments, and :func:`strip_cells` picks the cells a block walks along
w1; both run here, so the CPU tests hold them.
"""

from __future__ import annotations

import torch

from patch2pix_tpu_torch.ops import _build
from patch2pix_tpu_torch.ops.conv4d_small import conv4d_small_plain
from patch2pix_tpu_torch.utils import profiling

K = 3
# the channel counts csrc/conv4d_mid.cu is built for: those the port's NCN
# configurations put in a C -> C layer (ImMatchNet 10, NCNet InLoc 16)
MID_CHANNELS = (10, 16)
CPAD = 16  # channels as the kernel stages them, and its K and N
STRIP_MAX = 20  # most cells a block walks along w1
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {"p2p_conv4d_mid": "ppppiiiiiiiip", "p2p_conv4d_mid_attrs": "iippp"}


def strip_cells(w1: int) -> int:
    """Cells a block walks along w1: w1 cut into the fewest strips of at
    most :data:`STRIP_MAX`, as even as they go (100 -> 20, 64 -> 16). A
    strip of J cells stages J + 2 columns of source planes."""
    return -(-w1 // -(-w1 // STRIP_MAX))


def mid_fragments(w):
    """``(3, 3, 3, 3, C, C)`` -> int32 ``(81, 32, 4)``: for tap ``((di * 3
    + dj) * 3 + dk) * 3 + dl``, the m16n8k16 B fragments of its filter
    ``W[ci, co] = w[di, dj, dk, dl, ci, co]`` in bfloat16, zero-padded to
    16 x 16. Register ``2 * nt + j`` of lane ``4 * g + t`` holds rows ``8 *
    j + 2 * t`` (low half) and ``+ 1`` (high half) of column ``8 * nt +
    g``: both n-tiles in one 16-byte load a lane."""
    c = w.shape[4]
    wp = w.new_zeros((K ** 4, CPAD, CPAD), dtype=torch.bfloat16)
    wp[:, :c, :w.shape[5]] = w.reshape(K ** 4, c, w.shape[5])
    f = wp.reshape(K ** 4, 2, 4, 2, 2, 8)  # (tap, j, t, half, nt, g)
    f = f.permute(0, 5, 2, 4, 1, 3).contiguous()  # (tap, g, t, nt, j, half)
    return f.view(torch.int32).reshape(K ** 4, 32, 4)


def conv4d_mid(x, w, b=None, out_dtype=None):
    """x ``(B, h1, w1, h2, w2, C)`` bfloat16 (float32 too on the CPU), w
    ``(3, 3, 3, 3, C, C)`` with C in :data:`MID_CHANNELS` (any layout),
    bias ``(C,)`` -> ``(B, h1, w1, h2, w2, C)`` contiguous, float32 or
    ``out_dtype``. On the card the kernel has no backward: inputs that
    require grad raise under grad mode (the route sends those to the
    per-tap loop)."""
    if x.device.type == "cpu":
        return conv4d_small_plain(x, w, b, out_dtype)
    _build.refuse_grad("conv4d_mid", *(t for t in (x, w, b) if t is not None))
    bs, h1, w1, h2, w2, c = x.shape
    dev = x.device
    if dev.type != "cuda" or w.device != dev or (b is not None and b.device != dev):
        raise ValueError("conv4d_mid: tensors must share one CUDA device")
    odt = torch.float32 if out_dtype is None else out_dtype
    if x.dtype != torch.bfloat16 or odt not in _DTYPES:
        raise TypeError(f"conv4d_mid: x {x.dtype}, out_dtype {odt}")
    if c not in MID_CHANNELS or tuple(w.shape) != (K,) * 4 + (c, c):
        raise ValueError(f"conv4d_mid: filter {tuple(w.shape)} on {c} channels")
    x = x.contiguous()
    frag = mid_fragments(w)
    bias = (torch.zeros(c, dtype=torch.float32, device=dev) if b is None
            else b.float().contiguous())
    out = torch.empty((bs, h1, w1, h2, w2, c), dtype=odt, device=dev)
    lib = _build.library("conv4d_mid", _SIGNATURES)
    rc = lib.p2p_conv4d_mid(x.data_ptr(), frag.data_ptr(), bias.data_ptr(), out.data_ptr(),
                            bs, h1, w1, h2, w2, c, strip_cells(w1), _DTYPES[odt],
                            _build.current_stream(dev))
    _build.check_launch(rc, "conv4d_mid")
    conv4d_mid.launches += 1
    profiling.count("conv4d.mid_layer_kernel", 1)
    return out


conv4d_mid.launches = 0
