"""B4's C -> C instances (the NCN's middle layer on the card) on the CPU.

The kernel runs only on a CUDA card (tests/test_torch_card.py); here its
plain version, the wrapper's host-side packing and the route's plumbing
are held. On the CPU ``conv4d_mid`` runs B4's plain version: held against
the per-tap loop it replaces on the card (``conv4d_xla_taps``) in
float32 to 1e-5 at odd shapes, C 10 and 16, with and without bias, both
symmetric directions through ``conv4d_transpose_symmetric``. The B
fragments (``mid_fragments``) follow the m16n8k16 register layout bit
for bit, and multiplied out tap by tap in the kernel's order, on 16
channels with the pad zero, they give the plain version's sums. The
strip length and the shared-memory plan against ``csrc/conv4d_mid.cu``.
The ``mid_layer_kernel`` route still goes through the module's
``conv4d_xla_taps`` by name (the benchmark times that name), and on the
CPU, in float32 and with a gradient the per-tap loop keeps its route
and its counter.
"""

import importlib
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from patch2pix_tpu_torch.models.ncn import NeighConsensus
from patch2pix_tpu_torch.ops.conv4d import conv4d, conv4d_route, conv4d_transpose_symmetric
from patch2pix_tpu_torch.ops.conv4d_mid import (
    CPAD,
    MID_CHANNELS,
    STRIP_MAX,
    conv4d_mid,
    mid_fragments,
    strip_cells,
)
from patch2pix_tpu_torch.ops.conv4d_small import conv4d_small_plain
from patch2pix_tpu_torch.utils import profiling
from tests.test_torch_fine_stage import _cu_constants
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

conv4d_module = importlib.import_module("patch2pix_tpu_torch.ops.conv4d")


def _inputs(seed, dims, c, scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(dims + (c,)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 3, c, c)) / (81 * c) ** 0.5).astype(np.float32)
    b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return (torch.from_numpy(a) * s for a, s in ((x, scale), (w, 1.0), (b, 1.0)))


@pytest.mark.parametrize("dims", [(1, 3, 5, 7, 9), (2, 4, 3, 5, 11), (1, 1, 6, 9, 1)],
                         ids=["odd", "batch2", "w2_1"])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("c", MID_CHANNELS)
def test_plain_matches_xla_taps(c, with_bias, dims):
    """The plain version (the ``mid_layer_kernel`` route on a CPU tensor)
    against the per-tap loop, both directions of the symmetric NCN."""
    x, w, b = _inputs(c + dims[4], dims, c)
    b = b if with_bias else None
    for op in (conv4d, conv4d_transpose_symmetric):
        got = op(x, w, b, route="mid_layer_kernel")
        want = op(x, w, b, route="xla_taps")
        assert got.shape == want.shape == dims + (c,) and got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    # out_dtype reaches the plain version through the per-tap entry
    got = conv4d(x.bfloat16(), w, b, out_dtype=torch.bfloat16, route="mid_layer_kernel")
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, conv4d_small_plain(x.bfloat16(), w, b, torch.bfloat16))


@pytest.mark.parametrize("c", MID_CHANNELS)
def test_mid_fragments_follow_the_register_layout(c):
    """mma.sync m16n8k16 B, both n-tiles in one 16-byte load: register
    2nt + j of lane 4g + t holds rows 8j + 2t (low half) and + 1 (high
    half) of column 8nt + g of tap ((di*3 + dj)*3 + dk)*3 + dl, zero past
    C."""
    _, w, _ = _inputs(c, (1,), c)
    frag = mid_fragments(w).numpy().astype(np.uint32)
    assert frag.shape == (81, 32, 4)
    bits = F.pad(w.reshape(81, c, c).bfloat16(), (0, CPAD - c, 0, CPAD - c))
    bits = bits.view(torch.int16).numpy().astype(np.uint16)
    tap, lane, reg = np.indices(frag.shape)
    k = 8 * (reg % 2) + 2 * (lane % 4)
    n = 8 * (reg // 2) + lane // 4
    np.testing.assert_array_equal(frag & 0xFFFF, bits[tap, k, n])
    np.testing.assert_array_equal(frag >> 16, bits[tap, k + 1, n])
    # a permuted filter (the transposed branch's) packs as its copy does
    wt = w.permute(2, 3, 0, 1, 4, 5)
    assert torch.equal(mid_fragments(wt), mid_fragments(wt.contiguous()))


def _unpack(frag):
    """The kernel's view of the fragments: (81, 16, 16) float32 filters
    ``B[tap][ci, co]``."""
    halves = frag.contiguous().view(torch.bfloat16).reshape(81, 8, 4, 2, 2, 2)  # g t nt j half
    return halves.permute(0, 4, 2, 5, 3, 1).reshape(81, CPAD, CPAD).float()


@pytest.mark.parametrize("c", MID_CHANNELS)
def test_fragments_multiplied_out_match_plain(c):
    """The kernel's arithmetic in float32: x padded to 16 channels and on
    all four spatial axes, each tap's 16-channel product with the
    unpacked fragments, the 81 taps in the kernel's order: within 1e-5 of
    the plain version with the filter rounded to bf16, as the kernel's."""
    dims = (1, 3, 4, 5, 6)
    x, w, b = _inputs(2 * c, dims, c)
    taps = _unpack(mid_fragments(w))
    xp = F.pad(x, (0, CPAD - c, 1, 1, 1, 1, 1, 1, 1, 1))
    acc = torch.zeros(dims + (CPAD,))
    for tap in range(81):
        di, dj, dk, dl = np.unravel_index(tap, (3, 3, 3, 3))
        src = xp[:, di:di + dims[1], dj:dj + dims[2], dk:dk + dims[3], dl:dl + dims[4]]
        acc = acc + src @ taps[tap]
    assert (acc[..., c:] == 0).all()
    want = conv4d_small_plain(x, w.bfloat16().float(), b)
    torch.testing.assert_close(acc[..., :c] + b, want, rtol=0, atol=1e-5)


def test_strip_cells():
    """Strips of at most STRIP_MAX cells, as few as w1 allows, the last
    one not empty."""
    assert (strip_cells(100), strip_cells(64), strip_cells(1)) == (20, 16, 1)
    for w1 in range(1, 200):
        j = strip_cells(w1)
        strips = -(-w1 // j)
        assert j <= STRIP_MAX and strips == -(-w1 // STRIP_MAX)
        assert 0 < w1 - (strips - 1) * j <= j


def test_shared_memory_plan_matches_the_kernels_constants():
    """csrc/conv4d_mid.cu: a warp's 16 base positions, a staged row of
    them plus one each side and the zero slot, 16-byte aligned; the ring
    and the 81 taps' fragments (the wrapper's bytes) fit one block an SM
    (228 KB, 1 KB of it reserved a block), which the 12 warps fill."""
    path = Path(conv4d_mid.__code__.co_filename).parents[1] / "csrc" / "conv4d_mid.cu"
    k = _cu_constants(path)
    assert k["BASE"] == 16 * k["NWARP"] and k["RHO"] == k["R"] + 2
    assert k["ROWB"] == (k["BASE"] + 3) * 2 * CPAD and k["ROWB"] % 16 == 0
    _, w, _ = _inputs(0, (1,), 16)
    frag = mid_fragments(w)
    assert k["FRAGB"] == frag.numel() * frag.element_size() == 81 * 32 * 16
    assert k["SMEM"] + 1024 <= 233472 and 2 * (k["SMEM"] + 1024) > 233472
    assert k["NTHREADS"] * 168 <= 65536


def _ncn(channels, dtype, seed=3):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return NeighConsensus((3,) * len(channels), channels, dtype=dtype, device="cpu")


@pytest.mark.parametrize("channels", [(10, 10, 1), (16, 16, 1)])
def test_mid_route_goes_through_the_per_tap_entry(channels, monkeypatch):
    """With the route forced to ``mid_layer_kernel`` (the card's, in
    bf16), a symmetric NCN call reaches the module's ``conv4d_xla_taps``
    twice, by name, as the benchmark's stage timer wraps it, and counts
    no per-tap loop; its output equals the loop's to float32 rounding."""
    ncn = _ncn(channels, torch.float32)
    corr = torch.rand(1, 3, 4, 3, 5)
    with torch.no_grad():
        want = ncn(corr)
    route = conv4d_module.conv4d_route
    monkeypatch.setattr(conv4d_module, "conv4d_route",
                        lambda k, cin, cout, *a: ("mid_layer_kernel" if cin == cout
                                                  else route(k, cin, cout, *a)))
    entry, seen = conv4d_module.conv4d_xla_taps, []

    def wrapped(*a, **kw):
        seen.append(kw.get("route"))
        return entry(*a, **kw)

    monkeypatch.setattr(conv4d_module, "conv4d_xla_taps", wrapped)
    profiling.drain()
    with profiling.tracing(), torch.no_grad():
        got = ncn(corr)
    counters = profiling.drain()["counters"]
    assert seen == ["mid_layer_kernel"] * 2
    assert "conv4d.xla_taps" not in counters and "conv4d.mid_layer_kernel" not in counters
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels", [(10, 10, 1), (16, 16, 1)])
def test_ncn_middle_layer_keeps_the_loop_off_the_card(channels, dtype):
    """On the CPU, in either type and with a gradient, a symmetric NCN's
    C -> C layer runs the per-tap loop: two ``conv4d.xla_taps``, no
    ``conv4d.mid_layer_kernel``; on the card the same layer in float32
    or wanting a gradient keeps the loop's route."""
    ncn = _ncn(channels, dtype)
    corr = torch.rand(1, 3, 4, 3, 4)
    for grad in (False, True):
        profiling.drain()
        with torch.set_grad_enabled(grad), profiling.tracing():
            ncn(corr)
        counters = profiling.drain()["counters"]
        assert counters.get("conv4d.xla_taps") == 2
        assert "conv4d.mid_layer_kernel" not in counters
    c = channels[0]
    assert conv4d_route(3, c, c, "cuda", torch.float32) == "xla_taps"
    assert conv4d_route(3, c, c, "cuda", torch.bfloat16, True) == "xla_taps"
    assert conv4d_route(3, c, c, "cuda", torch.bfloat16) == "mid_layer_kernel"
