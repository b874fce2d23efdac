"""The port's small-channel conv4d (kernel B4) against the JAX package.

On the CPU ``conv4d_small`` runs its plain version; it is held against
``conv4d_pallas`` in interpret mode and against JAX ``conv4d``. The bf16
kernel's banded filter (``banded_filter``) multiplied out over im2col'd
rows, as the kernel multiplies it, is held to both in float32 to 1e-5,
and its B fragments (``mma_fragments``) to the m16n8k16 register layout
bit for bit.
Tolerances: float32 atol 1e-4 (the 81*cin products summed in another
order; the JAX interpret tests use the same bound); bf16 output within
one bf16 ulp (the float32 sums round either way of a bf16 midpoint);
the backward at float32 rtol 1e-5 / atol 1e-4. The kernel itself runs
only on a CUDA card: tests/test_torch_card.py.
"""

import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from patch2pix_tpu.models.ncn import NeighConsensus as JaxNCN
from patch2pix_tpu.ops.conv4d_pallas import conv4d_pallas
from patch2pix_tpu_torch.models.ncn import NeighConsensus
from patch2pix_tpu_torch.ops.conv4d import conv4d, conv4d_route, conv4d_transpose_symmetric
from patch2pix_tpu_torch.ops.conv4d_small import (
    banded_filter,
    conv4d_small,
    conv4d_small_plain,
    mma_dims,
    mma_fragments,
    staging_mode,
)
from patch2pix_tpu_torch.utils.jax_import import ncn_state_dict_from_jax
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

# the package re-exports a function named conv4d over the module
jconv = importlib.import_module("patch2pix_tpu.ops.conv4d")

CASES = [(3, 3), (3, 4), (4, 3), (4, 4), (3, 5)]


def _inputs(seed, dims, cin, cout):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(dims + (cin,)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    return x, w, b


def assert_within_bf16_ulp(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want) / ulp)


@pytest.mark.parametrize("dims", [(2, 4, 6, 4, 6), (1, 3, 5, 6, 4)],
                         ids=["square", "asymmetric"])
@pytest.mark.parametrize("cin,cout", CASES)
def test_forward_matches_pallas_and_conv4d(cin, cout, dims):
    x, w, b = _inputs(cin * 100 + cout, dims, cin, cout)
    got = conv4d_small(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == dims + (cout,)
    jx, jw, jb = jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)
    np.testing.assert_allclose(got.numpy(), np.asarray(conv4d_pallas(jx, jw, jb, interpret=True)),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jconv.conv4d(jx, jw, jb)),
                               rtol=0, atol=1e-4)
    # the port's dispatcher sends these CPU tensors to the plain version
    before = conv4d_small.launches
    routed = conv4d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    assert torch.equal(routed, got) and conv4d_small.launches == before


@pytest.mark.parametrize("cin,cout", [(3, 4), (4, 4)])
def test_forward_bf16_matches_pallas(cin, cout):
    """bf16 input, the filter rounded to bf16: bf16 and float32 outputs."""
    x, w, b = _inputs(7, (2, 3, 4, 5, 4), cin, cout)
    xt = torch.from_numpy(x).bfloat16()
    jx = jnp.asarray(x, jnp.bfloat16)
    for od_t, od_j in ((torch.bfloat16, jnp.bfloat16), (None, None)):
        got = conv4d_small(xt, torch.from_numpy(w), torch.from_numpy(b), out_dtype=od_t)
        want = conv4d_pallas(jx, jnp.asarray(w), jnp.asarray(b), interpret=True,
                             out_dtype=od_j)
        if od_t is None:
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
        else:
            assert got.dtype == torch.bfloat16
            assert_within_bf16_ulp(got.float().numpy(), np.asarray(want, np.float32))


def test_transpose_symmetric_matches_jax():
    x, w, b = _inputs(11, (1, 4, 3, 5, 6), 4, 3)
    got = conv4d_transpose_symmetric(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(b))
    want = jconv.conv4d_transpose_symmetric(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("cin,cout,route", [
    (1, 16, "fold_in"), (2, 2, "fold_in"), (16, 1, "fold_out"), (3, 2, "fold_out"),
    (3, 3, "small"), (3, 4, "small"), (3, 5, "small"), (4, 3, "small"), (4, 4, "small"),
    (5, 3, "small"), (4, 5, "xla_taps"), (3, 6, "xla_taps"), (16, 16, "xla_taps"),
])
def test_dispatch_route(cin, cout, route):
    """The JAX dispatch order: fold-in, fold-out, then B4 (the kernel on
    a CUDA tensor, its plain version on a CPU tensor), else per-tap."""
    for dev in ("cuda", "cpu"):
        want = route if route != "small" else ("small_kernel" if dev == "cuda" else "small_plain")
        assert conv4d_route(3, cin, cout, dev) == want
    assert conv4d_route(5, cin, cout, "cuda") == "xla_taps"


@pytest.mark.parametrize("with_bias", [True, False])
def test_vjp_matches_jax(with_bias):
    x, w, b = _inputs(5, (1, 3, 4, 5, 4), 4, 3)
    g = np.random.default_rng(6).standard_normal((1, 3, 4, 5, 4, 3)).astype(np.float32)
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    out = conv4d_small(xt, wt, bt if with_bias else None)
    out.backward(torch.from_numpy(g))

    def f(x_, w_, b_):
        return conv4d_pallas(x_, w_, b_ if with_bias else None, interpret=True)

    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    dx, dw, db = vjp(jnp.asarray(g))
    for got, want in ((xt.grad, dx), (wt.grad, dw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    if with_bias:
        np.testing.assert_allclose(bt.grad.numpy(), np.asarray(db), rtol=1e-5, atol=1e-4)
    else:
        assert bt.grad is None


def test_ncn_441_matches_jax():
    """NeighConsensus (4, 4, 1): fold-in 1->4, B4 4->4, fold-out 4->1
    with B1, symmetric, float32; rtol/atol 1e-5 relative to the output
    scale."""
    rng = np.random.default_rng(12)
    channels, cin, params = (4, 4, 1), 1, {}
    for li, cout in enumerate(channels):
        params[f"conv{li}_kernel"] = (rng.standard_normal((3, 3, 3, 3, cin, cout))
                                      * 0.15).astype(np.float32)
        params[f"conv{li}_bias"] = (rng.standard_normal((cout,)) * 0.05).astype(np.float32)
        cin = cout
    corr = rng.standard_normal((2, 4, 5, 4, 3)).astype(np.float32)
    ncn = NeighConsensus(kernel_sizes=(3, 3, 3), channels=channels, device="cpu")
    ncn.load_state_dict(ncn_state_dict_from_jax(params))
    before = conv4d_small.launches
    with torch.no_grad():
        got = ncn(torch.from_numpy(corr)).numpy()
    assert conv4d_small.launches == before
    want = np.asarray(JaxNCN(kernel_sizes=(3, 3, 3), channels=channels).apply(
        {"params": {k: jnp.asarray(v) for k, v in params.items()}}, jnp.asarray(corr)))
    assert got.shape == want.shape == corr.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def _band_conv(x, w, b):
    """The bf16 kernel's arithmetic in float32: for each outer tap, the
    im2col'd rows (4 input rows, 3 dl, channels padded) of every output
    row pair (k, k+1) and 16 columns l, times the banded filter."""
    bs, h1, w1, h2, w2, cin = x.shape
    cout = w.shape[-1]
    cinp, ks, _ = mma_dims(cin, cout)
    band = banded_filter(w)
    h2p = h2 + h2 % 2  # an odd h2 cuts the last row pair
    xp = F.pad(x, (0, cinp - cin, 1, 1, 1, 1 + h2p - h2, 1, 1, 1, 1))
    acc = 0
    for tap in range(9):
        di, dj = divmod(tap, 3)
        src = xp[:, di:di + h1, dj:dj + w1]
        a = torch.stack([torch.stack([src[:, :, :, r:r + h2p:2, dl:dl + w2] for dl in range(3)],
                                     dim=-2) for r in range(4)], dim=-3)
        a = a.reshape(bs, h1, w1, h2p // 2, w2, 12 * cinp)
        a = F.pad(a, (0, 16 * ks - 12 * cinp))
        acc = acc + torch.matmul(a, band[tap])[..., :2 * cout]
    out = acc.reshape(bs, h1, w1, h2p // 2, w2, 2, cout).permute(0, 1, 2, 3, 5, 4, 6)
    return out.reshape(bs, h1, w1, h2p, w2, cout)[:, :, :, :h2] + b


@pytest.mark.parametrize("cin,cout", [(3, 5), (4, 4), (5, 3)])
def test_banded_filter_matches_plain_and_pallas(cin, cout):
    """A bad band offset, pad or row-pair split shows here on the CPU."""
    dims = (1, 3, 4, 5, 6)  # odd h2
    x, w, b = _inputs(cin * 10 + cout, dims, cin, cout)
    got = _band_conv(*(torch.from_numpy(a) for a in (x, w, b))).numpy()
    assert got.shape == dims + (cout,)
    plain = conv4d_small_plain(*(torch.from_numpy(a) for a in (x, w, b))).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5)
    pallas = conv4d_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=0, atol=1e-5)


@pytest.mark.parametrize("cin,cout", [(3, 5), (4, 4), (5, 3)])
def test_mma_fragments_follow_the_register_layout(cin, cout):
    """mma.sync m16n8k16 B: register j of lane 4g + t holds rows
    16ks + 8j + 2t (low half) and + 1 (high half) of column 8nt + g."""
    _, w, _ = _inputs(cin + cout, (1,), cin, cout)
    band = banded_filter(torch.from_numpy(w)).bfloat16()
    bits = band.view(torch.int16).numpy().astype(np.uint16)
    frag = mma_fragments(band).numpy().astype(np.uint32)
    tap, ks, nt, j, lane = np.indices(frag.shape)
    k = 16 * ks + 8 * j + 2 * (lane % 4)
    n = 8 * nt + lane // 4
    np.testing.assert_array_equal(frag & 0xFFFF, bits[tap, k, n])
    np.testing.assert_array_equal(frag >> 16, bits[tap, k + 1, n])


def _nchw_view(x):
    """The NCHW-per-cell view of x (B, h1, w1, h2, w2, C): planar per cell
    in memory, channels-last in shape."""
    dims, c = x.shape[:5], x.shape[5]
    y = x.reshape(-1, *dims[3:], c).permute(0, 3, 1, 2).contiguous()
    return y.reshape(*dims[:3], c, *dims[3:]).permute(0, 1, 2, 4, 5, 3)


@pytest.mark.parametrize("layout,cin,mode", [
    ("channels_last", 4, 1),   # the fold-in's volume: one 8-byte load a position
    ("channels_last", 3, 0),   # 6-byte positions
    ("offset", 4, 0),          # 2 bytes off an 8-byte boundary
    ("nchw", 4, 0),            # the NCHW-per-cell view: one 2-byte load an element
])
def test_staging_mode(layout, cin, mode):
    dims = (1, 2, 3, 4, 6)
    x = torch.zeros(dims + (cin,), dtype=torch.bfloat16)
    if layout == "nchw":
        x = _nchw_view(x)
    elif layout == "offset":
        base = torch.zeros(x.numel() + 8, dtype=torch.bfloat16)
        off = (-base.data_ptr() % 8) // 2 + 1  # elements: 2 bytes past a boundary
        x = base[off:off + x.numel()].view(x.shape)
    assert staging_mode(x) == mode
