"""The port's small-channel conv4d (kernel B4) against the JAX package.

On the CPU ``conv4d_small`` runs its plain version; it is held against
``conv4d_pallas`` in interpret mode and against JAX ``conv4d``. The bf16
kernel's banded filter (``banded_filter``) multiplied out over im2col'd
rows, as the kernel multiplies it, is held to both in float32 to 1e-5,
and its B fragments (``mma_fragments``) to the m16n8k16 register layout
bit for bit; so is the Cin-1 kernel's, whose K holds the two rows of a
column as one pair. The dispatcher's route (the Cin-1 kernel for a bf16
first layer on the card without a gradient, the C -> C kernel for a
bf16 10 -> 10 or 16 -> 16 layer there, else the JAX order) and the
staging modes are held here too. The float32 kernel's unpaired band, multiplied out as
three TF32 products a product (``tf32_split``'s parts, lo read as the
tensor cores read it) and summed per outer tap in float32, is held to
both to 1e-5, where one TF32 product misses; its hi and lo fragments
(``tf32_fragments``) to the m16n8k8 TF32 register layout bit for bit;
its shared-memory plan (``TF32_PLAN``, ``tf32_smem_bytes``) to the
constants of ``csrc/conv4d.cu``.
Tolerances: float32 atol 1e-4 (the 81*cin products summed in another
order; the JAX interpret tests use the same bound); bf16 output within
one bf16 ulp (the float32 sums round either way of a bf16 midpoint);
the backward at float32 rtol 1e-5 / atol 1e-4. The kernel itself runs
only on a CUDA card: tests/test_torch_card.py.
"""

import importlib
import re
from pathlib import Path

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
    TF32_PLAN,
    banded_filter,
    conv4d_small,
    conv4d_small_plain,
    mma_dims,
    mma_fragments,
    staging_mode,
    tf32_fragments,
    tf32_smem_bytes,
)
from patch2pix_tpu_torch.ops.fine_stage import tf32_split
from patch2pix_tpu_torch.utils import profiling
from patch2pix_tpu_torch.utils.jax_import import ncn_state_dict_from_jax
from tests.test_torch_fine_stage import _cu_constants
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
    # the NCN's first layers (ImMatchNet's, the (4, 4, 1) NCN's), and Couts
    # after one channel that B4's Cin-1 kernel is not built for
    (1, 10, "fold_in"), (1, 4, "fold_in"), (1, 8, "fold_in"), (1, 1, "fold_in"),
    # the NCN's middle layers (ImMatchNet's, NCNet InLoc's), and C -> C
    # layers B4's C -> C kernel is not built for
    (10, 10, "xla_taps"), (16, 10, "xla_taps"), (12, 12, "xla_taps"),
])
def test_dispatch_route(cin, cout, route):
    """The JAX dispatch order: fold-in, fold-out, then B4 (the kernel on
    a CUDA tensor, its plain version on a CPU tensor), else per-tap; the
    route in float32 on either device, on the CPU in bf16, and wherever
    a gradient is wanted. Two exceptions in bf16 on the card where no
    gradient is wanted: a first layer (Cin 1, Cout 4, 10 or 16) takes
    B4's Cin-1 kernel instead of the fold-in, a middle layer (Cin = Cout,
    10 or 16) B4's C -> C kernel instead of the per-tap convs."""
    first_layer = cin == 1 and cout in (4, 10, 16)
    mid_layer = cin == cout and cin in (10, 16)
    for dev in ("cuda", "cpu"):
        for dtype in (torch.float32, torch.bfloat16):
            for grad in (False, True):
                card_bf16 = (dev, dtype, grad) == ("cuda", torch.bfloat16, False)
                if first_layer and card_bf16:
                    want = "first_layer_kernel"
                elif mid_layer and card_bf16:
                    want = "mid_layer_kernel"
                elif route == "small":
                    want = "small_kernel" if dev == "cuda" else "small_plain"
                else:
                    want = route
                assert conv4d_route(3, cin, cout, dev, dtype, grad) == want
        # float32 without a gradient by default
        assert conv4d_route(3, cin, cout, dev) == conv4d_route(3, cin, cout, dev,
                                                               torch.float32, False)
    assert conv4d_route(5, cin, cout, "cuda", torch.bfloat16) == "xla_taps"


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ncn_first_layer_counts_fold_in_on_cpu(dtype):
    """On the CPU the NCN's first layer stays the fold-in, in either
    type: a symmetric (16, 1) call counts two fold-ins and no Cin-1
    kernel under ``tracing()``, and nothing outside it."""
    ncn = NeighConsensus(channels=(16, 1), dtype=dtype, device="cpu")
    corr = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 3, 4, 3, 4))
                            .astype(np.float32))
    profiling.drain()
    with torch.no_grad():
        ncn(corr)
        assert profiling.drain()["counters"] == {}
        with profiling.tracing():
            ncn(corr)
    counters = profiling.drain()["counters"]
    assert counters.get("conv4d.fold_in") == 2
    assert "conv4d.first_layer_kernel" not in counters


def _band_conv(x, w, b, pairs=True, product=torch.matmul):
    """The kernels' arithmetic in float32: for each outer tap, the
    im2col'd rows (4 input rows, 3 dl, channels: padded to even where the
    bf16 kernel ``pairs`` them) of every output row pair (k, k+1) and 16
    columns l, times the banded filter by ``product``; the taps' sums
    added in float32."""
    bs, h1, w1, h2, w2, cin = x.shape
    cout = w.shape[-1]
    cinp, ks, _ = mma_dims(cin, cout, pairs)
    band = banded_filter(w, pairs)
    h2p = h2 + h2 % 2  # an odd h2 cuts the last row pair
    xp = F.pad(x, (0, cinp - cin, 1, 1, 1, 1 + h2p - h2, 1, 1, 1, 1))
    # K: (row r, dl, channel), channel fastest; bf16 at Cin 1: (row pair
    # h, dl, row 2h or 2h + 1), the two rows of a column one K pair
    rows = ([(2 * h + rr, dl) for h in range(2) for dl in range(3) for rr in range(2)]
            if pairs and cin == 1 else [(r, dl) for r in range(4) for dl in range(3)])
    acc = 0
    for tap in range(9):
        di, dj = divmod(tap, 3)
        src = xp[:, di:di + h1, dj:dj + w1]
        a = torch.stack([src[:, :, :, r:r + h2p:2, dl:dl + w2] for r, dl in rows], dim=-2)
        a = a.reshape(bs, h1, w1, h2p // 2, w2, 12 * cinp)
        a = F.pad(a, (0, band.shape[1] - 12 * cinp))
        acc = acc + product(a, band[tap])[..., :2 * cout]
    out = acc.reshape(bs, h1, w1, h2p // 2, w2, 2, cout).permute(0, 1, 2, 3, 5, 4, 6)
    return out.reshape(bs, h1, w1, h2p, w2, cout)[:, :, :, :h2] + b


@pytest.mark.parametrize("cin,cout", [(3, 5), (4, 4), (5, 3), (1, 4), (1, 10), (1, 16)])
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


@pytest.mark.parametrize("cin,cout", [(3, 5), (4, 4), (5, 3), (1, 4), (1, 10), (1, 16)])
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


def _tf32(x):
    """x as the tensor cores read a float32 register for a TF32 product:
    the 13 low mantissa bits cut."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _three_tf32(a, b):
    """The float32 kernel's product: A split in registers, the band by
    the wrapper, lo*hi' + hi*lo' + hi*hi' summed in float32."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    return (torch.matmul(_tf32(a_lo), b_hi) + torch.matmul(a_hi, _tf32(b_lo))
            + torch.matmul(a_hi, b_hi))


def _one_tf32(a, b):
    return torch.matmul(tf32_split(a)[0], tf32_split(b)[0])


@pytest.mark.parametrize("cin,cout", [(3, 5), (4, 4), (5, 3)])
def test_3xtf32_band_matches_plain_and_pallas(cin, cout):
    """The float32 kernel's arithmetic on the unpaired band (K 40 / 48 /
    64 for cin 3 / 4 / 5), odd h2: within 1e-5 of the plain version and
    of the Pallas kernel, ten times inside the card's 1e-4 rule."""
    dims = (1, 3, 4, 5, 6)
    x, w, b = _inputs(cin * 10 + cout + 1, dims, cin, cout)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    got = _band_conv(xt, wt, bt, pairs=False, product=_three_tf32).numpy()
    assert got.shape == dims + (cout,)
    np.testing.assert_allclose(got, conv4d_small_plain(xt, wt, bt).numpy(), rtol=0, atol=1e-5)
    pallas = conv4d_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=0, atol=1e-5)


@pytest.mark.parametrize("cin,cout", [(3, 5), (4, 4), (5, 3)])
def test_one_tf32_product_misses_the_float32_rule(cin, cout):
    """Why three: on the same inputs one TF32 product (hi*hi') errs
    beyond 1e-5, tens of times more than three."""
    x, w, b = _inputs(cin * 10 + cout + 1, (1, 3, 4, 5, 6), cin, cout)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    want = conv4d_small_plain(xt, wt, bt)
    one = (_band_conv(xt, wt, bt, pairs=False, product=_one_tf32) - want).abs().max().item()
    three = (_band_conv(xt, wt, bt, pairs=False, product=_three_tf32)
             - want).abs().max().item()
    assert one > max(1e-5, 20 * three), (one, three)


@pytest.mark.parametrize("cin,cout", [(3, 5), (4, 4), (5, 3)])
def test_tf32_fragments_follow_the_register_layout(cin, cout):
    """mma.sync m16n8k8 TF32 B: lane 4g + t holds b0 = (row 8ks + t, column
    8nt + g) and b1 = (row 8ks + t + 4, same column), hi then lo."""
    _, w, _ = _inputs(cin + cout, (1,), cin, cout)
    band = banded_filter(torch.from_numpy(w), pairs=False)
    assert band.shape[1:] == ({3: 40, 4: 48, 5: 64}[cin], 16 if cout > 4 else 8)
    hi, lo = (p.view(torch.int32).numpy() for p in tf32_split(band))
    frag = tf32_fragments(band)
    assert frag.dtype == torch.float32 and frag.is_contiguous()
    frag = frag.view(torch.int32).numpy()
    tap, ks, nt, lane, word = np.indices(frag.shape)
    k = 8 * ks + lane % 4 + 4 * (word % 2)
    n = 8 * nt + lane // 4
    np.testing.assert_array_equal(frag, np.where(word < 2, hi[tap, k, n], lo[tap, k, n]))


def test_tf32_plan_matches_the_kernels_constants():
    """TF32_PLAN and tf32_smem_bytes against csrc/conv4d.cu: the staged
    plane's rows and pitch, the ring, and DimsF's shared memory for every
    instance the kernel is built for (its formula evaluated here), which
    leaves room for two blocks an SM (228 KB, 1 KB of it reserved a
    block) and 16-byte aligned planes."""
    path = Path(conv4d_small.__code__.co_filename).parents[1] / "csrc" / "conv4d.cu"
    src, k = path.read_text(), _cu_constants(path)
    assert TF32_PLAN == {name: k[name] for name in TF32_PLAN}
    assert k["ROWS"] == k["MT"] + 2 and k["PITCH_F"] >= k["COLS"] == k["MW"] + 2
    body = re.search(r"struct DimsF \{(.*?)\};", src, re.S).group(1)
    dims = re.findall(r"static constexpr int (\w+) = ([^;]+);", body)
    cases = re.findall(r"F\((\d), (\d), (\d)\)", re.search(
        r"#define P2P_MMA_CASES\(F\)(.*?)\n\n", src, re.S).group(1))
    assert sorted({(int(a), int(b)) for a, b, _ in cases}) == [
        (3, 3), (3, 4), (3, 5), (4, 3), (4, 4), (5, 3)]
    for cin, cout, _ in cases:
        env = {**k, "CIN": int(cin), "COUT": int(cout)}
        for name, expr in dims:
            env[name] = eval(expr.replace("/", "//"), {"__builtins__": {}}, env)
        smem = tf32_smem_bytes(int(cin), int(cout))
        assert env["SMEM"] == smem
        assert (env["KS"], env["NT"]) == mma_dims(int(cin), int(cout), pairs=False)[1:]
        assert 2 * (smem + 1024) <= 233472 and env["NB"] * 512 % 16 == 0
    assert tf32_smem_bytes(4, 4) == 27648 + 39168


def _nchw_view(x):
    """The NCHW-per-cell view of x (B, h1, w1, h2, w2, C): planar per cell
    in memory, channels-last in shape."""
    dims, c = x.shape[:5], x.shape[5]
    y = x.reshape(-1, *dims[3:], c).permute(0, 3, 1, 2).contiguous()
    return y.reshape(*dims[:3], c, *dims[3:]).permute(0, 1, 2, 4, 5, 3)


@pytest.mark.parametrize("layout,cin,mode", [
    ("channels_last", 4, 1),   # the first layer's volume: one 8-byte load a position
    ("channels_last", 3, 0),   # 6-byte positions
    ("offset", 4, 0),          # 2 bytes off an 8-byte boundary
    ("nchw", 4, 0),            # the NCHW-per-cell view: one 2-byte load an element
    ("channels_last", 1, 2),   # the NCN's input: 16-byte loads of 8 positions along l
    ("offset", 1, 0),          # 2 bytes off a 16-byte boundary
    ("narrow", 1, 0),          # w2 7 of a row of 8: a load would cross the row's end
    ("strided", 1, 0),         # l stride 2
])
def test_staging_mode(layout, cin, mode):
    assert staging_mode(_staged(layout, cin, torch.bfloat16)) == mode


def _staged(layout, cin, dtype):
    """A (1, 2, 3, 4, w2, cin) input in ``layout``, w2 6 (8 at Cin 1);
    "offset": bf16 2 bytes past an 8-byte boundary (a 16-byte one at Cin
    1), float32 8 bytes past a 16-byte one; "narrow": the first w2 - 1
    positions of each row; "strided": every other position of rows of
    2 * w2."""
    dims = (1, 2, 3, 4, 8 if cin == 1 else 6)
    x = torch.zeros(dims + (cin,), dtype=dtype)
    if layout == "nchw":
        x = _nchw_view(x)
    elif layout == "narrow":
        x = x[:, :, :, :, :-1]
    elif layout == "strided":
        x = torch.zeros(dims[:4] + (2 * dims[4], cin), dtype=dtype)[:, :, :, :, ::2]
    elif layout == "offset":
        size = x.element_size()
        base = torch.zeros(x.numel() + 8, dtype=dtype)
        align = 16 if cin == 1 else 4 * size
        off = (-base.data_ptr() % align) // size + (1 if size == 2 else 2)
        x = base[off:off + x.numel()].view(x.shape)
    return x


@pytest.mark.parametrize("layout,cin,mode", [
    ("channels_last", 4, 1),   # the first layer's volume: one 16-byte load a position
    ("channels_last", 3, 0),   # 12-byte positions
    ("offset", 4, 0),          # 8 bytes off a 16-byte boundary (bf16's rule would take it)
    ("nchw", 4, 0),            # the NCHW-per-cell view: one 4-byte load an element
    ("channels_last", 1, 0),   # Cin 1 in float32: no kernel of B4 stages it by rows
])
def test_staging_mode_float32(layout, cin, mode):
    x = _staged(layout, cin, torch.float32)
    if layout == "offset":
        assert x.data_ptr() % 16 == 8
    assert staging_mode(x) == mode
