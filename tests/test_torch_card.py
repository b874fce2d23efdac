"""The port's CUDA kernels and CUDA path, on a CUDA card.

Every test takes the ``cuda`` fixture, which skips without a card. This
file imports neither JAX nor the JAX package, so it also runs where JAX
is absent (``--noconftest`` skips ``tests/conftest.py``, which imports
JAX):

    python -m pytest --noconftest tests/test_torch_card.py

Each kernel is held against its plain version on the card, at small
and ragged shapes (partial tiles, channel counts that are not a
multiple of 8, a t=1 pyramid level), to its kernel's tolerance: tap_sum
bit-identical, corr_pool atol 1e-4 on unit-norm features,
expand_scale_pair f32 rtol 1e-6 / bf16 bit for bit, except at patch
pixels whose inverse norm rounds to the neighbouring bf16 value (one in
10^4 at most; chip_smoke's ``expand_bf16_mismatch``), with corners
aligned to the cells and not, negative and at the superblock's edge, M
from 1, psize 6, 8 and 16, and rows off a 16-byte boundary; conv4d_small
float32 atol 1e-4, bf16 output within one bf16 ulp + 1e-5 (a sum that
cancels to near zero keeps the float32 rounding of its terms), its backward
through the kernel against the CPU's to rtol 1e-5 / atol 1e-4;
expand_level bit-identical; fused_fine_head float32 rtol/atol 2e-4,
bf16 within two bf16 ulps + 1e-3 (a float32 sum rounded either way of a
midpoint moves a BN0 output by one ulp; chip_smoke's ``bf16_ulps``),
at M from 1 to 2399, F 64 to 512 and corners at the superblock's edges.
B1-B3 refuse inputs that require grad while grad mode is on. The whole
pipeline on the card (f32, TF32 off) is held against the same model on
the CPU, which runs the plain versions.
"""

import json
import os

import numpy as np
import pytest
import torch

from chip_smoke import bf16_ulps, expand_bf16_mismatch
from patch2pix_tpu_torch.config import ModelConfig
from patch2pix_tpu_torch.models.patch2pix import Patch2Pix
from patch2pix_tpu_torch.ops.conv4d_small import conv4d_small, conv4d_small_plain
from patch2pix_tpu_torch.ops.corr_pool import corr_pool, corr_pool_plain
from patch2pix_tpu_torch.ops.fine_stage import (
    fused_fine_head,
    fused_fine_head_plain,
    head_prolog,
    segment_weights,
)
from patch2pix_tpu_torch.ops.patch_expand import (
    expand_level,
    expand_level_plain,
    expand_scale_pair,
    expand_scale_pair_plain,
)
from patch2pix_tpu_torch.ops.tap_sum import tap_sum, tap_sum_plain
from tests.ref_loader import seeded_state_dict

PSIZE = 16
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "pipeline_golden_cs.npz")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rs(seed):
    return np.random.RandomState(seed)


def _unit_feats(seed, b, h, w, c):
    f = _rs(seed).standard_normal((b, h, w, c)).astype(np.float32)
    return torch.from_numpy(f / np.linalg.norm(f, axis=-1, keepdims=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,h1,w1,hw,cout", [(2, 8, 8, 24, 1), (1, 5, 7, 300, 2)])
def test_tap_sum_bit_identical(cuda, dtype, bs, h1, w1, hw, cout):
    n = bs * h1 * w1
    z = torch.from_numpy(_rs(0).standard_normal((n, 9, cout * hw)).astype(np.float32))
    z = z.to(cuda, dtype)
    bias = torch.tensor([0.37, -1.5][:cout], device=cuda)
    n0 = tap_sum.launches
    got = tap_sum(z, bias, bs, h1, w1)
    assert tap_sum.launches == n0 + 1
    assert torch.equal(got, tap_sum_plain(z, bias, bs, h1, w1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h1,w1,h2,w2,c", [
    (2, 8, 12, 10, 6, 96), (1, 6, 70, 4, 36, 20),
    (2, 18, 26, 22, 30, 256),  # C of the main path, pooled grids ragged against every tile
    (2, 48, 64, 48, 64, 256),  # the upsample-16 main-path shape
])
def test_corr_pool_matches_plain(cuda, dtype, b, h1, w1, h2, w2, c):
    f1 = _unit_feats(1, b, h1, w1, c).to(cuda, dtype)
    f2 = _unit_feats(2, b, h2, w2, c).to(cuda, dtype)
    n0 = corr_pool.launches
    got = corr_pool(f1, f2)
    assert corr_pool.launches == n0 + 1
    torch.testing.assert_close(got, corr_pool_plain(f1, f2), rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("levels", [((16, 3), (8, 64), (4, 64), (2, 128)),
                                    ((8, 64), (4, 64), (2, 128), (1, 256))])
def test_expand_scale_pair_matches_plain(cuda, dtype, levels):
    rs, m = _rs(3), 37
    rows = [[torch.from_numpy(rs.standard_normal((m, 4, t, t * c)).astype(np.float32))
             .to(cuda, dtype) for t, c in levels] for _ in range(2)]
    # a few negative corners: they count as 0 in both versions
    corners = [torch.from_numpy(rs.randint(-20, 80, (m,)).astype(np.int32)).to(cuda)
               for _ in range(4)]
    n0 = expand_scale_pair.launches
    got = expand_scale_pair(rows[0], rows[1], *corners, PSIZE, dtype)
    assert expand_scale_pair.launches == n0 + 1
    want = expand_scale_pair_plain(rows[0], rows[1], *corners, PSIZE, dtype)
    assert [g.shape for g in got] == [w.shape for w in want]
    if dtype == torch.float32:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
    else:
        flipped, pixels, _ = expand_bf16_mismatch(got, want, levels, PSIZE)
        assert flipped * 1e4 <= pixels


MAIN_LEVELS = ((16, 3), (8, 64), (4, 64), (2, 128))
WIDE_LEVELS = ((8, 64), (4, 64), (2, 128), (1, 256))


def _expand_corners(kind, m, psize, rs):
    """(y1, x1, y2, x2) padded corners: "aligned" multiples of psize (every
    window starts on a cell edge: t cells a side); "unaligned" odd (t + 1
    cells a side wherever ds > 1); "edges" 0, negatives (they count as 0),
    psize - 1 (the window ends on the superblock's last cell) and far
    corners, rolled so the four corners of a proposal differ."""
    if kind == "aligned":
        v = rs.randint(0, 6, (4, m)) * psize
    elif kind == "unaligned":
        v = rs.randint(0, 3 * psize, (4, m)) | 1
    else:
        edge = np.array([0, -3, psize - 1, -1000, 7 * psize - 1, 1, psize])
        v = np.stack([np.roll(edge, i)[np.arange(m) % len(edge)] for i in range(4)])
    return [torch.from_numpy(c.astype(np.int32)) for c in v]


def _check_expand(got, want, levels, psize, dtype):
    assert [g.shape for g in got] == [w.shape for w in want]
    if dtype == torch.float32:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
    else:
        flipped, pixels, _ = expand_bf16_mismatch(got, want, levels, psize)
        assert flipped * 1e4 <= pixels


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,psize,levels,kind", [
    (1, 16, MAIN_LEVELS, "edges"),
    (7, 16, MAIN_LEVELS, "edges"),
    (33, 16, MAIN_LEVELS, "aligned"),
    (33, 16, MAIN_LEVELS, "unaligned"),
    (9, 8, WIDE_LEVELS, "edges"),
    (21, 8, WIDE_LEVELS, "unaligned"),
    # cells of 20 and 24 channels: whole 16-byte units or not, by dtype
    (5, 8, ((8, 3), (4, 20), (2, 24)), "edges"),
    # psize 6: a proposal's per-side run of a 3- or 20-channel level is
    # not a whole number of 16-byte units (unaligned heads and tails)
    (5, 6, ((6, 3), (3, 20)), "edges"),
])
def test_expand_scale_pair_windows(cuda, dtype, m, psize, levels, kind):
    rs = _rs(9)
    rows = [[torch.from_numpy(rs.standard_normal((m, 4, t, t * c)).astype(np.float32))
             .to(cuda, dtype) for t, c in levels] for _ in range(2)]
    corners = [c.to(cuda) for c in _expand_corners(kind, m, psize, rs)]
    n0 = expand_scale_pair.launches
    got = expand_scale_pair(rows[0], rows[1], *corners, psize, dtype)
    assert expand_scale_pair.launches == n0 + 1
    _check_expand(got, expand_scale_pair_plain(rows[0], rows[1], *corners, psize, dtype),
                  levels, psize, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expand_scale_pair_unaligned_rows(cuda, dtype):
    """Rows that start off a 16-byte boundary are staged value by value."""
    rs, m = _rs(10), 6
    rows = [[torch.from_numpy(rs.standard_normal((m, 4, t, t * c)).astype(np.float32))
             .to(cuda, dtype) for t, c in MAIN_LEVELS] for _ in range(2)]
    for side in rows:
        r = side[1]
        buf = torch.empty(r.numel() + 1, device=cuda, dtype=dtype)
        side[1] = buf[1:].view(r.shape)
        side[1].copy_(r)
        assert side[1].data_ptr() % 16
    corners = [c.to(cuda) for c in _expand_corners("edges", m, PSIZE, rs)]
    got = expand_scale_pair(rows[0], rows[1], *corners, PSIZE, dtype)
    _check_expand(got, expand_scale_pair_plain(rows[0], rows[1], *corners, PSIZE, dtype),
                  MAIN_LEVELS, PSIZE, dtype)


def test_expand_scale_pair_rejects_bad_inputs(cuda):
    r = torch.zeros((2, 4, 8, 8 * 64), device=cuda, dtype=torch.bfloat16)
    c = [torch.zeros(2, device=cuda, dtype=torch.int32)] * 4
    n0 = expand_scale_pair.launches
    with pytest.raises(ValueError):  # the two sides' rows differ in shape
        expand_scale_pair([r], [torch.zeros_like(r[:, :, :4, :4 * 64])], *c, PSIZE, r.dtype)
    with pytest.raises(ValueError):  # the two sides have different level counts
        expand_scale_pair([r, r], [r], *c, PSIZE, r.dtype)
    with pytest.raises(ValueError):  # no level
        expand_scale_pair([], [], *c, PSIZE, r.dtype)
    with pytest.raises(ValueError):  # more than 8 levels
        expand_scale_pair([r] * 9, [r] * 9, *c, PSIZE, r.dtype)
    wide = torch.zeros((2, 4, 32, 32 * 64), device=cuda)
    with pytest.raises(ValueError):  # the windows exceed a block's shared memory
        expand_scale_pair([wide] * 4, [wide] * 4, *c, 64, wide.dtype)
    assert expand_scale_pair.launches == n0


@pytest.mark.parametrize("odtype", [None, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout", [(3, 3), (3, 4), (3, 5), (4, 3), (4, 4), (5, 3)])
def test_conv4d_small_matches_plain(cuda, cin, cout, dtype, odtype):
    rs = _rs(5)
    dims = (2, 3, 5, 11, 37)  # ragged (k, l) tiles
    x = torch.from_numpy(rs.standard_normal(dims + (cin,)).astype(np.float32)).to(cuda, dtype)
    w = torch.from_numpy((rs.standard_normal((3, 3, 3, 3, cin, cout)) * 0.1)
                         .astype(np.float32)).to(cuda)
    b = torch.from_numpy(rs.standard_normal(cout).astype(np.float32)).to(cuda)
    # channels-last, and the NCHW-per-cell view the NCN's fold-in leaves
    nchw = x.reshape(-1, *dims[3:], cin).permute(0, 3, 1, 2).contiguous()
    nchw = nchw.reshape(*dims[:3], cin, *dims[3:]).permute(0, 1, 2, 4, 5, 3)
    for xin in (x, nchw):
        n0 = conv4d_small.launches
        got = conv4d_small(xin, w, b, odtype)
        assert conv4d_small.launches == n0 + 1
        want = conv4d_small_plain(x, w, b, odtype)
        assert got.dtype == want.dtype and got.shape == want.shape
        if odtype is None:
            torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
        else:
            assert bf16_ulps(got.float(), want.float(), atol=1e-5).max() <= 1


def test_conv4d_small_backward_matches_cpu(cuda):
    rs = _rs(6)
    x, w, b = (rs.standard_normal(s).astype(np.float32) * sc for s, sc in
               (((1, 4, 5, 6, 4, 4), 1.0), ((3, 3, 3, 3, 4, 3), 0.1), ((3,), 1.0)))
    g = torch.from_numpy(rs.standard_normal((1, 4, 5, 6, 4, 3)).astype(np.float32))
    grads = []
    for dev in ("cpu", cuda):
        ts = [torch.from_numpy(a).to(dev).requires_grad_() for a in (x, w, b)]
        conv4d_small(*ts).backward(g.to(dev))
        grads.append([t.grad.cpu() for t in ts])
    for got, want in zip(grads[1], grads[0]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expand_level_bit_identical(cuda, dtype):
    rs, m = _rs(7), 29
    y0, x0 = (torch.from_numpy(rs.randint(-20, 80, (m,)).astype(np.int32)).to(cuda)
              for _ in range(2))
    for t, c in ((16, 3), (8, 64), (4, 64), (2, 128), (1, 256), (16, 1)):
        rows = torch.from_numpy(rs.standard_normal((m, 4, t, t * c)).astype(np.float32))
        rows = rows.to(cuda, dtype)
        n0 = expand_level.launches
        got = expand_level(rows, y0, x0, PSIZE)
        assert expand_level.launches == n0 + 1
        assert torch.equal(got, expand_level_plain(rows, y0, x0, PSIZE))


def _fine_head_args(rs, m, f, dtype, corners, cuda):
    """Seeded rows of the main levels, corners, a head of width f and its
    prolog: the arguments of fused_fine_head."""
    levels = ((16, 3), (8, 64), (4, 64), (2, 128))
    cs = [c for _, c in levels]
    rows = [[torch.from_numpy(rs.standard_normal((m, 4, t, t * c)).astype(np.float32))
             .to(cuda, dtype) for t, c in levels] for _ in range(2)]
    corners = [c.to(cuda) for c in corners]
    k0 = torch.from_numpy((rs.standard_normal((3, 3, 2 * sum(cs), f)) * 0.05)
                          .astype(np.float32)).to(cuda)
    k1 = torch.from_numpy((rs.standard_normal((3, 3, f, f)) * 0.05).astype(np.float32)).to(cuda)
    bn = [tuple(torch.from_numpy(a.astype(np.float32)).to(cuda)
                for a in (rs.uniform(0.5, 1.5, f), rs.uniform(-0.2, 0.2, f)))
          for _ in range(2)]
    inv1, inv2, partial0 = head_prolog(rows[0], rows[1], *corners, k0.to(dtype), PSIZE, dtype)
    return (rows[0][1:], rows[1][1:], *corners, inv1, inv2, partial0,
            segment_weights(k0, cs, dtype), k1.reshape(9, f, f).to(dtype), bn[0], bn[1],
            PSIZE, dtype)


def _check_fine_head(args, m, f, dtype):
    n0 = fused_fine_head.launches
    got = fused_fine_head(*args)
    assert fused_fine_head.launches == n0 + 1
    want = fused_fine_head_plain(*args)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape == (m, f)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        assert bf16_ulps(got.float(), want.float(), atol=1e-3).max() <= 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [64, 96])
def test_fused_fine_head_matches_plain(cuda, dtype, f):
    rs, m = _rs(8), 37
    corners = [torch.from_numpy(rs.randint(0, 2 * PSIZE, (m,)).astype(np.int32))
               for _ in range(4)]
    _check_fine_head(_fine_head_args(rs, m, f, dtype, corners, cuda), m, f, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,f,kind", [
    (1, 512, "edges"),        # one proposal: the block's second warpgroup has none
    (2399, 512, "unaligned"),  # an odd M at the fine stage's size
    (7, 64, "edges"),
    (9, 256, "aligned"),
    (33, 512, "edges"),
])
def test_fused_fine_head_shapes_and_edges(cuda, dtype, m, f, kind):
    """M = 1 and odd M (the last block's second proposal is missing), F
    below, at and above one 256-channel tile, and corners at the
    superblock's edges (0, negative, psize - 1, far)."""
    rs = _rs(11)
    args = _fine_head_args(rs, m, f, dtype, _expand_corners(kind, m, PSIZE, rs), cuda)
    _check_fine_head(args, m, f, dtype)


def test_fused_fine_head_rejects_bad_inputs(cuda):
    rs, m = _rs(12), 3
    corners = _expand_corners("edges", m, PSIZE, rs)
    args = list(_fine_head_args(rs, m, 64, torch.bfloat16, corners, cuda))
    n0 = fused_fine_head.launches
    bad_rows = [r[..., :-8].contiguous() for r in args[0]]  # channels that fit no weights
    with pytest.raises(ValueError):
        fused_fine_head(bad_rows, args[1], *args[2:])
    with pytest.raises(ValueError):  # one weight segment missing
        fused_fine_head(*args[:9], args[9][:-1], *args[10:])
    # a 16 x 16 x 64 level: its two windows (2 x 17^2 cells) exceed the
    # kernel's 62 KB of shared memory for them
    big = [torch.zeros((m, 4, 16, 16 * 64), device=cuda, dtype=torch.bfloat16)]
    with pytest.raises(ValueError):
        fused_fine_head(big, big, *args[2:9], [torch.zeros((9, 128, 64), device=cuda)],
                        *args[10:])
    assert fused_fine_head.launches == n0


def test_kernels_refuse_inputs_that_require_grad(cuda):
    """B1-B3 write through ctypes, so their outputs carry no grad_fn:
    with grad mode on, an input that requires grad raises; under no_grad
    the same call runs the kernel."""
    z = torch.zeros((8, 9, 4), device=cuda, requires_grad=True)
    bias = torch.zeros(1, device=cuda)
    f = _unit_feats(1, 1, 4, 4, 8).to(cuda).requires_grad_()
    rows = [torch.zeros((2, 4, 8, 8 * 64), device=cuda, requires_grad=True)]
    c = [torch.zeros(2, device=cuda, dtype=torch.int32)] * 4
    calls = [(tap_sum, lambda: tap_sum(z, bias, 1, 2, 4)),
             (corr_pool, lambda: corr_pool(f, f)),
             (expand_scale_pair,
              lambda: expand_scale_pair(rows, rows, *c, PSIZE, torch.float32))]
    for fn, call in calls:
        n0 = fn.launches
        with pytest.raises(RuntimeError, match="backward"):
            call()
        assert fn.launches == n0
        with torch.no_grad():
            call()
        assert fn.launches == n0 + 1


def test_wrappers_reject_bad_inputs(cuda):
    z = torch.zeros((8, 9, 4), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        tap_sum(z, torch.zeros(1, device=cuda), 1, 2, 4)
    f = torch.zeros((1, 4, 4, 8), device=cuda)
    with pytest.raises(ValueError):
        corr_pool(f, f.cpu())
    with pytest.raises(ValueError):
        corr_pool(f[:, :3], f)
    wide = torch.zeros((1, 4, 4, 392), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # beyond the bf16 kernel's resident panel
        corr_pool(wide, wide)
    x = torch.zeros((1, 2, 2, 3, 3, 4), device=cuda)
    with pytest.raises(ValueError):  # cin * cout > 16: not B4's range
        conv4d_small(x, torch.zeros((3, 3, 3, 3, 4, 5), device=cuda))
    with pytest.raises(TypeError):
        expand_level(torch.zeros((2, 4, 2, 2), device=cuda, dtype=torch.float64),
                     *(torch.zeros(2, device=cuda, dtype=torch.int32),) * 2, PSIZE)


@pytest.mark.parametrize("change_stride", [False, True])
def test_pipeline_on_card_matches_cpu(cuda, change_stride):
    meta = json.loads(str(np.load(FIXTURE, allow_pickle=True)["meta"]))
    sd = seeded_state_dict({k: tuple(s) for k, s in meta["shapes"].items()}, seed=0)
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    cfg = ModelConfig(change_stride=change_stride).resolved()
    cfg.regressor.panc = 1
    cpu, card = Patch2Pix(cfg, device="cpu"), Patch2Pix(cfg, device=cuda)
    cpu.load_state_dict(sd)
    card.load_state_dict(sd)
    rs = _rs(4)
    ims = [torch.from_numpy((rs.rand(1, 128, 192, 3).astype(np.float32) - 0.45) / 0.25)
           for _ in range(2)]
    counts = (tap_sum.launches, corr_pool.launches, expand_scale_pair.launches)
    want = cpu.predict_fine(*ims, ksize=2)
    got = card.predict_fine(*(im.to(cuda) for im in ims), ksize=2)
    assert all(a > b for a, b in zip(
        (tap_sum.launches, corr_pool.launches, expand_scale_pair.launches), counts))
    fine, mid, cm = ([t.cpu() for t in m] for m in got)
    wfine, wmid, wcm = want
    assert torch.equal(cm[2], wcm.valid) and torch.equal(cm[0], wcm.coords)
    valid = wcm.valid
    for g, w in ((mid, wmid), (fine, wfine)):
        torch.testing.assert_close(g[0][valid], w.coords[valid], rtol=0, atol=1e-3)
        torch.testing.assert_close(g[1][valid], w.scores[valid], rtol=0, atol=1e-4)
