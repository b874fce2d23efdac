"""The port's CUDA kernels and CUDA path, on a CUDA card.

Every test takes the ``cuda`` fixture, which skips without a card. This
file imports neither JAX nor the JAX package, so it also runs where JAX
is absent (``--noconftest`` skips ``tests/conftest.py``, which imports
JAX):

    python -m pytest --noconftest tests/test_torch_card.py

Each kernel is held against its plain version on the card, at small
and ragged shapes (partial tiles, channel counts that are not a
multiple of 8, a t=1 pyramid level), to its kernel's tolerance: tap_sum
bit-identical, corr_pool atol 1e-4 on unit-norm features (bf16 up to
1024 channels, through the streamed instance beyond 384),
expand_scale_pair f32 rtol 1e-6 / bf16 bit for bit, except at patch
pixels whose inverse norm rounds to the neighbouring bf16 value (one in
10^4 at most; chip_smoke's ``expand_bf16_mismatch``), with corners
aligned to the cells and not, negative and at the superblock's edge, M
from 1, psize 6, 8 and 16, and rows off a 16-byte boundary; conv4d_small
(bf16 input on its tensor-core kernel, at ragged tiles and strips, h1 or
w1 of 1, odd h2, both input layouts, with and without bias) float32
atol 1e-4, bf16 output within one bf16 ulp + 1e-5 (a sum that
cancels to near zero keeps the float32 rounding of its terms), its backward
through the kernel against the CPU's to rtol 1e-5 / atol 1e-4;
expand_level bit-identical (C from 1 to 256, M from 1 to 2400, every
tile side, rows off a 16-byte boundary); fused_fine_head float32 rtol/atol 2e-4,
bf16 within two bf16 ulps + 1e-3 (a float32 sum rounded either way of a
midpoint moves a BN0 output by one ulp; chip_smoke's ``bf16_ulps``),
at M from 1 to 2399, F 64 to 512 and corners at the superblock's edges.
The backward passes of B1-B3: the gradients through the kernel route
are ``torch.equal`` to autograd's through the plain version (the same
plain code runs in both), in f32 and bf16, with non-contiguous upstream
gradients and an odd M for B3. B5 and B7, which have no backward,
refuse inputs that require grad while grad mode is on. The whole
pipeline on the card (f32, TF32 off), and one training step, are held
against the same model on the CPU, which runs the plain versions.
``prefetch_to_device`` delivers the host batch on the consumer's stream,
and a bf16 train step with ``backbone_train_bn`` launches B1-B3. The
NCNet family's paths (ImMatchNet with VGG16, relocalisation 0 and 2;
the ResNet101 coarse matcher through B2 at 1024 channels) on the card
are held against the CPU in f32. The 5-point, 8-point and PnP RANSACs on
the card agree with the CPU's on the same sample ids (chip_smoke's
phase 13 scene at 1200 correspondences: inlier masks within 0.5% of
rows, R within 0.05 deg, t within 0.1 deg), and degenerate inputs (0, 3
or 5 valid rows, a point set on one line) do not raise there. One
Schur BA step (``sfm/ba.py``, padded and not) on the card agrees with
the CPU's by chip_smoke's phase 14 rules (old cost rtol 1e-5, new cost
rtol 1e-3, R and t atol 1e-5; points atol 1e-4).
"""

import json
import os

import numpy as np
import pytest
import torch

from chip_smoke import (
    RANSACS,
    bf16_ulps,
    dir_deg,
    expand_bf16_mismatch,
    hold_ba_step,
    ransac_scene,
    rot_deg,
)
from patch2pix_tpu_torch.config import ModelConfig, OptimConfig, RegressorConfig
from patch2pix_tpu_torch.data.synthetic import synthetic_batch
from patch2pix_tpu_torch.models.immatch_net import ImMatchNet
from patch2pix_tpu_torch.models.patch2pix import Patch2Pix
from patch2pix_tpu_torch.ops.conv4d_small import conv4d_small, conv4d_small_plain
from patch2pix_tpu_torch.ops.corr_pool import corr_pool, corr_pool_backward, corr_pool_plain
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
    expand_scale_pair_backward,
    expand_scale_pair_plain,
)
from patch2pix_tpu_torch.ops.tap_sum import tap_sum, tap_sum_backward, tap_sum_plain
from patch2pix_tpu_torch.sfm.ba import ba_step, build_problem
from patch2pix_tpu_torch.sfm.fivepoint import ransac_essential_5pt
from patch2pix_tpu_torch.sfm.scale_demo import make_ba_scene, perturb_points
from patch2pix_tpu_torch.sfm.twoview import draw_sample_ids
from patch2pix_tpu_torch.train import create_train_state, make_train_step
from patch2pix_tpu_torch.utils.torch_import import load_ncnet_checkpoint
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
    # bf16 beyond 384 channels: the streamed instance (panel K blocks
    # through the ring), ragged and at ResNet50/101's layer3 width
    (2, 18, 26, 22, 30, 512), (1, 10, 14, 6, 70, 448), (2, 24, 32, 24, 32, 1024),
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


@pytest.mark.parametrize("dims,with_bias", [
    # ragged (k, l) tiles, w1 = 5 a strip shorter than the bf16 kernel's
    # (7 cells at this w1), h2 odd (the last output row pair cut)
    ((2, 3, 5, 11, 37), True),
    ((1, 1, 6, 9, 20), False),  # h1 = 1: only the middle row of outer taps
    ((2, 4, 1, 17, 33), True),  # w1 = 1: one cell a strip, a 1-row second tile
    # three (k, l) tiles each way; w1 = 17 is a strip of 16 cells and one of 1
    ((1, 3, 17, 35, 68), False),
], ids=["ragged", "h1_1", "w1_1", "tiles"])
@pytest.mark.parametrize("odtype", [None, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout", [(3, 3), (3, 4), (3, 5), (4, 3), (4, 4), (5, 3)])
def test_conv4d_small_matches_plain(cuda, cin, cout, dtype, odtype, dims, with_bias):
    rs = _rs(5)
    x = torch.from_numpy(rs.standard_normal(dims + (cin,)).astype(np.float32)).to(cuda, dtype)
    w = torch.from_numpy((rs.standard_normal((3, 3, 3, 3, cin, cout)) * 0.1)
                         .astype(np.float32)).to(cuda)
    b = torch.from_numpy(rs.standard_normal(cout).astype(np.float32)).to(cuda)
    b = b if with_bias else None
    # channels-last (the volume the NCN's fold-in leaves), and an
    # NCHW-per-cell view
    nchw = x.reshape(-1, *dims[3:], cin).permute(0, 3, 1, 2).contiguous()
    nchw = nchw.reshape(*dims[:3], cin, *dims[3:]).permute(0, 1, 2, 4, 5, 3)
    # bf16 channels-last Cin 4 is staged a position at a time (8-byte loads)
    cl4 = int(dtype == torch.bfloat16 and cin == 4)
    for xin, mode in ((x, cl4), (nchw, 0)):
        n0, m0 = conv4d_small.launches, conv4d_small.mma_launches
        p0 = conv4d_small.channels_last_launches
        got = conv4d_small(xin, w, b, odtype)
        assert conv4d_small.launches == n0 + 1
        # bf16 input goes through the tensor-core kernel, float32 the SIMT one
        assert conv4d_small.mma_launches == m0 + (dtype == torch.bfloat16)
        assert conv4d_small.channels_last_launches == p0 + mode
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
@pytest.mark.parametrize("c", [1, 2, 3, 5, 8, 64, 128, 256])
@pytest.mark.parametrize("m", [1, 29, 2400])
def test_expand_level_bit_identical(cuda, dtype, c, m):
    """Cells of whole 16-byte units (16-byte copies), cells that are not
    and cells below 16 bytes (flat runs), at every tile side from t = 16
    (ds = 1) to t = 1, corners negative, 0, psize - 1 (a t + 1-cell
    window) and at the last tile of a 1024-wide map's padded corners; at
    M = 29 also rows off a 16-byte boundary."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(c * 10000 + m)
    edges = torch.tensor([-20, 0, PSIZE - 1, 1024 + PSIZE - 1], dtype=torch.int32)
    y0, x0 = (torch.randint(-20, 1024 + PSIZE, (m,), generator=gen, device=cuda,
                            dtype=torch.int32) for _ in range(2))
    y0[:4], x0[:4] = edges[:m].to(cuda), edges.roll(1)[:m].to(cuda)
    for t in (16, 8, 4, 2, 1):
        rows = torch.randn((m, 4, t, t * c + 8), generator=gen, device=cuda).to(dtype)
        views = [rows[..., :t * c].contiguous()]
        if m == 29:
            views.append(rows.flatten()[1:1 + rows[..., :t * c].numel()].view(m, 4, t, t * c))
        for r in views:
            n0 = expand_level.launches
            got = expand_level(r, y0, x0, PSIZE)
            assert expand_level.launches == n0 + 1
            assert torch.equal(got, expand_level_plain(r, y0, x0, PSIZE)), (t, r.data_ptr() % 16)


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
    """B5 and B7 write through ctypes and have no backward, so their
    outputs carry no grad_fn: with grad mode on, an input that requires
    grad raises; under no_grad the same call runs the kernel."""
    rs = _rs(12)
    m = 3
    corners = [torch.from_numpy(rs.randint(0, 2 * PSIZE, (m,)).astype(np.int32))
               for _ in range(4)]
    args = list(_fine_head_args(rs, m, 64, torch.float32, corners, cuda))
    args[0] = [r.requires_grad_() for r in args[0]]
    rows = args[0][0]
    calls = [(expand_level, lambda: expand_level(rows, args[2], args[3], PSIZE)),
             (fused_fine_head, lambda: fused_fine_head(*args))]
    for fn, call in calls:
        n0 = fn.launches
        with pytest.raises(RuntimeError, match="backward"):
            call()
        assert fn.launches == n0
        with torch.no_grad():
            call()
        assert fn.launches == n0 + 1


def _backward_pair(kernel, plain, inputs, grads):
    """Gradients with respect to ``inputs`` through the kernel route and
    through autograd of the plain version, for the upstream ``grads``."""
    out = []
    for fn in (kernel, plain):
        xs = [x.detach().clone().requires_grad_() for x in inputs]
        outs = fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        out.append(torch.autograd.grad(outs, xs, grads))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,h1,w1,hw,cout", [(2, 8, 8, 24, 1), (1, 5, 7, 300, 2)])
def test_tap_sum_backward_kernel_route_equals_plain(cuda, dtype, bs, h1, w1, hw, cout):
    rs = _rs(13)
    n = bs * h1 * w1
    z = torch.from_numpy(rs.standard_normal((n, 9, cout * hw)).astype(np.float32)).to(cuda, dtype)
    bias = torch.from_numpy(rs.standard_normal(cout).astype(np.float32)).to(cuda)
    # a non-contiguous upstream gradient
    g = torch.from_numpy(rs.standard_normal((cout * hw, n)).astype(np.float32)).to(cuda).T
    n0, c0 = tap_sum.launches, tap_sum_backward.calls
    got, want = _backward_pair(lambda a, b: tap_sum(a, b, bs, h1, w1),
                               lambda a, b: tap_sum_plain(a, b, bs, h1, w1), (z, bias), (g,))
    assert tap_sum.launches == n0 + 1 and tap_sum_backward.calls == c0 + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ties", [False, True])
def test_corr_pool_backward_kernel_route_equals_plain(cuda, dtype, ties):
    f1 = _unit_feats(14, 2, 10, 12, 128)
    f2 = _unit_feats(15, 2, 8, 14, 128)
    if ties:  # a window of equal rows in both images
        f1[0, 2:4, 4:6] = f1[0, 2, 4].clone()
        f2[0, 0:2, 2:4] = f2[0, 0, 2].clone()
    f1, f2 = f1.to(cuda, dtype), f2.to(cuda, dtype)
    # a non-contiguous upstream gradient of the (2, 5, 6, 4, 7) output
    g = torch.from_numpy(_rs(16).standard_normal((2, 6, 5, 4, 7)).astype(np.float32))
    g = g.to(cuda).permute(0, 2, 1, 3, 4)
    n0, c0 = corr_pool.launches, corr_pool_backward.calls
    got, want = _backward_pair(corr_pool, corr_pool_plain, (f1, f2), (g,))
    assert corr_pool.launches == n0 + 1 and corr_pool_backward.calls == c0 + 1
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 7])
def test_expand_scale_pair_backward_kernel_route_equals_plain(cuda, dtype, m):
    levels = ((16, 3), (8, 64), (4, 64), (2, 128))
    rs = _rs(17)
    rows = [torch.from_numpy(rs.standard_normal((m, 4, t, t * c)).astype(np.float32))
            .to(cuda, dtype) for _ in range(2) for t, c in levels]
    corners = [torch.from_numpy(rs.randint(-4, 64 + PSIZE, (m,)).astype(np.int32)).to(cuda)
               for _ in range(4)]
    n = len(levels)

    def route(fn):
        return lambda *r: fn(r[:n], r[n:], *corners, PSIZE, dtype)

    outs = expand_scale_pair_plain(rows[:n], rows[n:], *corners, PSIZE, dtype)
    # non-contiguous upstream gradients: transposed pixel axes
    grads = tuple(torch.from_numpy(rs.standard_normal(o.shape).astype(np.float32))
                  .to(cuda, dtype).transpose(1, 2).contiguous().transpose(1, 2) for o in outs)
    n0, c0 = expand_scale_pair.launches, expand_scale_pair_backward.calls
    got, want = _backward_pair(route(expand_scale_pair), route(expand_scale_pair_plain),
                               rows, grads)
    assert expand_scale_pair.launches == n0 + 1
    assert expand_scale_pair_backward.calls == c0 + 1
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)


def test_train_step_on_card_matches_cpu(cuda):
    """One Patch2Pix train step (narrow regressors, 96x64, batch 2, f32,
    TF32 off) through B1-B3 on the card and their plain versions on the
    CPU, from the same weights and draw: metrics rtol 1e-3, regressor
    gradients within 1e-3 of their largest, frozen weights unchanged."""
    cfg = ModelConfig(change_stride=True, regressor=RegressorConfig(
        conv_dims=(64, 64), fc_dims=(64, 32))).resolved()
    cpu = Patch2Pix(cfg, device="cpu")
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in cpu.state_dict().items()}, seed=0)
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(_rs(0), 2, 64, 96).items()}
    rand = torch.from_numpy(_rs(1).uniform(size=(2, 2 * 4 * 6)).astype(np.float32))
    runs = []
    for dev in ("cpu", cuda):
        model = cpu if dev == "cpu" else Patch2Pix(cfg, device=dev)
        model.load_state_dict(sd)
        state = create_train_state(model, OptimConfig())
        step = make_train_step(model, state.optimizer, ksize=2, ptmax=8)
        counts = (tap_sum.launches, corr_pool.launches, expand_scale_pair.launches)
        _, met = step(state, {k: v.to(dev) for k, v in batch.items()}, rand=rand.to(dev))
        if dev != "cpu":
            assert all(a > b for a, b in zip(
                (tap_sum.launches, corr_pool.launches, expand_scale_pair.launches), counts))
        grads = {k: p.grad.cpu() for k, p in model.named_parameters() if p.grad is not None}
        runs.append(({k: float(v) for k, v in met.items()}, grads,
                     {k: v.cpu() for k, v in model.state_dict().items()}))
    (mc, gc, sc), (mg, gg, sg) = runs
    for k in mc:
        np.testing.assert_allclose(mg[k], mc[k], rtol=1e-3, atol=1e-5, err_msg=k)
    assert set(gg) == set(gc) and all(k.startswith("regress_") for k in gc)
    scale = max(float(g.abs().max()) for g in gc.values())
    for k in gc:
        torch.testing.assert_close(gg[k], gc[k], rtol=0, atol=1e-3 * scale)
    for k, v in sd.items():
        if k.startswith(("extract.", "ncn.")):
            assert torch.equal(sg[k], v) and torch.equal(sc[k], v), k


def test_wrappers_reject_bad_inputs(cuda):
    z = torch.zeros((8, 9, 4), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        tap_sum(z, torch.zeros(1, device=cuda), 1, 2, 4)
    f = torch.zeros((1, 4, 4, 8), device=cuda)
    with pytest.raises(ValueError):
        corr_pool(f, f.cpu())
    with pytest.raises(ValueError):
        corr_pool(f[:, :3], f)
    with pytest.raises(ValueError):  # unequal channel counts
        corr_pool(f, f[..., :4])
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


def test_prefetch_on_card_delivers_the_host_batch(cuda):
    """``prefetch_to_device`` on the card, consumed on a stream of the
    test's own: each tensor equals the host array it was staged from,
    lies on the card, and reads correctly on the consumer's stream
    (which waited on the side stream's copies)."""
    from patch2pix_tpu_torch.data.prefetch import prefetch_to_device

    rs = _rs(8)
    batches = [{"im1": rs.standard_normal((4, 320, 480, 3)).astype(np.float32),
                "F": rs.standard_normal((4, 3, 3)).astype(np.float32)} for _ in range(5)]
    consumer = torch.cuda.Stream()
    with torch.cuda.stream(consumer):
        got = []
        for b in prefetch_to_device(iter(batches), size=2, device=cuda):
            assert all(t.device.type == "cuda" for t in b.values())
            # work on the consumer's stream, read back after it finishes
            got.append({k: (t * 1.0).cpu() for k, t in b.items()})
    assert len(got) == 5
    for g, want in zip(got, batches):
        for k in want:
            assert torch.equal(g[k], torch.from_numpy(want[k])), k


def test_train_step_with_backbone_train_bn_launches_b1_to_b3(cuda):
    """One bf16 train step with ``backbone_train_bn`` (change_stride,
    128x192, batch 2, seeded weights, 64-wide regressors): B1, B2 and B3
    launch, the backbone's running averages move and its weights do
    not, the losses are finite."""
    reg = RegressorConfig(conv_dims=(64, 64), fc_dims=(64, 32))
    model = Patch2Pix(ModelConfig(change_stride=True, regressor=reg, dtype="bfloat16")
                      .resolved(), device=cuda)
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in model.state_dict().items()}, seed=0)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, OptimConfig(lr_init=5e-4))
    step = make_train_step(model, state.optimizer, ksize=2, ptmax=32, backbone_train_bn=True)
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in synthetic_batch(_rs(9), 2, 128, 192).items()}
    counts = (tap_sum.launches, corr_pool.launches, expand_scale_pair.launches)
    state, met = step(state, batch, generator=torch.Generator(device=cuda).manual_seed(0))
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(
        (tap_sum.launches, corr_pool.launches, expand_scale_pair.launches), counts)]
    assert launched == [2, 1, 2], launched
    assert all(torch.isfinite(v) for v in met.values())
    for k, v in model.state_dict().items():
        if k.startswith("extract.") and ".layer4." not in k and "num_batches" not in k:
            assert torch.equal(v, before[k]) != ("running" in k), k


@pytest.mark.parametrize("reloc", [0, 2])
def test_immatch_on_card_matches_cpu(cuda, reloc):
    """ImMatchNet (VGG16 pool4, NCN (3, 3, 3)/(10, 10, 1)) at 128x192,
    f32 (TF32 off), seeded weights: the card's volume within 1e-4 of its
    scale of the CPU's, the offsets equal; B1 twice a call."""
    models = [ImMatchNet(relocalization_k_size=reloc, device=d) for d in ("cpu", cuda)]
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in models[0].state_dict().items()},
                           seed=1)
    for m in models:
        load_ncnet_checkpoint(m, sd)
    rs = _rs(5)
    ims = [torch.from_numpy((rs.rand(1, 128, 192, 3).astype(np.float32) - 0.45) / 0.25)
           for _ in range(2)]
    with torch.no_grad():
        want, wdelta = models[0](*ims)
        n0 = tap_sum.launches
        got, delta = models[1](*(im.to(cuda) for im in ims))
        torch.cuda.synchronize()
    assert tap_sum.launches == n0 + 2
    scale = want.abs().max().item()
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4 * scale)
    if reloc:
        for g, w in zip(delta, wdelta):
            assert torch.equal(g.cpu(), w)


def test_resnet101_coarse_on_card_matches_cpu(cuda):
    """``Patch2Pix(backbone="ResNet101", change_stride=True,
    regressor=None).predict_coarse`` at 128x192, f32 (TF32 off): B2 on
    1024 channels and B1 twice; the match set equal to the CPU's,
    scores within 1e-4."""
    cfg = ModelConfig(backbone="ResNet101", change_stride=True, regressor=None).resolved()
    cpu, card = Patch2Pix(cfg, device="cpu"), Patch2Pix(cfg, device=cuda)
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in cpu.state_dict().items()}, seed=2)
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    cpu.load_state_dict(sd)
    card.load_state_dict(sd)
    rs = _rs(6)
    ims = [torch.from_numpy((rs.rand(2, 128, 192, 3).astype(np.float32) - 0.45) / 0.25)
           for _ in range(2)]
    want = cpu.predict_coarse(*ims, ksize=2)
    n0 = (tap_sum.launches, corr_pool.launches)
    got = card.predict_coarse(*(im.to(cuda) for im in ims), ksize=2)
    assert (tap_sum.launches - n0[0], corr_pool.launches - n0[1]) == (2, 1)
    assert torch.equal(got.coords.cpu(), want.coords) and torch.equal(got.valid.cpu(), want.valid)
    torch.testing.assert_close(got.scores.cpu(), want.scores, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", sorted(RANSACS))
def test_ransac_on_card_matches_cpu(cuda, name):
    fn, k, n, _ = RANSACS[name]
    scene = ransac_scene(7)
    a, b = (scene["X"], scene["p2"]) if name == "ransac_pnp" else (scene["p1"], scene["p2"])
    ids = draw_sample_ids(torch.Generator().manual_seed(1), torch.ones(len(a), dtype=torch.bool),
                          n, k)
    want = fn(None, a, b, n, scene["thres"], ids=ids)
    got = fn(None, a.to(cuda), b.to(cuda), n, scene["thres"], ids=ids.to(cuda))
    assert int((got.inliers.cpu() != want.inliers).sum()) <= len(a) // 200
    assert rot_deg(got.R.cpu(), want.R) < 0.05 and dir_deg(got.t.cpu(), want.t) < 0.1


@pytest.mark.parametrize("n_valid,collinear", [(0, False), (3, False), (5, False),
                                               (12, True)],
                         ids=["n0", "n3", "n5", "collinear"])
def test_ransac_5pt_degenerate_inputs_on_card_do_not_raise(cuda, n_valid, collinear):
    scene = ransac_scene(8)
    q1, q2 = torch.zeros(64, 2), torch.zeros(64, 2)
    if collinear:  # points on one 3D line: collinear in both views
        s = torch.linspace(-1, 1, n_valid)[:, None]
        X = torch.tensor([0.1, -0.2, 4.0]) + s * torch.tensor([0.5, 0.3, 1.0])
        Xc = X + torch.tensor([0.3, 0.1, 0.05])
        q1[:n_valid], q2[:n_valid] = X[:, :2] / X[:, 2:], Xc[:, :2] / Xc[:, 2:]
    else:
        q1[:n_valid], q2[:n_valid] = scene["p1"][:n_valid], scene["p2"][:n_valid]
    valid = torch.arange(64) < n_valid
    ids = draw_sample_ids(torch.Generator().manual_seed(2), valid, 256, 5)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    for res in (ransac_essential_5pt(None, q1.to(cuda), q2.to(cuda), 256, scene["thres"],
                                     valid.to(cuda), ids=ids.to(cuda)),
                ransac_essential_5pt(gen, q1.to(cuda), q2.to(cuda), 256, scene["thres"],
                                     valid.to(cuda))):
        torch.cuda.synchronize()
        assert res.R.shape == (3, 3) and not res.inliers.cpu()[~valid].any()


@pytest.mark.parametrize("bucket", [False, True])
def test_ba_step_on_card_matches_cpu(cuda, bucket):
    """One LM step of the Schur BA on a small bench_ba scene (40 cameras,
    2000 points, 6 observations a point, the points perturbed), on the card
    against the CPU: chip_smoke's phase 14 rules."""
    Rs, ts, X, ci, pi, uv = make_ba_scene(40, 2000, 6)
    args = (Rs, ts, perturb_points(X), ci, pi, uv)
    new_c, cn_c, co_c = ba_step(build_problem(*args, bucket=bucket, device="cpu"), 1e-3, 1e9,
                                False)
    new_g, cn_g, co_g = ba_step(build_problem(*args, bucket=bucket, device=cuda), 1e-3, 1e9,
                                False)
    hold_ba_step("ba_step", (new_g.Rs, new_g.ts, cn_g, co_g), (new_c.Rs, new_c.ts, cn_c, co_c))
    np.testing.assert_allclose(new_g.X.cpu().numpy(), new_c.X.numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("bucket", [False, True])
def test_ba_step_repeats_bit_for_bit_on_card(cuda, bucket):
    """The segment sums add each segment's rows in one order on the card,
    so two LM steps from the same problem are equal bit for bit (the padded
    problem repeats its pad camera and pad point in every pad row)."""
    Rs, ts, X, ci, pi, uv = make_ba_scene(40, 2000, 6)
    prob = build_problem(Rs, ts, perturb_points(X), ci, pi, uv, bucket=bucket, device=cuda)
    first, cn1, co1 = ba_step(prob, 1e-3, 1e9, False)
    for _ in range(3):
        again, cn2, co2 = ba_step(prob, 1e-3, 1e9, False)
        for a, b in ((first.Rs, again.Rs), (first.ts, again.ts), (first.X, again.X),
                     (cn1, cn2), (co1, co2)):
            assert torch.equal(a, b)
