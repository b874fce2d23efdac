"""The port's three kernels (``patch2pix_tpu_torch.ops``) against the
Pallas kernels they replace.

On the CPU each wrapper runs its plain PyTorch version; those are held
here against the JAX kernels, run as the JAX package's own tests run
them (Pallas in interpret mode, or their jnp formulation). Tolerances:

  * B1 tap_sum: exact in f32 (the same nine f32 adds in tap order);
  * B2 corr_pool: rtol 1e-5 (dot products summed in another order);
    its kernels' operand layout, fed through a plain matmul and a max
    over aligned groups of four rows, the same;
  * decode_delta_from_feats: exact, first max on ties;
  * B3 expand_scale_pair: f32 rtol 1e-6, bf16 one bf16 ulp (channel
    square-sums in another order), identical ``output_slice_map``; its
    kernel's plan (window geometry, shared-memory layout, divisions by
    multiply-shift) exact.

The kernels themselves run only on a CUDA card: tests/test_torch_card.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from patch2pix_tpu.ops.corr_pool_pallas import corr_pool_fused
from patch2pix_tpu.ops.corr_pool_pallas import (
    decode_delta_from_feats as jax_decode_delta_from_feats,
)
from patch2pix_tpu.ops.patch_expand_pallas import (
    expand_scale_pair_pallas,
    expand_scale_pair_xla,
)
from patch2pix_tpu.ops.patch_expand_pallas import output_slice_map as jax_slice_map
from patch2pix_tpu.ops.tap_sum_pallas import tap_sum_pallas, tap_sum_pallas_t
from patch2pix_tpu_torch.ops.corr_pool import (
    LAYOUTS,
    cell_parity_rows,
    corr_pool,
    corr_pool_plain,
    decode_delta_from_feats,
)
from patch2pix_tpu_torch.ops.patch_expand import (
    SMEM_LIMIT,
    _window_indices,
    expand_scale_pair,
    expand_scale_pair_plain,
    fast_div,
    output_slice_map,
    plan,
    window_extent,
    window_side,
)
from patch2pix_tpu_torch.ops.tap_sum import tap_sum, tap_sum_plain
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

PSIZE = 16
LEVELS = ((16, 3), (8, 64), (4, 64), (2, 128))  # (t, C) at feat_idx (0,1,2,3)


def assert_within_bf16_ulp(got, want):
    """|got - want| <= one bf16 ulp of ``want``, elementwise."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want) / ulp)


# ------------------------------------------------------------------ B1


def _tap_sum_inputs(rng):
    bs, h1, w1, h2, w2 = 2, 8, 8, 4, 6  # n = 128: the v2 kernel's lane unit
    n, hw = bs * h1 * w1, h2 * w2
    z = rng.standard_normal((n, 9, hw)).astype(np.float32)
    bias = np.float32(0.37)
    return z, bias, bs, h1, w1


def test_tap_sum_plain_matches_pallas_v1_and_v2(rng):
    z, bias, bs, h1, w1 = _tap_sum_inputs(rng)
    n, _, hw = z.shape
    got = tap_sum_plain(torch.from_numpy(z), torch.tensor([bias]), bs, h1, w1).numpy()

    v1 = np.asarray(tap_sum_pallas(
        jnp.asarray(z.transpose(1, 0, 2)), jnp.float32(bias), bs, h1, w1,
        interpret=True))
    np.testing.assert_array_equal(got, v1)

    p = w1 + 1
    p_right = (-(n + p)) % 128
    while p_right < p:
        p_right += 128
    zt = np.pad(z, ((p, p_right), (0, 0), (0, 0))).transpose(2, 1, 0)
    v2 = np.asarray(tap_sum_pallas_t(
        jnp.asarray(zt), jnp.float32(bias), bs, h1, w1, interpret=True))
    np.testing.assert_array_equal(got, v2.T)


def test_tap_sum_multi_channel_bias(rng):
    """cout=2: m = 2*hw columns, bias per channel block."""
    bs, h1, w1, hw = 1, 3, 4, 5
    n = bs * h1 * w1
    z = torch.from_numpy(rng.standard_normal((n, 9, 2 * hw)).astype(np.float32))
    bias = torch.tensor([0.5, -2.0])
    got = tap_sum_plain(z, bias, bs, h1, w1)
    want = tap_sum_plain(z, torch.zeros(2), bs, h1, w1)
    want[:, :hw] += 0.5
    want[:, hw:] -= 2.0
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ------------------------------------------------------------------ B2


def _unit_feats(seed, b, h, w, c):
    rs = np.random.RandomState(seed)
    f = rs.standard_normal((b, h, w, c)).astype(np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


@pytest.mark.parametrize("b,h1,w1,h2,w2,c", [(2, 8, 12, 8, 12, 128),
                                              (1, 6, 10, 10, 8, 128)])
def test_corr_pool_plain_matches_pallas(b, h1, w1, h2, w2, c):
    f1 = _unit_feats(0, b, h1, w1, c)
    f2 = _unit_feats(1, b, h2, w2, c)
    got = corr_pool_plain(torch.from_numpy(f1), torch.from_numpy(f2)).numpy()
    want = np.asarray(corr_pool_fused(jnp.asarray(f1), jnp.asarray(f2), True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout", sorted(LAYOUTS, key=str), ids=str)
@pytest.mark.parametrize("b,h1,w1,h2,w2,c", [(3, 6, 10, 10, 14, 20),   # 15 x 35 cells
                                              (3, 12, 18, 8, 22, 96)])  # 54 x 44 cells
def test_corr_pool_layout_matches_plain_and_pallas(layout, b, h1, w1, h2, w2, c):
    """The (pooled cell, parity) rows the CUDA kernels read, padded to
    their tiles: one matmul, then the max over each cell's four rows on
    both sides, is the pooled correlation."""
    rows1, rows2, chans, k_major = LAYOUTS[layout]
    f1 = _unit_feats(5, b, h1, w1, c)
    f2 = _unit_feats(6, b, h2, w2, c)
    a = cell_parity_rows(torch.from_numpy(f1), rows1, chans, k_major)
    m = cell_parity_rows(torch.from_numpy(f2), rows2, chans, k_major)
    if k_major:
        a, m = a.transpose(1, 2), m.transpose(1, 2)
    r1, r2 = a.shape[1], m.shape[1]
    assert r1 % rows1 == 0 and r2 % rows2 == 0 and a.shape[2] % chans == 0
    np1, np2 = (h1 // 2) * (w1 // 2), (h2 // 2) * (w2 // 2)
    pooled = torch.matmul(a, m.transpose(1, 2)).reshape(b, r1 // 4, 4, r2 // 4, 4)
    got = pooled.amax(dim=(2, 4))[:, :np1, :np2].reshape(b, h1 // 2, w1 // 2, h2 // 2, w2 // 2)
    want = corr_pool_plain(torch.from_numpy(f1), torch.from_numpy(f2))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    pallas = np.asarray(corr_pool_fused(jnp.asarray(f1), jnp.asarray(f2), True))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=1e-6)


def test_decode_delta_from_feats_matches_jax_with_ties():
    b, h, w, c = 2, 8, 10, 16
    f1 = _unit_feats(2, b, h, w, c)
    f2 = _unit_feats(3, b, h, w, c)
    # force ties: a whole window of identical rows in both images, so
    # every one of the 16 window products is equal -> first max (0,0,0,0)
    f1[0, 2:4, 4:6] = f1[0, 2, 4]
    f2[0, 4:6, 2:4] = f2[0, 4, 2]
    rs = np.random.RandomState(4)
    idx = [rs.randint(0, n, (b, 7)).astype(np.int32) for n in (h // 2, w // 2) * 2]
    idx[0][0, 0], idx[1][0, 0], idx[2][0, 0], idx[3][0, 0] = 1, 2, 2, 1
    got = decode_delta_from_feats(torch.from_numpy(f1), torch.from_numpy(f2),
                                  *(torch.from_numpy(i) for i in idx), 2)
    want = jax_decode_delta_from_feats(jnp.asarray(f1), jnp.asarray(f2),
                                       *(jnp.asarray(i) for i in idx), 2)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    assert [int(g[0, 0]) for g in got] == [0, 0, 0, 0]


# ------------------------------------------------------------------ B3


def _expand_inputs(rng, m, levels=LEVELS):
    rows = [[rng.standard_normal((m, 4, t, t * c)).astype(np.float32) for t, c in levels]
            for _ in range(2)]
    corners = [rng.integers(0, 64 + PSIZE, (m,)).astype(np.int32) for _ in range(4)]
    return rows, corners


# the card tests' level sets: the main path's, and a wider one down to a
# t=1 level, at psize 16 and 8
WIDE_LEVELS = ((8, 64), (4, 64), (2, 128), (1, 256))
_EXPAND_CASES = [pytest.param(dtype, levels, psize, id=dtype + tag)
                 for levels, psize, tag in ((LEVELS, 16, ""), (WIDE_LEVELS, 16, "-wide-p16"),
                                            (WIDE_LEVELS, 8, "-wide-p8"))
                 for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("dtype,levels,psize", _EXPAND_CASES)
def test_expand_plain_matches_xla(rng, dtype, levels, psize):
    rows, corners = _expand_inputs(rng, 6, levels)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    got = expand_scale_pair_plain(
        [torch.from_numpy(r).to(tdt) for r in rows[0]],
        [torch.from_numpy(r).to(tdt) for r in rows[1]],
        *(torch.from_numpy(c) for c in corners), psize, tdt)
    ds_list = [psize // t for t, _ in levels]
    want = expand_scale_pair_xla(
        [jnp.asarray(r, jdt) for r in rows[0]], [jnp.asarray(r, jdt) for r in rows[1]],
        *(jnp.asarray(c) for c in corners), psize, ds_list, jdt)
    cs = [c for _, c in levels]
    assert len(got) == len(want) == len(output_slice_map(ds_list, cs, psize))
    for g, wnt in zip(got, want):
        assert g.dtype == tdt and tuple(g.shape) == wnt.shape
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-6, atol=0)
        else:
            assert_within_bf16_ulp(g.float().numpy(), np.asarray(wnt, np.float32))
    assert output_slice_map(ds_list, cs, psize) == jax_slice_map(ds_list, cs, psize)


def test_expand_plain_matches_pallas_interpret(rng):
    rows, corners = _expand_inputs(rng, 5)
    got = expand_scale_pair_plain(
        [torch.from_numpy(r).to(torch.bfloat16) for r in rows[0]],
        [torch.from_numpy(r).to(torch.bfloat16) for r in rows[1]],
        *(torch.from_numpy(c) for c in corners), PSIZE, torch.bfloat16)
    want = expand_scale_pair_pallas(
        tuple(jnp.asarray(r, jnp.bfloat16) for r in rows[0]),
        tuple(jnp.asarray(r, jnp.bfloat16) for r in rows[1]),
        *(jnp.asarray(c) for c in corners), PSIZE,
        tuple(PSIZE // t for t, _ in LEVELS), jnp.bfloat16, True)
    for g, wnt in zip(got, want):
        assert_within_bf16_ulp(g.float().numpy(), np.asarray(wnt, np.float32))


def test_expand_negative_corners_count_as_zero(rng):
    rows, corners = _expand_inputs(rng, 4)
    r1 = [torch.from_numpy(r) for r in rows[0]]
    r2 = [torch.from_numpy(r) for r in rows[1]]
    c = [torch.from_numpy(x) for x in corners]
    neg = [x.clone() for x in c]
    neg[0][0], neg[3][1] = -7, -100
    c[0][0], c[3][1] = 0, 0
    for g, w in zip(expand_scale_pair_plain(r1, r2, *neg, PSIZE, torch.float32),
                    expand_scale_pair_plain(r1, r2, *c, PSIZE, torch.float32)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("psize", [8, 16])
def test_expand_window_extent_matches_window_indices(psize):
    """The kernel's window geometry: the span of the indices the plain
    version reads, inside the staged window, which stays inside the
    superblock."""
    base = torch.arange(-5, 5 * psize, dtype=torch.int32)
    for t in (t for t in (1, 2, 4, 8, 16) if psize % t == 0):
        idx = _window_indices(base, psize, psize // t)
        first, cells = window_extent(base, psize, t)
        assert torch.equal(first, idx.min(dim=1).values)
        assert torch.equal(cells, idx.max(dim=1).values - first + 1)
        w = window_side(t, psize)
        assert int(cells.max()) == w and int((first + w).max()) <= 2 * t


@pytest.mark.parametrize("elsize,smem", [(2, 44600), (4, 79416)])
def test_expand_plan_shared_memory(elsize, smem):
    """The main path's plan: bf16 fits below 48 KB (no opt-in needed),
    float32 takes dynamic shared memory. Regions in order, windows
    16-byte aligned with cell strides of an odd count of 16-byte units
    where cells are whole units."""
    a = plan(LEVELS, PSIZE, elsize)
    assert a.smem == smem
    end = 0
    for side in (0, 1):
        for lv, (t, c) in zip(a.lv, LEVELS):
            assert lv.win[side] == end and lv.win[side] % 16 == 0
            if c * elsize % 16 == 0:
                assert lv.vec and (lv.cstride * elsize // 16) % 2 == 1 and lv.cstride >= c
            else:
                assert not lv.vec and lv.cstride == c
            end += -(-lv.w ** 2 * lv.cstride * elsize // 16) * 16
    sq = end // 4
    for side in (0, 1):
        for lv in a.lv[:len(LEVELS)]:
            assert lv.sq[side] == sq
            sq += lv.w ** 2
    assert a.inv_off == 4 * sq and a.tab_off == a.inv_off + 8 * PSIZE ** 2
    assert a.geo_off == a.tab_off + 16 * len(LEVELS) * PSIZE
    assert a.smem == a.geo_off + 16 * len(LEVELS) <= SMEM_LIMIT
    assert [lv.ostride for lv in a.lv[:4]] == [3, 128, 128, 128]


def test_expand_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):  # more than 8 levels
        plan(((2, 64),) * 9, PSIZE, 2)
    with pytest.raises(ValueError):  # psize not a multiple of t
        plan(((16, 3),), 8, 2)
    with pytest.raises(ValueError):  # psize^2 > 4096
        plan(((1, 3),), 65, 2)
    with pytest.raises(ValueError):  # windows beyond the shared memory
        plan(((32, 64),) * 4, 64, 4)


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 9, 16, 17, 24, 81, 128, 255, 256, 4095])
def test_fast_div_exact(d):
    m, s = fast_div(d)
    assert 0 < m < 2 ** 32
    x = np.concatenate([np.arange(1 << 16, dtype=np.uint64),
                        np.random.default_rng(d).integers(0, 2 ** 31, 4096).astype(np.uint64),
                        np.array([2 ** 31 - 1], np.uint64)])
    got = (((x * np.uint64(m)) >> np.uint64(32)) + x) >> np.uint64(s)
    np.testing.assert_array_equal(got, x // np.uint64(d))


# ------------------------------------------------------------ wrappers


def test_wrappers_count_no_launch_on_cpu(rng):
    before = (tap_sum.launches, corr_pool.launches, expand_scale_pair.launches)
    z, bias, bs, h1, w1 = _tap_sum_inputs(rng)
    tap_sum(torch.from_numpy(z), torch.tensor([bias]), bs, h1, w1)
    f = torch.from_numpy(_unit_feats(0, 1, 4, 4, 8))
    corr_pool(f, f)
    rows, corners = _expand_inputs(rng, 2)
    expand_scale_pair([torch.from_numpy(r) for r in rows[0]],
                      [torch.from_numpy(r) for r in rows[1]],
                      *(torch.from_numpy(c) for c in corners), PSIZE, torch.float32)
    assert (tap_sum.launches, corr_pool.launches,
            expand_scale_pair.launches) == before
