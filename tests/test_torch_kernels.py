"""The port's three kernels (``patch2pix_tpu_torch.ops``) against the
Pallas kernels they replace.

On the CPU each wrapper runs its plain PyTorch version; those are held
here against the JAX kernels, run as the JAX package's own tests run
them (Pallas in interpret mode, or their jnp formulation). Tolerances:

  * B1 tap_sum: exact in f32 (the same nine f32 adds in tap order);
  * B2 corr_pool: rtol 1e-5 (dot products summed in another order);
  * decode_delta_from_feats: exact, first max on ties;
  * B3 expand_scale_pair: f32 rtol 1e-6, bf16 one bf16 ulp (channel
    square-sums in another order), identical ``output_slice_map``.

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
    corr_pool,
    corr_pool_plain,
    decode_delta_from_feats,
)
from patch2pix_tpu_torch.ops.patch_expand import (
    expand_scale_pair,
    expand_scale_pair_plain,
    output_slice_map,
)
from patch2pix_tpu_torch.ops.tap_sum import tap_sum, tap_sum_plain

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


def _expand_inputs(rng, m):
    rows = [[rng.standard_normal((m, 4, t, t * c)).astype(np.float32) for t, c in LEVELS]
            for _ in range(2)]
    corners = [rng.integers(0, 64 + PSIZE, (m,)).astype(np.int32) for _ in range(4)]
    return rows, corners


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expand_plain_matches_xla(rng, dtype):
    rows, corners = _expand_inputs(rng, 6)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    got = expand_scale_pair_plain(
        [torch.from_numpy(r).to(tdt) for r in rows[0]],
        [torch.from_numpy(r).to(tdt) for r in rows[1]],
        *(torch.from_numpy(c) for c in corners), PSIZE, tdt)
    ds_list = [PSIZE // t for t, _ in LEVELS]
    want = expand_scale_pair_xla(
        [jnp.asarray(r, jdt) for r in rows[0]], [jnp.asarray(r, jdt) for r in rows[1]],
        *(jnp.asarray(c) for c in corners), PSIZE, ds_list, jdt)
    assert len(got) == len(want) == 6
    for g, wnt in zip(got, want):
        assert g.dtype == tdt and tuple(g.shape) == wnt.shape
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=1e-6, atol=0)
        else:
            assert_within_bf16_ulp(g.float().numpy(), np.asarray(wnt, np.float32))
    cs = [c for _, c in LEVELS]
    assert output_slice_map(ds_list, cs, PSIZE) == jax_slice_map(ds_list, cs, PSIZE)


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
