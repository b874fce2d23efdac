"""The port's plain-PyTorch ops against ``patch2pix_tpu.ops``, float32.

Same numpy inputs through both packages. Index outputs (argmax
relocation, masks, gathers) must be equal; values agree to float32
rounding (rtol 1e-6 for elementwise math and gathers, 1e-5 where a
contraction is summed in another order).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from patch2pix_tpu.ops import correlation as jcorr
from patch2pix_tpu.ops import match_extract as jme
from patch2pix_tpu.ops import patch_gather as jpg
from patch2pix_tpu_torch.ops import correlation as tcorr
from patch2pix_tpu_torch.ops import match_extract as tme
from patch2pix_tpu_torch.ops import patch_gather as tpg
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

# the packages re-export a function named conv4d over the module
jconv = importlib.import_module("patch2pix_tpu.ops.conv4d")
tconv = importlib.import_module("patch2pix_tpu_torch.ops.conv4d")


def T(a):
    return torch.from_numpy(np.array(a))


FEAT_IDX = (0, 1, 2, 3)
DS = (1, 2, 2, 2, 2)
DIMS = (3, 64, 64, 128, 128)
PSIZE = 16


def close(got, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def test_correlation_ops(rng):
    f1 = rng.standard_normal((2, 6, 8, 16)).astype(np.float32)
    f2 = rng.standard_normal((2, 4, 10, 16)).astype(np.float32)
    n1, n2 = tcorr.l2_normalize(T(f1)), tcorr.l2_normalize(T(f2))
    close(n1, jcorr.l2_normalize(jnp.asarray(f1)))
    corr = tcorr.feat_correlation(n1, n2)
    jc = jcorr.feat_correlation(jnp.asarray(n1.numpy()), jnp.asarray(n2.numpy()))
    close(corr, jc, rtol=1e-5)
    close(tcorr.mutual_matching(corr), jcorr.mutual_matching(jnp.asarray(corr.numpy())),
          rtol=1e-5)
    close(tcorr.maxpool4d_values(corr, 2),
          jcorr.maxpool4d_values(jnp.asarray(corr.numpy()), 2), rtol=0, atol=0)


def test_decode_delta_at_matches_jax(rng):
    corr = rng.standard_normal((2, 6, 8, 4, 6)).astype(np.float32)
    corr[0, 2:4, 2:4, 0:2, 0:2] = 1.0  # a tied window -> first max
    idx = [rng.integers(0, n, (2, 9)).astype(np.int32) for n in (3, 4, 2, 3)]
    idx[0][0, 0], idx[1][0, 0], idx[2][0, 0], idx[3][0, 0] = 1, 1, 0, 0
    got = tcorr.decode_delta_at(T(corr), *(T(i) for i in idx), 2)
    want = jcorr.decode_delta_at(jnp.asarray(corr), *(jnp.asarray(i) for i in idx), 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert [int(g[0, 0]) for g in got] == [0, 0, 0, 0]


@pytest.mark.parametrize("source", ["none", "volume", "feats"])
def test_match_extraction_matches_jax(rng, source):
    f1 = rng.standard_normal((2, 8, 12, 32)).astype(np.float32)
    f2 = rng.standard_normal((2, 8, 10, 32)).astype(np.float32)
    f1 /= np.linalg.norm(f1, axis=-1, keepdims=True)
    f2 /= np.linalg.norm(f2, axis=-1, keepdims=True)
    pre = np.asarray(jcorr.feat_correlation(jnp.asarray(f1), jnp.asarray(f2)))
    if source == "none":
        corr, ksize, tdelta, jdelta = pre, 1, None, None
    else:
        corr, ksize = np.asarray(jcorr.maxpool4d_values(jnp.asarray(pre), 2)), 2
        if source == "volume":
            tdelta, jdelta = T(pre), jnp.asarray(pre)
        else:
            tdelta = ("feats", T(f1), T(f2))
            jdelta = ("feats", jnp.asarray(f1), jnp.asarray(f2))
    grid, scores, mutual = tme.corr_to_matches(T(corr), tdelta, ksize=ksize)
    jgrid, jscores, jmutual = jme.corr_to_matches(jnp.asarray(corr), jdelta, ksize=ksize)
    np.testing.assert_array_equal(grid.numpy(), np.asarray(jgrid))
    np.testing.assert_array_equal(mutual.numpy(), np.asarray(jmutual))
    close(scores, jscores, rtol=1e-5)
    nb = corr.shape[3] * corr.shape[4]
    for keep in (True, False):
        valid = tme.mutual_consistency_mask(mutual, nb, keep)
        jvalid = jme.mutual_consistency_mask(jnp.asarray(mutual.numpy()), nb, keep)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        for thres in (0.0, 0.5, 2.0):
            np.testing.assert_array_equal(
                tme.score_threshold_mask(valid, scores, thres).numpy(),
                np.asarray(jme.score_threshold_mask(
                    jnp.asarray(valid.numpy()), jnp.asarray(scores.numpy()), thres)))
    close(tme.grid_to_pixel(grid, 8), jme.grid_to_pixel(jnp.asarray(grid.numpy()), 8),
          rtol=0, atol=0)


@pytest.mark.parametrize("cin,cout", [(1, 16), (16, 1), (2, 2), (3, 4)])
def test_conv4d_matches_jax(rng, cin, cout):
    x = rng.standard_normal((2, 4, 5, 6, 3, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 3, cin, cout)) * 0.2).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    for tf, jf in ((tconv.conv4d, jconv.conv4d),
                   (tconv.conv4d_transpose_symmetric, jconv.conv4d_transpose_symmetric)):
        got = tf(T(x), T(w), T(b))
        want = jf(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        assert tuple(got.shape) == want.shape
        close(got, want, rtol=1e-5, atol=1e-5)


def test_fold_out_rounds_z_to_input_dtype(rng):
    """bf16: z is rounded to bf16 before the f32 tap-sum, as in JAX."""
    x = rng.standard_normal((1, 3, 4, 5, 4, 16)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 3, 16, 1)) * 0.2).astype(np.float32)
    got = tconv.conv4d_fold_out(T(x).bfloat16(), T(w).bfloat16())
    want = jconv.conv4d_fold_out(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    assert got.dtype == torch.float32
    close(got, want, rtol=2e-2, atol=2e-2)


def _make_feats(rng, h, w, b=2):
    feats, ds = [], 1
    for j, c in enumerate(DIMS):
        ds = ds * DS[j] if j > 0 else 1
        feats.append(rng.standard_normal((b, h // ds, w // ds, c)).astype(np.float32))
    return feats


def test_grid_gather_matches_jax(rng):
    feats = _make_feats(rng, 48, 64)
    g = np.stack([rng.integers(-1, 5, (2, 6)), rng.integers(-1, 4, (2, 6))], -1)
    pts = (g * PSIZE + PSIZE // 2).astype(np.float32)
    lv, inv = tpg.gather_local_patches_grid_levels(
        [T(f) for f in feats], T(pts), FEAT_IDX, DS, PSIZE)
    jlv, jinv = jpg.gather_local_patches_grid_levels(
        [jnp.asarray(f) for f in feats], jnp.asarray(pts), FEAT_IDX, DS, PSIZE)
    for a, b in zip(lv, jlv):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    close(inv, jinv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_gather_matches_jax(rng, dtype):
    h, w = 48, 64
    feats1, feats2 = _make_feats(rng, h, w), _make_feats(rng, h, w)
    coords = np.stack([rng.integers(-4, w + 4, (2, 7)), rng.integers(-4, h + 4, (2, 7)),
                       rng.integers(-4, w + 4, (2, 7)), rng.integers(-4, h + 4, (2, 7))],
                      -1).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tf1, tf2 = ([T(f).to(tdt) for f in fs] for fs in (feats1, feats2))
    tiles1 = tpg.make_padded_tiles_levels(tf1, FEAT_IDX, DS, PSIZE)
    jtiles1 = jpg.make_padded_tiles_levels([jnp.asarray(f, jdt) for f in feats1],
                                           FEAT_IDX, DS, PSIZE)
    for a, b in zip(tiles1, jtiles1):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
    got, smap = tpg.gather_scaled_patch_pairs_fused(
        tf1, tf2, T(coords), FEAT_IDX, DS, PSIZE, tdt, tiles1=tiles1)
    want, jsmap = jpg.gather_scaled_patch_pairs_fused(
        [jnp.asarray(f, jdt) for f in feats1], [jnp.asarray(f, jdt) for f in feats2],
        jnp.asarray(coords), FEAT_IDX, DS, PSIZE, jdt, use_pallas=False)
    assert smap == jsmap
    for a, b in zip(got, want):
        assert a.dtype == tdt and tuple(a.shape) == b.shape
        if dtype == "float32":
            close(a, b, rtol=1e-6, atol=0)
        else:
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(np.asarray(b, np.float32)),
                                                      1e-30))) - 7)
            assert np.all(np.abs(a.float().numpy() - np.asarray(b, np.float32)) <= ulp)


def test_untileable_gather_raises(rng):
    feats = [T(f) for f in _make_feats(rng, 40, 64)]  # 40 % 16 != 0
    pts = torch.zeros((2, 3, 4))
    with pytest.raises(NotImplementedError):
        tpg.gather_scaled_patch_pairs_fused(feats, feats, pts, FEAT_IDX, DS, PSIZE,
                                            torch.float32)


def test_block_gather_matches_jax(rng):
    """The per-pixel block gather at map sizes that are not multiples of
    16 (a 120x200 input), corners inside, across and beyond the edges."""
    h, w = 120, 200
    feats = _make_feats(rng, h, w)
    pts = np.stack([rng.integers(-12, w + 12, (2, 9)), rng.integers(-12, h + 12, (2, 9))],
                   -1).astype(np.float32)
    assert not tpg.tileable([T(f) for f in feats], PSIZE)
    lv, inv = tpg.gather_local_patches_levels([T(f) for f in feats], T(pts), FEAT_IDX, DS,
                                              PSIZE)
    jlv, jinv = jpg.gather_local_patches_levels([jnp.asarray(f) for f in feats],
                                                jnp.asarray(pts), FEAT_IDX, DS, PSIZE)
    assert len(lv) == len(jlv)
    for a, b in zip(lv, jlv):
        assert tuple(a.shape) == b.shape
        close(a, b)
    close(inv, jinv)


def test_corr_pool_guard_sends_wide_bf16_to_plain_route(rng):
    """bf16 features of any width satisfy ``corr_pool_supported`` (B2's
    streamed kernel takes C > 384, as the JAX kernel takes any C %
    128 == 0); ``coarse_corr`` on the CPU still equals the plain
    composition bit for bit. Odd sides, unequal channels and ksize != 2
    are refused."""
    from patch2pix_tpu_torch.config import ModelConfig
    from patch2pix_tpu_torch.models.patch2pix import Patch2Pix
    from patch2pix_tpu_torch.ops.corr_pool import corr_pool_supported

    f = [T(rng.standard_normal((1, 6, 8, 1024)).astype(np.float32)) for _ in range(2)]
    bf = [x.bfloat16() for x in f]
    assert corr_pool_supported(*bf, 2) and corr_pool_supported(*f, 2)
    assert corr_pool_supported(*(x[..., :512] for x in bf), 2)
    assert not corr_pool_supported(bf[0], bf[1][..., :512], 2)
    assert not corr_pool_supported(bf[0][:, :5], bf[1], 2)
    assert not corr_pool_supported(*bf, 3)
    torch.manual_seed(0)
    model = Patch2Pix(ModelConfig(dtype="bfloat16").resolved(), device="cpu")
    corr, delta4d = model.coarse_corr(*bf, ksize=2)
    assert delta4d[0] == "feats"  # the fused route
    n1, n2 = (tcorr.l2_normalize(x) for x in bf)
    want = tcorr.maxpool4d_values(tcorr.feat_correlation(n1, n2), 2)
    want = tcorr.mutual_matching(model.ncn(tcorr.mutual_matching(want)))
    torch.testing.assert_close(corr, want, rtol=0, atol=0)
