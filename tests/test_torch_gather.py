"""The port's single-level patch gathers and ``gather="block"`` metas.

The same numpy pyramid and points (edge points, fractional points and
points beyond the image, both ``ptype``s) go through
``patch2pix_tpu.ops.patch_gather`` and the port. Tolerances:

  * the gathered values (every ``*_levels`` function's per-level
    patches) are copies: equal, bit for bit;
  * the L2-normalised hypercolumns and the ``inv_norm`` factors: rtol
    1e-6, the f32 square-sum and ``rsqrt`` rounding differently in XLA
    and in torch (one ulp seen);
  * within the port, every single-level gather gives the same tensor as
    the per-pixel oracle ``gather_local_patches_ref``, bit for bit.

Then a run directory whose meta says ``gather="block"`` (JAX's TPU
switch, which routes nothing in the port), written by the port's
``save_ckpt``, restores with the value kept, and its ``predict_fine``
(f32, upsample 16) equals the ``"auto"`` model's bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from patch2pix_tpu.ops import patch_gather as jpg
from patch2pix_tpu_torch.config import ModelConfig, OptimConfig, RegressorConfig
from patch2pix_tpu_torch.models.patch2pix import Patch2Pix
from patch2pix_tpu_torch.ops import patch_gather as tpg
from patch2pix_tpu_torch.train import create_train_state, read_meta, restore_for_eval, save_ckpt
from tests.ref_loader import seeded_state_dict
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

B, H, W, PSIZE = 2, 64, 96, 16
FEAT_IDX, DS = (0, 1, 2, 3), (1, 2, 2, 2, 2)
CHANNELS, STRIDES = (3, 8, 8, 16, 16), (1, 2, 4, 8, 16)
PTYPES = ("center", "topleft")


@pytest.fixture(scope="module")
def pyramid():
    rng = np.random.default_rng(0)
    feats = [rng.standard_normal((B, H // s, W // s, c)).astype(np.float32)
             for s, c in zip(STRIDES, CHANNELS)]
    pts = np.stack([rng.uniform(-12, W + 12, (B, 40)), rng.uniform(-12, H + 12, (B, 40))],
                   -1).astype(np.float32)
    # corners, the far edge (inclusive, as the matches are clamped) and
    # a fractional negative point that truncates towards zero
    pts[:, :5] = [[0, 0], [W - 0.5, H - 0.5], [W, H], [-1.5, 3.7], [15.99, 16.0]]
    return feats, pts


def _jit(fn, *static):
    """JAX's ``fn`` jitted over the features and the points, the rest
    static: one compile instead of eager op-by-op dispatch."""
    return jax.jit(lambda f, p: fn(f, p, *static))


def _both(feats, pts):
    return ([torch.from_numpy(f) for f in feats], torch.from_numpy(pts),
            [jnp.asarray(f) for f in feats], jnp.asarray(pts))


@pytest.mark.parametrize("ptype", PTYPES)
@pytest.mark.parametrize("name", ["gather_local_patches", "gather_local_patches_ref",
                                  "gather_local_patches_tiled"])
def test_single_level_gather_matches_jax(pyramid, name, ptype):
    tf, tp, jf, jp = _both(*pyramid)
    got = getattr(tpg, name)(tf, tp, FEAT_IDX, DS, PSIZE, ptype)
    want = np.asarray(_jit(getattr(jpg, name), FEAT_IDX, DS, PSIZE, ptype)(jf, jp))
    assert tuple(got.shape) == want.shape == (B, 40, PSIZE, PSIZE, sum(CHANNELS[:4]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    oracle = tpg.gather_local_patches_ref(tf, tp, FEAT_IDX, DS, PSIZE, ptype)
    assert torch.equal(got, oracle)


@pytest.mark.parametrize("ptype", PTYPES)
@pytest.mark.parametrize("name", ["gather_local_patches_tiled_levels",
                                  "gather_local_patches_levels"])
def test_per_level_gather_matches_jax(pyramid, name, ptype):
    tf, tp, jf, jp = _both(*pyramid)
    levels, inv = getattr(tpg, name)(tf, tp, FEAT_IDX, DS, PSIZE, ptype)
    jlevels, jinv = _jit(getattr(jpg, name), FEAT_IDX, DS, PSIZE, ptype)(jf, jp)
    assert len(levels) == len(jlevels) == len(FEAT_IDX)
    for a, b in zip(levels, jlevels):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(inv.numpy(), np.asarray(jinv), rtol=1e-6, atol=0)


def test_tiled_levels_take_prebuilt_tiles(pyramid):
    """``tiles=`` (built once per image) gives what building them does."""
    tf, tp, _, _ = _both(*pyramid)
    tiles = tpg.make_padded_tiles_levels(tf, FEAT_IDX, DS, PSIZE)
    a, _ = tpg.gather_local_patches_tiled_levels(tf, tp, FEAT_IDX, DS, PSIZE, tiles=tiles)
    b, _ = tpg.gather_local_patches_tiled_levels(tf, tp, FEAT_IDX, DS, PSIZE)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_grid_gather_matches_jax(pyramid):
    """Cell-centre points, inside and beyond the grid, against JAX's grid
    gather; inside it, the port's block gather gives it bit for bit."""
    feats, _ = pyramid
    rng = np.random.default_rng(1)
    pts = (rng.integers(-1, 7, (B, 12, 2)) * PSIZE + PSIZE // 2).astype(np.float32)
    pts[..., 1] = np.minimum(pts[..., 1], H - PSIZE // 2)
    tf, tp, jf, jp = _both(feats, pts)
    got = tpg.gather_local_patches_grid(tf, tp, FEAT_IDX, DS, PSIZE)
    want = np.asarray(_jit(jpg.gather_local_patches_grid, FEAT_IDX, DS, PSIZE)(jf, jp))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    inside = (tp >= 0).all(-1) & (tp[..., 0] < W) & (tp[..., 1] < H)
    block = tpg.gather_local_patches(tf, tp, FEAT_IDX, DS, PSIZE)
    assert 0 < int(inside.sum()) < inside.numel()
    assert torch.equal(got[inside], block[inside])


def test_fused_pair_gather_top_left_matches_jax(pyramid):
    """``ptype`` reaches B3's two-sided gather (its plain version here)."""
    feats, pts = pyramid
    coords = np.concatenate([pts, pts[:, ::-1]], -1)
    tf, _, jf, _ = _both(feats, pts)
    got, smap = tpg.gather_scaled_patch_pairs_fused(
        tf, tf, torch.from_numpy(coords), FEAT_IDX, DS, PSIZE, torch.float32, "topleft")
    jsmap = []

    def fused(f, c):
        out, sm = jpg.gather_scaled_patch_pairs_fused(
            f, f, c, FEAT_IDX, DS, PSIZE, jnp.float32, "topleft", use_pallas=False)
        jsmap.append(sm)  # static: known at trace time
        return out

    want = jax.jit(fused)(jf, jnp.asarray(coords))
    assert [smap] == jsmap
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)


def _model(gather, sd=None):
    cfg = ModelConfig(gather=gather,
                      regressor=RegressorConfig(conv_dims=(64, 64), fc_dims=(64, 32)))
    model = Patch2Pix(cfg.resolved(), device="cpu")
    if sd is None:
        sd = seeded_state_dict({k: tuple(v.shape) for k, v in model.state_dict().items()})
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    return model, sd


def test_block_gather_meta_restores_and_matches_auto(tmp_path):
    auto, sd = _model("auto")
    block, _ = _model("block", sd)
    save_ckpt(str(tmp_path), create_train_state(block, OptimConfig()), block.config, epoch=3)
    assert read_meta(str(tmp_path))["model_config"]["gather"] == "block"
    restored = restore_for_eval(str(tmp_path), device="cpu")
    assert restored.config.gather == "block" and restored.config.regressor.panc == 1
    assert read_meta(str(tmp_path))["epoch"] == 3

    rs = np.random.RandomState(0)
    im1, im2 = (torch.from_numpy(rs.rand(B, 128, 160, 3).astype(np.float32)) for _ in range(2))
    want = auto.predict_fine(im1, im2, ksize=2)
    got = restored.predict_fine(im1, im2, ksize=2)
    assert int(want[0].valid.sum()) > 0
    for g, w in zip(got, want):
        assert torch.equal(g.valid, w.valid)
        assert torch.equal(g.coords, w.coords) and torch.equal(g.scores, w.scores)


def test_unknown_gather_raises():
    with pytest.raises(ValueError, match="gather='tiled'"):
        ModelConfig(gather="tiled")
