"""The port's modules against ``patch2pix_tpu.models``, float32.

Both packages are built from one numpy state dict in the reference key
layout (``tests/ref_loader.seeded_state_dict`` over the shape map stored
in the golden fixtures): the port loads it as it is, the JAX side through
``convert_patch2pix_state_dict``. Tolerances are float32 rounding of
deep stacks summed in another order (stated per test).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from patch2pix_tpu.models.ncn import NeighConsensus as JaxNCN
from patch2pix_tpu.models.regressor import FeatRegressNet as JaxRegressor
from patch2pix_tpu.models.resnet import resnet34 as jax_resnet34
from patch2pix_tpu.ops.patch_gather import gather_scaled_patch_pairs_fused as jax_fused
from patch2pix_tpu.utils.torch_import import convert_patch2pix_state_dict
from patch2pix_tpu_torch.models.ncn import NeighConsensus
from patch2pix_tpu_torch.models.regressor import FeatRegressNet
from patch2pix_tpu_torch.models.resnet import resnet34
from patch2pix_tpu_torch.ops.patch_gather import gather_scaled_patch_pairs_fused
from tests.ref_loader import seeded_state_dict

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "pipeline_golden_cs.npz")


@pytest.fixture(scope="module")
def weights():
    meta = json.loads(str(np.load(FIXTURE, allow_pickle=True)["meta"]))
    sd = seeded_state_dict({k: tuple(s) for k, s in meta["shapes"].items()}, seed=0)
    params, stats = convert_patch2pix_state_dict(sd)
    return sd, params, stats


def sub_state_dict(sd, prefix):
    return {k[len(prefix):]: torch.from_numpy(np.asarray(v))
            for k, v in sd.items() if k.startswith(prefix)}


def test_ncn_matches_jax(weights, rng):
    """Symmetric NCN (16, 1): rtol/atol 1e-5 (fold-in, fold-out and the
    tap-sum reassociate the same f32 contraction)."""
    sd, params, _ = weights
    ncn = NeighConsensus(device="cpu")
    ncn.load_state_dict(sub_state_dict(sd, "ncn."))
    corr = rng.standard_normal((2, 4, 6, 5, 3)).astype(np.float32)
    got = ncn(torch.from_numpy(corr))
    want = JaxNCN().apply({"params": params["ncn"]}, jnp.asarray(corr))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("change_stride", [False, True])
def test_resnet34_pyramid_matches_jax(weights, rng, change_stride):
    """Every pyramid level; atol 1e-4 relative to the level's scale
    (30+ f32 convs with BN folded into the weights on both sides)."""
    sd, params, stats = weights
    net = resnet34(change_stride, device="cpu")
    net.load_state_dict(sub_state_dict(sd, "extract."))
    x = rng.standard_normal((2, 64, 96, 3)).astype(np.float32)
    with torch.no_grad():
        got = net(torch.from_numpy(x), pyramid=True)
    model = jax_resnet34(change_stride)
    want = jax.jit(lambda v, x: model.apply(v, x, train=False, pyramid=True))(
        {"params": params["extract"], "batch_stats": stats["extract"]}, jnp.asarray(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())


def test_regressor_matches_jax(weights, rng):
    """FeatRegressNet 'pre' on per-level patches and on the fused-gather
    layout with its slice map; atol 1e-4 on O(1) logits."""
    sd, params, stats = weights
    net = FeatRegressNet(feat_dim=259, device="cpu")
    net.load_state_dict(sub_state_dict(sd, "regress_mid."))
    variables = {"params": params["regress_mid"], "batch_stats": stats["regress_mid"]}
    jnet = JaxRegressor(psize=16)
    m = 3
    lv = [[rng.standard_normal((m, 16, 16, c)).astype(np.float32) * 0.1
           for c in (3, 64, 64, 128)] for _ in range(2)]
    with torch.no_grad():
        got = net([torch.from_numpy(a) for a in lv[0]], [torch.from_numpy(a) for a in lv[1]])
    want = jnet.apply(variables, [jnp.asarray(a) for a in lv[0]],
                      [jnp.asarray(a) for a in lv[1]], train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)

    h, w = 48, 64
    feats = [[rng.standard_normal((1, h // ds, w // ds, c)).astype(np.float32)
              for ds, c in ((1, 3), (2, 64), (4, 64), (8, 128), (16, 128))]
             for _ in range(2)]
    coords = np.stack([rng.integers(0, w, (1, 4)), rng.integers(0, h, (1, 4)),
                       rng.integers(0, w, (1, 4)), rng.integers(0, h, (1, 4))],
                      -1).astype(np.float32)
    args = ((0, 1, 2, 3), (1, 2, 2, 2, 2), 16)
    patches, smap = gather_scaled_patch_pairs_fused(
        *([torch.from_numpy(f) for f in fs] for fs in feats), torch.from_numpy(coords),
        *args, torch.float32)
    jpatches, jsmap = jax_fused(*([jnp.asarray(f) for f in fs] for fs in feats),
                                jnp.asarray(coords), *args, jnp.float32, use_pallas=False)
    with torch.no_grad():
        got = net(patches, None, slice_map=smap)
    want = jnet.apply(variables, jpatches, None, train=False, slice_map=jsmap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_regressor_post_is_not_ported():
    with pytest.raises(NotImplementedError):
        FeatRegressNet(feat_dim=259, feat_comb="post", device="cpu")
