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
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

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


def _perturbed(tree, rng):
    """A JAX ``model.init`` tree with every leaf moved off its initial
    value: BatchNorm scales and running variances in [0.5, 1.5], every
    other leaf plus 0.1 x a unit normal."""
    def leaf(path, x):
        x = np.asarray(x)
        if path[-1].key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def test_regressor_post_matches_jax(rng):
    """FeatRegressNet ``post`` (one conv stack over each side's
    ``feat_dim`` channels, pooled features concatenated before the fcs),
    weights carried across from a JAX ``init``: eval BN and batch-
    statistics BN (outputs, and every running average after the update,
    each shared conv BN updated once per side) within atol 1e-4; then the
    fused-gather layout (B3's outputs split back into their sides) equal
    to per-level patches from the block gather, atol 1e-5."""
    from patch2pix_tpu_torch.models.regressor import update_running_stats
    from patch2pix_tpu_torch.ops.patch_gather import gather_local_patches_levels
    from patch2pix_tpu_torch.utils.jax_import import regressor_state_dict_from_jax

    dims = dict(conv_dims=(32, 32), fc_dims=(32, 16))
    jnet = JaxRegressor(psize=16, feat_comb="post", **dims)
    m, cs = 6, (3, 64, 64, 128)
    lv = [[rng.standard_normal((m, 16, 16, c)).astype(np.float32) * 0.1 for c in cs]
          for _ in range(2)]
    jl = [[jnp.asarray(a) for a in side] for side in lv]
    variables = _perturbed(jnet.init(jax.random.PRNGKey(0), *jl, train=False), rng)
    net = FeatRegressNet(feat_dim=259, feat_comb="post", device="cpu", **dims)
    sd = regressor_state_dict_from_jax(variables["params"], variables["batch_stats"])
    net.load_state_dict(sd, strict=False)
    assert net.conv[0].weight.shape[1] == 259 and net.fc[0].weight.shape[1] == 64
    tl = [[torch.from_numpy(a) for a in side] for side in lv]
    with torch.no_grad():
        got = net(*tl)
    want = jnet.apply(variables, *jl, train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)

    want, upd = jnet.apply(variables, *jl, train=True, mutable=["batch_stats"])
    stats = []
    with torch.no_grad():
        got = net(*tl, stats=stats)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    assert len(stats) == 2 * 2 + 2  # each conv BN per side, each fc BN once
    update_running_stats(stats)
    moved = regressor_state_dict_from_jax(variables["params"], upd["batch_stats"])
    for k, v in net.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), moved[k].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)
            assert not torch.equal(v, sd[k]), k

    h, w = 48, 64
    feats = [[torch.from_numpy(rng.standard_normal((1, h // ds, w // ds, c)).astype(np.float32))
              for ds, c in ((1, 3), (2, 64), (4, 64), (8, 128), (16, 128))] for _ in range(2)]
    coords = torch.from_numpy(np.stack(
        [rng.integers(0, w, (1, 5)), rng.integers(0, h, (1, 5)),
         rng.integers(0, w, (1, 5)), rng.integers(0, h, (1, 5))], -1).astype(np.float32))
    args = ((0, 1, 2, 3), (1, 2, 2, 2, 2), 16)
    patches, smap = gather_scaled_patch_pairs_fused(*feats, coords, *args, torch.float32)
    sides = []
    for f, pts in zip(feats, (coords[..., 0:2], coords[..., 2:4])):
        levels, inv = gather_local_patches_levels(f, pts, *args)
        sides.append([(lv * inv).reshape(5, 16, 16, lv.shape[-1]) for lv in levels])
    net.eval()
    with torch.no_grad():
        np.testing.assert_allclose(net(patches, None, slice_map=smap).numpy(),
                                   net(*sides).numpy(), rtol=0, atol=1e-5)


def test_fresh_kernels_match_the_jax_initialisers():
    """A fresh port model's kernels against a JAX ``init`` at the same
    shapes (NCN (16, 1), ResNet34 to layer3, a 64-wide regressor): NCN
    kernels ``xavier_uniform`` with the fans of the JAX layout (k, k, k,
    k, in, out), every conv and Linear kernel ``lecun_normal`` (variance
    1 / fan_in, truncated at two standard deviations). Per kernel: both
    draws within the initialiser's bound, the port's variance within
    5 x sqrt(2 / n) of the initialiser's (five standard errors of a
    sample variance of n draws, kurtosis <= 3) and of the JAX draw's
    within twice that. Biases zero; BatchNorm scales 1."""
    from patch2pix_tpu_torch.config import ModelConfig, RegressorConfig
    from patch2pix_tpu_torch.models.patch2pix import Patch2Pix
    from patch2pix_tpu_torch.utils.jax_import import state_dict_from_jax

    torch.manual_seed(0)
    reg = dict(conv_dims=(64, 64), fc_dims=(64, 32))
    model = Patch2Pix(ModelConfig(regressor=RegressorConfig(**reg)).resolved(), device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    # jitted: the same draws, in a third of the eager time
    ncn = jax.jit(lambda k: JaxNCN().init(k, jnp.zeros((1, 2, 2, 2, 2))))(keys[0])
    lv = [jnp.zeros((1, 16, 16, c)) for c in (3, 64, 64, 128)]
    rv = jax.jit(lambda k: JaxRegressor(psize=16, **reg).init(k, lv, lv, train=False))(keys[1])
    bv = jax.jit(lambda k: jax_resnet34().init(k, jnp.zeros((1, 32, 32, 3)), train=False,
                                                pyramid=True))(keys[2])
    jax_sd = state_dict_from_jax(
        {"params": {"extract": bv["params"], "ncn": ncn["params"],
                    "regress_mid": rv["params"]},
         "batch_stats": {"extract": bv["batch_stats"], "regress_mid": rv["batch_stats"]}})

    sd = model.state_dict()
    n_kernels = 0
    for k, want in jax_sd.items():
        got = sd[k]
        assert got.shape == want.shape, k
        if k.endswith("bias") or "running" in k or ("weight" in k and got.dim() == 1):
            torch.testing.assert_close(got, want, rtol=0, atol=0, msg=k)
            continue
        if k.startswith("ncn."):  # stored (k1, out, in, k2, k3, k4)
            ksz, cout, cin = got.shape[0], got.shape[1], got.shape[2]
            limit = (6.0 / ((cin + cout) * ksz ** 4)) ** 0.5
            var = limit ** 2 / 3
        else:
            fan_in = got[0].numel()
            var = 1.0 / fan_in
            limit = 2 * var ** 0.5 / 0.87962566103423978
        n = got.numel()
        tol = 5 * (2.0 / n) ** 0.5
        for w in (got, want):
            assert float(w.abs().max()) <= limit * (1 + 1e-6), k
        assert abs(float(got.var()) / var - 1) <= tol, (k, float(got.var()), var)
        assert abs(float(got.var()) / float(want.var()) - 1) <= 2 * tol, k
        n_kernels += 1
    assert n_kernels == 2 + 29 + 2 + 3  # NCN, ResNet34 to layer3, 2 convs, 3 Linears
