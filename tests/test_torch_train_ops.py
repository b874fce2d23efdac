"""The training pieces of the port below the train step, on the CPU,
against the JAX package.

  * The backward passes of B1 ``tap_sum``, B2 ``corr_pool`` and B3
    ``expand_scale_pair`` against ``jax.vjp`` of the JAX custom VJPs
    (``_tap_sum_t`` / ``_tap_sum`` and ``corr_pool_fused`` with their
    Pallas forwards in interpret mode; ``expand_scale_pair_xla``, whose
    VJP is ``expand_scale_pair_pallas``'s backward):
    B1 exact (the same f32 values moved, no adds), B2 rtol 1e-5 (dot
    products summed in another order, ties split the same way), B3 rtol
    1e-5 (square-sums and the scatter of the window gather in another
    order). Each named backward also equals autograd of its kernel's
    plain version exactly.
  * ``sampson_dist`` / ``sym_epi_dist`` (rtol 1e-5), ``select_ptmax``
    with the same draw (exact), ``patch2pix_losses`` on the same outputs
    and F (every metric key, rtol 1e-5).
  * The regressor on batch statistics against the JAX ``FeatRegressNet``
    with ``train=True``: outputs (atol 1e-4), the running averages after
    the update (rtol 1e-5) and the parameters' gradients (within 1e-4 of
    the largest gradient of any parameter: the biases ahead of a
    batch-statistics BatchNorm have a gradient of rounding size).
  * The configs' JSON round trip, ``lr_schedule`` against optax's, and
    three optimizer updates against the JAX package's optax chain.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from patch2pix_tpu.config import OptimConfig as JaxOptimConfig
from patch2pix_tpu.config import to_json as jax_to_json
from patch2pix_tpu.models.regressor import FeatRegressNet as JaxRegressor
from patch2pix_tpu.ops import geometry as jgeo
from patch2pix_tpu.ops import match_extract as jme
from patch2pix_tpu.ops.corr_pool_pallas import corr_pool_fused
from patch2pix_tpu.ops.patch_expand_pallas import expand_scale_pair_xla
from patch2pix_tpu.train import losses as jlosses
from patch2pix_tpu.train import state as jstate
from patch2pix_tpu_torch.config import (
    ModelConfig,
    OptimConfig,
    TrainConfig,
    from_json,
    model_config_from_json,
    to_json,
)
from patch2pix_tpu_torch.models.regressor import FeatRegressNet, update_running_stats
from patch2pix_tpu_torch.ops import geometry as tgeo
from patch2pix_tpu_torch.ops.corr_pool import corr_pool, corr_pool_backward, corr_pool_plain
from patch2pix_tpu_torch.ops.match_extract import select_ptmax
from patch2pix_tpu_torch.ops.patch_expand import (
    expand_scale_pair,
    expand_scale_pair_backward,
    expand_scale_pair_plain,
)
from patch2pix_tpu_torch.ops.tap_sum import tap_sum, tap_sum_backward, tap_sum_plain
from patch2pix_tpu_torch.train.losses import patch2pix_losses
from patch2pix_tpu_torch.train.state import lr_schedule, make_optimizer

jconv = importlib.import_module("patch2pix_tpu.ops.conv4d")

PSIZE = 16
LEVELS = ((16, 3), (8, 64), (4, 64), (2, 128))


def T(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ B1


def _tap_sum_case(rng, bs=2, h1=8, w1=8, hw=24):
    n = bs * h1 * w1
    z = rng.standard_normal((n, 9, hw)).astype(np.float32)
    g = rng.standard_normal((n, hw)).astype(np.float32)
    return z, g, bs, h1, w1


def test_tap_sum_backward_matches_jax_vjp_v2(rng):
    """Against ``_tap_sum_t``'s VJP (the fold-out's transposed layout)."""
    z, g, bs, h1, w1 = _tap_sum_case(rng)
    n, _, hw = z.shape
    p = w1 + 1
    p_right = (-(n + p)) % 128
    while p_right < p:
        p_right += 128
    zt = np.pad(z, ((p, p_right), (0, 0), (0, 0))).transpose(2, 1, 0)
    _, vjp = jax.vjp(lambda a, b: jconv._tap_sum_t(a, b, bs, h1, w1),
                     jnp.asarray(zt), jnp.float32(0.37))
    dzt, dbias = (np.asarray(x) for x in vjp(jnp.asarray(g.T)))
    dz, db = tap_sum_backward(T(g), bs, h1, w1, 1, torch.float32)
    np.testing.assert_array_equal(dz.numpy(), dzt[:, :, p:p + n].transpose(2, 1, 0))
    assert not dzt[:, :, :p].any() and not dzt[:, :, p + n:].any()
    np.testing.assert_allclose(db.numpy(), [dbias], rtol=1e-5)


def test_tap_sum_backward_matches_jax_vjp_v1(rng):
    """Against ``_tap_sum``'s VJP (the prepadded layout)."""
    z, g, bs, h1, w1 = _tap_sum_case(rng, bs=2, h1=4, w1=5, hw=128)
    n = z.shape[0]
    p = w1 + 1
    zf = np.pad(z.transpose(1, 0, 2), ((0, 0), (p, p + 8), (0, 0)))
    _, vjp = jax.vjp(lambda a, b: jconv._tap_sum(a, b, bs, h1, w1),
                     jnp.asarray(zf), jnp.float32(-0.2))
    dzf, dbias = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    dz, db = tap_sum_backward(T(g), bs, h1, w1, 1, torch.float32)
    np.testing.assert_array_equal(dz.numpy(), dzf[:, p:p + n].transpose(1, 0, 2))
    np.testing.assert_allclose(db.numpy(), [dbias], rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cout", [1, 2])
def test_tap_sum_autograd_equals_named_backward(rng, dtype, cout):
    """Autograd through the wrapper (its plain version here) and through
    ``tap_sum_plain``: the same dz (exact) and dbias; a non-contiguous
    upstream gradient."""
    bs, h1, w1, hw = 1, 3, 4, 5
    n = bs * h1 * w1
    z = T(rng.standard_normal((n, 9, cout * hw)).astype(np.float32)).to(dtype)
    bias = T(rng.standard_normal(cout).astype(np.float32))
    g = T(rng.standard_normal((cout * hw, n)).astype(np.float32)).T
    grads = []
    for fn in (tap_sum, tap_sum_plain):
        zz, bb = z.clone().requires_grad_(), bias.clone().requires_grad_()
        fn(zz, bb, bs, h1, w1).backward(g)
        grads.append((zz.grad, bb.grad))
    assert grads[0][0].dtype == dtype
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------------ B2


def _unit_feats(seed, b, h, w, c):
    rs = np.random.RandomState(seed)
    f = rs.standard_normal((b, h, w, c)).astype(np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


@pytest.mark.parametrize("ties", [False, True])
def test_corr_pool_backward_matches_jax_vjp(ties):
    """``corr_pool_backward`` against ``jax.vjp`` of ``corr_pool_fused``
    (Pallas forward in interpret mode). With ``ties``, features built to
    tie: a window of equal rows in both images makes all 16 products of
    a pooled cell equal, and two equal rows of one window tie pairwise;
    both frameworks' pairwise maxima split the gradient in halves."""
    b, h1, w1, h2, w2, c = 1, 8, 8, 6, 8, 128
    f1 = _unit_feats(6, b, h1, w1, c)
    f2 = _unit_feats(7, b, h2, w2, c)
    if ties:
        f1[0, 2:4, 4:6] = f1[0, 2, 4]
        f2[0, 0:2, 2:4] = f2[0, 0, 2]
        f1[0, 5, 1] = f1[0, 4, 0]
    g = np.random.RandomState(8).standard_normal((b, h1 // 2, w1 // 2, h2 // 2, w2 // 2))
    g = g.astype(np.float32)
    _, vjp = jax.vjp(lambda a, m: corr_pool_fused(a, m, True), jnp.asarray(f1), jnp.asarray(f2))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    got = corr_pool_backward(T(f1), T(f2), T(g))
    for gt, w_ in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), w_, rtol=1e-5, atol=1e-6)
    # and autograd through the wrapper equals the named backward
    a, m = T(f1).requires_grad_(), T(f2).requires_grad_()
    corr_pool(a, m).backward(T(g))
    torch.testing.assert_close(a.grad, got[0], rtol=0, atol=0)
    torch.testing.assert_close(m.grad, got[1], rtol=0, atol=0)


def test_corr_pool_plain_autograd_equals_named_backward():
    """bf16 features: autograd of the plain version (the volume's
    pairwise-maximum pool) and the named backward agree exactly."""
    f1 = T(_unit_feats(1, 2, 4, 6, 32)).to(torch.bfloat16)
    f2 = T(_unit_feats(2, 2, 6, 4, 32)).to(torch.bfloat16)
    g = torch.randn((2, 2, 3, 3, 2), generator=torch.Generator().manual_seed(0))
    a, m = f1.clone().requires_grad_(), f2.clone().requires_grad_()
    corr_pool_plain(a, m).backward(g)
    d1, d2 = corr_pool_backward(f1, f2, g)
    assert d1.dtype == torch.bfloat16
    torch.testing.assert_close(a.grad, d1, rtol=0, atol=0)
    torch.testing.assert_close(m.grad, d2, rtol=0, atol=0)


# ------------------------------------------------------------------ B3


def _expand_case(rng, m, levels=LEVELS):
    rows = [[rng.standard_normal((m, 4, t, t * c)).astype(np.float32) for t, c in levels]
            for _ in range(2)]
    corners = [rng.integers(0, 64 + PSIZE, (m,)).astype(np.int32) for _ in range(4)]
    return rows, corners


def test_expand_scale_pair_backward_matches_jax_vjp(rng):
    """Against ``jax.vjp`` of ``expand_scale_pair_xla``, which is the
    backward of ``expand_scale_pair_pallas``'s custom VJP: both sides'
    rows, an odd M; the corners get no gradient."""
    m = 5
    rows, corners = _expand_case(rng, m)
    ds = tuple(PSIZE // t for t, _ in LEVELS)
    jrows = [tuple(jnp.asarray(r) for r in side) for side in rows]
    jc = [jnp.asarray(c) for c in corners]
    shapes = [o.shape for o in expand_scale_pair_xla(*jrows, *jc, PSIZE, ds, jnp.float32)]
    gs = [rng.standard_normal(sh).astype(np.float32) for sh in shapes]

    @jax.jit
    def vjp(r1, r2, g):
        return jax.vjp(lambda a, b: expand_scale_pair_xla(a, b, *jc, PSIZE, ds, jnp.float32),
                       r1, r2)[1](g)

    want = vjp(*jrows, tuple(jnp.asarray(g) for g in gs))
    got = expand_scale_pair_backward([T(r) for r in rows[0]], [T(r) for r in rows[1]],
                                     *(T(c) for c in corners), PSIZE, torch.float32,
                                     [T(g) for g in gs])
    for side_got, side_want in zip(got, want):
        for gt, w_ in zip(side_got, side_want):
            w_ = np.asarray(w_)
            np.testing.assert_allclose(gt.numpy(), w_, rtol=1e-5,
                                       atol=1e-5 * np.abs(w_).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expand_scale_pair_autograd_equals_named_backward(rng, dtype):
    """Autograd through the wrapper equals autograd of the plain
    version: the same function, recomputed."""
    rows, corners = _expand_case(rng, 3)
    c = [T(x) for x in corners]
    grads = []
    for fn in (expand_scale_pair, expand_scale_pair_plain):
        r = [[T(x).to(dtype).requires_grad_() for x in side] for side in rows]
        outs = fn(r[0], r[1], *c, PSIZE, dtype)
        torch.autograd.backward(outs, [o.detach().float().cos().to(dtype) for o in outs])
        grads.append([x.grad for side in r for x in side])
    for a, b in zip(*grads):
        assert a.dtype == dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------------ geometry, sampling, losses


def _fundamentals(rs, b):
    return (rs.standard_normal((b, 3, 3)) * np.asarray([[1e-5, 1e-4, 1e-2]] * 3)
            ).astype(np.float32)


def test_epipolar_distances_match_jax():
    rs = np.random.RandomState(0)
    m = rs.uniform(0, 96, (3, 20, 4)).astype(np.float32)
    F = _fundamentals(rs, 3)
    np.testing.assert_allclose(
        tgeo.sampson_dist_batched(T(m), T(F)).numpy(),
        np.asarray(jgeo.sampson_dist_batched(jnp.asarray(m), jnp.asarray(F))), rtol=1e-5)
    np.testing.assert_allclose(tgeo.sampson_dist(T(m[0]), T(F[0])).numpy(),
                               np.asarray(jgeo.sampson_dist(m[0], F[0])), rtol=1e-5)
    for sqrt in (False, True):
        np.testing.assert_allclose(
            tgeo.sym_epi_dist(T(m[1]), T(F[1]), sqrt).numpy(),
            np.asarray(jgeo.sym_epi_dist(m[1], F[1], sqrt)), rtol=1e-5)


def test_select_ptmax_matches_jax_with_the_same_draw():
    """Rows with fewer valid than ptmax cycle, a pair with none repeats
    row 0."""
    rs = np.random.RandomState(1)
    b, n, ptmax = 3, 12, 8
    coords = rs.uniform(0, 100, (b, n, 4)).astype(np.float32)
    scores = rs.uniform(0, 1, (b, n)).astype(np.float32)
    valid = rs.uniform(0, 1, (b, n)) < 0.5
    valid[1] = False
    valid[2, :3] = True
    valid[2, 3:] = False
    key = jax.random.PRNGKey(4)
    rand = np.asarray(jax.random.uniform(key, (b, n)))
    want = jme.select_ptmax(key, jnp.asarray(coords), jnp.asarray(scores),
                            jnp.asarray(valid), ptmax)
    got = select_ptmax(T(coords), T(scores), T(valid), ptmax, rand=T(rand))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    drawn = select_ptmax(T(coords), T(scores), T(valid), ptmax,
                         generator=torch.Generator().manual_seed(0))
    assert drawn.coords.shape == (b, ptmax, 4) and drawn.valid.all()


@pytest.mark.parametrize("scale", [2e-3, 1e3])
def test_patch2pix_losses_match_jax(scale):
    """Every metric key on the same outputs and F; ``scale`` 1e3 skips
    every pair."""
    rs = np.random.RandomState(7)
    b, n = 4, 32
    out = {k: rs.uniform(0, 64, (b, n, 4)).astype(np.float32)
           for k in ("coarse", "mid", "fine")}
    out.update({k: rs.uniform(0, 1, (b, n)).astype(np.float32)
                for k in ("mid_probs", "fine_probs")})
    F = (rs.standard_normal((b, 3, 3)) * scale).astype(np.float32)
    kw = dict(cls_dthres=(50.0, 5.0), epi_dthres=(40.0, 6.0), weight_cls=10.0,
              weight_epi=(1.0, 0.5))
    jloss, jmet = jlosses.patch2pix_losses({k: jnp.asarray(v) for k, v in out.items()},
                                           jnp.asarray(F), **kw)
    loss, met = patch2pix_losses({k: T(v) for k, v in out.items()}, T(F), **kw)
    assert set(met) == set(jmet)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in jmet:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


# ------------------------------------------------------------------ regressor on batch statistics


def test_regressor_batch_statistics_match_jax(rng):
    """A narrow regressor on batch statistics: outputs, the updated
    running averages (``BNAffine`` and the fc BatchNorms) and every
    parameter's gradient of a scalar of the outputs."""
    feat_dim, m = 8, 6
    kw = dict(conv_dims=(16, 16), fc_dims=(16, 8))
    jnet = JaxRegressor(**kw)
    f1 = rng.standard_normal((m, PSIZE, PSIZE, feat_dim)).astype(np.float32)
    f2 = rng.standard_normal((m, PSIZE, PSIZE, feat_dim)).astype(np.float32)
    variables = jnet.init(jax.random.PRNGKey(0), f1, f2, train=False)
    # non-trivial running averages and BN affines
    variables = jax.tree.map(
        lambda v: v + jnp.asarray(rng.uniform(0.1, 0.5, v.shape), v.dtype), variables)
    w = rng.standard_normal((m, 5)).astype(np.float32)

    def jloss(params):
        out, upd = jnet.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              f1, f2, train=True, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, upd["batch_stats"])

    (_, (jout, jstats)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])

    net = FeatRegressNet(feat_dim=feat_dim, device="cpu", **kw)
    tree = {"params": {"regress_mid": variables["params"]},
            "batch_stats": {"regress_mid": variables["batch_stats"]}}
    net.load_state_dict(_regressor_state_dict(tree))
    stats = []
    out = net(T(f1), T(f2), stats=stats)
    (out * T(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-4)
    update_running_stats(stats)
    want_sd = _regressor_state_dict({
        "params": {"regress_mid": jax.tree.map(np.asarray, jgrads)},
        "batch_stats": {"regress_mid": jax.tree.map(np.asarray, jstats)}})
    for k, v in net.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), rtol=1e-5, err_msg=k)
    scale = max(np.abs(want_sd[k].numpy()).max() for k, _ in net.named_parameters())
    for k, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_sd[k].numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=k)


def _regressor_state_dict(tree):
    """The port's state dict of a regressor-only JAX tree (its
    ``regress_mid`` keys, prefix stripped)."""
    from patch2pix_tpu_torch.utils import jax_import

    out = {}
    jax_import._regressor(out, "regress_mid", tree["params"], tree["batch_stats"])
    return {k[len("regress_mid."):]: v for k, v in jax_import._to_torch(out).items()}


# ------------------------------------------------------------------ configs, schedule


def test_configs_json_round_trip():
    for cfg in (OptimConfig(opt="sgd", lr_decay=("multistep", 0.5, 10, 20)),
                TrainConfig(weight_epi=(0.0, 1.0)), ModelConfig(change_stride=True)):
        assert from_json(type(cfg), to_json(cfg)) == cfg
    jcfg = JaxOptimConfig(lr_decay=("step", 0.1, 5))
    assert from_json(OptimConfig, jax_to_json(jcfg)) == OptimConfig(lr_decay=("step", 0.1, 5))
    assert model_config_from_json(to_json(ModelConfig())).regressor.panc == 8


@pytest.mark.parametrize("lr_decay", [None, ("step", 0.5, 3), ("multistep", 0.1, 2, 5)])
def test_lr_schedule_matches_optax(lr_decay):
    spe = 4
    want = jstate.lr_schedule(JaxOptimConfig(lr_decay=lr_decay, epochs=10), spe)
    got = lr_schedule(OptimConfig(lr_decay=lr_decay, epochs=10), spe)
    for count in range(0, 48):
        w_ = want if isinstance(want, float) else float(want(count))
        np.testing.assert_allclose(got(count), w_, rtol=1e-6, err_msg=str(count))


@pytest.mark.parametrize("opt,weight_decay", [("adam", 0.0), ("adam", 1e-2), ("sgd", 1e-2)])
def test_optimizer_matches_optax(opt, weight_decay):
    """Three updates of a frozen and a trained tensor from the same
    gradients, with a multistep schedule: the port's optimizer against
    the JAX package's optax chain (coupled weight decay, Adam's bias
    correction, SGD's momentum 0.9), rtol 1e-5; the frozen tensor and the
    ``extract/layer1*`` prefix pattern hold."""
    cfg = dict(opt=opt, lr_init=0.1, weight_decay=weight_decay,
               lr_decay=("multistep", 0.5, 1), epochs=3)
    rs = np.random.RandomState(9)
    init = {"extract": {"layer1_0": rs.standard_normal(4).astype(np.float32),
                        "layer2_0": rs.standard_normal(3).astype(np.float32)},
            "regress_mid": rs.standard_normal(5).astype(np.float32)}
    grads = [jax.tree.map(lambda a: rs.standard_normal(a.shape).astype(np.float32), init)
             for _ in range(3)]
    tx = jstate.make_optimizer(JaxOptimConfig(**cfg), init, steps_per_epoch=2,
                               freeze=("extract/layer1*",))
    params, opt_state = jax.tree.map(jnp.asarray, init), None
    opt_state = tx.init(params)
    for g in grads:
        upd, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, upd)

    model = torch.nn.Module()
    model.extract = torch.nn.Module()
    model.extract.layer1 = torch.nn.Module()
    model.extract.layer2 = torch.nn.Module()
    model.extract.layer1.w = torch.nn.Parameter(T(init["extract"]["layer1_0"]))
    model.extract.layer2.w = torch.nn.Parameter(T(init["extract"]["layer2_0"]))
    model.regress_mid = torch.nn.Parameter(T(init["regress_mid"]))
    optimizer = make_optimizer(OptimConfig(**cfg), model, steps_per_epoch=2,
                               freeze=("extract/layer1*",))
    assert not model.extract.layer1.w.requires_grad and model.extract.layer2.w.requires_grad
    for count, g in enumerate(grads):
        optimizer.zero_grad()
        model.extract.layer2.w.grad = T(g["extract"]["layer2_0"])
        model.regress_mid.grad = T(g["regress_mid"])
        optimizer.step(count)
    np.testing.assert_array_equal(model.extract.layer1.w.detach().numpy(),
                                  init["extract"]["layer1_0"])
    np.testing.assert_array_equal(np.asarray(params["extract"]["layer1_0"]),
                                  init["extract"]["layer1_0"])
    for got, want in ((model.extract.layer2.w, params["extract"]["layer2_0"]),
                      (model.regress_mid, params["regress_mid"])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)
