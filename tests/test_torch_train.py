"""The port's training path against the JAX package's, on the CPU.

One ``train_step`` of ResNet34 at 96x64, batch 2, ptmax 8, panc 8 (with
narrow 64-wide regressors to keep the test short), for both strides,
from one seeded state dict and the proposal draw JAX makes, against the
JAX ``make_train_step`` under jit. Tolerances:

  * loss and every metric key: rtol 1e-3 (f32 through the backbone, the
    NCN and two regression stages, summed in other orders: the fine
    coordinates differ by ~1e-4 px);
  * the regressors' gradients, against the one the JAX step applied
    (read from its Adam state): within 1e-3 of the largest of them;
  * the parameters after the Adam step: within the difference that the
    two gradients make to Adam's first step (``assert_adam_step_close``);
  * the regressors' running averages after the step: rtol 1e-4;
  * frozen parameters (backbone, NCN): unchanged, bit for bit.

Also: ``backbone_train_bn`` against JAX's per-side batch-statistics
backbone; every ``remat`` mode gives the ``none`` step; one NCN
pretraining step at ksize 1 and 2 against JAX's (loss and scores rtol
1e-4, NCN gradients within 1e-3 of the largest of them, parameters as
above); ``freeze=()`` reaches B3's backward in
the train step; NCN pretraining trains the NCN only and never reaches
B2's backward; the synthetic pairs equal the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from patch2pix_tpu.config import ModelConfig as JaxModelConfig
from patch2pix_tpu.config import OptimConfig as JaxOptimConfig
from patch2pix_tpu.config import RegressorConfig as JaxRegressorConfig
from patch2pix_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from patch2pix_tpu.models.patch2pix import Patch2Pix as JaxPatch2Pix
from patch2pix_tpu.train import create_train_state as jax_create_train_state
from patch2pix_tpu.train import make_optimizer as jax_make_optimizer
from patch2pix_tpu.train import make_train_step as jax_make_train_step
from patch2pix_tpu.train import patch2pix_losses as jax_losses
from patch2pix_tpu.train.ncn_pretrain import make_ncn_pretrain_step as jax_ncn_step
from patch2pix_tpu.utils.torch_import import convert_patch2pix_state_dict
from patch2pix_tpu_torch.config import ModelConfig, OptimConfig, RegressorConfig
from patch2pix_tpu_torch.data.synthetic import synthetic_batch
from patch2pix_tpu_torch.models.patch2pix import Patch2Pix
from patch2pix_tpu_torch.models.regressor import update_running_stats
from patch2pix_tpu_torch.ops.corr_pool import corr_pool_backward
from patch2pix_tpu_torch.ops.patch_expand import expand_scale_pair_backward
from patch2pix_tpu_torch.ops.tap_sum import tap_sum_backward
from patch2pix_tpu_torch.train import create_train_state, make_ncn_pretrain_step, make_train_step
from patch2pix_tpu_torch.utils.jax_import import (
    load_jax_train_state,
    load_jax_variables,
    state_dict_from_jax,
)
from tests.ref_loader import seeded_state_dict
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

H, W, BATCH, PTMAX = 64, 96, 2, 8
REG = dict(conv_dims=(64, 64), fc_dims=(64, 32))
LR = 5e-4


def _models(change_stride):
    cfg = ModelConfig(change_stride=change_stride, regressor=RegressorConfig(**REG)).resolved()
    port = Patch2Pix(cfg, device="cpu")
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in port.state_dict().items()}, seed=0)
    jm = JaxPatch2Pix(config=JaxModelConfig(
        change_stride=change_stride, regressor=JaxRegressorConfig(**REG)).resolved())
    params, stats = convert_patch2pix_state_dict(sd)
    variables = {"params": jax.tree.map(jnp.asarray, params),
                 "batch_stats": jax.tree.map(jnp.asarray, stats)}
    return port, jm, variables


def _batch(seed=0):
    b = synthetic_batch(np.random.RandomState(seed), BATCH, H, W)
    return b, {k: torch.from_numpy(v) for k, v in b.items()}


def _proposal_draw(jm, variables, rng, n):
    """The uniform draw ``select_ptmax`` makes inside the JAX forward
    under ``rngs={"proposal": rng}``."""
    return np.array(jm.apply(variables, method=lambda m: jax.random.uniform(
        m.make_rng("proposal"), (BATCH, n)), rngs={"proposal": rng}))


def jax_step_grads(opt_state, params):
    """The gradient a JAX step applied, from its Adam state: after the
    first step the first moment is (1 - b1) g. Frozen subtrees (optax
    ``MaskedNode``) come back as zeros."""
    mu = opt_state.inner_states["train"].inner_state[0].mu
    return jax.tree.map(
        lambda m, p: (jax.tree.map(jnp.zeros_like, p) if isinstance(m, optax.MaskedNode)
                      else m / (1 - 0.9)),
        mu, params, is_leaf=lambda x: isinstance(x, optax.MaskedNode))


def assert_adam_step_close(got, want, g, jg, lr, eps=1e-8):
    """Parameters after one Adam step, ``p - lr * g / (|g| + eps)``, from
    the port's gradient ``g`` and the gradient ``jg`` the JAX step
    applied. Where the two have one sign the step's sensitivity to g is
    at most lr * eps / (min |g| + eps)^2 between them, which times their
    difference bounds the parameters' difference; where the signs differ
    (a gradient of rounding size) the steps may differ by 2 lr. Plus
    1e-6 for the parameters' f32 rounding."""
    same = torch.sign(g) == torch.sign(jg)
    gmin = torch.minimum(g.abs(), jg.abs())
    bound = torch.where(same, lr * eps * (g - jg).abs() / (gmin + eps) ** 2,
                        torch.full_like(g, 2 * lr))
    excess = (got - want).abs() - 1.01 * bound - 1e-6
    assert float(excess.max()) <= 0, float(excess.max())


def _tree_sd(params, stats):
    return state_dict_from_jax({"params": jax.tree.map(np.asarray, params),
                                "batch_stats": jax.tree.map(np.asarray, stats)})


@pytest.fixture(scope="module", params=[False, True], ids=["s16", "cs"])
def stepped(request):
    """One JAX step and one port step from the same weights and draw."""
    cs = request.param
    port, jm, variables = _models(cs)
    nb, tb = _batch()
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    rng = jax.random.PRNGKey(3)
    cells = (H // (8 if cs else 16) // 2) * (W // (8 if cs else 16) // 2)
    rand = _proposal_draw(jm, variables, rng, 2 * cells)

    jstate = jax_create_train_state(rng, jm, JaxOptimConfig(lr_init=LR),
                                    init_variables=variables)
    jstep = jax_make_train_step(jm, jax_make_optimizer(JaxOptimConfig(lr_init=LR),
                                                       jstate.params),
                                ksize=2, ptmax=PTMAX, remat="none")

    jnew, jmet = jax.jit(jstep)(jstate, jb, rng)
    jgrads = jax_step_grads(jnew.opt_state, jnew.params)

    load_jax_train_state(port, jstate)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    state = create_train_state(port, OptimConfig(lr_init=LR))
    step = make_train_step(port, state.optimizer, ksize=2, ptmax=PTMAX)
    state, met = step(state, tb, rand=torch.from_numpy(rand))
    return dict(port=port, before=before, state=state, met=met, tb=tb, rand=rand,
                after={k: v.clone() for k, v in port.state_dict().items()},
                grads={k: p.grad for k, p in port.named_parameters()},
                jmet=jmet, jgrads=_tree_sd(jgrads, jnew.batch_stats),
                jnew=_tree_sd(jnew.params, jnew.batch_stats))


def test_train_step_matches_jax(stepped):
    jmet, met = stepped["jmet"], stepped["met"]
    assert stepped["state"].step == 1
    assert set(met) == set(jmet)
    assert float(met["skipped"]) < BATCH  # the loss reaches the regressors
    for k in jmet:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-3, atol=1e-5,
                                   err_msg=k)
    grads = {k: g for k, g in stepped["grads"].items() if k.startswith("regress_")}
    jg = stepped["jgrads"]
    scale = max(float(jg[k].abs().max()) for k in grads)
    assert scale > 0
    sd = stepped["after"]
    for k, g in grads.items():
        assert g is not None, k
        np.testing.assert_allclose(g.numpy(), jg[k].numpy(), rtol=0, atol=1e-3 * scale,
                                   err_msg=k)
        assert_adam_step_close(sd[k], stepped["jnew"][k], g, jg[k], LR)
        assert not torch.equal(sd[k], stepped["before"][k]), k
    for k, v in sd.items():
        if k.startswith(("extract.", "ncn.")) and k in stepped["jnew"]:
            assert torch.equal(v, stepped["before"][k]), k
            assert torch.equal(stepped["jnew"][k], stepped["before"][k]), k
        elif "running" in k and k in stepped["jnew"]:
            np.testing.assert_allclose(v.numpy(), stepped["jnew"][k].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
            if k.startswith("regress_"):
                assert not torch.equal(v, stepped["before"][k]), k
    for k, g in stepped["grads"].items():
        if k.startswith(("extract.", "ncn.")):
            assert g is None, k  # frozen: no gradient computed


@pytest.mark.parametrize("remat", ["fine", "both", "dots"])
def test_train_step_remat_modes_agree(stepped, remat):
    """From the weights before the step, each checkpointing mode gives
    the ``none`` step's loss, gradients, parameters and running
    averages (a recomputed stage updates them once)."""
    port = stepped["port"]
    port.load_state_dict(stepped["before"])
    state = create_train_state(port, OptimConfig(lr_init=LR))
    step = make_train_step(port, state.optimizer, ksize=2, ptmax=PTMAX, remat=remat)
    _, met = step(state, stepped["tb"], rand=torch.from_numpy(stepped["rand"]))
    for k in met:
        torch.testing.assert_close(met[k], stepped["met"][k], rtol=1e-6, atol=1e-6)
    for k, p in port.named_parameters():
        if k.startswith("regress_"):
            torch.testing.assert_close(p.grad, stepped["grads"][k], rtol=1e-5, atol=1e-7)
    for k, v in port.state_dict().items():
        torch.testing.assert_close(v, stepped["after"][k], rtol=1e-5, atol=1e-6)


def test_train_step_without_freezing_reaches_b3_backward():
    """``freeze=()``: the backbone trains, so the patch rows need a
    gradient and B3's backward runs; NCN weights get none (the coarse
    matches are arg-maxima)."""
    port, _, variables = _models(True)
    load_jax_variables(port, variables)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    state = create_train_state(port, OptimConfig(lr_init=LR), freeze=())
    step = make_train_step(port, state.optimizer, ksize=2, ptmax=PTMAX)
    calls = expand_scale_pair_backward.calls
    _, tb = _batch(1)
    state, met = step(state, tb, generator=torch.Generator().manual_seed(0))
    assert expand_scale_pair_backward.calls == calls + 2  # mid and fine stages
    assert all(torch.isfinite(v) for v in met.values())
    sd = port.state_dict()
    assert not torch.equal(sd["extract.layer1.0.conv1.weight"],
                           before["extract.layer1.0.conv1.weight"])
    assert all(p.grad is None for p in port.ncn.parameters())


def test_backbone_train_bn_matches_jax():
    """``backbone_train_bn``: one backbone call per side on batch
    statistics, against JAX ``extract_pyramid_pair(train=True,
    stack=False)`` (what ``backbone_train_bn=True`` runs) under
    ``mutable=["batch_stats"]``, f32: every pyramid level within 1e-4 of
    its scale, every backbone running average (both sides' updates, in
    order) within rtol 1e-4, atol 1e-5. Then a train step with the flag
    moves the backbone's running averages and leaves its weights alone."""
    port, jm, variables = _models(True)
    nb, tb = _batch(2)
    pair = jax.jit(lambda v, a, b: jm.apply(
        v, a, b, method=lambda m, x, y: m.extract_pyramid_pair(x, y, train=True, stack=False),
        mutable=["batch_stats"]))
    (jf1, jf2), upd = pair(variables, jnp.asarray(nb["im1"]), jnp.asarray(nb["im2"]))
    load_jax_variables(port, variables)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    stats = []
    with torch.no_grad():
        f1, f2 = port.extract_pyramid_pair(tb["im1"], tb["im2"], stats)
    for got, want in zip(f1 + f2, jf1 + jf2):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert len(stats) == 2 * 29  # the stem and 28 convs to layer3, per side
    update_running_stats(stats)
    moved = _tree_sd(variables["params"], upd["batch_stats"])
    n = 0
    for k, v in port.state_dict().items():
        if k.startswith("extract.") and "running" in k and ".layer4." not in k:
            np.testing.assert_allclose(v.numpy(), moved[k].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)
            n += 1
    assert n == 2 * 29

    load_jax_variables(port, variables)
    state = create_train_state(port, OptimConfig(lr_init=LR))
    step = make_train_step(port, state.optimizer, ksize=2, ptmax=PTMAX,
                           backbone_train_bn=True)
    state, met = step(state, tb, generator=torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v) for v in met.values())
    sd = port.state_dict()
    for k, v in sd.items():
        if not k.startswith("extract.") or ".layer4." in k or "num_batches" in k:
            continue
        assert torch.equal(v, before[k]) != ("running" in k), k


@pytest.mark.parametrize("ksize", [1, 2])
def test_ncn_pretrain_step_matches_jax(ksize):
    """One pretraining step (Adam 1e-2 on the NCN only) against JAX's:
    the metrics, the NCN parameters after the step; nothing else moves,
    and the gradient reaches the NCN through B1's backward."""
    port, jm, variables = _models(True)
    rs = np.random.RandomState(5)
    batch = {k: rs.standard_normal((1, 64, 64, 3)).astype(np.float32)
             for k in ("im_src", "im_pos", "im_neg")}
    jstep, init_opt = jax_ncn_step(jm, lr=1e-2, ksize=ksize)
    params, stats = variables["params"], variables["batch_stats"]
    jparams, jopt, jmet = jstep(params, stats, init_opt(params),
                                {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = jax_step_grads(jopt, jparams)

    load_jax_variables(port, variables)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    step, init = make_ncn_pretrain_step(port, lr=1e-2, ksize=ksize)
    calls = tap_sum_backward.calls
    met = step(init(), {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tap_sum_backward.calls == calls + 4  # fold-out of both branches, two pairs
    for k in jmet:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    want = _tree_sd(jparams, stats)
    jg = _tree_sd(jgrads, stats)
    sd = port.state_dict()
    # the loss is a difference of two near-equal scores: its gradients
    # carry their rounding at the scale of the largest
    scale = max(float(jg[k].abs().max()) for k in sd if k.startswith("ncn."))
    for k, v in sd.items():
        if not k.startswith("ncn."):
            assert torch.equal(v, before[k]), k
            continue
        g = dict(port.named_parameters())[k].grad
        np.testing.assert_allclose(g.numpy(), jg[k].numpy(), rtol=0, atol=1e-3 * scale,
                                   err_msg=k)
        assert_adam_step_close(v, want[k], g, jg[k], 1e-2)
        assert not torch.equal(v, before[k]), k


def test_ncn_pretrain_keeps_the_backbone_frozen():
    """At ksize 2 (B2 on the path) only the NCN trains, as in JAX: the
    backbone's parameters need no gradient, so autograd stops at the
    correlation and B2's backward never runs on this path."""
    port, _, variables = _models(True)
    load_jax_variables(port, variables)
    rs = np.random.RandomState(6)
    batch = {k: torch.from_numpy(rs.standard_normal((1, 64, 64, 3)).astype(np.float32))
             for k in ("im_src", "im_pos", "im_neg")}
    step, init = make_ncn_pretrain_step(port, lr=1e-3, ksize=2)
    before = port.extract.conv1.weight.detach().clone()
    calls = (corr_pool_backward.calls, tap_sum_backward.calls)
    met = step(init(), batch)
    assert corr_pool_backward.calls == calls[0]
    assert tap_sum_backward.calls == calls[1] + 4
    assert all(torch.isfinite(v) for v in met.values())
    assert torch.equal(port.extract.conv1.weight, before)
    assert all(not p.requires_grad for n, p in port.named_parameters()
               if not n.startswith("ncn."))


def test_synthetic_pairs_equal_the_jax_packages():
    want = jax_synthetic_batch(np.random.RandomState(2), 2, 32, 48, with_h=True)
    got = synthetic_batch(np.random.RandomState(2), 2, 32, 48, with_h=True)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_fresh_model_pretrains_its_ncn():
    """A model built with no state dict loaded: its NCN (xavier-uniform
    kernels, as JAX's ``model.init`` draws them) gives a gradient, and one
    NCN pretraining step at ksize 2 moves every NCN parameter and nothing
    else."""
    torch.manual_seed(1)
    port = Patch2Pix(ModelConfig(change_stride=True, regressor=RegressorConfig(**REG)).resolved(),
                     device="cpu")
    before = {k: v.clone() for k, v in port.state_dict().items()}
    rs = np.random.RandomState(7)
    batch = {k: torch.from_numpy(rs.standard_normal((1, 64, 64, 3)).astype(np.float32))
             for k in ("im_src", "im_pos", "im_neg")}
    step, init = make_ncn_pretrain_step(port, lr=5e-4, ksize=2)
    met = step(init(), batch)
    assert all(torch.isfinite(v) for v in met.values())
    for k, p in port.named_parameters():
        if k.startswith("ncn."):
            assert float(p.grad.abs().max()) > 0, k
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]) != k.startswith("ncn."), k
