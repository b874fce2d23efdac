"""The port's data-parallel train step against its single-device step and
JAX's sharded step, on the CPU.

ResNet34 change_stride at 96x64, global batch 4, ptmax 8, panc 8, with
64-wide regressors, from one seeded state dict, with the proposal draw
JAX makes. The fourth pair's fundamental matrix puts every epipolar
line 1000 px away, so that pair passes no gate: the ranks hold
different counts of valid pairs (2 and 1 at world size 2; 1, 1, 1, 0 at
4), and a step that averaged per-rank losses would weight them wrongly.
One spawned gloo group of 4 ranks (ranks 0-1 or 2-3 for world size 2;
rank workers import no JAX) runs one sharded step per case. Tolerances:

  * against the single-device step on the global batch: the metrics
    rtol 1e-5 (atol 1e-6); the regressors' running averages rtol 1e-5
    (atol 1e-6); the summed gradients within 1e-4 of the largest of
    them; the parameters within the difference those gradients make to
    Adam's first step (``assert_adam_step_close``: a gradient of rounding
    size, the fc biases' before a batch-statistics BatchNorm, may flip
    the sign of its whole step, so a plain rtol cannot hold); frozen
    weights unchanged; every rank holds the same state;
  * against JAX's ``make_sharded_train_step`` on a fake 2-device mesh:
    test_torch_train.py's rules (metrics rtol 1e-3, gradients within
    1e-3 of the largest, Adam's bound, running averages rtol 1e-4);
  * ``backbone_train_bn`` at world size 2 against the single-device
    step: the backbone's running averages move by the global moments;
  * the collectives: all-reduces only, the same count and bytes at 2
    and 4 ranks, at least the trainable gradients' bytes;
  * ``resolve_remat`` equals the choice JAX's step makes with
    ``n_data_shards``.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from patch2pix_tpu.config import ModelConfig as JaxModelConfig
from patch2pix_tpu.config import OptimConfig as JaxOptimConfig
from patch2pix_tpu.config import RegressorConfig as JaxRegressorConfig
from patch2pix_tpu.models.patch2pix import Patch2Pix as JaxPatch2Pix
from patch2pix_tpu.train import create_train_state as jax_create_train_state
from patch2pix_tpu.train import make_optimizer as jax_make_optimizer
from patch2pix_tpu.train.step import make_sharded_train_step as jax_sharded_step
from patch2pix_tpu.train.step import make_train_step as jax_make_train_step
from patch2pix_tpu.utils.torch_import import convert_patch2pix_state_dict
from patch2pix_tpu_torch.config import ModelConfig, OptimConfig, RegressorConfig
from patch2pix_tpu_torch.data.synthetic import synthetic_batch
from patch2pix_tpu_torch.models.patch2pix import Patch2Pix
from patch2pix_tpu_torch.train import create_train_state, make_train_step
from patch2pix_tpu_torch.train.step import resolve_remat, shard_batch_spec
from tests.ref_loader import seeded_state_dict
from tests.test_torch_train import assert_adam_step_close, jax_step_grads
from tests.torch_parallel_worker import LR, run_group
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

H, W, BATCH, PTMAX = 64, 96, 4, 8
REG = dict(conv_dims=(64, 64), fc_dims=(64, 32))
FAR_F = np.array([[0, 0, 0], [0, 0, -1], [0, 1, -1000.0]], np.float32)


def _setting():
    cfg = ModelConfig(change_stride=True, regressor=RegressorConfig(**REG)).resolved()
    port = Patch2Pix(cfg, device="cpu")
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in port.state_dict().items()}, seed=0)
    tsd = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    port.load_state_dict(tsd)
    jm = JaxPatch2Pix(config=JaxModelConfig(
        change_stride=True, regressor=JaxRegressorConfig(**REG)).resolved())
    params, stats = convert_patch2pix_state_dict(sd)
    variables = {"params": jax.tree.map(jnp.asarray, params),
                 "batch_stats": jax.tree.map(jnp.asarray, stats)}
    batch = synthetic_batch(np.random.RandomState(0), BATCH, H, W)
    batch["F"][3] = FAR_F
    rng = jax.random.PRNGKey(3)
    cells = (H // 8 // 2) * (W // 8 // 2)
    rand = np.array(jm.apply(variables, method=lambda m: jax.random.uniform(
        m.make_rng("proposal"), (BATCH, 2 * cells)), rngs={"proposal": rng}))
    return cfg, port, tsd, jm, variables, batch, rng, rand


def _single_step(port, tsd, batch, rand, **kw):
    model = copy.deepcopy(port)
    model.load_state_dict(tsd)
    state = create_train_state(model, OptimConfig(lr_init=LR))
    step = make_train_step(model, state.optimizer, ksize=2, ptmax=PTMAX, **kw)
    _, met = step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                  rand=torch.from_numpy(rand))
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return model.state_dict(), grads, {k: float(v) for k, v in met.items()}


@pytest.fixture(scope="module")
def setting(tmp_path_factory):
    cfg, port, tsd, jm, variables, batch, rng, rand = _setting()
    kw = dict(ksize=2, ptmax=PTMAX, debug_checks=True)
    cases = {"train2": ("train", 2, (cfg, tsd, batch, rand, kw)),
             "train4": ("train", 4, (cfg, tsd, batch, rand, kw)),
             "bn2": ("train", (2, 3), (cfg, tsd, batch, rand,
                                       dict(kw, backbone_train_bn=True)))}
    ranks = run_group(4, cases, tmp_path_factory.mktemp("gloo"))
    single = _single_step(port, tsd, batch, rand)
    single_bn = _single_step(port, tsd, batch, rand, backbone_train_bn=True)

    jstate = jax_create_train_state(rng, jm, JaxOptimConfig(lr_init=LR),
                                    init_variables=variables)
    tx = jax_make_optimizer(JaxOptimConfig(lr_init=LR), jstate.params)
    mesh = JaxMesh(np.asarray(jax.devices()[:2]), ("data",))
    jstep = jax_sharded_step(jm, tx, mesh, ksize=2, ptmax=PTMAX, remat="none")
    jnew, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    from tests.test_torch_train import _tree_sd

    jax_out = dict(met={k: float(v) for k, v in jmet.items()},
                   grads=_tree_sd(jax_step_grads(jnew.opt_state, jnew.params),
                                  jnew.batch_stats),
                   after=_tree_sd(jnew.params, jnew.batch_stats))
    return dict(tsd=tsd, ranks=ranks, single=single, single_bn=single_bn, jax=jax_out)


def _assert_step_close(got, want, before, grad_tol, met_rtol, run_rtol):
    sd, grads, met, _ = got
    wsd, wgrads, wmet = want
    assert set(met) == set(wmet)
    for k in wmet:
        np.testing.assert_allclose(met[k], wmet[k], rtol=met_rtol, atol=1e-6, err_msg=k)
    trained = sorted(grads)
    assert trained and all(k.startswith("regress_") and k in wgrads for k in trained)
    scale = max(float(wgrads[k].abs().max()) for k in trained)
    for k in trained:
        np.testing.assert_allclose(grads[k].numpy(), wgrads[k].numpy(), rtol=0,
                                   atol=grad_tol * scale, err_msg=k)
        assert_adam_step_close(sd[k], wsd[k], grads[k], wgrads[k], LR)
    for k, v in sd.items():
        if k.startswith(("extract.", "ncn.")) and "running" not in k and k in wsd:
            assert torch.equal(v, before[k]), k
        elif "running" in k and k in wsd:
            np.testing.assert_allclose(v.numpy(), wsd[k].numpy(), rtol=run_rtol, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_step_equals_single_device(setting, n):
    ranks = setting["ranks"]
    got = ranks[0][f"train{n}"]
    _assert_step_close(got, setting["single"], setting["tsd"], 1e-4, 1e-5, 1e-5)
    assert 0 < got[2]["skipped"] == 1.0  # one pair of the four fails the gates
    for r in range(1, n):  # replicated on every rank
        for k, v in got[0].items():
            assert torch.equal(ranks[r][f"train{n}"][0][k], v), k
        assert ranks[r][f"train{n}"][2] == got[2]


def test_sharded_step_equals_jax_sharded_step(setting):
    j = setting["jax"]
    _assert_step_close(setting["ranks"][0]["train2"], (j["after"], j["grads"], j["met"]),
                       setting["tsd"], 1e-3, 1e-3, 1e-4)


def test_sharded_step_backbone_train_bn(setting):
    got = setting["ranks"][2]["bn2"]
    _assert_step_close(got, setting["single_bn"], setting["tsd"], 1e-4, 1e-5, 1e-5)
    moved = [k for k in got[0] if k.startswith("extract.") and "running_mean" in k
             and ".layer4." not in k]
    assert moved and all(not torch.equal(got[0][k], setting["tsd"][k]) for k in moved)


def test_sharded_step_collectives(setting):
    ranks = setting["ranks"]
    s2, s4 = ranks[0]["train2"][3], ranks[0]["train4"][3]
    assert set(s2) == set(s4) == {"all-reduce"}
    assert s2 == s4
    n_trained = sum(v.numel() for k, v in ranks[0]["train2"][1].items())
    assert s2["all-reduce"]["bytes"] >= 4 * n_trained


class _Decided(Exception):
    pass


@pytest.mark.parametrize("b,ptmax,panc,n", [(4, 400, 8, 1), (8, 400, 8, 1), (8, 400, 8, 2),
                                            (32, 400, 8, 8), (32, 400, 8, 4), (5, 320, 8, 1)])
def test_resolve_remat_equals_jax(b, ptmax, panc, n):
    """JAX's choice, read from the ``remat`` its step passes to the model."""

    class Stub:
        config = JaxModelConfig(regressor=JaxRegressorConfig(panc=panc)).resolved()

        def apply(self, *args, remat, **kwargs):
            raise _Decided(remat)

    class State:
        params, batch_stats, opt_state = {}, {}, None

    step = jax_make_train_step(Stub(), None, ptmax=ptmax, n_data_shards=n)
    with pytest.raises(_Decided) as decided:
        step(State(), {"im1": jnp.zeros((b, 8, 8, 3)), "im2": jnp.zeros((b, 8, 8, 3)),
                       "F": jnp.zeros((b, 3, 3))}, jax.random.PRNGKey(0))
    assert resolve_remat("auto", b, ptmax, panc, n) == decided.value.args[0]
    assert resolve_remat("fine", b, ptmax, panc, n) == "fine"


def test_shard_batch_spec_names_the_data_axis():
    from patch2pix_tpu.train.step import shard_batch_spec as jax_spec

    assert shard_batch_spec() == {k: v[0] for k, v in jax_spec().items()}
