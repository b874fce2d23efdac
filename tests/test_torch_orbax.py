"""A JAX orbax run directory, converted by ``tools/orbax_to_torch.py``,
read by the port on the CPU.

A small Patch2Pix (ResNet34, upsample 16, 64-wide regressors, 96x64,
batch 2, ptmax 8, Adam 5e-4, backbone and NCN frozen) takes two JAX
train steps from a seeded state; the JAX package's ``save_ckpt`` writes
the run directory into ``tmp_path``; the tool converts it in place.
Then:

  * the meta round-trips: the port's ``read_meta`` equals JAX's;
  * the port's ``restore_for_eval`` gives JAX ``restore_for_eval``'s
    ``predict_fine`` at the goldens' tolerances (the same coarse set,
    coords 0.05 px, scores 5e-3), and ``load_model`` and
    ``init_patch2pix_matcher`` build the same model, bit for bit;
  * ``load_ckpt`` gives JAX's step and, after the layout map, JAX's Adam
    moments bit for bit (``exp_avg`` = ``mu``, ``exp_avg_sq`` = ``nu``,
    ``step`` = ``count``); frozen parameters hold no state;
  * one more step from each side on the same batch and proposal draw:
    the metrics rtol 1e-3, the regressors' gradients (JAX's from its
    moments) within 1e-3 of the largest of them, and the parameters
    within the difference the two sides' new moments make to Adam's
    step (:func:`assert_adam_update_close`, the rule of
    ``test_torch_train.assert_adam_step_close`` for a step with history);
  * ``python -m patch2pix_tpu_torch.train.cli --resume`` continues the
    converted run at the meta's next epoch and JAX's step count;
  * ``--eval_only`` writes the same weights with no optimizer state, and
    ``load_ckpt`` refuses to resume from it;
  * an SGD state's momentum becomes ``momentum_buffer``.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from patch2pix_tpu.config import OptimConfig as JaxOptimConfig
from patch2pix_tpu.train import create_train_state as jax_create_train_state
from patch2pix_tpu.train import make_optimizer as jax_make_optimizer
from patch2pix_tpu.train import make_train_step as jax_make_train_step
from patch2pix_tpu.train.checkpoint import read_meta as jax_read_meta
from patch2pix_tpu.train.checkpoint import restore_for_eval as jax_restore_for_eval
from patch2pix_tpu.train.checkpoint import save_ckpt as jax_save_ckpt
from patch2pix_tpu_torch.config import OptimConfig
from patch2pix_tpu_torch.data.synthetic import write_megadepth_fixture
from patch2pix_tpu_torch.evaluation.matcher import init_patch2pix_matcher, load_model
from patch2pix_tpu_torch.train import cli
from patch2pix_tpu_torch.train import (
    create_train_state,
    load_ckpt,
    make_optimizer,
    make_train_step,
    read_meta,
    restore_for_eval,
)
from patch2pix_tpu_torch.utils.jax_import import optimizer_state_from_jax, state_dict_from_jax
from tests.test_pipeline_e2e_parity import assert_match_parity, seeded_images
from tests.test_torch_train import BATCH, H, LR, PTMAX, W, _batch, _models, _proposal_draw
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from orbax_to_torch import main as orbax_to_torch  # noqa: E402

B1, B2, EPS = 0.9, 0.999, 1e-8
CELLS = (H // 16 // 2) * (W // 16 // 2)


def _moments(opt_state):
    adam = opt_state.inner_states["train"].inner_state[0]
    return adam.count, adam.mu, adam.nu


def _sd(tree):
    """A JAX moment tree (frozen leaves ``MaskedNode``) in the port's
    keys and layouts, through the converter's own unmasking."""
    from patch2pix_tpu_torch.utils.jax_import import _NoStats, _unmask

    return state_dict_from_jax({"params": _unmask(tree), "batch_stats": _NoStats()})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Two JAX steps, the JAX run directory, the conversion."""
    port, jm, variables = _models(False)
    cfg = JaxOptimConfig(lr_init=LR)
    jstate = jax_create_train_state(jax.random.PRNGKey(0), jm, cfg, init_variables=variables)
    jstep = jax.jit(jax_make_train_step(jm, jax_make_optimizer(cfg, jstate.params),
                                        ksize=2, ptmax=PTMAX, remat="none"))
    for i in range(2):
        nb, _ = _batch(seed=i)
        jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in nb.items()},
                          jax.random.PRNGKey(10 + i))
    run_dir = str(tmp_path_factory.mktemp("jax_run"))
    jax_save_ckpt(run_dir, jstate, jm.config, epoch=4, best_vals=[1.5, 0.25, np.inf, 0.0])
    orbax_to_torch([run_dir, "--lr_init", str(LR)])
    return dict(dir=run_dir, jm=jm, jstate=jstate, jstep=jstep, port=port)


@pytest.fixture(scope="module")
def restored(run):
    """The port's ``restore_for_eval`` of the converted directory."""
    return restore_for_eval(run["dir"], device="cpu")


def test_meta_round_trips(run):
    assert read_meta(run["dir"]) == jax_read_meta(run["dir"])
    assert read_meta(run["dir"])["epoch"] == 4


def test_restore_for_eval_matches_jax(run, restored):
    jm, jvars = jax_restore_for_eval(run["dir"])
    im1, im2 = (seeded_images(2, 128, 192, seed) for seed in (5, 6))
    want = jax.tree.map(np.asarray, jax.jit(lambda v, a, b: jm.apply(
        v, a, b, ksize=2, method=jm.predict_fine))(jvars, jnp.asarray(im1), jnp.asarray(im2)))
    model = restored
    assert model.config.regressor.panc == 1
    got = [jax.tree.map(lambda t: t.numpy(), m) for m in model.predict_fine(
        torch.from_numpy(im1), torch.from_numpy(im2), ksize=2)]
    wf, wm, wc = want
    for b in range(2):
        valid = wc.valid[b]
        assert valid.any()
        assert_match_parity(b, wc.coords[b][valid], wm.coords[b][valid],
                            wm.scores[b][valid], wf.coords[b][valid],
                            wf.scores[b][valid], *got, coord_tol=0.05, score_tol=5e-3)
    # the evaluation loaders build the same model from the directory
    sd = model.state_dict()
    for other in (load_model(run["dir"], device="cpu"),
                  init_patch2pix_matcher(run["dir"], device="cpu").model):
        assert other.config == model.config
        assert all(torch.equal(v, sd[k]) for k, v in other.state_dict().items())


def _resumed(run):
    port = run["port"]
    state = create_train_state(port, OptimConfig(lr_init=LR))
    return load_ckpt(run["dir"], state)[0]


def test_resume_holds_jax_step_and_moments(run):
    state = _resumed(run)
    count, mu, nu = _moments(run["jstate"].opt_state)
    assert state.step == int(run["jstate"].step) == int(count) == 2
    opt = state.optimizer.inner
    names = {id(p): n for n, p in state.model.named_parameters()}
    held = {names[id(p)]: opt.state[p] for p in opt.param_groups[0]["params"]}
    assert held and all(n.startswith("regress_") for n in held)
    mu, nu = _sd(mu), _sd(nu)
    for n, st in held.items():
        assert float(st["step"]) == 2.0
        np.testing.assert_array_equal(st["exp_avg"].numpy(), mu[n].numpy(), err_msg=n)
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), nu[n].numpy(), err_msg=n)
    assert not any(k.startswith(("extract.", "ncn.")) for k in mu)


def assert_adam_update_close(got, want, m, v, jm, jv, count, lr):
    """Parameters after an Adam step from equal parameters, the port's
    new moments ``m``, ``v`` and JAX's ``jm``, ``jv``: within 1.01 times
    the difference of the two steps ``lr * m^ / (sqrt(v^) + eps)``, plus
    1e-6 for the parameters' f32 rounding."""
    def update(m_, v_):
        m_, v_ = m_.double() / (1 - B1 ** count), v_.double() / (1 - B2 ** count)
        return lr * m_ / (v_.sqrt() + EPS)

    bound = (update(m, v) - update(jm, jv)).abs()
    excess = (got.double() - want.double()).abs() - 1.01 * bound - 1e-6
    assert float(excess.max()) <= 0, float(excess.max())


def test_resumed_step_agrees_with_jax(run):
    state = _resumed(run)
    nb, tb = _batch(seed=7)
    rng = jax.random.PRNGKey(21)
    jstate = run["jstate"]
    rand = _proposal_draw(run["jm"], {"params": jstate.params,
                                      "batch_stats": jstate.batch_stats}, rng, 2 * CELLS)
    jnew, jmet = run["jstep"](run["jstate"], {k: jnp.asarray(v) for k, v in nb.items()}, rng)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    step = make_train_step(state.model, state.optimizer, ksize=2, ptmax=PTMAX)
    state, met = step(state, tb, rand=torch.from_numpy(rand))
    assert state.step == int(jnew.step) == 3
    assert float(met["skipped"]) < BATCH
    for k in jmet:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-3, atol=1e-5,
                                   err_msg=k)
    _, mu0, _ = _moments(run["jstate"].opt_state)
    _, mu1, nu1 = _moments(jnew.opt_state)
    mu0, mu1, nu1 = _sd(mu0), _sd(mu1), _sd(nu1)
    jparams = _sd(jnew.params)
    opt = state.optimizer.inner
    grads = {n: p.grad for n, p in state.model.named_parameters() if p.grad is not None}
    jgrads = {n: (mu1[n] - B1 * mu0[n]) / (1 - B1) for n in grads}
    scale = max(float(g.abs().max()) for g in jgrads.values())
    assert scale > 0 and set(grads) == set(mu1)
    params = dict(state.model.named_parameters())
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[n].numpy(), rtol=0, atol=1e-3 * scale,
                                   err_msg=n)
        st = opt.state[params[n]]
        assert_adam_update_close(params[n].detach(), jparams[n], st["exp_avg"],
                                 st["exp_avg_sq"], mu1[n], nu1[n], 3, LR)
    for k, v in state.model.state_dict().items():
        if k.startswith(("extract.", "ncn.")):
            assert torch.equal(v, before[k]), k


def test_cli_resumes_the_converted_run(run, tmp_path):
    """The converted tag, at the run directory the CLI's flags name (the
    JAX CLI's scheme), resumes one epoch of one step."""
    data_root, pair_root, npy, _ = write_megadepth_fixture(str(tmp_path / "fx"), 2, H, W)
    flags = ["--device", "cpu", "--no_eval", "--data_root", data_root, "--pair_root",
             pair_root, "--match_npy", npy, "--wt", str(W), "--ht", str(H), "--batch",
             str(BATCH), "--ptmax", str(PTMAX), "--conv_dims", "64", "64", "--fc_dims", "64",
             "32", "--lr_init", str(LR), "--epochs", "6", "--steps_per_epoch", "1",
             "-o", str(tmp_path / "runs"), "--resume"]
    out = cli.run_dir_tags(cli.parse_args(flags))
    os.makedirs(out)
    for f in ("last.pt", "last.meta.json"):
        shutil.copy(os.path.join(run["dir"], f), out)
    assert cli.main(flags) == out
    assert "Resumed from epoch 5" in open(os.path.join(out, "log.txt")).read()
    assert read_meta(out)["epoch"] == 5
    assert torch.load(os.path.join(out, "last.pt"), weights_only=True)["step"] == 3


def test_eval_only_conversion(run, restored, tmp_path):
    out = str(tmp_path / "eval")
    orbax_to_torch([run["dir"], "--eval_only", "--out", out])
    assert read_meta(out) == jax_read_meta(run["dir"])
    got = restore_for_eval(out, device="cpu").state_dict()
    want = restored.state_dict()
    # layer4 and the BatchNorm counters are not in the JAX tree: they
    # keep each model's initial values
    held = [k for k in want if ".layer4." not in k and not k.endswith("num_batches_tracked")]
    assert len(held) > 150 and all(torch.equal(got[k], want[k]) for k in held)
    with pytest.raises(ValueError, match="no optimizer state"):
        load_ckpt(out, create_train_state(run["port"], OptimConfig(lr_init=LR)))


def test_sgd_momentum_becomes_momentum_buffer(run):
    """optax ``sgd(momentum=0.9)``'s trace -> torch SGD's buffer."""
    port = run["port"]
    cfg = JaxOptimConfig(opt="sgd", lr_init=LR)
    jstate = run["jstate"]
    tx = jax_make_optimizer(cfg, jstate.params)
    opt_state = tx.init(jstate.params)
    trace = opt_state.inner_states["train"].inner_state[0].trace
    opt_state = jax.tree.map(lambda t: t + 1.0, opt_state)
    optimizer = make_optimizer(OptimConfig(opt="sgd", lr_init=LR), port)
    sd = optimizer_state_from_jax(opt_state, port, optimizer)
    optimizer.inner.load_state_dict(sd)
    want = _sd(jax.tree.map(lambda t: t + 1.0, trace))
    names = dict(port.named_parameters())
    held = [n for n, p in names.items() if p.requires_grad]
    assert held
    for n in held:
        buf = optimizer.inner.state[names[n]]["momentum_buffer"]
        np.testing.assert_array_equal(buf.numpy(), want[n].numpy(), err_msg=n)
