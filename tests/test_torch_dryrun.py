"""The port's ``dryrun_multichip`` (``parallel/dryrun.py``) over 2 gloo
ranks on the CPU, on the JAX package's shapes, held to world size 1.

One module-scoped run of ``dryrun_multichip(2, device="cpu")`` (spawned
ranks that import no JAX), then:

  * the train step's collectives are all-reduces only, the step counter
    reads 1, and their count and bytes equal what the step must send,
    counted in this process on the same batch without a mesh: the
    trainable gradients' one buffer, each batch-statistics moment sum
    forward and backward, and the loss's one sum over pairs;
  * ``BatchedMatcher`` records only the results' final
    ``all_gather_object``, and its matches equal world size 1's (a mesh
    of one rank in this process): the same coarse matches, coords within
    1e-3 px, scores within 1e-4 (``test_torch_batched.py``'s rule);
  * the dist BA's final cost is finite and within rtol 1e-3 of
    ``run_dist_ba`` at world size 1 on the same problem, plus the cost's
    float32 floor (the cost of the exact solution, evaluated in float32):
    three LM steps bring the cost from 1.3e-3 to ~2.4e-12, where the
    ranks' other order of summation moves it by ~0.14%;
  * against JAX on the same inputs (``__graft_entry__.dryrun_multichip``'s
    step, compiled by ``make_sharded_train_step`` on a mesh of 2 fake CPU
    devices, its collectives read from the HLO): the same count of
    all-reduces (18), all-reduces only; the convolutions' and dense
    layers' weight gradients the same bytes, and the forward passes'
    batch-statistics moments the same bytes. The rest differs (226 KiB
    more in JAX, ``PERF.md``): XLA sends the backward sums over the batch
    of each regressor's second conv before it sums over the 8x8
    positions, where the port sends per-channel sums;
  * the dist BA's final cost at mesh 2 within rtol 1e-3 of JAX's
    ``run_dist_ba`` on the same problem (mesh of 2 fake CPU devices),
    plus the float32 floor above;
  * a rank's CUDA device without an index (``parallel.mesh.rank_device``)
    is its own card, made the current one, in a group of more than one
    rank; the current card alone;
  * a spawned rank that fails (``parallel.mesh.spawned_rank``) ends at
    once with exit code 1 while its peer waits in a collective, and the
    run ends well inside the group's timeout (over gloo the peer may
    fail first, on the closed connection);
  * ``parallel.mesh.process_group`` aborts its group when the body
    raises (the NCCL teardown would wait on the peers' collectives:
    ROADMAP C7) and destroys it on a normal exit; either way no group is
    left and a new one can start.
"""

import contextlib
import re
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from patch2pix_tpu.config import ModelConfig as JaxModelConfig
from patch2pix_tpu.config import OptimConfig as JaxOptimConfig
from patch2pix_tpu.models.patch2pix import Patch2Pix as JaxPatch2Pix
from patch2pix_tpu.parallel.comm_stats import collective_stats
from patch2pix_tpu.sfm import dist_ba as jax_dist
from patch2pix_tpu.train import create_train_state as jax_create_train_state
from patch2pix_tpu.train import make_optimizer as jax_make_optimizer
from patch2pix_tpu.train import make_sharded_train_step as jax_sharded_step

from patch2pix_tpu_torch.config import ModelConfig
from patch2pix_tpu_torch.evaluation.batched import BatchedMatcher
from patch2pix_tpu_torch.models.patch2pix import Patch2Pix
from patch2pix_tpu_torch.parallel import dryrun, mesh as mesh_module
from patch2pix_tpu_torch.parallel.mesh import (
    make_mesh,
    process_group,
    rank_device,
    spawned_rank,
)
from patch2pix_tpu_torch.sfm.ba import build_problem, cost
from patch2pix_tpu_torch.sfm.dist_ba import run_dist_ba_ranks, shard_problem
from patch2pix_tpu_torch.train import step as step_module
from patch2pix_tpu_torch.train.state import create_train_state
from tests.torch_dist_worker import failing_rank
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

WORLD = 2


@pytest.fixture(scope="module")
def run():
    return dryrun.dryrun_multichip(WORLD, device="cpu")


def _model():
    model = Patch2Pix(ModelConfig().resolved(), device="cpu")
    model.load_state_dict(dryrun.template_state())
    return model


class _Spy(torch.autograd.Function):
    """The identity, recording its input's bytes forward (in
    ``sent[0]``) and its gradient's bytes backward (in ``sent[1]``)."""

    @staticmethod
    def forward(ctx, t, sent):
        ctx.sent = sent
        sent[0].append(t.numel() * t.element_size())
        return t.clone()

    @staticmethod
    def backward(ctx, g):
        ctx.sent[1].append(g.numel() * g.element_size())
        return g, None


def _spied_all_reduces(batch, monkeypatch):
    """What one step must sum over ranks, from a step without a mesh
    whose moment and pair sums are recorded: the bytes of each forward
    and each backward moment sum, of the pair sums, and of the trainable
    weights of two or more dimensions (convolutions and dense layers)
    and of all of them."""
    moments, pairs = ([], []), []
    make_moments, make_losses = step_module.global_batch_moments, step_module.patch2pix_losses

    def moments_spy(sum_fn, ranks):
        return make_moments(lambda t: _Spy.apply(t, moments), ranks)

    def losses_spy(*args, pair_sum=None, **kw):
        def record(t):
            pairs.append(t.numel() * t.element_size())
            return pair_sum(t)
        return make_losses(*args, pair_sum=record, **kw)

    monkeypatch.setattr(step_module, "global_batch_moments", moments_spy)
    monkeypatch.setattr(step_module, "patch2pix_losses", losses_spy)
    model = _model()
    state = create_train_state(model, dryrun.OPTIM)
    step = step_module.make_train_step(model, state.optimizer, ksize=dryrun.KSIZE,
                                       ptmax=dryrun.PTMAX)
    step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
         generator=torch.Generator().manual_seed(1))
    trainable = [p for p in model.parameters() if p.requires_grad]
    assert moments[0] and len(moments[1]) == len(moments[0]) and len(pairs) == 1
    return {"forward moments": moments[0], "backward moments": moments[1], "pairs": pairs,
            "weights": sum(4 * p.numel() for p in trainable if p.dim() >= 2),
            "grads": sum(4 * p.numel() for p in trainable)}


def _expected_all_reduces(sent):
    """(count, bytes) of the port's step: the gradients' one buffer, each
    moment sum forward and backward, and the pair sum."""
    sums = sent["forward moments"] + sent["backward moments"] + sent["pairs"]
    return 1 + len(sums), sent["grads"] + sum(sums)


@pytest.fixture(scope="module")
def jax_step_hlo():
    """The compiled HLO of JAX's sharded step as its ``dryrun_multichip``
    builds it (default model, Adam 5e-4 with the multistep decay, ksize
    2, ptmax 8), on a mesh of ``WORLD`` fake CPU devices and the dry
    run's batch."""
    model = JaxPatch2Pix(config=JaxModelConfig().resolved())
    cfg = JaxOptimConfig(lr_init=5e-4, lr_decay=("multistep", 0.2, 5))
    state = jax_create_train_state(jax.random.PRNGKey(0), model, cfg,
                                   image_shape=(1, dryrun.IMAGE, dryrun.IMAGE, 3))
    step = jax_sharded_step(model, jax_make_optimizer(cfg, state.params),
                            JaxMesh(np.asarray(jax.devices()[:WORLD]), ("data",)),
                            ksize=dryrun.KSIZE, ptmax=dryrun.PTMAX)
    batch = {k: jax.numpy.asarray(v) for k, v in dryrun.train_batches(WORLD)[WORLD].items()}
    return step.lower(state, batch, jax.random.PRNGKey(1)).compile().as_text()


def _all_reduce_operands(hlo):
    """[(bytes, op_name)] of every operand of every all-reduce in
    ``hlo``, each named by the op its defining instruction came from."""
    defs = {}
    for line in hlo.splitlines():
        m = re.match(r"\s*(?:ROOT )?(%[\w.\-]+) = (.*)", line)
        if m:
            defs[m.group(1)] = m.group(2)
    out = []
    for line in hlo.splitlines():
        if " all-reduce(" not in line:
            continue
        args = line[line.index(" all-reduce(") + len(" all-reduce("):]
        for name in args[:args.index(")")].split(","):
            d = defs[re.sub(r"/\*.*?\*/", "", name).strip()]
            dims = re.match(r"\w+\[([\d,]*)\]", d).group(1)
            op = re.search(r'op_name="([^"]*)"', d)
            out.append((4 * int(np.prod([int(x) for x in dims.split(",") if x])),
                        op.group(1) if op else ""))
    return out


def test_dryrun_train_step_sends_all_reduces_only(run, monkeypatch):
    assert run["devices"] == ["cpu"] * WORLD
    got = run["train"][WORLD]
    assert got["step"] == 1
    assert set(got["comm"]) == {"all-reduce"}
    sent = _spied_all_reduces(dryrun.train_batches(WORLD)[WORLD], monkeypatch)
    count, nbytes = _expected_all_reduces(sent)
    assert got["comm"]["all-reduce"] == {"count": count, "bytes": nbytes}


def test_dryrun_train_step_all_reduces_match_jax(run, jax_step_hlo, monkeypatch):
    """JAX's step at mesh 2 (its HLO's all-reduces, all float32): the same
    count as the port's step; the weight gradients and the forward
    moments the same bytes. JAX's gradient sums come from the transposed
    (backward) convolutions and dot products; its forward moments from
    the forward pass's reductions of non-scalar shape."""
    jax_comm = collective_stats(jax_step_hlo)
    got = run["train"][WORLD]["comm"]
    assert set(jax_comm) == set(got) == {"all-reduce"}
    assert got["all-reduce"]["count"] == jax_comm["all-reduce"]["count"] == 18
    operands = _all_reduce_operands(jax_step_hlo)
    assert sum(b for b, _ in operands) == jax_comm["all-reduce"]["bytes"]
    backward = [(b, op) for b, op in operands if "transpose(" in op]
    weights = sum(b for b, op in backward if op.endswith(("conv_general_dilated", "dot_general")))
    forward_moments = sum(b for b, op in operands
                          if "transpose(" not in op and "Patch2Pix" in op and b > 4)
    sent = _spied_all_reduces(dryrun.train_batches(WORLD)[WORLD], monkeypatch)
    assert weights == sent["weights"]
    assert forward_moments == sum(sent["forward moments"])
    # most of the rest: each regressor's second conv's backward sum over
    # the batch, all-reduced before the sum over its 8x8 positions
    partials = [b for b, op in backward if op.endswith("conv1/reduce_sum")]
    assert partials == [4 * 8 * 8 * 512] * 2


def test_dryrun_batched_matcher_equals_world_one(run, tmp_path):
    got = run["batched"][WORLD]
    assert got["B"] == WORLD and set(got["comm"]) == {"all-gather"}
    assert got["comm"]["all-gather"]["count"] == 1
    pairs = dryrun.write_pairs(str(tmp_path), WORLD)
    want = BatchedMatcher(_model(), mesh=make_mesh(1, device="cpu"),
                          ksize=dryrun.KSIZE).match_pairs(pairs)
    assert len(got["results"]) == len(want) == WORLD
    for (gm, gs, gc), (wm, ws, wc) in zip(got["results"], want):
        assert len(wc) > 0
        g, w = np.lexsort(gc.T[::-1]), np.lexsort(wc.T[::-1])
        np.testing.assert_array_equal(gc[g], wc[w])
        np.testing.assert_allclose(gm[g], wm[w], rtol=0, atol=1e-3)
        np.testing.assert_allclose(gs[g], ws[w], rtol=0, atol=1e-4)


def test_dryrun_dist_ba_equals_world_one(run):
    got = run["ba"][WORLD]["cost"]
    Rs, ts, X, cam_idx, pt_idx, uv = dryrun.ba_problems(WORLD)[WORLD]
    want = run_dist_ba_ranks(shard_problem(Rs, ts, X, cam_idx, pt_idx, uv, n_shards=1),
                             device="cpu", max_iters=3, debug_checks=True)[3]
    exact = np.random.default_rng(1).uniform([-1, -1, 4], [1, 1, 8], (X.shape[0], 3))
    floor = float(cost(build_problem(Rs, ts, exact, cam_idx, pt_idx, uv, device="cpu")))
    assert np.isfinite(got) and 0 < floor < 0.1 * want
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=floor)


def test_dryrun_dist_ba_matches_jax(run):
    """The dist BA at mesh 2 against JAX's ``run_dist_ba`` on the same
    problem, as JAX's ``dryrun_multichip`` runs it (3 LM steps, the debug
    checks), on a mesh of 2 fake CPU devices."""
    got = run["ba"][WORLD]["cost"]
    Rs, ts, X, cam_idx, pt_idx, uv = dryrun.ba_problems(WORLD)[WORLD]
    want = jax_dist.run_dist_ba(
        jax_dist.shard_problem(Rs, ts, X, cam_idx, pt_idx, uv, n_shards=WORLD),
        JaxMesh(np.asarray(jax.devices()[:WORLD]), ("ba",)), max_iters=3,
        debug_checks=True)[3]
    exact = np.random.default_rng(1).uniform([-1, -1, 4], [1, 1, 8], (X.shape[0], 3))
    floor = float(cost(build_problem(Rs, ts, exact, cam_idx, pt_idx, uv, device="cpu")))
    assert np.isfinite(want) and 0 < floor < 0.1 * want
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=floor)


def test_dryrun_refuses_more_ranks_than_cards():
    if torch.cuda.is_available():
        pytest.skip("the refusal is tested where no card is visible")
    with pytest.raises(RuntimeError, match="card"):
        dryrun.dryrun_multichip(2, device="cuda")


@pytest.mark.parametrize("local_rank,rank,want", [(None, 2, 2), (None, 5, 1), ("3", 1, 3)])
def test_rank_device_is_the_ranks_own_card(monkeypatch, local_rank, rank, want):
    """In a group of 4 ranks on hosts of 4 cards, a rank that never set
    its card gets ``LOCAL_RANK``'s card, else its rank's modulo the
    cards, made current; card 0 was the current one."""
    made = []
    monkeypatch.setattr(mesh_module.dist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(mesh_module.dist, "get_rank", lambda group=None: rank)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_device", made.append)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    assert rank_device("cuda", group=object()) == torch.device("cuda", want)
    assert made == [want]
    # an indexed device, or a rank alone, keeps its card and sets none
    assert rank_device("cuda:3", group=object()) == torch.device("cuda", 3)
    assert rank_device("cuda") == torch.device("cuda", 0)
    assert made == [want]



def test_failed_rank_ends_at_once(tmp_path):
    t0 = time.perf_counter()
    with pytest.raises(torch.multiprocessing.ProcessExitedException) as raised:
        torch.multiprocessing.start_processes(
            spawned_rank, args=(failing_rank, 2, str(tmp_path), 120), nprocs=2,
            join=True, start_method="spawn")
    assert raised.value.exit_code == 1
    assert time.perf_counter() - t0 < 60


@pytest.mark.parametrize("fails", [False, True])
def test_process_group_aborts_on_error_and_destroys_on_exit(tmp_path, monkeypatch, fails):
    calls = []
    destroy, abort = mesh_module.dist.destroy_process_group, mesh_module.abort_process_group

    def destroy_logged():
        calls.append("destroy")
        destroy()

    def abort_logged():
        calls.append("abort")
        abort()

    monkeypatch.setattr(mesh_module.dist, "destroy_process_group", destroy_logged)
    monkeypatch.setattr(mesh_module, "abort_process_group", abort_logged)
    with pytest.raises(RuntimeError) if fails else contextlib.nullcontext():
        with process_group(1, 0, "gloo", str(tmp_path)):
            torch.distributed.barrier()
            if fails:
                raise RuntimeError("the body fails")
    assert calls == (["abort"] if fails else ["destroy"])
    assert not torch.distributed.is_initialized()
    (tmp_path / "again").mkdir()
    with process_group(1, 0, "gloo", str(tmp_path / "again")):
        torch.distributed.barrier()
