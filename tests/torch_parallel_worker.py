"""The rank worker of the parallel tests' gloo groups.

Imports no JAX (each spawned rank starts in seconds). Each rank joins
one gloo group from a ``file://`` store, makes a subgroup for each set
of ranks its cases name, runs every case it belongs to and writes its
results to ``{out_dir}/rank{r}.pkl``. A case is ``(kind, ranks, args)``,
``ranks`` an int n for the first n ranks or a tuple of ranks (the
case's world size is its length; a mesh of one rank has no group):

  * ``("coarse", world, (cfg, state_dict, feat1, feat2, ksize))``: the
    sharded coarse matcher -> (coords, scores, valid, collectives);
  * ``("batched", world, (cfg, state_dict, pairs, kwargs))``:
    ``BatchedMatcher.match_pairs`` -> (results, collectives);
  * ``("train", world, (cfg, state_dict, batch, rand, kwargs))``: one
    sharded train step (Adam 5e-4) -> (state dict after the step, the
    summed gradients by name, metrics, collectives).
"""

import os
import pickle

import torch
import torch.distributed as dist

from patch2pix_tpu_torch.config import OptimConfig
from patch2pix_tpu_torch.evaluation.batched import BatchedMatcher
from patch2pix_tpu_torch.models.patch2pix import Patch2Pix
from patch2pix_tpu_torch.parallel import (
    make_mesh,
    make_sharded_coarse_matcher,
    process_group,
    record_collectives,
    shard_batch,
)
from patch2pix_tpu_torch.train import create_train_state
from patch2pix_tpu_torch.train.step import make_sharded_train_step

LR = 5e-4


_MODELS = {}


def _model(cfg, state_dict):
    """A model of ``cfg`` holding ``state_dict`` (built once per config)."""
    key = repr(cfg)
    if key not in _MODELS:
        _MODELS[key] = Patch2Pix(cfg, device="cpu")
    model = _MODELS[key]
    model.load_state_dict(state_dict)
    return model


def _coarse(mesh, cfg, sd, f1, f2, ksize):
    model = _model(cfg, sd)
    fn = make_sharded_coarse_matcher(model, mesh, ksize=ksize)
    with record_collectives() as stats:
        m = fn(torch.from_numpy(f1), torch.from_numpy(f2))
    return m.coords.numpy(), m.scores.numpy(), m.valid.numpy(), stats


def _batched(mesh, cfg, sd, pairs, kwargs):
    bm = BatchedMatcher(_model(cfg, sd), mesh=mesh, **kwargs)
    with record_collectives() as stats:
        out = bm.match_pairs(pairs)
    return out, stats


def _train(mesh, cfg, sd, batch, rand, kwargs):
    model = _model(cfg, sd)
    state = create_train_state(model, OptimConfig(lr_init=LR))
    step = make_sharded_train_step(model, state.optimizer, mesh, **kwargs)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with record_collectives() as stats:
        state, metrics = step(state, shard_batch(tb, mesh), rand=torch.from_numpy(rand))
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    after = {k: v.clone() for k, v in model.state_dict().items()}
    return after, grads, {k: float(v) for k, v in metrics.items()}, stats


RUNNERS = {"coarse": _coarse, "batched": _batched, "train": _train}


def worker(rank, world, store_dir, cases_path, out_dir):
    torch.set_num_threads(1)
    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    results = {}
    members = {name: tuple(range(r)) if isinstance(r, int) else tuple(r)
               for name, (_, r, _) in cases.items()}
    with process_group(world, rank, "gloo", store_dir):
        groups = {tuple(range(world)): dist.group.WORLD}
        for ranks in sorted(set(members.values())):
            if ranks not in groups:  # every rank makes every subgroup, in one order
                groups[ranks] = dist.new_group(list(ranks))
        for name, (kind, _, args) in cases.items():
            if rank in members[name]:
                mesh = make_mesh(len(members[name]), group=groups[members[name]],
                                 device="cpu")
                results[name] = RUNNERS[kind](mesh, *args)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def run_group(world, cases, tmp):
    """Spawn ``world`` gloo ranks over ``cases`` (written once to a file
    in ``tmp`` for the ranks to read: each spawned rank would unpickle its
    arguments in turn); returns each rank's results, in rank order."""
    cases_path = os.path.join(str(tmp), "cases.pkl")
    with open(cases_path, "wb") as f:
        pickle.dump(cases, f)
    torch.multiprocessing.start_processes(worker, args=(world, str(tmp), cases_path, str(tmp)),
                                          nprocs=world, join=True, start_method="spawn")
    out = []
    for r in range(world):
        with open(os.path.join(str(tmp), f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out

