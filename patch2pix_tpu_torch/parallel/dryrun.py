"""The multi-device dry run: the port's twin of the JAX package's
``dryrun_multichip`` (``__graft_entry__.py``).

    python -m patch2pix_tpu_torch.parallel.dryrun --world N [--device cpu]

Spawns one rank per device (NCCL, one card a rank; gloo processes with
``--device cpu``) from a ``file://`` store and, for each mesh size m in
{2, 4, N} with m <= N (the first m ranks), on JAX's tiny shapes:

  * one sharded train step (the default model, 64x64, ptmax 8, ksize 2,
    Adam 5e-4 with a multistep decay): its only collectives are
    all-reduces, and the step counter reads 1;
  * ``BatchedMatcher`` over m x ``per_chip_batch`` seeded PNG pairs:
    nothing is recorded while matching, only the results' final
    ``all_gather_object``;
  * ``run_dist_ba`` on JAX's synthetic problem (6 cameras, 16 N points,
    0.01 noise, ``max_iters=3``, ``debug_checks=True``): a finite cost.

It prints JAX's ``[dryrun] ...`` lines (``comm_stats.format_comm_table``)
and raises when fewer devices are visible than asked for: it never runs
fewer ranks, or on the CPU, instead.
"""

from __future__ import annotations

import argparse
import os
import pickle
import tempfile
import time
from datetime import timedelta
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from patch2pix_tpu_torch.config import ModelConfig, OptimConfig, resolve_device
from patch2pix_tpu_torch.evaluation.batched import BatchedMatcher
from patch2pix_tpu_torch.models.patch2pix import Patch2Pix
from patch2pix_tpu_torch.parallel.comm_stats import format_comm_table, record_collectives
from patch2pix_tpu_torch.parallel.mesh import (
    make_mesh,
    process_group,
    shard_batch,
    spawned_rank,
)
from patch2pix_tpu_torch.sfm.dist_ba import run_dist_ba, shard_problem
from patch2pix_tpu_torch.train.state import create_train_state
from patch2pix_tpu_torch.train.step import make_train_step

# JAX's shapes: images, proposals, the optimizer
IMAGE, PTMAX, KSIZE = 64, 8, 2
OPTIM = OptimConfig(lr_init=5e-4, lr_decay=("multistep", 0.2, 5))
# how long a rank waits in a collective: a hang fails the run
TIMEOUT = timedelta(minutes=5)


def mesh_sizes(n_devices: int) -> List[int]:
    """JAX's sweep: {2, 4, n} with m <= n."""
    return sorted({m for m in (2, 4, n_devices) if m <= n_devices})


def template_state(seed: int = 0) -> Dict[str, torch.Tensor]:
    """The default model's initial weights, drawn on the CPU from
    ``seed`` (every rank draws the same)."""
    torch.manual_seed(seed)
    return Patch2Pix(ModelConfig().resolved(), device="cpu").state_dict()


def train_batches(n_devices: int) -> Dict[int, Dict[str, np.ndarray]]:
    """{m: the global batch of m pairs} in JAX's draw order."""
    gen = np.random.default_rng(0)
    out = {}
    for m in mesh_sizes(n_devices):
        out[m] = {"im1": gen.normal(size=(m, IMAGE, IMAGE, 3)).astype(np.float32),
                  "im2": gen.normal(size=(m, IMAGE, IMAGE, 3)).astype(np.float32),
                  "F": (gen.normal(size=(m, 3, 3)) * 1e-9).astype(np.float32)}
    return out


def ba_problems(n_devices: int) -> Dict[int, Tuple[np.ndarray, ...]]:
    """{m: (Rs, ts, X, cam_idx, pt_idx, uv)}: JAX's synthetic problem (6
    cameras along x, 16 n points, every point seen by every camera), its
    points perturbed by 0.01 anew for each mesh size, in JAX's order."""
    n_cams, n_pts = 6, 16 * n_devices
    rng = np.random.default_rng(1)
    Rs = np.stack([np.eye(3)] * n_cams)
    ts = np.stack([np.array([0.3 * c, 0.0, 0.0]) for c in range(n_cams)])
    X = rng.uniform([-1, -1, 4], [1, 1, 8], (n_pts, 3))
    cam_idx = np.repeat(np.arange(n_cams), n_pts)
    pt_idx = np.tile(np.arange(n_pts), n_cams)
    uv = np.concatenate([(X @ Rs[c].T + ts[c])[:, :2] / (X @ Rs[c].T + ts[c])[:, 2:3]
                         for c in range(n_cams)])
    return {m: (Rs, ts, X + 0.01 * rng.standard_normal(X.shape), cam_idx, pt_idx, uv)
            for m in mesh_sizes(n_devices)}


def write_pairs(root: str, n: int, seed: int = 2) -> List[Tuple[str, str]]:
    """``n`` pairs of seeded noise PNGs of JAX's image size under ``root``."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(n):
        paths = tuple(os.path.join(root, f"pair{i}_{k}.png") for k in (1, 2))
        for p in paths:
            Image.fromarray(rng.integers(0, 256, (IMAGE, IMAGE, 3), dtype=np.uint8)).save(p)
        pairs.append(paths)
    return pairs


def _train(mesh, template, batch, dev):
    model = Patch2Pix(ModelConfig().resolved(), device="cpu")
    model.load_state_dict(template)
    model.to(dev)
    state = create_train_state(model, OPTIM)
    step = make_train_step(model, state.optimizer, ksize=KSIZE, ptmax=PTMAX, mesh=mesh)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    with record_collectives() as comm:
        state, metrics = step(state, shard_batch(tb, mesh), generator=gen)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    extra = {k: v for k, v in comm.items() if k != "all-reduce"}
    if extra or "all-reduce" not in comm:
        raise RuntimeError(f"train step at mesh {mesh.size}: collectives {comm}; "
                           "all-reduces only expected")
    if state.step != 1:
        raise RuntimeError(f"train step at mesh {mesh.size}: step counter {state.step}")
    return {"comm": comm, "step": state.step,
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _batched(mesh, template, pairs, dev):
    model = Patch2Pix(ModelConfig().resolved(), device="cpu")
    model.load_state_dict(template)
    bm = BatchedMatcher(model.to(dev), mesh=mesh, ksize=KSIZE)
    rows = mesh.size * bm.per_chip_batch
    with record_collectives() as comm:
        out = bm.match_pairs(pairs[:rows])
    # the one collective is the results' final all_gather_object (none on one rank)
    want = {"all-gather": 1} if mesh.size > 1 else {}
    if {k: v["count"] for k, v in comm.items()} != want:
        raise RuntimeError(f"batched matcher at mesh {mesh.size}: collectives {comm}; "
                           "only the final all_gather_object expected")
    return {"B": rows, "comm": comm, "results": out}


def _dist_ba(group, problem, m, dev):
    sp = shard_problem(*problem, n_shards=m)
    with record_collectives() as comm:
        _, _, _, cost = run_dist_ba(sp, group, max_iters=3, debug_checks=True, device=dev)
    if not np.isfinite(cost):
        raise RuntimeError(f"dist BA at mesh {m}: final cost {cost}")
    return {"cost": cost, "comm": comm}


def _rank_main(rank: int, n: int, backend: str, store: str, pairs, out_dir: str,
               threads: int, t_spawn: float) -> None:
    """One rank: its device, the default group, one subgroup a mesh size
    (the first m ranks), the three programs on each mesh it belongs to;
    rank 0 prints JAX's lines and writes the results, with the wall
    seconds from ``t_spawn`` (``time.time()`` at the spawn) to each
    stage's end."""
    seconds = {"up": time.time() - t_spawn}
    if backend == "nccl":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        torch.set_num_threads(threads)
        dev = torch.device("cpu")
    template = template_state()
    batches, problems = train_batches(n), ba_problems(n)
    out = {"train": {}, "batched": {}, "ba": {}, "seconds": seconds}
    with process_group(n, rank, backend, store, timeout=TIMEOUT):
        out["devices"] = [str(d) for d in _gather_devices(dev)]
        groups = {m: dist.group.WORLD if m == n else dist.new_group(list(range(m)))
                  for m in mesh_sizes(n)}
        seconds["group"] = time.time() - t_spawn
        for m, group in groups.items():
            if rank < m:
                out["train"][m] = _train(make_mesh(group=group, device=dev), template,
                                         batches[m], dev)
                _say(rank, f"[dryrun] train step mesh data={m}: "
                     f"{format_comm_table(out['train'][m]['comm'])}")
        seconds["train"] = time.time() - t_spawn
        for m, group in groups.items():
            if rank < m:
                out["batched"][m] = _batched(make_mesh(group=group, device=dev), template,
                                             pairs, dev)
                b = out["batched"][m]
                _say(rank, f"[dryrun] batched matcher mesh data={m}: B={b['B']}, collectives "
                     f"while matching: none, with the results' all_gather_object "
                     f"{format_comm_table(b['comm'])}")
        seconds["batched"] = time.time() - t_spawn
        for m, group in groups.items():
            if rank < m:
                out["ba"][m] = _dist_ba(group, problems[m], m, dev)
                _say(rank, f"[dryrun] dist BA mesh ba={m}: final cost "
                     f"{out['ba'][m]['cost']:.3e}")
        dist.barrier()
        seconds["ba"] = time.time() - t_spawn
    seconds["teardown"] = time.time() - t_spawn
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _gather_devices(dev) -> List[torch.device]:
    """Every rank's device, in rank order; raises where two ranks share a
    card."""
    devices = [None] * dist.get_world_size()
    dist.all_gather_object(devices, dev)
    cards = [d for d in devices if d.type == "cuda"]
    if len(set(cards)) != len(cards):
        raise RuntimeError(f"ranks share a card: {devices}")
    return devices


def _say(rank: int, msg: str) -> None:
    if rank == 0:
        print(msg, flush=True)


def dryrun_multichip(n_devices: int, device=None) -> Dict:
    """Run the sweep over ``n_devices`` ranks (module docstring): one NCCL
    rank per card (CUDA unless ``device`` says otherwise), or gloo
    processes on the CPU. Returns rank 0's results, ``{"devices": every
    rank's device, "train" / "batched" / "ba": {m: ...}, "seconds": the
    wall seconds from the spawn to each stage's end on rank 0, and to the
    parent's join}``."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}): "
                           f"{torch.cuda.device_count()} CUDA card(s) visible")
    threads = max(1, torch.get_num_threads() // n_devices)
    with tempfile.TemporaryDirectory() as tmp:
        # BatchedMatcher's default per_chip_batch: 1 at the default upsample 16
        per_rank = 4 if ModelConfig().change_stride else 1
        pairs = write_pairs(tmp, max(mesh_sizes(n_devices)) * per_rank)
        t_spawn = time.time()
        torch.multiprocessing.start_processes(
            spawned_rank, args=(_rank_main, n_devices, backend, tmp, pairs, tmp, threads,
                                t_spawn), nprocs=n_devices, join=True, start_method="spawn")
        with open(os.path.join(tmp, "rank0.pkl"), "rb") as f:
            out = pickle.load(f)
    out["seconds"]["joined"] = time.time() - t_spawn
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, required=True, help="ranks (devices) to sweep")
    ap.add_argument("--device", default=None, help="cpu or cuda (default: CUDA, required)")
    args = ap.parse_args(argv)
    out = dryrun_multichip(args.world, args.device)
    print("dryrun_multichip OK")
    return out


if __name__ == "__main__":
    main()
