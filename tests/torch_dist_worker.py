"""The rank worker of ``tests/test_torch_sfm_ba.py``'s gloo group.

Imports no JAX (each spawned rank starts in seconds). Each rank joins
one gloo group from a ``file://`` store, runs every case on its shard,
and rank 0 writes the results to ``{out_dir}/results.pkl``:

  * ``("step", sp, C)``: one :func:`make_dist_ba_step` step (λ 1e-3, no
    Huber) -> new R, t, the gathered new points (global order), new and
    old cost;
  * ``("run", sp, kwargs)``: :func:`run_dist_ba` -> (R, t, X, cost).

:func:`failing_rank` is a group whose rank 0 raises while the others
wait in a collective (``tests/test_torch_dryrun.py`` over gloo,
``tests/test_torch_card.py`` over NCCL); :func:`time_failing_run` prints
such a run's timeline (``PYTHONPATH=. python3 tests/torch_dist_worker.py
--backend nccl --timeout 40`` on two cards).
"""

import argparse
import os
import pickle
import sys
import tempfile
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from patch2pix_tpu_torch.parallel.mesh import process_group, spawned_rank
from patch2pix_tpu_torch.sfm.dist_ba import local_problem, make_dist_ba_step, run_dist_ba


def failing_rank(rank, world, store_dir, timeout_s, backend="gloo", t_spawn=None):
    """Join the group (gloo, or NCCL with one card a rank), pass a
    barrier, then rank 0 raises while the other ranks wait in a second
    barrier. With ``t_spawn`` (the parent's ``time.time()`` at the
    spawn) each rank prints its stages in wall seconds from it."""

    def stage(what):
        if t_spawn is not None:
            print(f"rank {rank}: {what} {time.time() - t_spawn:.2f} s", file=sys.stderr,
                  flush=True)

    stage("up")
    if backend == "nccl":
        torch.cuda.set_device(rank)
    with process_group(world, rank, backend, store_dir, timeout=timedelta(seconds=timeout_s)):
        dist.barrier()
        stage("past the first barrier")
        if rank == 0:
            stage("raising")
            raise RuntimeError("rank 0 fails inside its group")
        dist.barrier()


def time_failing_run(world, timeout_s, backend):
    """Spawn :func:`failing_rank` over ``world`` ranks and print, in wall
    seconds from the spawn, each rank's stages, when each rank process
    ends and with which exit code, and when the parent's join (which
    terminates the ranks left once one has failed: SIGTERM, then SIGKILL
    after its grace period) returns."""
    store_dir = tempfile.mkdtemp()
    t_spawn = time.time()
    ctx = torch.multiprocessing.start_processes(
        spawned_rank, args=(failing_rank, world, store_dir, timeout_s, backend, t_spawn),
        nprocs=world, join=False, start_method="spawn")
    ended = {}

    def poll():
        for r, p in enumerate(ctx.processes):
            if r not in ended and not p.is_alive():
                ended[r] = p.exitcode
                print(f"parent: rank {r} ended with exit code {p.exitcode} "
                      f"{time.time() - t_spawn:.2f} s", flush=True)

    while not ended:
        poll()
        time.sleep(0.05)
    try:
        ctx.join()
    except torch.multiprocessing.ProcessExitedException as e:
        print(f"parent: join raised for rank {e.error_index} (exit code {e.exit_code}) "
              f"{time.time() - t_spawn:.2f} s", flush=True)
    poll()
    print(f"parent: every rank ended {time.time() - t_spawn:.2f} s after the spawn "
          f"(group timeout {timeout_s} s, {backend})", flush=True)


def _gather_points(sp, X_local, group):
    parts = [torch.empty_like(X_local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, X_local.contiguous(), group=group)
    Xg = np.zeros((int(sp.X_map.max()) + 1, 3), np.float32)
    for s, part in enumerate(parts):
        m = sp.X_map[s] >= 0
        Xg[sp.X_map[s][m]] = part.numpy()[m]
    return Xg


def worker(rank, world, store_dir, cases, out_dir):
    torch.set_num_threads(1)
    results = {}
    with process_group(world, rank, "gloo", store_dir) as group:
        for name, (kind, sp, arg) in cases.items():
            if kind == "step":
                step = make_dist_ba_step(arg, use_huber=False, group=group)
                nR, nt, nX, nc, oc = step(local_problem(sp, rank, "cpu"), 1e-3, 1e9)
                results[name] = (nR.numpy(), nt.numpy(), _gather_points(sp, nX, group),
                                 float(nc), float(oc))
            else:
                results[name] = run_dist_ba(sp, group, device="cpu", **arg)
    if rank == 0:
        with open(os.path.join(out_dir, "results.pkl"), "wb") as f:
            pickle.dump(results, f)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=time_failing_run.__doc__)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=120.0, help="the group's timeout, s")
    ap.add_argument("--backend", default="gloo")
    a = ap.parse_args()
    time_failing_run(a.world, a.timeout, a.backend)
