"""The rank worker of ``tests/test_torch_sfm_ba.py``'s gloo group.

Imports no JAX (each spawned rank starts in seconds). Each rank joins
one gloo group from a ``file://`` store, runs every case on its shard,
and rank 0 writes the results to ``{out_dir}/results.pkl``:

  * ``("step", sp, C)``: one :func:`make_dist_ba_step` step (λ 1e-3, no
    Huber) -> new R, t, the gathered new points (global order), new and
    old cost;
  * ``("run", sp, kwargs)``: :func:`run_dist_ba` -> (R, t, X, cost).
"""

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from patch2pix_tpu_torch.sfm.dist_ba import (
    local_problem,
    make_dist_ba_step,
    process_group,
    run_dist_ba,
)


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
