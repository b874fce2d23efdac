"""One rank of ``tests/test_torch_multihost.py``'s TCP group, a process
of its own (a "host"):

    python tests/torch_multihost_worker.py RANK WORLD HOST:PORT OUT_DIR

Imports no JAX. It joins the gloo group through
``initialize_multihost(HOST:PORT, WORLD, RANK, device="cpu")`` and
``make_mesh(WORLD)``, then writes to ``OUT_DIR/result.pkl``: its rank,
the world, the backend, its mesh, its ``shard_batch`` rows of the dry
run's training batch, and the dry run's tiny ``BatchedMatcher`` over the
mesh on pairs it writes under ``OUT_DIR``.
"""

import os
import pickle
import sys
from datetime import timedelta

import torch
import torch.distributed as dist

from patch2pix_tpu_torch.parallel import dryrun
from patch2pix_tpu_torch.parallel.mesh import (
    abort_process_group,
    initialize_multihost,
    make_mesh,
    shard_batch,
)


def main(rank: int, world: int, address: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    initialize_multihost(address, world, rank, device="cpu", timeout=timedelta(minutes=3))
    try:
        mesh = make_mesh(world, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in dryrun.train_batches(world)[world].items()}
        rows = {k: v.numpy() for k, v in shard_batch(batch, mesh).items()}
        pairs = dryrun.write_pairs(out_dir, world)
        batched = dryrun._batched(mesh, dryrun.template_state(), pairs, mesh.device)
        out = {"rank": dist.get_rank(), "world": dist.get_world_size(),
               "backend": dist.get_backend(), "rows": rows, "batched": batched,
               "mesh": (mesh.axis, mesh.size, mesh.rank, str(mesh.device))}
    except BaseException:
        abort_process_group()
        raise
    dist.destroy_process_group()
    with open(os.path.join(out_dir, "result.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
