"""The mesh over ``torch.distributed``, and its sharding helpers.

Port of ``patch2pix_tpu.parallel.mesh``. JAX's mesh is a grid of devices
that one program spans; here each rank of a process group is one
program with one device, so a :class:`Mesh` is this rank's view of a
1-D mesh: its axis name, the world size, its rank, its device and the
process group (None for a mesh of one rank without a group). A sharded
array is this rank's rows of the global one, in JAX's addressable-shard
layout: rank r holds rows ``[r*B/n, (r+1)*B/n)``.

Backends: NCCL for CUDA tensors (one rank per card), gloo on the CPU.
:func:`process_group` initialises one from a ``file://`` store (no
network); :func:`initialize_multihost` joins a ``torchrun``-style
environment or a TCP coordinator.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from patch2pix_tpu_torch.config import resolve_device


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D mesh of ``size`` ranks."""

    axis: str
    size: int
    rank: int
    device: torch.device
    group: Optional[object] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis: self.size}


class Sharding(NamedTuple):
    """A layout over ``mesh``: the leading axis split over ``axis``, or
    replicated where ``axis`` is None."""

    mesh: Mesh
    axis: Optional[str]

    @property
    def is_fully_replicated(self) -> bool:
        return self.axis is None or self.mesh.size == 1


def rank_device(device=None, group=None) -> torch.device:
    """This rank's device in ``group`` (None: the rank alone). A CUDA
    device without an index is the current card on a rank alone or in a
    group of one; in a group of more ranks it is the rank's card on its
    host (``LOCAL_RANK`` where ``torchrun`` set it, else the rank in the
    default group modulo the visible cards), made the current card:
    NCCL, the object collectives and the kernels launch on the current
    card, which is card 0 on a rank that never set it."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if group is None or dist.get_world_size(group) == 1:
        return torch.device("cuda", torch.cuda.current_device())
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else dist.get_rank() % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def make_mesh(n_devices: Optional[int] = None, axis: str = "data", group=None,
              device=None) -> Mesh:
    """This rank's 1-D mesh of ``n_devices`` ranks: the ranks of
    ``group`` (the default group when None). A mesh of one rank needs no
    process group; a larger one needs an initialised group of exactly
    ``n_devices`` ranks. ``device``: this rank's device (CUDA unless
    given; without an index, :func:`rank_device`'s card)."""
    if n_devices == 1 or (n_devices is None and group is None and not dist.is_initialized()):
        return Mesh(axis, 1, 0, rank_device(device), None)
    if not dist.is_initialized():
        raise RuntimeError(f"a mesh of {n_devices} ranks needs an initialised process group "
                           "(parallel.mesh.process_group or initialize_multihost)")
    group = group if group is not None else dist.group.WORLD
    size = dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} ranks from a group of {size}")
    return Mesh(axis, size, dist.get_rank(group), rank_device(device, group), group)


def data_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """The leading (batch) dimension split over the mesh."""
    return Sharding(mesh, axis)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def rank_rows(n: int, mesh: Mesh) -> slice:
    """This rank's rows of a leading axis of ``n``; raises unless the
    mesh divides it."""
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not split over {mesh.size} ranks")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(batch: Dict, mesh: Mesh, axis: str = "data") -> Dict:
    """This rank's rows of each array or tensor of ``batch`` (a dict of
    equal leading sizes), as tensors on the rank's device."""
    del axis  # a 1-D mesh has one axis
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t[rank_rows(t.shape[0], mesh)].to(mesh.device)
    return out


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, backend: Optional[str] = None,
                         device=None, timeout: Optional[timedelta] = None) -> None:
    """Join a process group of ``num_processes`` ranks as rank
    ``process_id``: through the TCP ``coordinator_address``
    (``host:port``), or the ``MASTER_ADDR``/``MASTER_PORT`` environment
    ``torchrun`` sets when it is None. NCCL where the device is CUDA,
    gloo on the CPU. A no-op at ``num_processes`` <= 1, as in JAX.
    ``timeout``: how long a collective waits (the backend's default when
    None)."""
    if num_processes is None or num_processes <= 1:
        return
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    init = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id, **_timeout_kw(timeout))


def _timeout_kw(timeout: Optional[timedelta]) -> Dict:
    return {} if timeout is None else {"timeout": timeout}


@contextlib.contextmanager
def process_group(world_size: int, rank: int, backend: str, store_dir: Optional[str] = None,
                  timeout: Optional[timedelta] = None):
    """Initialise the default process group from a ``file://`` store in
    ``store_dir`` (a fresh temporary directory when None, which only a
    group of one rank can use). Yields the group. On a normal exit the
    group is destroyed; when the body raises it is aborted
    (:func:`abort_process_group`), so that the error reaches the caller
    at once, while the other ranks may still wait in a collective.
    ``timeout`` as for :func:`initialize_multihost`."""
    with contextlib.ExitStack() as stack:
        if store_dir is None:
            store_dir = stack.enter_context(tempfile.TemporaryDirectory())
        dist.init_process_group(backend, init_method=f"file://{os.path.join(store_dir, 'store')}",
                                world_size=world_size, rank=rank, **_timeout_kw(timeout))
        try:
            yield dist.group.WORLD
        except BaseException:
            abort_process_group()
            raise
        dist.destroy_process_group()


def abort_process_group() -> None:
    """Tear down every process group of this rank without waiting for
    the other ranks: ``ncclCommAbort`` under NCCL. Destroying an NCCL
    group instead waits on the collectives its peers have pending, up
    to the group's timeout. Afterwards no group is initialised, as after
    ``dist.destroy_process_group``."""
    dist.distributed_c10d._abort_process_group()


def spawned_rank(rank: int, fn, *args) -> None:
    """``fn(rank, *args)`` as the body of a spawned rank
    (``torch.multiprocessing.start_processes(spawned_rank, args=(fn,
    ...))``): an error prints its traceback and ends the process with
    exit code 1, and the parent then terminates the other ranks, which
    may be waiting in a collective. The error leaves
    :func:`process_group` through its abort, not its orderly teardown,
    so the run ends in seconds over NCCL as over gloo; a group's timeout
    bounds only a real hang."""
    try:
        fn(rank, *args)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def replicated_divergence(blocks, group) -> torch.Tensor:
    """Max RELATIVE cross-rank deviation of a checksum of state that must
    be replicated (two scalar all-reduces)."""
    from patch2pix_tpu_torch.parallel import comm_stats

    chk = sum(torch.sum(torch.abs(b).float()) for b in blocks).reshape(1)
    mean = chk.clone()
    comm_stats.all_reduce(mean, group=group)
    mean = mean / comm_stats.world_size(group)
    dev = torch.abs(chk - mean)
    comm_stats.all_reduce(dev, op=dist.ReduceOp.MAX, group=group)
    return (dev / torch.clamp(torch.abs(mean), min=1e-30))[0]
