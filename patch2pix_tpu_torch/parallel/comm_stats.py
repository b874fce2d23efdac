"""Collective-communication accounting of the port's parallel code.

The JAX package parses compiled HLO for its collectives
(``patch2pix_tpu.parallel.comm_stats.collective_stats``); PyTorch has no
compiled program to read, so the port counts what its own code sends:
every collective of ``parallel/``, ``evaluation/batched.py``, the
sharded train step and ``sfm/dist_ba.py`` goes through the wrappers
below, and :func:`record_collectives` fills the same
``{kind: {"count": n, "bytes": b}}`` dict under JAX's kind names:

  * ``all-reduce``: the reduced tensor's bytes (also each backward
    all-reduce of :func:`all_reduce_sum`);
  * ``all-gather``: the gathered output's bytes (world x input), for
    :func:`all_gather_object` the pickled objects';
  * ``collective-permute``: one per direction of a neighbour shift
    (:func:`exchange_halo`), the shifted slab's bytes, as JAX counts a
    ``ppermute``'s output.

Each wrapper runs over the group it is given. Without one (``group``
None: a mesh of one rank, even inside a larger job) it is the identity
and records nothing: nothing is sent. With a group of one rank (NCCL
from a ``file://`` store) the collectives run and are recorded, but a
neighbour shift sends nothing: a rank never sends to itself.
"""

from __future__ import annotations

import contextlib
import pickle
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

_ACTIVE: List[Dict[str, Dict[str, int]]] = []


@contextlib.contextmanager
def record_collectives() -> Iterator[Dict[str, Dict[str, int]]]:
    """Yield a dict that counts every collective the wrappers run until
    the block ends (nested blocks each count)."""
    stats: Dict[str, Dict[str, int]] = {}
    _ACTIVE.append(stats)
    try:
        yield stats
    finally:
        _ACTIVE.remove(stats)


def _record(kind: str, nbytes: int) -> None:
    for stats in _ACTIVE:
        d = stats.setdefault(kind, {"count": 0, "bytes": 0})
        d["count"] += 1
        d["bytes"] += int(nbytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _active(group) -> bool:
    """True when a collective over ``group`` runs: a group is given."""
    return group is not None


def world_size(group=None) -> int:
    """The ranks a collective over ``group`` spans (1 without a group)."""
    return dist.get_world_size(group) if _active(group) else 1


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """In-place ``all_reduce`` of ``t``; returns ``t``."""
    if _active(group):
        _record("all-reduce", _nbytes(t))
        dist.all_reduce(t, op=op, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t.clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), group=ctx.group), None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable SUM all-reduce (out of place): the gradient of each
    rank's input is the sum of every rank's output gradient, which is
    right when the ranks' losses add up to the global one."""
    return _AllReduceSum.apply(t, group) if _active(group) else t


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), in rank order."""
    if not _active(group):
        return [t]
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    _record("all-gather", _nbytes(t) * len(parts))
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


def all_gather_object(obj, group=None) -> list:
    """Every rank's picklable ``obj``, in rank order."""
    if not _active(group):
        return [obj]
    out = [None] * dist.get_world_size(group)
    _record("all-gather", len(pickle.dumps(obj)) * len(out))
    dist.all_gather_object(out, obj, group=group)
    return out


def exchange_halo(first: torch.Tensor, last: torch.Tensor, group=None
                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The neighbour shift of a 1-D mesh: each rank sends ``last`` to
    its successor and ``first`` to its predecessor, and returns (the
    predecessor's ``last``, the successor's ``first``), None at the
    mesh's ends. Two ``collective-permute``s where the mesh has more
    than one rank; nothing at all on one rank."""
    n = world_size(group)
    if n == 1:
        return None, None
    r = dist.get_rank(group)
    _record("collective-permute", _nbytes(last))
    _record("collective-permute", _nbytes(first))
    from_prev = torch.empty_like(last) if r > 0 else None
    from_next = torch.empty_like(first) if r < n - 1 else None
    ops = []
    if r < n - 1:
        nxt = dist.get_global_rank(group, r + 1)
        ops += [dist.P2POp(dist.isend, last.contiguous(), nxt, group),
                dist.P2POp(dist.irecv, from_next, nxt, group)]
    if r > 0:
        prv = dist.get_global_rank(group, r - 1)
        ops += [dist.P2POp(dist.isend, first.contiguous(), prv, group),
                dist.P2POp(dist.irecv, from_prev, prv, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_prev, from_next


def format_comm_table(stats: Dict[str, Dict[str, int]]) -> str:
    if not stats:
        return "collectives: none"
    rows = [
        f"{k}: x{v['count']} {v['bytes'] / 1024:.1f} KiB"
        for k, v in sorted(stats.items())
    ]
    return "collectives: " + ", ".join(rows)
