"""Distributed Schur-complement bundle adjustment over ``torch.distributed``.

Port of ``patch2pix_tpu.sfm.dist_ba``. POINTS (and with them all their
observations) are sharded over the ranks of a process group, one shard
per rank; camera poses are replicated. Each rank computes its partial
camera-Hessian blocks (U, b_c) and its partial Schur cross term (one
local ``Bt^T @ Bt``: the cross term is additive over points); per LM
iteration one ``all_reduce(SUM)`` of one flat buffer holding
``S_cross_neg``, ``U`` and ``b_red`` assembles the exact global reduced
camera system — O((6C)^2) floats, whatever the number of points — and a
second one sums the new cost. Every rank solves the small dense system
redundantly; point updates stay on the rank.

The LM accept/reject and damping are computed on the device with
``torch.where``, replicated on every rank, as JAX's ``lm_body`` does;
the host reads one stop flag per iteration (JAX's ``while_loop``
condition), so the solver runs exactly JAX's iterations.

Backends: NCCL for CUDA tensors (one rank per card), gloo for the CPU;
:func:`process_group` initialises one from a ``file://`` store in a
temporary directory (no network).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from patch2pix_tpu_torch.config import resolve_device
from patch2pix_tpu_torch.sfm.ba import (
    BAProblem,
    apply_updates,
    backsub_points,
    cost,
    problem_on,
    schur_blocks,
    solve_reduced,
)


class ShardedBA(NamedTuple):
    """Host-side layout of a BA problem partitioned over n_shards.

    Point/observation arrays have a leading shard axis; camera arrays
    are replicated. ``X_map`` maps (shard, local_pt) back to the
    global point id (-1 = padding). Padded observations have
    ``obs_w = 0`` and contribute nothing to any Hessian block.
    """

    Rs: np.ndarray
    ts: np.ndarray
    X: np.ndarray  # (S, Pl, 3)
    cam_idx: np.ndarray  # (S, Ml)
    pt_idx: np.ndarray  # (S, Ml) LOCAL point indices
    uv: np.ndarray  # (S, Ml, 2)
    obs_w: np.ndarray  # (S, Ml)
    fixed_cams: np.ndarray  # (C,)
    X_map: np.ndarray  # (S, Pl) global point ids


def shard_problem(
    Rs: np.ndarray,
    ts: np.ndarray,
    X: np.ndarray,
    cam_idx: np.ndarray,
    pt_idx: np.ndarray,
    uv: np.ndarray,
    n_shards: int,
    fixed_cams=None,
) -> ShardedBA:
    """Partition points greedily by observation count (balance), pad
    every shard to equal sizes with zero-weight observations."""
    P_ = X.shape[0]
    cam_idx = np.asarray(cam_idx)
    pt_idx = np.asarray(pt_idx)
    uv = np.asarray(uv)
    obs_per_pt = np.bincount(pt_idx, minlength=P_)
    order = np.argsort(-obs_per_pt, kind="stable")
    shard_of = np.zeros(P_, np.int64)
    loads = np.zeros(n_shards, np.int64)
    for pj in order:
        s = int(np.argmin(loads))
        shard_of[pj] = s
        loads[s] += obs_per_pt[pj] + 1
    shard_pts = [np.where(shard_of == s)[0] for s in range(n_shards)]

    Pl = max(max(len(sp) for sp in shard_pts), 1)
    obs_shards = []
    for s in range(n_shards):
        ids = np.where(np.isin(pt_idx, shard_pts[s]))[0]
        g2l = {g: l for l, g in enumerate(shard_pts[s])}
        lp = (
            np.asarray([g2l[g] for g in pt_idx[ids]], np.int64)
            if len(ids) else np.zeros(0, np.int64)
        )
        obs_shards.append((cam_idx[ids], lp, uv[ids]))

    Ml = max(max(len(o[0]) for o in obs_shards), 1)
    Xs = np.zeros((n_shards, Pl, 3), np.float32)
    Xmap = np.full((n_shards, Pl), -1, np.int64)
    ci = np.zeros((n_shards, Ml), np.int64)
    pi = np.zeros((n_shards, Ml), np.int64)
    uvs = np.zeros((n_shards, Ml, 2), np.float32)
    w = np.zeros((n_shards, Ml), np.float32)
    for s in range(n_shards):
        sp = shard_pts[s]
        Xs[s, : len(sp)] = X[sp]
        Xmap[s, : len(sp)] = sp
        c, l, u = obs_shards[s]
        m = len(c)
        ci[s, :m], pi[s, :m], uvs[s, :m] = c, l, u
        w[s, :m] = 1.0

    C = Rs.shape[0]
    if fixed_cams is None:
        fixed = np.zeros(C, bool)
        fixed[0] = True
    else:
        fixed = np.asarray(fixed_cams, bool)
    return ShardedBA(
        Rs.astype(np.float32), ts.astype(np.float32), Xs, ci, pi, uvs, w,
        fixed, Xmap,
    )


@contextlib.contextmanager
def process_group(world_size: int, rank: int, backend: str, store_dir: Optional[str] = None):
    """Initialise the default process group from a ``file://`` store in
    ``store_dir`` (a fresh temporary directory when None, which only a
    group of one rank can use), and destroy it on exit. Yields the
    group."""
    with contextlib.ExitStack() as stack:
        if store_dir is None:
            store_dir = stack.enter_context(tempfile.TemporaryDirectory())
        dist.init_process_group(backend, init_method=f"file://{os.path.join(store_dir, 'store')}",
                                world_size=world_size, rank=rank)
        try:
            yield dist.group.WORLD
        finally:
            dist.destroy_process_group()


def local_problem(sp: ShardedBA, rank: int, device) -> BAProblem:
    """Rank ``rank``'s shard of ``sp`` as a :class:`BAProblem` on
    ``device`` (local point indices)."""
    return problem_on(resolve_device(device), sp.Rs, sp.ts, sp.X[rank], sp.cam_idx[rank],
                      sp.pt_idx[rank], sp.uv[rank], sp.obs_w[rank], sp.fixed_cams)


def _reduced_system(p: BAProblem, lam, hd, use_huber: bool, C: int, group):
    """This rank's Schur blocks, with the reduced camera system summed
    over the group in one ``all_reduce`` of one flat buffer."""
    S_cross_neg, U, b_red, W, Vinv, bp = schur_blocks(p, lam, hd, use_huber, C)
    flat = torch.cat([S_cross_neg.reshape(-1), U.reshape(-1), b_red.reshape(-1)])
    dist.all_reduce(flat, group=group)
    nS, nU = S_cross_neg.numel(), U.numel()
    return (flat[:nS].view(C, C, 6, 6), flat[nS:nS + nU].view(C, 6, 6),
            flat[nS + nU:].view(C, 6), W, Vinv, bp)


def _group_cost(p: BAProblem, hd, group) -> torch.Tensor:
    c = cost(p, hd).reshape(1)
    dist.all_reduce(c, group=group)
    return c[0]


def make_dist_ba_step(C: int, use_huber: bool = True, group=None):
    """One point-sharded LM step (for parity with :func:`ba.ba_step`).

    ``step(p, lam, hd)`` takes this rank's shard (:func:`local_problem`)
    and returns (new Rs, new ts, new local X, new cost, old cost), the
    costs summed over the group."""

    def step(p: BAProblem, lam, hd):
        S_cross_neg, U, b_red, W, Vinv, bp = _reduced_system(p, lam, hd, use_huber, C, group)
        dc = solve_reduced(S_cross_neg, U, b_red, lam, p.fixed_cams)
        dp = backsub_points(p, W, Vinv, bp, dc)
        new_Rs, new_ts, new_X = apply_updates(p.Rs, p.ts, p.X, dc, dp)
        hd_or_none = hd if use_huber else None
        costs = torch.stack([cost(p._replace(Rs=new_Rs, ts=new_ts, X=new_X), hd_or_none),
                             cost(p, hd_or_none)])
        dist.all_reduce(costs, group=group)
        return new_Rs, new_ts, new_X, costs[0], costs[1]

    return step


def _replicated_divergence(blocks, group) -> torch.Tensor:
    """Max RELATIVE cross-rank deviation of a checksum of state that must
    be replicated after the all_reduce (two scalar collectives)."""
    chk = sum(torch.sum(torch.abs(b).float()) for b in blocks).reshape(1)
    mean = chk.clone()
    dist.all_reduce(mean, group=group)
    mean = mean / dist.get_world_size(group)
    dev = torch.abs(chk - mean)
    dist.all_reduce(dev, op=dist.ReduceOp.MAX, group=group)
    return (dev / torch.clamp(torch.abs(mean), min=1e-30))[0]


def make_dist_ba_solver(C: int, use_huber: bool, max_iters: int, tol: float,
                        debug_checks: bool = False, group=None):
    """The point-sharded LM solver: ``solve(p0, lam0, hd)`` on this rank's
    shard returns (Rs, ts, local X, cost, max divergence, {"iterations",
    "host_syncs": the stop flags read}).

    Accept/reject and λ live on the device, replicated on every rank
    (JAX's ``lm_body``); the host reads one stop flag per iteration after
    the first (JAX's ``lm_cond``). With ``debug_checks`` the replicated
    reduced system, cost and λ are checksummed across ranks every
    iteration (two more scalar collectives) and the maximum relative
    divergence is returned."""

    def solve(p0: BAProblem, lam0: float, hd):
        hd_or_none = hd if use_huber else None
        dev = p0.X.device
        Rs, ts, Xl = p0.Rs, p0.ts, p0.X
        lam = torch.tensor(lam0, dtype=torch.float32, device=dev)
        cur = _group_cost(p0, hd_or_none, group)
        done = torch.tensor(False, device=dev)
        maxdiv = torch.tensor(0.0, device=dev)
        it = reads = 0
        while it < max_iters:
            if it:
                reads += 1
                if not bool(~done & (lam < 1e6)):
                    break
            p = p0._replace(Rs=Rs, ts=ts, X=Xl)
            S_cross_neg, U, b_red, W, Vinv, bp = _reduced_system(p, lam, hd, use_huber, C, group)
            dc = solve_reduced(S_cross_neg, U, b_red, lam, p.fixed_cams)
            dp = backsub_points(p, W, Vinv, bp, dc)
            nR, nt, nX = apply_updates(Rs, ts, Xl, dc, dp)
            new_cost = _group_cost(p._replace(Rs=nR, ts=nt, X=nX), hd_or_none, group)
            accept = new_cost < cur
            rel = (cur - new_cost) / torch.clamp(cur, min=1e-12)
            Rs = torch.where(accept, nR, Rs)
            ts = torch.where(accept, nt, ts)
            Xl = torch.where(accept, nX, Xl)
            cur = torch.where(accept, new_cost, cur)
            lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                              torch.clamp(lam * 4.0, max=1e6))
            done = accept & (rel < tol)
            if debug_checks:
                maxdiv = torch.maximum(maxdiv, _replicated_divergence(
                    (S_cross_neg, U, b_red, new_cost, lam), group))
            it += 1
        return Rs, ts, Xl, cur, maxdiv, {"iterations": it, "host_syncs": reads}

    return solve


def run_dist_ba(
    sp: ShardedBA,
    group=None,
    max_iters: int = 30,
    init_lambda: float = 1e-3,
    huber_delta: float = float("inf"),
    tol: float = 1e-8,
    debug_checks: bool = False,
    device=None,
    stats: Optional[dict] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """LM driver over the point-sharded solver, called on every rank of
    ``group`` (the default group when None) with the same ``sp``; rank r
    solves shard r on ``device`` (CUDA unless given; the current card
    where no index is given).

    Returns (Rs, ts, X_global, final_cost) on every rank: the shards'
    points are gathered once, at the end. With ``debug_checks`` a
    cross-rank divergence of the replicated state above 1e-5 raises.
    ``stats``, where given, receives the iteration count and the stop
    flags the loop read (its host synchronisations)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        raise RuntimeError("run_dist_ba needs an initialised process group "
                           "(dist_ba.process_group)")
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if sp.X.shape[0] != world:
        raise ValueError(f"{sp.X.shape[0]} shards for a group of {world} ranks")
    use_huber = bool(np.isfinite(huber_delta))
    C = sp.Rs.shape[0]
    solver = make_dist_ba_solver(C, use_huber, max_iters, tol, debug_checks, group)
    hd = float(np.float32(huber_delta if use_huber else 1e9))
    Rs, ts, Xl, cur, maxdiv, info = solver(local_problem(sp, rank, dev),
                                           float(np.float32(init_lambda)), hd)
    cur = float(cur)
    if stats is not None:
        stats.update(info)
    if debug_checks:
        div = float(maxdiv)
        if div > 1e-5:
            raise RuntimeError(
                f"dist BA ranks desynchronised: max replicated-state "
                f"relative checksum divergence {div:.3e} (all-reduce "
                f"rounding jitter is ~1e-7; anything larger means a "
                f"rank is out of sync)"
            )

    # gather the local points and scatter them back to global order
    parts = [torch.empty_like(Xl) for _ in range(world)]
    dist.all_gather(parts, Xl.contiguous(), group=group)
    Xs = torch.stack(parts).cpu().numpy()
    Xg = np.zeros((int(sp.X_map.max()) + 1, 3), np.float32)
    for s in range(world):
        m = sp.X_map[s] >= 0
        Xg[sp.X_map[s][m]] = Xs[s][m]
    return Rs.cpu().numpy(), ts.cpu().numpy(), Xg, cur


def _rank_main(rank: int, world_size: int, backend: str, store_dir: str, sp: ShardedBA,
               kwargs: dict, out_path: Optional[str]):
    """One rank of :func:`run_dist_ba_ranks`: its group, its shard, and
    (rank 0, where ``out_path`` is given) the result written to
    ``out_path``. Returns the result."""
    if backend == "nccl":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    stats: dict = {}
    with process_group(world_size, rank, backend, store_dir) as group:
        Rs, ts, X, c = run_dist_ba(sp, group, device=device, stats=stats, **kwargs)
    if rank == 0 and out_path is not None:
        np.savez(out_path, Rs=Rs, ts=ts, X=X, cost=c, **stats)
    return Rs, ts, X, c, stats


def run_dist_ba_ranks(sp: ShardedBA, device=None, **kwargs):
    """:func:`run_dist_ba` over a group of ``sp``'s shard count: gloo
    processes on the CPU, or one NCCL rank per card (as many cards as
    shards); a group of one runs in this process, a larger one in
    spawned processes. ``kwargs`` go to :func:`run_dist_ba`. Returns
    (Rs, ts, X_global, cost, {"iterations", "host_syncs"})."""
    dev = resolve_device(device)
    world = sp.X.shape[0]
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(f"{world} NCCL ranks need {world} cards; "
                         f"{torch.cuda.device_count()} found")
    with tempfile.TemporaryDirectory() as tmp:
        if world == 1:
            return _rank_main(0, 1, backend, tmp, sp, kwargs, None)
        out = os.path.join(tmp, "rank0.npz")
        torch.multiprocessing.start_processes(
            _rank_main, args=(world, backend, tmp, sp, kwargs, out), nprocs=world,
            join=True, start_method="spawn")
        with np.load(out) as r:
            stats = {k: int(r[k]) for k in ("iterations", "host_syncs")}
            return r["Rs"], r["ts"], r["X"], float(r["cost"]), stats
