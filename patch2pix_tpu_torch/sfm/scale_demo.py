"""Scene-scale incremental SfM + point-sharded distributed BA on a
synthetic scene, and the bundle-adjustment timing at scale.

Builds a ring scene with partial visibility, pixel noise and outlier
matches (:func:`patch2pix_tpu_torch.sfm.synthetic.make_scale_scene`),
runs tracks -> incremental reconstruction -> point-sharded distributed
BA (20 LM iterations, Huber 3 px) -> a COLMAP export read back, and
reports per-stage wall time, ATE against the ground truth and the
per-iteration all_reduce volume in ``{out}/summary.json``:

    python -m patch2pix_tpu_torch.sfm.scale_demo [--cams 50] [--pts 5000]
        [--mesh 1] [--seed 0] [--device cpu] [--out artifacts/sfm_scale_torch]

``--mesh N`` runs the distributed BA on N ranks: gloo processes with
``--device cpu``, else one NCCL rank per card (N cards). Without
``--device`` it needs CUDA.

``--ba_scales "C,P,K;..."`` instead times one LM iteration of the
single-device solver on the ring scene of ``tools/bench_ba.py`` (C
cameras, P points, each seen by its K nearest cameras, points perturbed
by 0.05): ms per iteration by the marginal method (k = 6 minus k = 2
iterations, best of 3), one JSON line per scale.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from datetime import timedelta
from typing import Optional

import numpy as np
import torch

from patch2pix_tpu_torch.config import resolve_device
from patch2pix_tpu_torch.data.colmap_model import read_model
from patch2pix_tpu_torch.sfm.ba import (
    apply_updates,
    backsub_points,
    build_problem,
    schur_blocks,
    solve_reduced,
)
from patch2pix_tpu_torch.sfm.dist_ba import run_dist_ba_ranks, shard_problem
from patch2pix_tpu_torch.sfm.incremental import IncrementalSfM, export_colmap
from patch2pix_tpu_torch.sfm.metrics import ate_rmse
from patch2pix_tpu_torch.sfm.synthetic import make_scale_scene


def make_ba_scene(n_cams: int, n_pts: int, obs_per_pt: int, seed: int = 0):
    """``tools/bench_ba.py``'s scene: a ring of cameras around a point
    cloud, each point observed by its ``obs_per_pt`` nearest cameras.
    Returns BA arrays in normalized camera coordinates with 0.5
    px-equivalent noise (f=1000)."""
    rng = np.random.default_rng(seed)
    R0 = 10.0
    ang = 2 * np.pi * np.arange(n_cams) / n_cams
    centers = np.stack(
        [R0 * np.cos(ang), 0.3 * rng.standard_normal(n_cams),
         R0 * np.sin(ang)], axis=1)
    Rs = np.zeros((n_cams, 3, 3))
    ts = np.zeros((n_cams, 3))
    for c in range(n_cams):
        fwd = -centers[c] / np.linalg.norm(centers[c])
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        upc = np.cross(fwd, right)
        Rs[c] = np.stack([right, upc, fwd])
        ts[c] = -Rs[c] @ centers[c]
    X = rng.uniform([-3, -3, -3], [3, 3, 3], (n_pts, 3))

    # nearest cameras per point (by angle)
    pt_ang = np.arctan2(X[:, 2], X[:, 0])
    cam_of = np.argsort(
        np.abs(((pt_ang[:, None] - ang[None, :]) + np.pi) % (2 * np.pi)
               - np.pi), axis=1)[:, :obs_per_pt]
    pt_idx = np.repeat(np.arange(n_pts), obs_per_pt)
    cam_idx = cam_of.reshape(-1)
    pc = np.einsum("mij,mj->mi", Rs[cam_idx], X[pt_idx]) + ts[cam_idx]
    uv = pc[:, :2] / pc[:, 2:3]
    uv = uv + rng.standard_normal(uv.shape) * (0.5 / 1000.0)
    keep = pc[:, 2] > 0.5
    return Rs, ts, X, cam_idx[keep], pt_idx[keep], uv[keep]


def perturb_points(X: np.ndarray) -> np.ndarray:
    """``tools/bench_ba.py``'s start: the points moved by 0.05 (seed 1)."""
    return X + 0.05 * np.random.default_rng(1).standard_normal(X.shape)


def lm_iterations(prob, k: int) -> float:
    """``k`` fixed-λ (1e-3, no Huber) LM iterations from ``prob``, each
    applied; returns a checksum read on the host (so the work is done)."""
    C = prob.Rs.shape[0]
    Rs, ts, X = prob.Rs, prob.ts, prob.X
    for _ in range(k):
        pp = prob._replace(Rs=Rs, ts=ts, X=X)
        S, U, b, W, Vinv, bp = schur_blocks(pp, 1e-3, 1e9, False, C)
        dc = solve_reduced(S, U, b, 1e-3, prob.fixed_cams)
        dp = backsub_points(pp, W, Vinv, bp, dc)
        Rs, ts, X = apply_updates(Rs, ts, X, dc, dp)
    return float(X.sum() + Rs.sum() + ts.sum())


def lm_iteration_ms(prob, hi: int = 6, lo: int = 2) -> float:
    """ms per LM iteration by ``tools/bench_ba.py``'s marginal method:
    (best of 3 runs of ``hi`` iterations - best of 3 of ``lo``) / (hi -
    lo), each after one warm-up run."""
    def timed(k):
        lm_iterations(prob, k)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            lm_iterations(prob, k)
            best = min(best, time.perf_counter() - t0)
        return best

    return (timed(hi) - timed(lo)) / (hi - lo) * 1e3


def device_info(dev: torch.device):
    """(name, power limit) of ``dev``: the card's as ``nvidia-smi``
    prints them, or ("cpu", None)."""
    if dev.type != "cuda":
        return "cpu", None
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--id={idx}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    name, limit = (s.strip() for s in out.split(","))
    return name, limit


def bench_ba(scales: str, dev: torch.device):
    """One JSON line per "C,P,K" scale: ms per LM iteration, observations
    per s, the reduced system's MB and the peak device memory."""
    name, limit = device_info(dev)
    results = []
    for spec in scales.split(";"):
        c, p, o = (int(v) for v in spec.split(","))
        Rs, ts, X, ci, pi, uv = make_ba_scene(c, p, o)
        prob = build_problem(Rs, ts, perturb_points(X), ci, pi, uv, device=dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        dt = lm_iteration_ms(prob)
        r = dict(cams=c, pts=p, obs=len(ci), ms_per_lm_iter=dt,
                 obs_per_s=len(ci) / dt * 1e3, reduced_system_mb=(6 * c) ** 2 * 4 / 1e6,
                 peak_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                          if dev.type == "cuda" else None),
                 device=name, power_limit=limit)
        results.append(r)
        print(json.dumps(r), flush=True)
        del prob
    return results


def main(argv=None, group_timeout: Optional[timedelta] = None):
    """Run the demo (or ``--ba_scales``) as the flags say; returns the
    summary. ``group_timeout``: how long a rank of ``--mesh`` waits in a
    collective (the backend's default when None)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--cams", type=int, default=50)
    ap.add_argument("--pts", type=int, default=5000)
    ap.add_argument("--mesh", type=int, default=1,
                    help="ranks of the distributed BA (gloo on the CPU, NCCL "
                    "one rank per card)")
    ap.add_argument("--noise_px", type=float, default=0.4)
    ap.add_argument("--outlier_frac", type=float, default=0.05)
    ap.add_argument("--ba_every", type=int, default=10)
    ap.add_argument(
        "--pair_gap", type=int, default=None,
        help="max ring-step separation of matched pairs; default "
        "scales with camera count to keep the ANGULAR pair-graph "
        "connectivity comparable across scene sizes",
    )
    ap.add_argument("--out", default="artifacts/sfm_scale_torch")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--cell", type=float, default=4.0)
    ap.add_argument("--min_track_len", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the incremental run's RANSAC generator (the scene keeps its own)")
    ap.add_argument("--device", default=None, help="cpu or cuda (default: CUDA, required)")
    ap.add_argument("--ba_scales", default=None,
                    help='time the LM iteration at "C,P,K;..." instead of the demo')
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.ba_scales:
        return bench_ba(args.ba_scales, dev)

    pair_gap = args.pair_gap
    if pair_gap is None:
        pair_gap = max(5, round(args.cams / 10))
    t0 = time.time()
    Rs_gt, ts_gt, X_gt, K, pair_matches = make_scale_scene(
        n_cams=args.cams, n_pts=args.pts, noise_px=args.noise_px,
        outlier_frac=args.outlier_frac, max_pair_gap=pair_gap,
    )
    n_match = sum(len(m) for m in pair_matches.values())
    t_scene = time.time() - t0
    print(f"scene: {args.cams} cams, {args.pts} pts, "
          f"{len(pair_matches)} pairs, {n_match} matches "
          f"({100 * args.outlier_frac:.0f}% outliers) [{t_scene:.1f}s]")

    t0 = time.time()
    sfm = IncrementalSfM(
        pair_matches, {i: K for i in range(args.cams)}, px_thres=2.0,
        cell=args.cell, min_track_len=args.min_track_len, seed=args.seed,
        log=print if args.verbose else lambda *_: None, device=dev,
    )
    t_tracks = time.time() - t0
    print(f"tracks: {len(sfm.tracks)} [{t_tracks:.1f}s]")

    t0 = time.time()
    rec = sfm.run(ba_every=args.ba_every)
    t_inc = time.time() - t0
    gt_centers = np.stack([-R.T @ t for R, t in zip(Rs_gt, ts_gt)])
    if len(rec.registered) != args.cams:
        print("registration shortfall diagnostics:",
              sfm.registration_report())
        raise RuntimeError(f"only {len(rec.registered)}/{args.cams} registered")
    ate_inc = ate_rmse(rec.centers(), gt_centers)
    print(f"incremental: {len(rec.registered)} cams, "
          f"{len(rec.points)} points, ATE {ate_inc:.4f} "
          f"[{t_inc:.1f}s = {t_inc / args.cams:.2f} s/image]")
    stage_stats = {k: (round(v, 2) if isinstance(v, float) else v)
                   for k, v in sorted(sfm.stats.items())}
    accounted = sum(v for k, v in sfm.stats.items() if k.endswith("_s"))
    stage_stats["host_bookkeeping_s"] = round(t_inc - accounted, 2)
    print(f"stage attribution: {stage_stats}")

    # point-sharded distributed BA refinement
    Rs, ts, X, cam_idx, pt_idx, uv, f_mean, reg, tids = sfm.assemble_ba()
    sp = shard_problem(Rs, ts, X, cam_idx, pt_idx, uv, n_shards=args.mesh)
    t0 = time.time()
    Rs2, ts2, X2, cost, dstats = run_dist_ba_ranks(
        sp, device=dev, timeout=group_timeout, max_iters=20, huber_delta=3.0 / f_mean)
    t_dba = time.time() - t0
    for c, im in enumerate(reg):
        rec.Rs[im] = np.asarray(Rs2[c], np.float64)
        rec.ts[im] = np.asarray(ts2[c], np.float64)
    ate_dba = ate_rmse(rec.centers(), gt_centers)
    C = len(reg)
    allreduce_mb = (6 * C) ** 2 * 4 / 1e6
    print(f"dist BA ({args.mesh} rank(s), point-sharded, {len(cam_idx)} obs): "
          f"cost {cost:.3e}, ATE {ate_dba:.4f} [{t_dba:.1f}s, {dstats['iterations']} "
          f"iterations, {dstats['host_syncs']} stop-flag reads]; per-iteration "
          f"all_reduce {allreduce_mb:.2f} MB (reduced {6 * C}^2 system)")

    # COLMAP export roundtrip at scale
    export_dir = os.path.join(args.out, "colmap")
    os.makedirs(export_dir, exist_ok=True)
    export_colmap(rec, export_dir, ext=".bin")
    cams_r, ims_r, pts_r = read_model(export_dir, ext=".bin")
    if not (len(ims_r) == args.cams and len(pts_r) == len(rec.points)):
        raise RuntimeError(f"colmap export read back {len(ims_r)} images, {len(pts_r)} "
                           f"points; wrote {args.cams}, {len(rec.points)}")
    print(f"colmap export roundtrip: {len(ims_r)} images, "
          f"{len(pts_r)} points OK")

    radius = float(np.linalg.norm(gt_centers, axis=1).mean())
    name, limit = device_info(dev)
    summary = {
        "cams": args.cams, "pts": args.pts,
        "pairs": len(pair_matches), "matches": n_match,
        "outlier_frac": args.outlier_frac, "noise_px": args.noise_px,
        "tracks": len(sfm.tracks), "points": len(rec.points),
        "obs": int(len(cam_idx)),
        "t_tracks_s": round(t_tracks, 1),
        "t_incremental_s": round(t_inc, 1),
        "s_per_image": round(t_inc / args.cams, 2),
        "t_dist_ba_s": round(t_dba, 1),
        "ate_incremental": float(ate_inc),
        "ate_after_dist_ba": float(ate_dba),
        "ate_pct_of_radius": round(100 * float(ate_dba) / radius, 3),
        "dist_ba_psum_mb_per_iter": round(allreduce_mb, 2),
        "mesh": args.mesh,
        "stage_attribution": stage_stats,
        "device": name,
        "power_limit": limit,
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
