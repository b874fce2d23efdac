"""Incremental SfM driver: host orchestration over device work.

Port of ``patch2pix_tpu.sfm.incremental``. The host owns the graph
bookkeeping (numpy, copied from the JAX module); every numeric step
(essential RANSAC, PnP RANSAC, triangulation, Schur BA) runs on the
device through :mod:`patch2pix_tpu_torch.sfm`. The RANSACs draw from
one ``torch.Generator`` on the device, seeded from ``seed``, where JAX
splits a PRNG key per call. The row and shape buckets are kept (JAX
pads to them so that its jitted programs compile once per bucket), so
the same calls see the same padded inputs.

Pipeline: pairwise matches -> tracks (quantized union-find) ->
best-pair initialization -> loop {PnP-register best next image,
triangulate new tracks, bundle adjust} -> COLMAP-format export
(:func:`export_colmap`) so reconstructions are directly comparable.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from patch2pix_tpu_torch.config import resolve_device
from patch2pix_tpu_torch.data.colmap_model import (
    Camera,
    ImagePose,
    Point3D,
    rotmat2qvec,
    write_model,
)
from patch2pix_tpu_torch.sfm.ba import build_problem, run_ba
from patch2pix_tpu_torch.sfm.pnp import ransac_pnp
from patch2pix_tpu_torch.sfm.tracks import build_tracks
from patch2pix_tpu_torch.sfm.twoview import (
    normalize_points,
    ransac_essential,
    triangulate,
)


_BUCKETS = (64, 128, 256, 512, 1024, 2048)


def _bucket_pad(n: int) -> int:
    """Shape bucket for a row count (JAX's: its device RANSACs are
    fixed-shape jits). Row counts above the cap are subsampled by
    callers."""
    for b in _BUCKETS:
        if n <= b:
            return b
    b = _BUCKETS[-1]
    while b < n:  # beyond the table: next power of two
        b *= 2
    return b


def _sampson_np(p1: np.ndarray, p2: np.ndarray, E: np.ndarray) -> np.ndarray:
    """Squared sampson distance of normalized correspondences vs E
    (host numpy; matches the device RANSAC's inlier metric)."""
    x1 = np.concatenate([p1, np.ones((len(p1), 1))], axis=1)
    x2 = np.concatenate([p2, np.ones((len(p2), 1))], axis=1)
    Ex1 = x1 @ E.T
    Etx2 = x2 @ E
    num = np.sum(x2 * Ex1, axis=1) ** 2
    den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
    return num / np.maximum(den, 1e-12)


def _pad_valid(arrs, n: int):
    """Pad row arrays to the bucket of ``n`` (repeating the last row)
    and return (padded arrays, bool validity mask)."""
    b = _bucket_pad(n)
    out = []
    for a in arrs:
        a = np.asarray(a)
        if len(a) < b:
            a = np.concatenate([a, np.repeat(a[-1:], b - len(a), axis=0)])
        out.append(a)
    valid = np.zeros(b, bool)
    valid[:n] = True
    return out, valid


@dataclass
class Reconstruction:
    """Sparse reconstruction state."""

    K: Dict[int, np.ndarray]  # per-image intrinsics
    Rs: Dict[int, np.ndarray] = field(default_factory=dict)
    ts: Dict[int, np.ndarray] = field(default_factory=dict)
    points: Dict[int, np.ndarray] = field(default_factory=dict)  # track -> xyz
    track_obs: List[Dict[int, np.ndarray]] = field(default_factory=list)

    @property
    def registered(self) -> List[int]:
        return sorted(self.Rs.keys())

    def centers(self) -> np.ndarray:
        return np.stack(
            [-self.Rs[i].T @ self.ts[i] for i in self.registered]
        )


class IncrementalSfM:
    """Drives a reconstruction from pairwise matches.

    Args:
      pair_matches: {(i, j): (N, 4) pixel matches}, i < j.
      intrinsics: {image_id: (3, 3) K}.
      px_thres: RANSAC/observation gating threshold in pixels.
      seed: seed of the device RANSACs' generator.
      device: where the RANSACs, triangulation and BA run (CUDA unless
        given).
    """

    def __init__(
        self,
        pair_matches: Dict[Tuple[int, int], np.ndarray],
        intrinsics: Dict[int, np.ndarray],
        px_thres: float = 2.0,
        min_track_len: int = 2,
        cell: float = 4.0,
        seed: int = 0,
        verify_pairs: bool = True,
        tri_min_angle_deg: float = 1.5,
        log: Callable[[str], None] = print,
        device=None,
    ):
        self.device = resolve_device(device)
        self.K = {i: np.asarray(k, np.float64) for i, k in intrinsics.items()}
        self.px_thres = px_thres
        self.tri_min_angle_deg = tri_min_angle_deg
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.log = log
        # per-stage wall-clock attribution (seconds), with JAX's keys:
        # *_first_shape_* accumulates calls at a new shape bucket (a
        # compile in JAX; nothing compiles here)
        self.stats: Dict[str, float] = defaultdict(float)
        self._ba_shapes: set = set()
        self._pnp_shapes: set = set()
        if verify_pairs:
            pair_matches = self._verify_pairs(pair_matches)
        self.matches = pair_matches
        self.tracks = build_tracks(pair_matches, cell, min_track_len)
        self.rec = Reconstruction(K=self.K, track_obs=self.tracks)
        self.log(f"tracks: {len(self.tracks)} from {len(pair_matches)} pairs")

    def _verify_pairs(
        self, pair_matches: Dict[Tuple[int, int], np.ndarray]
    ) -> Dict[Tuple[int, int], np.ndarray]:
        """Geometric verification: fit E per pair (device RANSAC on a
        size-bucketed subsample), keep matches epipolar-consistent with
        it. The standard SfM front-end step — raw matcher outliers
        otherwise percolate track building (see sfm/tracks.py)."""
        rs = np.random.default_rng(7)
        out = {}
        n_in, n_all = 0, 0
        for (i, j), m in pair_matches.items():
            m = np.asarray(m, np.float64)
            n_all += len(m)
            if len(m) < 16:
                continue
            sub = m
            if len(sub) > _BUCKETS[-1]:
                sub = m[rs.choice(len(m), _BUCKETS[-1], replace=False)]
            (m_pad,), valid = _pad_valid([sub], len(sub))
            thres = self._norm_thres(i, j)
            p1, p2 = self._normalize_dev(m_pad, i, j)
            res = ransac_essential(
                self.gen, p1, p2, 256, thres, valid=self._dev(valid),
            )
            if int(res.num_inliers) < 16:
                continue
            # classify ALL matches against the fitted E on the host
            E = res.E.cpu().numpy().astype(np.float64)
            q1 = self._normalize_np(m[:, 0:2], self.K[i])
            q2 = self._normalize_np(m[:, 2:4], self.K[j])
            d = _sampson_np(q1, q2, E)
            keep = m[d < thres]
            if len(keep) >= 16:
                out[(i, j)] = keep
                n_in += len(keep)
        self.log(
            f"pair verification: {n_in}/{n_all} matches kept over "
            f"{len(out)}/{len(pair_matches)} pairs"
        )
        return out

    @staticmethod
    def _normalize_np(px: np.ndarray, K: np.ndarray) -> np.ndarray:
        y = (px[:, 1] - K[1, 2]) / K[1, 1]
        x = (px[:, 0] - K[0, 2] - K[0, 1] * y) / K[0, 0]
        return np.stack([x, y], axis=1)

    def _dev(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype), device=self.device)

    def _normalize_dev(self, m_pad: np.ndarray, i: int, j: int):
        """Device-normalised float32 endpoints of (N, 4) pixel matches."""
        return tuple(
            normalize_points(self._dev(m_pad[:, c:c + 2], np.float32),
                             self._dev(self.K[im], np.float32))
            for c, im in ((0, i), (2, j)))

    # ------------------------------------------------- initialization

    def _norm_thres(self, i: int, j: int) -> float:
        f = (self.K[i][0, 0] + self.K[i][1, 1] + self.K[j][0, 0] + self.K[j][1, 1]) / 4
        return float((self.px_thres / f) ** 2)

    def init_pair(self, min_tri_angle_deg: float = 8.0) -> Tuple[int, int]:
        """Two-view RANSAC on every pair; pick max inliers among pairs
        whose median triangulation angle clears ``min_tri_angle_deg``
        (COLMAP's init conditioning rule — raw max-inliers prefers the
        SHORTEST-baseline pair, whose near-parallel rays seed the map
        with unbounded depth noise; measured at 120-camera ring
        density this alone collapsed the reconstruction)."""
        best, best_score = None, -1
        best_narrow, best_narrow_score = None, -1
        rs = np.random.default_rng(0)
        for (i, j), m in self.matches.items():
            if len(m) < 16:
                continue
            if len(m) > _BUCKETS[-1]:
                m = m[rs.choice(len(m), _BUCKETS[-1], replace=False)]
            (m_pad,), valid = _pad_valid([m], len(m))
            p1, p2 = self._normalize_dev(m_pad, i, j)
            res = ransac_essential(
                self.gen, p1, p2, 256, self._norm_thres(i, j),
                valid=self._dev(valid),
            )
            score = int(res.num_inliers)
            if score <= max(best_score, 15):
                if score > best_narrow_score:
                    best_narrow, best_narrow_score, best_narrow_res = (
                        (i, j), score, res)
                continue
            # conditioning: median parallax angle of the inliers,
            # computed from the OBSERVED bearing directions (rotating
            # view-2 rays into view-1's frame) — triangulating first
            # and measuring ray angles at X is self-defeating, because
            # the degenerate narrow pairs produce depth-noise-scattered
            # X whose apparent angles pass the gate
            inl = res.inliers.cpu().numpy()
            q1 = p1.cpu().numpy().astype(np.float64)[inl]
            q2 = p2.cpu().numpy().astype(np.float64)[inl]
            r1 = np.concatenate([q1, np.ones((len(q1), 1))], axis=1)
            r2 = np.concatenate([q2, np.ones((len(q2), 1))], axis=1)
            r1 /= np.linalg.norm(r1, axis=1, keepdims=True)
            r2 /= np.linalg.norm(r2, axis=1, keepdims=True)
            r2w = r2 @ res.R.cpu().numpy().astype(np.float64)  # R^T r2 per row
            cosang = np.sum(r1 * r2w, axis=1)
            med = np.degrees(np.arccos(
                np.clip(np.median(cosang), -1.0, 1.0)))
            if med < min_tri_angle_deg:
                if score > best_narrow_score:
                    best_narrow, best_narrow_score, best_narrow_res = (
                        (i, j), score, res)
                continue
            best, best_score, best_res = (i, j), score, res
        if best is None and best_narrow is not None:
            # no pair clears the angle gate: fall back to max inliers
            best, best_score, best_res = (
                best_narrow, best_narrow_score, best_narrow_res)
        if best is None:
            raise ValueError("no usable initial pair")
        i, j = best
        self.rec.Rs[i] = np.eye(3)
        self.rec.ts[i] = np.zeros(3)
        self.rec.Rs[j] = best_res.R.cpu().numpy().astype(np.float64)
        self.rec.ts[j] = best_res.t.cpu().numpy().astype(np.float64)
        self.log(f"init pair ({i},{j}) inliers={best_score}")
        self._triangulate_tracks()
        return best

    # ------------------------------------------------- track geometry

    def _triangulate_tracks(self):
        """(Re)triangulate all tracks with >=2 registered observations,
        batched over a single device call per image pair group."""
        t_start = time.perf_counter()
        reg = set(self.rec.registered)
        centers = {
            im: -self.rec.Rs[im].T @ self.rec.ts[im]
            for im in self.rec.registered
        }
        jobs = []  # (track_id, im_a, im_b, uv_a, uv_b)
        for tid, tr in enumerate(self.tracks):
            if tid in self.rec.points:
                continue
            ims = [im for im in tr if im in reg]
            if len(ims) < 2:
                continue
            # widest-baseline registered view pair: track-insertion
            # order picked near-adjacent ring neighbours whose short
            # baseline makes depth ill-conditioned (the dominant error
            # source once camera spacing halves at 120 cams)
            ims = ims[:8]
            a, b, best = ims[0], ims[1], -1.0
            for i in range(len(ims)):
                for j in range(i + 1, len(ims)):
                    d = float(np.sum(
                        (centers[ims[i]] - centers[ims[j]]) ** 2))
                    if d > best:
                        a, b, best = ims[i], ims[j], d
            jobs.append((tid, a, b, tr[a], tr[b]))
        if not jobs:
            return
        # group by (a, b) for batched triangulation
        from collections import defaultdict

        groups = defaultdict(list)
        for job in jobs:
            groups[(job[1], job[2])].append(job)
        n_new = 0
        for (a, b), js in groups.items():
            # pad each group to a shape bucket as JAX does (rows are
            # independent, padding repeats the last row; extras sliced
            # off below)
            (uv_a, uv_b), _ = _pad_valid(
                [[j[3] for j in js], [j[4] for j in js]], len(js)
            )
            p1, p2 = self._normalize_dev(np.concatenate([uv_a, uv_b], axis=1), a, b)
            f32 = np.float32
            X = triangulate(
                self._dev(self.rec.Rs[a], f32), self._dev(self.rec.ts[a], f32),
                self._dev(self.rec.Rs[b], f32), self._dev(self.rec.ts[b], f32),
                p1, p2,
            )
            X = X.cpu().numpy().astype(np.float64)[: len(js)]
            # VECTORISED chirality + reprojection gating on the two
            # triangulating views (the remaining observations are
            # enforced by the post-BA filter_points pass, which drops
            # inconsistent obs/points wholesale). The per-point
            # per-observation python loop this replaces was the
            # dominant triangulation cost at 120 cameras (427 s).
            ok = np.ones(len(js), bool)
            for im, uvs in (
                (a, np.stack([j[3] for j in js])),
                (b, np.stack([j[4] for j in js])),
            ):
                pc = X @ self.rec.Rs[im].T + self.rec.ts[im]
                ok &= pc[:, 2] > 1e-6
                proj = (self.K[im] @ (pc / np.maximum(
                    pc[:, 2:3], 1e-9)).T).T[:, :2]
                ok &= (
                    np.linalg.norm(proj - uvs, axis=1) <= 3 * self.px_thres
                )
            # COLMAP-style minimum triangulation angle: short-baseline
            # points carry unbounded depth noise and poison PnP/BA
            va = X - centers[a]
            vb = X - centers[b]
            cosang = np.sum(va * vb, axis=1) / np.maximum(
                np.linalg.norm(va, axis=1) * np.linalg.norm(vb, axis=1),
                1e-12,
            )
            ok &= cosang < np.cos(np.deg2rad(self.tri_min_angle_deg))
            for (tid, *_), x, good in zip(js, X, ok):
                if good:
                    self.rec.points[tid] = x
                    n_new += 1
        self.stats["triangulate_s"] += time.perf_counter() - t_start
        self.log(f"triangulated {n_new} new points ({len(self.rec.points)} total)")

    # ------------------------------------------------- registration

    def _candidates(self) -> List[Tuple[int, int]]:
        """Unregistered images ranked by visible 3D points."""
        reg = set(self.rec.registered)
        count: Dict[int, int] = {}
        for tid in self.rec.points:
            for im in self.tracks[tid]:
                if im not in reg:
                    count[im] = count.get(im, 0) + 1
        return sorted(count.items(), key=lambda kv: -kv[1])

    # PnP candidate batch width (JAX evaluates a batch in one vmapped
    # RANSAC; here each candidate is one ransac_pnp call)
    PNP_BATCH = 8
    # hypotheses of each rescue-pass PnP RANSAC (JAX draws 256 there
    # too). A straggler at a ring closure is rescued against tracks of
    # which only about a third agree with its pose, and a 6-point sample
    # of such a set is seldom clean: with 256 draws the three rescue
    # gates could all miss it, and the last camera of the scale demo's
    # 50-camera ring stayed out in some runs
    RESCUE_HYPS = 2048

    def register_next(self, thres_scale: float = 1.0) -> Optional[int]:
        """Register ONE image (the best-passing candidate)."""
        regs = self.register_batch(thres_scale=thres_scale, max_accept=1)
        return regs[0] if regs else None

    def register_batch(
        self, thres_scale: float = 1.0, max_accept: Optional[int] = None,
        min_inliers: int = 30, n_hyps: int = 256,
    ) -> List[int]:
        """Try the top candidates, ``PNP_BATCH`` at a time, one PnP RANSAC
        of ``n_hyps`` hypotheses each, and register every passing image
        (PnP against the CURRENT map is independent per image). Returns
        registered image ids."""
        t_start = time.perf_counter()
        cands = [(im, nv) for im, nv in self._candidates() if nv >= 6]
        registered: List[int] = []
        ci = 0
        while ci < len(cands) and not (
            max_accept is not None and len(registered) >= max_accept
        ):
            batch = cands[ci: ci + self.PNP_BATCH]
            ci += self.PNP_BATCH
            jobs = []
            for im, _ in batch:
                tids = [
                    tid for tid in self.rec.points if im in self.tracks[tid]
                ]
                X = np.stack([self.rec.points[t] for t in tids])
                uv = np.stack([self.tracks[t][im] for t in tids])
                if len(X) > _BUCKETS[-1]:
                    sel = np.random.default_rng(im).choice(
                        len(X), _BUCKETS[-1], replace=False
                    )
                    X, uv = X[sel], uv[sel]
                f = (self.K[im][0, 0] + self.K[im][1, 1]) / 2
                jobs.append((im, X, uv, len(tids),
                             float((thres_scale * self.px_thres / f) ** 2)))
            # one shared obs bucket per batch, as JAX pads it (one
            # compiled program per (PNP_BATCH, bucket) pair there)
            b = max(_bucket_pad(len(j[1])) for j in jobs)
            Xs, ps, valids, thrs = [], [], [], []
            for im, X, uv, _, thr in jobs:
                (X_pad, uv_pad), valid = _pad_valid([X, uv], len(X))
                if len(X_pad) < b:
                    X_pad = np.concatenate(
                        [X_pad, np.repeat(X_pad[-1:], b - len(X_pad), 0)])
                    uv_pad = np.concatenate(
                        [uv_pad, np.repeat(uv_pad[-1:], b - len(uv_pad), 0)])
                    valid = np.concatenate([valid, np.zeros(b - len(valid), bool)])
                Xs.append(X_pad)
                ps.append(self._normalize_np(uv_pad, self.K[im]))
                valids.append(valid)
                thrs.append(thr)
            self._pnp_shapes.add((self.PNP_BATCH, b))
            res = [
                ransac_pnp(self.gen, self._dev(X, np.float32), self._dev(p, np.float32),
                           n_hyps, float(np.float32(t)), valid=self._dev(v))
                for X, p, v, t in zip(Xs, ps, valids, thrs)
            ]
            n_inl = torch.stack([r.num_inliers for r in res]).cpu().numpy()
            Rb = torch.stack([r.R for r in res]).cpu().numpy().astype(np.float64)
            tb = torch.stack([r.t for r in res]).cpu().numpy().astype(np.float64)
            for bi, (im, X, _, n_tids, _) in enumerate(jobs):
                if n_inl[bi] < 6:
                    continue
                # acceptance is ALWAYS verified at the STRICT (1x)
                # threshold, whatever gate RANSAC searched with: a
                # widened rescue gate may fit a grossly wrong pose on
                # borderline support (measured at 120 cams: one junk
                # rescue registration blew the ATE from <0.1% to 58%
                # of scene radius)
                f = (self.K[im][0, 0] + self.K[im][1, 1]) / 2
                pc = X @ Rb[bi].T + tb[bi]
                ok_z = pc[:, 2] > 1e-6
                proj = pc[:, :2] / np.maximum(pc[:, 2:3], 1e-6)
                pn = ps[bi][: len(X)]
                err = np.sum((proj - pn) ** 2, axis=1)
                n_strict = int(np.sum(ok_z & (err < (self.px_thres / f) ** 2)))
                # quality gate (COLMAP's abs_pose_min_num_inliers
                # convention): a pose supported by only a handful of
                # strict inliers is drift fit against an immature map
                # — defer the image; its support improves once this
                # round's accepted registrations triangulate more of
                # its tracks (measured at 120 cams: 6-24-inlier early
                # acceptances snowballed into an unregistrable arc)
                if n_strict < min_inliers:
                    continue
                if max_accept is not None and len(registered) >= max_accept:
                    break
                self.rec.Rs[im] = Rb[bi]
                self.rec.ts[im] = tb[bi]
                registered.append(im)
                self.log(
                    f"registered im {im}: {int(n_inl[bi])}/{n_tids} PnP "
                    f"inliers ({n_strict} strict)"
                )
        self.stats["register_s"] += time.perf_counter() - t_start
        self.stats["pnp_shapes"] = len(self._pnp_shapes)
        return registered

    # ------------------------------------------------- bundle adjust

    def assemble_ba(self):
        """Flatten the reconstruction into BA problem arrays:
        (Rs, ts, X, cam_idx, pt_idx, uv_normalized, f_mean, reg, tids).
        Shared by the single-device and mesh-sharded solvers.

        Fully host-vectorised: observations are gathered into flat
        numpy arrays and normalized per CAMERA in one pass (a previous
        version issued one device ``normalize_points`` call per
        observation — ~100 us of dispatch x 65k observations dominated
        every BA call at the 50-camera scale)."""
        reg = self.rec.registered
        im2c = {im: c for c, im in enumerate(reg)}
        tids = sorted(self.rec.points.keys())
        t2p = {t: p for p, t in enumerate(tids)}
        cam_idx, pt_idx, uv_px = [], [], []
        for t in tids:
            for im, xy in self.tracks[t].items():
                if im not in im2c:
                    continue
                cam_idx.append(im2c[im])
                pt_idx.append(t2p[t])
                uv_px.append(xy)
        cam_idx = np.asarray(cam_idx, np.int32)
        pt_idx = np.asarray(pt_idx, np.int32)
        uv_px = np.asarray(uv_px, np.float64).reshape(-1, 2)
        uv = np.empty_like(uv_px, dtype=np.float32)
        for im, c in im2c.items():
            sel = cam_idx == c
            if sel.any():
                uv[sel] = self._normalize_np(uv_px[sel], self.K[im])
        f_mean = float(np.mean([self.K[im][0, 0] for im in reg]))
        return (
            np.stack([self.rec.Rs[im] for im in reg]),
            np.stack([self.rec.ts[im] for im in reg]),
            np.stack([self.rec.points[t] for t in tids]),
            cam_idx, pt_idx, uv, f_mean, reg, tids,
        )

    def bundle_adjust(self, max_iters: int = 15, huber_px: float = 3.0):
        t0 = time.perf_counter()
        Rs, ts, X, cam_idx, pt_idx, uv, f_mean, reg, tids = self.assemble_ba()
        self.stats["ba_assemble_s"] += time.perf_counter() - t0
        im2c = {im: c for c, im in enumerate(reg)}
        t2p = {t: p for p, t in enumerate(tids)}
        t0 = time.perf_counter()
        # bucketed shapes, as JAX pads them (its jitted LM step compiles
        # once per (C, P, M) bucket triple)
        prob = build_problem(Rs, ts, X, cam_idx, pt_idx, uv, bucket=True,
                             device=self.device)
        shape_key = tuple(prob.uv.shape) + tuple(prob.X.shape) + (
            prob.Rs.shape[0],)
        first = shape_key not in self._ba_shapes
        self._ba_shapes.add(shape_key)
        solved, c = run_ba(
            prob, max_iters=max_iters, huber_delta=huber_px / f_mean,
            device=self.device,
        )
        dt = time.perf_counter() - t0
        self.stats["ba_solve_s"] += dt
        if first:
            self.stats["ba_first_shape_time"] += dt
            self.stats["ba_shapes"] = len(self._ba_shapes)
        self.stats["ba_calls"] = self.stats.get("ba_calls", 0) + 1
        Rs_s, ts_s, X_s = (a.cpu().numpy().astype(np.float64)
                           for a in (solved.Rs, solved.ts, solved.X))
        for im, ci in im2c.items():
            self.rec.Rs[im] = Rs_s[ci]
            self.rec.ts[im] = ts_s[ci]
        for t, pi in t2p.items():
            self.rec.points[t] = X_s[pi]
        self.log(f"BA over {len(reg)} cams / {len(tids)} pts: cost {c:.3e}")

    # ------------------------------------------------- point filtering

    def filter_points(self, max_px: Optional[float] = None) -> Tuple[int, int]:
        """COLMAP-style observation/point gating after bundle adjust.

        Deletes observations whose reprojection exceeds ``max_px``
        (default 3*px_thres) under the current poses, then points left
        with <2 registered observations or behind a camera. Without
        this, chimera tracks (outlier edges merging two 3D points) and
        drifted triangulations accumulate in the map, drag the BA and
        eventually starve PnP registration (measured at 50 cams:
        median map reprojection 30 px, ring-closure images
        unregistrable).
        """
        t_start = time.perf_counter()
        max_px = max_px if max_px is not None else 3.0 * self.px_thres
        reg = set(self.rec.registered)
        n_obs_dropped, drop = 0, []
        for tid, x in self.rec.points.items():
            tr = self.tracks[tid]
            bad_ims = []
            ok = 0
            for im, xy in tr.items():
                if im not in reg:
                    continue
                pc = self.rec.Rs[im] @ x + self.rec.ts[im]
                if pc[2] <= 1e-6:
                    bad_ims.append(im)
                    continue
                proj = self.K[im] @ (pc / pc[2])
                if np.linalg.norm(proj[:2] - xy) > max_px:
                    bad_ims.append(im)
                else:
                    ok += 1
            for im in bad_ims:
                del tr[im]
            n_obs_dropped += len(bad_ims)
            if ok < 2:
                drop.append(tid)
        for tid in drop:
            del self.rec.points[tid]
        self.stats["filter_s"] += time.perf_counter() - t_start
        self.log(
            f"filtered {n_obs_dropped} obs, {len(drop)} points "
            f"({len(self.rec.points)} remain)"
        )
        return n_obs_dropped, len(drop)

    # ------------------------------------------------- driver

    def run(self, ba_every: int = 3, global_ba: bool = True) -> Reconstruction:
        self.init_pair()
        self.bundle_adjust()
        self.filter_points()
        while True:
            # one PnP pass registers up to ba_every candidates
            # against the current map; frontier images whose support
            # appears only after this round's triangulation register
            # next round. While the map is young (few cameras, mostly
            # 2-view points) register one at a time — early batch
            # acceptances against the immature map drift measurably
            k = 1 if len(self.rec.registered) < 6 else ba_every
            regs = self.register_batch(max_accept=k)
            if not regs:
                break
            self._triangulate_tracks()
            self.bundle_adjust()
            self.filter_points()
            # dropped tracks may re-triangulate under the adjusted
            # poses (triangulation skips only live points)
            self._triangulate_tracks()
        if global_ba:
            self.bundle_adjust(max_iters=30)
            self.filter_points()
        # rescue pass: stragglers (typically ring-closure images whose
        # candidates straddle accumulated drift) retried under the
        # refined map with progressively widened RANSAC gates; each
        # successful round is re-adjusted so the drift correction can
        # unlock the next straggler
        for scale in (2.0, 3.0, 5.0):
            while True:
                regs = self.register_batch(
                    thres_scale=scale, min_inliers=12, n_hyps=self.RESCUE_HYPS)
                if not regs:
                    break
                for im in regs:
                    self.log(f"rescued im {im} (gate x{scale})")
                self._triangulate_tracks()
                if global_ba:
                    self.bundle_adjust(max_iters=15)
                    self.filter_points()
                    self._triangulate_tracks()
        self.log(
            f"done: {len(self.rec.registered)} cams, {len(self.rec.points)} points"
        )
        return self.rec

    def registration_report(self) -> Dict[int, Dict[str, int]]:
        """Diagnostics for unregistered images: how many tracks contain
        the image, and how many of those have a live 3D point (the PnP
        support)."""
        reg = set(self.rec.registered)
        all_ims = set()
        for tr in self.tracks:
            all_ims.update(tr.keys())
        out = {}
        for im in sorted(all_ims - reg):
            n_tracks = sum(1 for tr in self.tracks if im in tr)
            n_vis = sum(
                1 for tid in self.rec.points if im in self.tracks[tid]
            )
            out[im] = {"tracks": n_tracks, "visible_points": n_vis}
        return out


def export_colmap(
    rec: Reconstruction,
    out_dir: str,
    image_names: Optional[Dict[int, str]] = None,
    ext: str = ".bin",
):
    """Write the reconstruction as a COLMAP sparse model, directly
    comparable with reference ground-truth models."""
    cams, ims, pts = {}, {}, {}
    track_of_im: Dict[int, List[Tuple[int, np.ndarray]]] = {
        im: [] for im in rec.registered
    }
    for tid, x in rec.points.items():
        for im, xy in rec.track_obs[tid].items():
            if im in track_of_im:
                track_of_im[im].append((tid, xy))

    tid2pid = {t: i + 1 for i, t in enumerate(sorted(rec.points))}
    for ci, im in enumerate(rec.registered, start=1):
        K = rec.K[im]
        cams[ci] = Camera(
            id=ci, model="PINHOLE", width=int(2 * K[0, 2]),
            height=int(2 * K[1, 2]),
            params=np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]),
        )
        obs = track_of_im[im]
        xys = np.stack([xy for _, xy in obs]) if obs else np.zeros((0, 2))
        pids = np.asarray([tid2pid[t] for t, _ in obs], np.int64) if obs else np.zeros(0, np.int64)
        ims[ci] = ImagePose(
            id=ci, qvec=rotmat2qvec(rec.Rs[im]), tvec=rec.ts[im],
            camera_id=ci,
            name=image_names.get(im, f"im_{im}.jpg") if image_names else f"im_{im}.jpg",
            xys=xys, point3D_ids=pids,
        )
    im2ci = {im: ci for ci, im in enumerate(rec.registered, start=1)}
    for t, pid in tid2pid.items():
        obs_ims = [im for im in rec.track_obs[t] if im in im2ci]
        pts[pid] = Point3D(
            id=pid, xyz=rec.points[t], rgb=np.array([128, 128, 128], np.uint8),
            error=0.0,
            image_ids=np.asarray([im2ci[im] for im in obs_ims], np.int32),
            point2D_idxs=np.zeros(len(obs_ims), np.int32),
        )
    write_model(cams, ims, pts, out_dir, ext=ext)
