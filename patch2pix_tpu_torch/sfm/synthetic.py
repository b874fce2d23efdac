"""Synthetic multi-view scenes for SfM benchmarks and tests.

Generates a ring of cameras observing a 3D point cloud with PARTIAL
visibility (frustum + random dropout), pixel noise, and OUTLIER
correspondences — the failure modes a real matcher feeds an SfM
pipeline — plus the ground-truth poses for ATE evaluation.

Copy of ``patch2pix_tpu.sfm.synthetic`` (numpy): the same seed gives
the same scene. Used by :mod:`patch2pix_tpu_torch.sfm.scale_demo`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def make_scale_scene(
    n_cams: int = 50,
    n_pts: int = 5000,
    noise_px: float = 0.4,
    outlier_frac: float = 0.05,
    drop_frac: float = 0.3,
    max_pair_gap: int = 5,
    radius: float = 8.0,
    K: np.ndarray | None = None,
    seed: int = 0,
):
    """Build (Rs, ts, X, K, pair_matches).

    Cameras sit on a ring of ``radius`` looking at the cloud (points in
    [-2, 2]^3). Each camera observes a point only if it projects inside
    the image and survives a ``drop_frac`` random dropout (partial
    visibility). Pair matches exist for camera pairs within
    ``max_pair_gap`` ring steps; each pair's match list carries
    ``outlier_frac`` random wrong correspondences appended to the
    inliers, shuffled.
    """
    rng = np.random.default_rng(seed)
    if K is None:
        K = np.array([[600.0, 0, 320], [0, 600, 240], [0, 0, 1]])
    w, h = int(2 * K[0, 2]), int(2 * K[1, 2])
    X = rng.uniform([-2, -2, -2], [2, 2, 2], (n_pts, 3))

    Rs, ts = [], []
    for i in range(n_cams):
        ang = 2 * np.pi * i / n_cams
        c = radius * np.array(
            [np.sin(ang), 0.15 * rng.standard_normal(), np.cos(ang)]
        )
        z = -c / np.linalg.norm(c)
        x = np.cross([0, 1, 0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        Rs.append(R)
        ts.append(-R @ c)
    Rs, ts = np.stack(Rs), np.stack(ts)

    # per-camera pixel observations with partial visibility
    vis: Dict[Tuple[int, int], np.ndarray] = {}
    for ci in range(n_cams):
        pc = X @ Rs[ci].T + ts[ci]
        ok = pc[:, 2] > 0.5
        proj = (pc[:, :2] / np.maximum(pc[:, 2:3], 1e-9))
        px = proj * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
        ok &= (px[:, 0] >= 0) & (px[:, 0] < w) & (px[:, 1] >= 0) & (px[:, 1] < h)
        ok &= rng.random(n_pts) >= drop_frac
        noise = noise_px * rng.standard_normal((n_pts, 2))
        for pj in np.where(ok)[0]:
            vis[(ci, int(pj))] = px[pj] + noise[pj]

    pair_matches: Dict[Tuple[int, int], np.ndarray] = {}
    for i in range(n_cams):
        for gap in range(1, max_pair_gap + 1):
            j = i + gap
            if j >= n_cams:
                j -= n_cams  # close the ring
            a, b = min(i, j), max(i, j)
            if (a, b) in pair_matches:
                continue
            rows = [
                np.concatenate([vis[(a, p)], vis[(b, p)]])
                for p in range(n_pts)
                if (a, p) in vis and (b, p) in vis
            ]
            if len(rows) < 16:
                continue
            m = np.stack(rows)
            n_out = int(len(m) * outlier_frac)
            if n_out:
                out = np.concatenate(
                    [
                        rng.uniform([0, 0], [w, h], (n_out, 2)),
                        rng.uniform([0, 0], [w, h], (n_out, 2)),
                    ],
                    axis=1,
                )
                m = np.concatenate([m, out])
            pair_matches[(a, b)] = m[rng.permutation(len(m))]
    return Rs, ts, X, K, pair_matches
