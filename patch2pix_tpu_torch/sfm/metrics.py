"""Trajectory / reconstruction quality metrics (host side, numpy).

Copy of ``patch2pix_tpu.sfm.metrics``: ATE with Sim(3) Umeyama
alignment, and per-camera rotation errors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = True
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Least-squares Sim(3): s, R, t minimising ||dst - (s R src + t)||.

    src, dst: (N, 3) corresponding points (e.g. camera centres).
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs**2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(
    est_centers: np.ndarray, gt_centers: np.ndarray, with_scale: bool = True
) -> float:
    """Absolute trajectory error (RMSE) after Sim(3) alignment."""
    s, R, t = umeyama_alignment(est_centers, gt_centers, with_scale)
    aligned = (s * (R @ np.asarray(est_centers, np.float64).T)).T + t
    return float(
        np.sqrt(np.mean(np.sum((aligned - gt_centers) ** 2, axis=1)))
    )


def rotation_errors_deg(
    est_Rs: np.ndarray, gt_Rs: np.ndarray, align_R: np.ndarray | None = None
) -> np.ndarray:
    """Per-camera rotation error (deg), optionally pre-rotated by the
    alignment rotation from :func:`umeyama_alignment`."""
    errs = []
    for Re, Rg in zip(est_Rs, gt_Rs):
        Ra = Re @ align_R.T if align_R is not None else Re
        c = (np.trace(Ra.T @ Rg) - 1) / 2
        errs.append(np.degrees(np.arccos(np.clip(c, -1, 1))))
    return np.asarray(errs)
