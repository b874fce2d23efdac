"""Host-side (numpy) match/pose quality measures.

A copy of ``patch2pix_tpu.evaluation.measure`` (the reference's
``utils/eval/measure.py``: ``sampson_distance`` :18,
``symmetric_epipolar_distance`` :43, the angle errors :73-100,
``eval_matches_relapose`` :102 and the histogram reporters :115-161),
kept in the port so that it imports nothing of the JAX package;
``eval_matches_relapose`` calls the port's geometry, on the card unless
``device`` is given.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def _to_homo(pts: np.ndarray) -> np.ndarray:
    return np.concatenate([pts, np.ones((pts.shape[0], 1))], axis=1)


def sampson_distance(
    pts1: np.ndarray, pts2: np.ndarray, F: np.ndarray, eps: float = 1e-8
) -> np.ndarray:
    """Sampson distance of correspondences under F (x2^T F x1 = 0).

    pts1, pts2: (N, 2). Returns (N,) squared first-order distances —
    same formula as the reference (measure.py:18-40).
    """
    p1 = _to_homo(np.asarray(pts1, np.float64))
    p2 = _to_homo(np.asarray(pts2, np.float64))
    l2 = p1 @ F.T  # (N, 3): epipolar lines in image 2
    l1 = p2 @ F  # (N, 3): lines in image 1 (F^T x2)
    dd = np.sum(l2 * p2, axis=1)
    denom = eps + l1[:, 0] ** 2 + l1[:, 1] ** 2 + l2[:, 0] ** 2 + l2[:, 1] ** 2
    return dd**2 / denom


def symmetric_epipolar_distance(
    pts1: np.ndarray, pts2: np.ndarray, F: np.ndarray, sqrt: bool = False
) -> np.ndarray:
    """Symmetric epipolar distance (squared by default, as in MVG)."""
    p1 = _to_homo(np.asarray(pts1, np.float64))
    p2 = _to_homo(np.asarray(pts2, np.float64))
    l2 = p1 @ F.T
    l1 = p2 @ F
    dd = np.sum(l2 * p2, axis=1)
    n1 = l1[:, 0] ** 2 + l1[:, 1] ** 2
    n2 = l2[:, 0] ** 2 + l2[:, 1] ** 2
    if sqrt:
        return np.abs(dd) * (1.0 / np.sqrt(n1) + 1.0 / np.sqrt(n2))
    return dd**2 * (1.0 / n1 + 1.0 / n2)


def vec_angle_error(label: np.ndarray, pred: np.ndarray, eps: float = 1e-14):
    """Angle (deg) between vectors; accepts (3,) or (N, 3)."""
    label = np.atleast_2d(label).astype(np.float64)
    pred = np.atleast_2d(pred).astype(np.float64)
    v1 = pred / (np.linalg.norm(pred, axis=1, keepdims=True) + eps)
    v2 = label / (np.linalg.norm(label, axis=1, keepdims=True) + eps)
    d = np.clip(np.sum(v1 * v2, axis=1), -1.0, 1.0)
    return np.degrees(np.arccos(d)).squeeze()


def quat_angle_error(label: np.ndarray, pred: np.ndarray, eps: float = 1e-14):
    """Rotation angle (deg) between unit quaternions (sign-invariant)."""
    label = np.atleast_2d(label).astype(np.float64)
    pred = np.atleast_2d(pred).astype(np.float64)
    q1 = pred / (np.linalg.norm(pred, axis=1, keepdims=True) + eps)
    q2 = label / (np.linalg.norm(label, axis=1, keepdims=True) + eps)
    d = np.clip(np.abs(np.sum(q1 * q2, axis=1)), -1.0, 1.0)
    return (2 * np.degrees(np.arccos(d))).squeeze()


def rot_angle_error(Rgt: np.ndarray, Rpred: np.ndarray) -> float:
    c = (np.trace(Rpred.T @ Rgt) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def eval_matches_relapose(
    matches: np.ndarray,
    K1: np.ndarray,
    K2: np.ndarray,
    q_gt: np.ndarray,
    t_gt: np.ndarray,
    ransac_thres: float = 1.0,
    backend: str = "device",
    device=None,
) -> Tuple[float, float, np.ndarray]:
    """5-pt RANSAC relative pose from matches + angular errors vs GT.

    Returns (translation angle err deg, rotation angle err deg,
    inlier indices) — the reference protocol (measure.py:102-113).
    ``backend``: 'device' (on-device Nister RANSAC, the default — the
    validation loop runs with zero host geometry) or 'cv2' (the
    reference's OpenCV path, kept as a cross-check); ``device`` is the
    device backend's.
    """
    from patch2pix_tpu_torch.data.colmap_model import rotmat2qvec
    from patch2pix_tpu_torch.evaluation.geometry import (
        matches2relapose_cv,
        matches2relapose_device,
    )

    if backend == "device":
        E, inls, R, t = matches2relapose_device(
            matches[:, :2], matches[:, 2:4], K1, K2, rthres=ransac_thres, device=device)
    else:
        E, inls, R, t = matches2relapose_cv(
            matches[:, :2], matches[:, 2:4], K1, K2, rthres=ransac_thres)
    terr = float(vec_angle_error(np.asarray(t_gt), t.reshape(3)))
    qerr = float(quat_angle_error(np.asarray(q_gt), rotmat2qvec(R)))
    return terr, qerr, inls


def inlier_distance_histogram(
    dist_lists: Sequence[np.ndarray],
    bins: Sequence[float] = (0, 1e-2, 1, 5, 10, 25, 50, 100, 2500, 1e5),
    tag: str = "",
) -> Tuple[Optional[List[float]], str]:
    """Mean per-pair histogram ratios (%) of match distances.

    The reference's ``check_inliers_distr`` (measure.py:115-141).
    """
    if not len(dist_lists):
        return None, ""
    ratios, counts = [], []
    for d in dist_lists:
        d = np.asarray(d)
        if d.size == 0:
            continue
        counts.append(d.size)
        ratios.append(np.histogram(d, bins)[0] / d.size)
    if not ratios:
        return None, ""
    mean_ratios = [100.0 * v for v in np.mean(ratios, axis=0)]
    txt = (
        f"{tag} Sample:{len(dist_lists)} "
        f"N(mean/max/min):{np.mean(counts):.0f}/{np.max(counts):.0f}/{np.min(counts):.0f}\n"
        "Ratios(%):"
    )
    for val, lo, hi in zip(mean_ratios, bins[:-1], bins[1:]):
        txt += f" [{lo},{hi})={val:.2f}"
    return mean_ratios, txt
