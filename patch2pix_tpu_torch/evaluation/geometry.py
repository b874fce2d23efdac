"""Host-side (numpy) two-view geometry for evaluation.

Port of ``patch2pix_tpu.evaluation.geometry``: the reference's F/E/pose
conversions (its ``utils/eval/geometry.py:6-20``), ``abs2relapose``
(:73), the OpenCV paths ``matches2relapose_cv`` (:32) and
``matches2relapose_degensac`` (:53), which import ``cv2`` when called,
and ``matches2relapose_device``, the 5-point (Nister) RANSAC of
:mod:`patch2pix_tpu_torch.sfm.fivepoint` on the card, the default of the
evaluation protocols. Differentiable torch equivalents live in
``patch2pix_tpu_torch.ops.geometry``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from patch2pix_tpu_torch.data.colmap_model import qvec2rotmat, rotmat2qvec


def skew(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v).reshape(3)
    return np.array(
        [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], dtype=np.float64
    )


def pose2ess(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    return skew(t) @ R


def ess2fund(K1: np.ndarray, K2: np.ndarray, E: np.ndarray) -> np.ndarray:
    return np.linalg.inv(K2).T @ E @ np.linalg.inv(K1)


def fund2ess(F: np.ndarray, K2: np.ndarray, K1: np.ndarray) -> np.ndarray:
    return K2.T @ F @ K1


def pose2fund(K1: np.ndarray, K2: np.ndarray, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """F from intrinsics + relative pose; the reference's formulation
    (geometry.py:15): F = K2^-T R K1^T [K1 R^T t]_x."""
    return np.linalg.inv(K2).T @ R @ K1.T @ skew((K1 @ R.T) @ np.asarray(t).reshape(3))


def norm_fund(F: np.ndarray) -> np.ndarray:
    return F / F[-1, -1]


def abs2relapose(
    c1: np.ndarray, c2: np.ndarray, q1: np.ndarray, q2: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Relative (t12, q12) from two absolute camera poses (world->cam
    quaternions + camera centres); reference geometry.py:73-89."""
    r1, r2 = qvec2rotmat(q1), qvec2rotmat(q2)
    r12 = r2 @ r1.T
    t12 = r2 @ (np.asarray(c1) - np.asarray(c2))
    return t12, rotmat2qvec(r12)


def _center_normalize(p1, p2, K1, K2):
    """Shift to principal-point origin and rescale image-1 points to
    image 2's focal length — the reference's preconditioning before
    the 5-pt solver (geometry.py:34-45)."""
    f1, f2 = K1[0, 0], K2[0, 0]
    p1 = (np.asarray(p1, np.float64) - K1[:2, 2]) * (f2 / f1)
    p2 = np.asarray(p2, np.float64) - K2[:2, 2]
    K = np.array([[f2, 0, 0], [0, f2, 0], [0, 0, 1]], dtype=np.float64)
    return p1, p2, K


def matches2relapose_cv(
    p1: np.ndarray,
    p2: np.ndarray,
    K1: np.ndarray,
    K2: np.ndarray,
    rthres: float = 1.0,
):
    """Essential matrix + relative pose via OpenCV 5-pt RANSAC.

    Returns (E, inlier indices, R, t).
    """
    import cv2

    p1n, p2n, K = _center_normalize(p1, p2, K1, K2)
    E, inls = cv2.findEssentialMat(
        p1n, p2n, cameraMatrix=K, method=cv2.FM_RANSAC, threshold=rthres
    )
    inls = np.where(inls.ravel() > 0)[0]
    _, R, t, _ = cv2.recoverPose(E, p1n[inls], p2n[inls], K)
    return E, inls, R, t


def matches2relapose_device(
    p1: np.ndarray,
    p2: np.ndarray,
    K1: np.ndarray,
    K2: np.ndarray,
    rthres: float = 1.0,
    n_samples: int = 256,
    seed: int = 0,
    device=None,
):
    """5-point (Nister) RANSAC relative pose on the device (the card
    unless ``device`` is given), in place of :func:`matches2relapose_cv`.
    The reference's preconditioning (its geometry.py:34-45): principal-
    point centring, image-1 points rescaled to image 2's focal, the
    threshold in f2-pixels; the samples drawn by a generator seeded with
    ``seed``.

    The matches are padded to a power-of-two bucket of at least 64 rows
    with a validity mask, as in JAX (where it bounds the compiles), so
    that fewer than 5 matches, or none, still make well-shaped samples.

    Returns (E, inlier indices, R, t) like the cv2 variant.
    """
    from patch2pix_tpu_torch.config import resolve_device
    from patch2pix_tpu_torch.sfm.fivepoint import ransac_essential_5pt

    device = resolve_device(device)
    p1n, p2n, K = _center_normalize(p1, p2, K1, K2)
    f2 = K[0, 0]
    n = len(p1n)
    bucket = max(64, 1 << int(np.ceil(np.log2(max(n, 1)))))
    pad = bucket - n
    q1 = np.pad(p1n / f2, ((0, pad), (0, 0))).astype(np.float32)
    q2 = np.pad(p2n / f2, ((0, pad), (0, 0))).astype(np.float32)
    valid = np.zeros((bucket,), bool)
    valid[:n] = True

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    res = ransac_essential_5pt(
        gen, torch.from_numpy(q1).to(device), torch.from_numpy(q2).to(device),
        n_samples, float((rthres / f2) ** 2), torch.from_numpy(valid).to(device),
    )
    inls = np.where(res.inliers.cpu().numpy()[:n])[0]
    R = res.R.cpu().numpy().astype(np.float64)
    t = res.t.cpu().numpy().astype(np.float64).reshape(3, 1)
    return res.E.cpu().numpy().astype(np.float64), inls, R, t


def matches2relapose_degensac(
    p1: np.ndarray,
    p2: np.ndarray,
    K1: np.ndarray,
    K2: np.ndarray,
    rthres: float = 1.0,
):
    """DEGENSAC variant (reference geometry.py:53-71).

    Uses pydegensac when installed; otherwise falls back to OpenCV's
    fundamental-matrix RANSAC (``findFundamentalMat`` + ``fund2ess``)
    — the same F-space estimation contract without the plane-degeneracy
    test, documented as an approximation rather than a hard gate.
    """
    import cv2

    p1n, p2n, K = _center_normalize(p1, p2, K1, K2)
    try:
        import pydegensac

        F, inls = pydegensac.findFundamentalMatrix(p1n, p2n, rthres)
    except ImportError:
        F, inls = cv2.findFundamentalMat(
            np.ascontiguousarray(p1n), np.ascontiguousarray(p2n),
            cv2.FM_RANSAC, rthres, 0.999,
        )
    E = fund2ess(F, K, K)
    inls = np.where(np.asarray(inls).ravel() > 0)[0]
    _, R, t, _ = cv2.recoverPose(E, p1n[inls], p2n[inls], K)
    return E, inls, R, t
