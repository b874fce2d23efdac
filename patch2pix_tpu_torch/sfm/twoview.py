"""Two-view geometry: batched solvers and a fixed-shape RANSAC.

Port of ``patch2pix_tpu.sfm.twoview``. JAX's ``vmap`` over hypotheses is
a leading batch axis here and its ``fori_loop`` a Python loop; every
function runs on the device of its inputs.

``torch.linalg`` raises where ``jnp.linalg`` returns non-finite values:
an SVD of a matrix holding NaN or inf, a solve of an exactly singular
system. Degenerate minimal samples (repeated or collinear points, fewer
valid matches than the sample size) produce both in a real RANSAC, so
:func:`svd` and :func:`solve` return NaN for such batch entries, as JAX
does, and the RANSAC goes on with the same inlier counts.

A RANSAC draws its sample ids first (:func:`draw_sample_ids`, with a
``torch.Generator`` where JAX takes a PRNG key) and then scores, refits
and recovers the pose given them; ``ids=`` feeds ids drawn elsewhere.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from patch2pix_tpu_torch.ops.geometry import skew


def svd(A: torch.Tensor, full_matrices: bool = True):
    """``torch.linalg.svd`` with NaN outputs for the batch entries whose
    input is not finite (where it would raise)."""
    ok = torch.isfinite(A).flatten(-2).all(-1)
    u, s, vh = torch.linalg.svd(torch.where(ok[..., None, None], A, 0.0),
                                full_matrices=full_matrices)
    nan = float("nan")
    return (torch.where(ok[..., None, None], u, nan), torch.where(ok[..., None], s, nan),
            torch.where(ok[..., None, None], vh, nan))


def solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.solve`` with NaN for the batch entries whose system
    is singular (where it would raise)."""
    x, info = torch.linalg.solve_ex(A, b)
    ok = (info == 0).reshape(info.shape + (1,) * (x.dim() - info.dim()))
    return torch.where(ok, x, float("nan"))


def right_vectors(A: torch.Tensor) -> torch.Tensor:
    """All right singular vectors ``vh`` (rows, singular values
    descending) of ``(..., m, n)`` A. Fewer rows than columns are padded
    with zero rows, which leaves them unchanged; so the thin SVD gives
    the null space without the ``(m, m)`` U that ``full_matrices`` would
    build for a tall A."""
    m, n = A.shape[-2:]
    if m < n:
        A = F.pad(A, (0, 0, 0, n - m))
    return svd(A, full_matrices=False)[2]


def det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of ``(..., 3, 3)`` matrices (cofactor expansion)."""
    return torch.sum(M[..., 0, :] * torch.linalg.cross(M[..., 1, :], M[..., 2, :]), dim=-1)


def normalize_points(pts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixel -> normalized camera coordinates: K^-1 [x y 1]."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    s = K[0, 1]
    y = (pts[..., 1] - cy) / fy
    x = (pts[..., 0] - cx - s * y) / fx
    return torch.stack([x, y], dim=-1)


def _epipolar_rows(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """``(..., N, 9)`` rows of ``p2^T E p1 = 0`` over E11..E33."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    ones = torch.ones_like(x1)
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], dim=-1)


def eight_point(p1: torch.Tensor, p2: torch.Tensor,
                w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Essential matrix from >= 8 normalized correspondences (Hartley's
    linear algorithm, then projection onto the essential manifold).

    p1, p2: ``(..., N, 2)`` with ``p2^T E p1 = 0``; w: optional ``(..., N)``
    row weights (0 masks a row out). Returns ``(..., 3, 3)``."""
    A = _epipolar_rows(p1, p2)
    if w is not None:
        A = A * w[..., None]
    E = right_vectors(A)[..., -1, :].reshape(A.shape[:-2] + (3, 3))
    u, s, vt = svd(E)
    sm = (s[..., 0] + s[..., 1]) / 2.0
    diag = torch.stack([sm, sm, torch.zeros_like(sm)], dim=-1)
    return (u * diag[..., None, :]) @ vt


def sampson_epipolar(p1: torch.Tensor, p2: torch.Tensor, E: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distance in normalized coordinates: p1, p2 ``(N,
    2)``, E ``(..., 3, 3)`` -> ``(..., N)``."""
    ones = torch.ones(p1.shape[:-1] + (1,), dtype=p1.dtype, device=p1.device)
    h1 = torch.cat([p1, ones], dim=-1)
    h2 = torch.cat([p2, ones], dim=-1)
    l2 = h1 @ E.transpose(-1, -2)
    l1 = h2 @ E
    dd = torch.sum(l2 * h2, dim=-1)
    denom = l1[..., 0] ** 2 + l1[..., 1] ** 2 + l2[..., 0] ** 2 + l2[..., 1] ** 2
    return dd ** 2 / (denom + 1e-12)


def triangulate(R1, t1, R2, t2, p1, p2) -> torch.Tensor:
    """DLT triangulation in normalized coordinates, batched over the
    poses' leading axes. Cameras map world X to ``R X + t``; p1, p2 are
    ``(N, 2)`` observations. Returns world points ``(..., N, 3)``."""
    def rows(R, t, p):
        P = torch.cat([R, t[..., None]], dim=-1)[..., None, :, :]  # (..., 1, 3, 4)
        return torch.stack([p[..., 0:1] * P[..., 2, :] - P[..., 0, :],
                            p[..., 1:2] * P[..., 2, :] - P[..., 1, :]], dim=-2)

    A = torch.cat(torch.broadcast_tensors(rows(R1, t1, p1), rows(R2, t2, p2)), dim=-2)
    X = svd(A)[2][..., -1, :]  # (..., N, 4)
    return X[..., :3] / (X[..., 3:4] + 1e-12 * torch.sign(X[..., 3:4] + 1e-30))


def decompose_essential(E: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """E -> the 4 candidate poses: (Rs ``(4, 3, 3)``, ts ``(4, 3)``)."""
    u, _, vt = svd(E)
    # keep rotations proper
    u = u * torch.sign(det3(u))[..., None, None]
    vt = vt * torch.sign(det3(vt))[..., None, None]
    W = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=E.dtype, device=E.device)
    Ra = u @ W @ vt
    Rb = u @ W.T @ vt
    t = u[:, 2]
    return torch.stack([Ra, Ra, Rb, Rb]), torch.stack([t, -t, t, -t])


def _chirality_counts(Rs, ts, p1, p2, mask) -> torch.Tensor:
    """Inlier-masked count of points in front of both cameras for each
    of the candidate poses ``Rs (P, 3, 3)``, ``ts (P, 3)``."""
    eye = torch.eye(3, dtype=p1.dtype, device=p1.device)
    X = triangulate(eye, torch.zeros(3, dtype=p1.dtype, device=p1.device), Rs, ts, p1, p2)
    z1 = X[..., 2]
    z2 = (X @ Rs.transpose(-1, -2) + ts[:, None, :])[..., 2]
    return torch.sum((z1 > 0) & (z2 > 0) & mask, dim=-1)


def _rodrigues(w: torch.Tensor) -> torch.Tensor:
    """so(3) exponential map (stable near 0)."""
    th = torch.sqrt(torch.sum(w * w) + 1e-24)
    Kx = skew(w / th)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + torch.sin(th) * Kx + (1.0 - torch.cos(th)) * (Kx @ Kx)


def _generators(R: torch.Tensor) -> torch.Tensor:
    """``(3, 3, 3)``: the derivatives [e_k]_x R of ``_rodrigues(delta) @ R``
    at delta = 0, k = 0..2."""
    return skew(torch.eye(3, dtype=R.dtype, device=R.device)) @ R


def refine_pose_gn(R0, t0, p1, p2, weights, iters: int = 5,
                   robust_scale: Optional[float] = None):
    """IRLS Gauss-Newton refinement of (R, t) on the 5-dof essential
    manifold, minimising the weighted signed Sampson residual; t moves
    in the tangent basis of t0 on the unit sphere. ``robust_scale``:
    Cauchy reweighting ``1 / (1 + (r / scale)^2)`` on top of ``weights``
    each iteration. The Jacobian at delta = 0 is written out (JAX takes
    it by ``jacfwd``): rotation columns [t]_x [e_k]_x R, translation
    columns [P b_j]_x R with P the unit sphere's tangent projection."""
    ones = torch.ones(p1.shape[:-1] + (1,), dtype=p1.dtype, device=p1.device)
    h1 = torch.cat([p1, ones], dim=-1)
    h2 = torch.cat([p2, ones], dim=-1)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=t0.dtype, device=t0.device)
    a = torch.where(torch.abs(t0[0]) < 0.9, ex, ex.roll(1))
    b1 = torch.linalg.cross(t0, a)
    b1 = b1 / torch.linalg.norm(b1)
    b2 = torch.linalg.cross(t0, b1)
    basis = torch.stack([b1, b2])  # (2, 3)

    def unit(v):
        n = torch.sqrt(torch.sum(v * v) + 1e-24)
        return v / n, n

    R, t = R0, t0
    eye = 1e-9 * torch.eye(5, dtype=p1.dtype, device=p1.device)
    for _ in range(iters):
        tn, n = unit(t)
        E = skew(tn) @ R
        dt = (basis - (basis @ tn)[:, None] * tn) / n  # (2, 3)
        dE = torch.cat([skew(tn) @ _generators(R), skew(dt) @ R])  # (5, 3, 3)
        l2, l1 = h1 @ E.T, h2 @ E
        dd = torch.sum(l2 * h2, dim=1)
        den = l1[:, 0] ** 2 + l1[:, 1] ** 2 + l2[:, 0] ** 2 + l2[:, 1] ** 2 + 1e-18
        sq = torch.sqrt(den)
        r = dd / sq
        dl2, dl1 = h1 @ dE.transpose(-1, -2), h2 @ dE  # (5, N, 3)
        ddd = torch.sum(dl2 * h2, dim=-1)
        dden = 2.0 * (l1[:, 0] * dl1[..., 0] + l1[:, 1] * dl1[..., 1]
                      + l2[:, 0] * dl2[..., 0] + l2[:, 1] * dl2[..., 1])
        J = (ddd / sq - dd / (2.0 * den * sq) * dden).T  # (N, 5)
        w = weights
        if robust_scale is not None:
            w = w / (1.0 + (r / robust_scale) ** 2)
        Jw = J * w[:, None]
        delta = -solve(Jw.T @ J + eye, Jw.T @ r)
        t = t + delta[3] * b1 + delta[4] * b2
        R, t = _rodrigues(delta[:3]) @ R, t / torch.sqrt(torch.sum(t * t) + 1e-24)
    return R, t


class TwoViewResult(NamedTuple):
    E: torch.Tensor  # (3, 3)
    R: torch.Tensor  # (3, 3) cam1 -> cam2
    t: torch.Tensor  # (3,) unit translation
    inliers: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # () int64


def draw_sample_ids(generator: Optional[torch.Generator], valid: torch.Tensor,
                    n_samples: int, k: int) -> torch.Tensor:
    """``(n_samples, k)`` minimal-sample row ids, each sample ``k``
    distinct valid rows drawn uniformly (JAX's sort trick: the first k
    of an argsort of uniforms, invalid rows keyed 2). ``generator`` lives
    on ``valid``'s device."""
    u = torch.rand((n_samples, valid.shape[0]), generator=generator, device=valid.device)
    return torch.argsort(torch.where(valid, u, 2.0), dim=1, stable=True)[:, :k]


def _valid_rows(p1: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    if valid is None:
        return torch.ones(p1.shape[0], dtype=torch.bool, device=p1.device)
    return valid


def ransac_essential(
    generator: Optional[torch.Generator],
    p1: torch.Tensor,
    p2: torch.Tensor,
    n_hyps: int = 512,
    thres: float = 1e-3,
    valid: Optional[torch.Tensor] = None,
    ids: Optional[torch.Tensor] = None,
) -> TwoViewResult:
    """Fixed-shape essential-matrix RANSAC (8-point minimal sets) + pose
    recovery.

    p1, p2: ``(N, 2)`` NORMALIZED correspondences; ``thres``: squared
    Sampson threshold in normalized coords (~ (px_thres / focal)^2);
    ``valid``: optional ``(N,)`` mask of usable rows; ``ids``: ``(H, 8)``
    sample ids in place of ``n_hyps`` draws from ``generator``. Returns
    the chirality-disambiguated pose of the weighted 8-point refit on the
    best hypothesis' inliers."""
    valid = _valid_rows(p1, valid)
    w = valid.to(p1.dtype)
    if ids is None:
        ids = draw_sample_ids(generator, valid, n_hyps, 8)
    Es = eight_point(p1[ids], p2[ids])  # (H, 3, 3)
    inl = (sampson_epipolar(p1, p2, Es) < thres) & valid
    best = torch.argmax(torch.sum(inl, dim=1))

    # refit on the best hypothesis' inliers (weighted 8-point)
    E = eight_point(p1, p2, w=inl[best].to(p1.dtype) * w)
    inliers = (sampson_epipolar(p1, p2, E) < thres) & valid

    Rs, ts = decompose_essential(E)
    pick = torch.argmax(_chirality_counts(Rs, ts, p1, p2, inliers))
    return TwoViewResult(E=E, R=Rs[pick], t=ts[pick], inliers=inliers,
                         num_inliers=torch.sum(inliers))


def estimate_relative_pose(
    generator: Optional[torch.Generator],
    matches: torch.Tensor,
    K1: torch.Tensor,
    K2: torch.Tensor,
    px_thres: float = 1.0,
    n_hyps: int = 512,
    valid: Optional[torch.Tensor] = None,
) -> TwoViewResult:
    """Pixel-space front end for :func:`ransac_essential`: matches ``(N,
    4)`` pixel coords; the threshold goes to normalized units with the
    mean focal length."""
    p1 = normalize_points(matches[:, 0:2], K1)
    p2 = normalize_points(matches[:, 2:4], K2)
    f = float(K1[0, 0] + K1[1, 1] + K2[0, 0] + K2[1, 1]) / 4.0
    return ransac_essential(generator, p1, p2, n_hyps, (px_thres / f) ** 2, valid)
