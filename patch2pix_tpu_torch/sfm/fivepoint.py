"""Nister's 5-point essential-matrix solver and its RANSAC, batched.

Port of ``patch2pix_tpu.sfm.fivepoint``, the same algorithm on a
leading sample axis:

  * the 10 cubic constraints (det(E) = 0 and the nine entries of
    ``2 E E^T E - tr(E E^T) E``) are evaluated at 32 fixed nodes and
    interpolated onto the 20-monomial basis with a float64
    pseudo-inverse of the node Vandermonde, built once with numpy;
  * one batched 10x10 solve eliminates to Nister's 3x3 B(z);
  * the real roots of det B(z) (degree 10) are found on a 256-point
    grid of the homogeneous form p(sin, cos) and 40 bisection steps per
    sign change, up to 10 root slots with a validity mask;
  * each root is polished by 3 Gauss-Newton steps on the exact
    constraints (analytic Jacobian).

The slots take the sign-change intervals in grid order (a stable
descending sort of the change mask, ``lax.top_k``'s tie order), so the
winner among equal inlier counts is JAX's. The minimal solve runs in
the inputs' dtype (float32 as in JAX); RANSAC re-fits the winner's
inliers with the weighted 8-point of :mod:`.twoview`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from patch2pix_tpu_torch.ops.geometry import skew
from patch2pix_tpu_torch.sfm.twoview import (
    TwoViewResult,
    _chirality_counts,
    _valid_rows,
    decompose_essential,
    det3,
    draw_sample_ids,
    eight_point,
    normalize_points,
    refine_pose_gn,
    right_vectors,
    sampson_epipolar,
    solve,
)

# Nister's 20-monomial basis, 10 leading + 10 trailing; the trailing
# block factors as x*[z^2,z,1], y*[z^2,z,1], [z^3,z^2,z,1], which makes
# the B(z) elimination possible.
_MONOMIALS: Tuple[Tuple[int, int, int], ...] = (
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
)
_N_NODES = 32
_GRID = 256
_BISECT = 40


def _interp_constants():
    """(nodes (32, 3), pinv of the node Vandermonde (20, 32)), computed in
    float64 and stored as float32: JAX's nodes (RandomState(1234))."""
    rs = np.random.RandomState(1234)
    nodes = rs.uniform(-1.0, 1.0, (_N_NODES, 3))
    V = np.empty((_N_NODES, len(_MONOMIALS)))
    for c, (i, j, k) in enumerate(_MONOMIALS):
        V[:, c] = nodes[:, 0] ** i * nodes[:, 1] ** j * nodes[:, 2] ** k
    return nodes.astype(np.float32), np.linalg.pinv(V).astype(np.float32)


_NODES, _VPINV = _interp_constants()
_THETAS = np.linspace(-np.pi / 2 * (1 - 1e-4), np.pi / 2 * (1 - 1e-4), _GRID).astype(np.float32)


def _cubic_constraints(E: torch.Tensor) -> torch.Tensor:
    """The 10 cubic constraints of ``(..., 3, 3)`` E -> ``(..., 10)``."""
    EEt = E @ E.transpose(-1, -2)
    trace = torch.diagonal(EEt, dim1=-2, dim2=-1).sum(-1)
    singular = 2.0 * EEt @ E - trace[..., None, None] * E
    return torch.cat([det3(E)[..., None], singular.flatten(-2)], dim=-1)


def _combine(xyz: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """E = x X + y Y + z Z + W for ``xyz (..., 3)`` over ``basis (..., 4,
    3, 3)``."""
    return (xyz[..., 0, None, None] * basis[..., 0, :, :]
            + xyz[..., 1, None, None] * basis[..., 1, :, :]
            + xyz[..., 2, None, None] * basis[..., 2, :, :] + basis[..., 3, :, :])


def _nullspace4(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """4-dim null-space basis ``(S, 4, 3, 3)`` of the 5x9 epipolar
    constraint matrices of ``(S, 5, 2)`` correspondences."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    ones = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], dim=-1)
    return right_vectors(A)[:, 5:].reshape(-1, 4, 3, 3)


def _poly_matrix(coeffs: torch.Tensor) -> torch.Tensor:
    """``(S, 10, 20)`` constraint coefficients -> Nister's B(z), ``(S, 3,
    3, 5)``: the three eliminated equations over (x, y, 1), polynomial
    coefficients in z highest degree first."""
    B = solve(coeffs[:, :, :10], coeffs[:, :, 10:])  # (S, 10, 10)

    def shift_sub(top, bot):  # top - z * bot, highest degree first
        return F.pad(top, (1, 0)) - F.pad(bot, (0, 1))

    def pair(rz, r):
        # rows by leading monomial: 4 x^2 z, 5 x^2, 6 y^2 z, 7 y^2, 8 xyz, 9 xy
        a = shift_sub(B[:, rz, 0:3], B[:, r, 0:3])  # (S, 4)
        b = shift_sub(B[:, rz, 3:6], B[:, r, 3:6])
        c = shift_sub(B[:, rz, 6:10], B[:, r, 6:10])  # (S, 5)
        return torch.stack([F.pad(a, (1, 0)), F.pad(b, (1, 0)), c], dim=1)  # (S, 3, 5)

    return torch.stack([pair(4, 5), pair(6, 7), pair(8, 9)], dim=1)


def _polymul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full polynomial products of ``(..., m)`` and ``(..., n)``
    coefficient rows -> ``(..., m + n - 1)``."""
    m, n = a.shape[-1], b.shape[-1]
    k = (torch.arange(m, device=a.device)[:, None]
         + torch.arange(n, device=a.device)[None, :]).reshape(-1)
    onehot = (k[:, None] == torch.arange(m + n - 1, device=a.device)).to(a.dtype)
    return (a[..., :, None] * b[..., None, :]).flatten(-2) @ onehot


def _det_poly(Bz: torch.Tensor) -> torch.Tensor:
    """Degree-10 determinant polynomial ``(S, 11)`` of ``(S, 3, 3, 5)``
    B(z)."""
    def m2(r0, r1, c0, c1):  # 2x2 minor, degree 8
        return (_polymul(Bz[:, r0, c0], Bz[:, r1, c1])
                - _polymul(Bz[:, r0, c1], Bz[:, r1, c0]))

    d = (_polymul(Bz[:, 0, 0], m2(1, 2, 1, 2))
         - _polymul(Bz[:, 0, 1], m2(1, 2, 0, 2))
         + _polymul(Bz[:, 0, 2], m2(1, 2, 0, 1)))  # (S, 13), leading two structurally 0
    return d[:, 2:]


def _eval_homogeneous(coeffs: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """p(tan t) cos^10 t = sum a_k sin^(10-k) cos^k, bounded for every t:
    ``coeffs (S, 11)`` highest first, ``theta`` ``(G,)`` or ``(S, G)`` ->
    ``(S, G)``."""
    k = torch.arange(11.0, dtype=coeffs.dtype, device=coeffs.device)
    s, c = torch.sin(theta)[..., None], torch.cos(theta)[..., None]
    return torch.sum(coeffs[:, None, :] * s ** (10.0 - k) * c ** k, dim=-1)


def _real_roots10(coeffs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """All real roots of degree-10 polynomials ``(S, 11)`` by grid +
    bisection: (roots ``(S, 10)``, valid ``(S, 10)``)."""
    thetas = torch.as_tensor(_THETAS, device=coeffs.device).to(coeffs.dtype)
    v = _eval_homogeneous(coeffs, thetas)  # (S, G)
    change = (v[:, :-1] * v[:, 1:] < 0.0).to(coeffs.dtype)
    # the first 10 changes in grid order; slots past the last change are invalid
    vals, idx = torch.sort(change, dim=1, descending=True, stable=True)
    valid = vals[:, :10] > 0.5
    idx = idx[:, :10]
    lo, hi = thetas[idx], thetas[idx + 1]
    flo = _eval_homogeneous(coeffs, lo)
    for _ in range(_BISECT):
        mid = 0.5 * (lo + hi)
        fmid = _eval_homogeneous(coeffs, mid)
        go_left = flo * fmid < 0.0
        lo, hi, flo = (torch.where(go_left, lo, mid), torch.where(go_left, mid, hi),
                       torch.where(go_left, flo, fmid))
    return torch.tan(0.5 * (lo + hi)), valid


def _polish_xyz(xyz: torch.Tensor, basis: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Damped Gauss-Newton on the exact constraints: ``xyz (S, 10, 3)``
    over ``basis (S, 4, 3, 3)``. The float32 polynomial roots carry ~1e-3
    relative error; 3 steps restore them to machine precision. The
    Jacobian's column along a basis matrix D is the constraints'
    derivative ``[tr(cof(E)^T D), 2 (D E^T E + E D^T E + E E^T D) -
    2 tr(D E^T) E - tr(E E^T) D]``."""
    basis = basis[:, None]  # (S, 1, 4, 3, 3)
    eye = 1e-8 * torch.eye(3, dtype=xyz.dtype, device=xyz.device)
    for _ in range(iters):
        E = _combine(xyz, basis)  # (S, 10, 3, 3)
        r = _cubic_constraints(E)  # (S, 10, 10)
        cof = torch.stack([torch.linalg.cross(E[..., 1, :], E[..., 2, :]),
                           torch.linalg.cross(E[..., 2, :], E[..., 0, :]),
                           torch.linalg.cross(E[..., 0, :], E[..., 1, :])], dim=-2)
        Et = E.transpose(-1, -2)
        EtE, EEt = Et @ E, E @ Et
        trace = torch.diagonal(EEt, dim1=-2, dim2=-1).sum(-1)[..., None, None]
        cols = []
        for i in range(3):
            D = basis[:, :, i]  # (S, 1, 3, 3)
            ddet = torch.sum(cof * D, dim=(-2, -1))
            dsing = (2.0 * (D @ EtE + E @ D.transpose(-1, -2) @ E + EEt @ D)
                     - 2.0 * torch.sum(D * E, dim=(-2, -1))[..., None, None] * E - trace * D)
            cols.append(torch.cat([ddet[..., None], dsing.flatten(-2)], dim=-1))
        J = torch.stack(cols, dim=-1)  # (S, 10, 10, 3)
        Jt = J.transpose(-1, -2)
        xyz = xyz - solve(Jt @ J + eye, Jt @ r[..., None])[..., 0]
    return xyz


def five_point(p1: torch.Tensor, p2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nister 5-point: up to 10 essential matrices for 5 normalized
    correspondences ``(..., 5, 2)``. Returns (Es ``(..., 10, 3, 3)``, each
    of unit Frobenius norm, valid ``(..., 10)``); invalid slots hold the
    identity."""
    lead = p1.shape[:-2]
    p1, p2 = p1.reshape(-1, 5, 2), p2.reshape(-1, 5, 2)
    basis = _nullspace4(p1, p2)  # (S, 4, 3, 3)
    nodes = torch.as_tensor(_NODES, device=p1.device).to(p1.dtype)
    vpinv = torch.as_tensor(_VPINV, device=p1.device).to(p1.dtype)
    vals = _cubic_constraints(_combine(nodes, basis[:, None]))  # (S, 32, 10)
    coeffs = vals.transpose(1, 2) @ vpinv.T  # (S, 10, 20)
    Bz = _poly_matrix(coeffs)
    zs, valid = _real_roots10(_det_poly(Bz))  # (S, 10)

    pows = torch.stack([zs ** 4, zs ** 3, zs ** 2, zs, torch.ones_like(zs)], dim=-1)
    Bn = torch.einsum("srcd,skd->skrc", Bz, pows)  # (S, 10, 3, 3) numeric B(z)
    # null vector (x, y, 1) of each B(z): the best-scaled cross product of two rows
    cand = torch.stack([torch.linalg.cross(Bn[..., 0, :], Bn[..., 1, :]),
                        torch.linalg.cross(Bn[..., 0, :], Bn[..., 2, :]),
                        torch.linalg.cross(Bn[..., 1, :], Bn[..., 2, :])], dim=-2)
    pick = torch.argmax(torch.abs(cand[..., 2]), dim=-1)  # (S, 10)
    v = torch.take_along_dim(cand, pick[..., None, None], dim=-2)[..., 0, :]
    denom = v[..., 2]
    ok = torch.abs(denom) > 1e-12
    valid = valid & ok
    safe = torch.where(ok, denom, 1.0)
    xyz = torch.stack([v[..., 0] / safe, v[..., 1] / safe, zs], dim=-1)
    xyz = _polish_xyz(xyz, basis)

    Es = _combine(xyz, basis[:, None])
    norm = torch.linalg.norm(Es.flatten(-2), dim=-1)
    Es = Es / torch.clamp(norm, min=1e-12)[..., None, None]
    eye = torch.eye(3, dtype=Es.dtype, device=Es.device)
    Es = torch.where(valid[..., None, None], Es, eye)
    return Es.reshape(lead + (10, 3, 3)), valid.reshape(lead + (10,))


def ransac_essential_5pt(
    generator: Optional[torch.Generator],
    p1: torch.Tensor,
    p2: torch.Tensor,
    n_samples: int = 256,
    thres: float = 1e-3,
    valid: Optional[torch.Tensor] = None,
    ids: Optional[torch.Tensor] = None,
) -> TwoViewResult:
    """Fixed-shape 5-point RANSAC + pose recovery. Scores all ``n_samples
    x 10`` candidate essential matrices of ``n_samples`` 5-point samples
    (``ids (S, 5)`` in their place when given); the winner's inliers are
    re-fit three times with the weighted 8-point, the better of raw and
    refit kept by inlier count; the chirality-picked pose is polished by
    two rounds of robust Gauss-Newton and inlier re-selection."""
    valid = _valid_rows(p1, valid)
    w = valid.to(p1.dtype)
    if ids is None:
        ids = draw_sample_ids(generator, valid, n_samples, 5)
    Es, ev = five_point(p1[ids], p2[ids])
    Es, ev = Es.reshape(-1, 3, 3), ev.reshape(-1)

    inl = (sampson_epipolar(p1, p2, Es) < thres) & valid  # (S*10, N)
    scores = torch.where(ev, torch.sum(inl, dim=1), -1)
    best = torch.argmax(scores)

    # iterated refit on the inlier set, re-selecting inliers each round
    inl_fit = inl[best]
    for _ in range(3):
        E_fit = eight_point(p1, p2, w=inl_fit.to(p1.dtype) * w)
        inl_fit = (sampson_epipolar(p1, p2, E_fit) < thres) & valid
    use_fit = torch.sum(inl_fit) >= scores[best]
    E = torch.where(use_fit, E_fit, Es[best])
    inliers = torch.where(use_fit, inl_fit, inl[best])

    Rs, ts = decompose_essential(E)
    pick = torch.argmax(_chirality_counts(Rs, ts, p1, p2, inliers))

    # two rounds of (IRLS Gauss-Newton on the signed Sampson residual ->
    # inlier re-selection)
    R_fin, t_fin = Rs[pick], ts[pick]
    for _ in range(2):
        R_fin, t_fin = refine_pose_gn(R_fin, t_fin, p1, p2, inliers.to(p1.dtype) * w,
                                      robust_scale=0.5 * thres ** 0.5)
        inliers = (sampson_epipolar(p1, p2, skew(t_fin) @ R_fin) < thres) & valid
    return TwoViewResult(E=skew(t_fin) @ R_fin, R=R_fin, t=t_fin, inliers=inliers,
                         num_inliers=torch.sum(inliers))


def estimate_relative_pose_5pt(
    generator: Optional[torch.Generator],
    matches: torch.Tensor,
    K1: torch.Tensor,
    K2: torch.Tensor,
    px_thres: float = 0.5,
    n_samples: int = 256,
    valid: Optional[torch.Tensor] = None,
) -> TwoViewResult:
    """Pixel-space front end (the threshold in normalized units with the
    mean focal length, as in the reference's ``matches2relapose_cv``)."""
    p1 = normalize_points(matches[:, 0:2], K1)
    p2 = normalize_points(matches[:, 2:4], K2)
    f = float(K1[0, 0] + K1[1, 1] + K2[0, 0] + K2[1, 1]) / 4.0
    return ransac_essential_5pt(generator, p1, p2, n_samples, (px_thres / f) ** 2, valid)
