"""PnP (camera registration) with a fixed-shape RANSAC.

Port of ``patch2pix_tpu.sfm.pnp``: minimal sets of 6 solved by DLT as
one batch of small SVDs, MSAC scoring at a 16x-widened gate, then an
IRLS Gauss-Newton polish of the winner; on the device of the inputs.
Sample ids as in :mod:`.twoview` (``ids=`` feeds them).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from patch2pix_tpu_torch.sfm.twoview import (
    _generators,
    _rodrigues,
    _valid_rows,
    det3,
    draw_sample_ids,
    right_vectors,
    solve,
    svd,
)


def dlt_pnp(X: torch.Tensor, p: torch.Tensor, w: Optional[torch.Tensor] = None):
    """Direct linear transform PnP from >= 6 points, batched over leading
    axes: X ``(..., N, 3)`` world points, p ``(..., N, 2)`` NORMALIZED
    observations, w optional ``(..., N)`` row weights. Returns (R ``(...,
    3, 3)``, t ``(..., 3)``), cam coords = R X + t: the projective scale
    (with its sign) is the signed cube root of det(M), M is projected to
    the nearest rotation."""
    ones = torch.ones(X.shape[:-1] + (1,), dtype=X.dtype, device=X.device)
    Xh = torch.cat([X, ones], dim=-1)
    z = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, z, -p[..., 0:1] * Xh], dim=-1)
    r2 = torch.cat([z, Xh, -p[..., 1:2] * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (..., 2N, 12)
    if w is not None:
        A = A * torch.cat([w, w], dim=-1)[..., None]
    P = right_vectors(A)[..., -1, :].reshape(A.shape[:-2] + (3, 4))
    M = P[..., :3]
    det = det3(M)
    sigma = torch.sign(det) * torch.abs(det) ** (1.0 / 3.0)
    sigma = torch.where(torch.abs(sigma) < 1e-12, 1e-12, sigma)
    M = M / sigma[..., None, None]
    t = P[..., 3] / sigma[..., None]
    u, _, vt = svd(M)
    d = det3(u @ vt)
    R = u @ torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)) @ vt
    return R, t


def reprojection_error_sq(X: torch.Tensor, p: torch.Tensor, R: torch.Tensor,
                          t: torch.Tensor) -> torch.Tensor:
    """Squared reprojection error in normalized coords, batched over the
    poses' leading axes (``(..., N)``); points behind the camera get
    +inf."""
    pc = X @ R.transpose(-1, -2) + t[..., None, :]
    z = pc[..., 2]
    proj = pc[..., :2] / (z[..., None] + 1e-12 * torch.sign(z[..., None] + 1e-30))
    err = torch.sum((proj - p) ** 2, dim=-1)
    return torch.where(z > 0, err, float("inf"))


class PnPResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    num_inliers: torch.Tensor


def refine_pose_pnp(R0, t0, X, p, weights, iters: int = 8,
                    robust_scale: Optional[float] = None):
    """IRLS Gauss-Newton refinement of an SE(3) pose on the reprojection
    residuals (a minimal DLT hypothesis carries multi-pixel algebraic
    error; a few steps reach the data's noise floor). The Jacobian at
    delta = 0 is written out (JAX takes it by ``jacfwd``): the camera
    point moves by ([e_k]_x R) X for the rotation and e_j for the
    translation; the depth's clamp at 1e-6 passes no derivative."""
    R, t = R0, t0
    eye = 1e-9 * torch.eye(6, dtype=X.dtype, device=X.device)
    w0 = torch.repeat_interleave(weights, 2)
    dt = torch.eye(3, dtype=X.dtype, device=X.device)[:, None, :].expand(3, X.shape[0], 3)
    for _ in range(iters):
        pc = X @ R.T + t
        z = torch.clamp(pc[:, 2], min=1e-6)
        r = (pc[:, :2] / z[:, None] - p).reshape(-1)  # (2N,)
        dpc = torch.cat([X @ _generators(R).transpose(-1, -2), dt])  # (6, N, 3)
        dz = torch.where(pc[:, 2] > 1e-6, dpc[..., 2], 0.0)
        J = (dpc[..., :2] / z[:, None] - pc[:, :2] * (dz / z ** 2)[..., None])
        J = J.reshape(6, -1).T  # (2N, 6)
        w = w0
        if robust_scale is not None:
            w = w / (1.0 + (r / robust_scale) ** 2)
        Jw = J * w[:, None]
        delta = -solve(Jw.T @ J + eye, Jw.T @ r)
        R, t = _rodrigues(delta[:3]) @ R, t + delta[3:]
    return R, t


def ransac_pnp(
    generator: Optional[torch.Generator],
    X: torch.Tensor,
    p: torch.Tensor,
    n_hyps: int = 256,
    thres: float = 1e-4,
    valid: Optional[torch.Tensor] = None,
    ids: Optional[torch.Tensor] = None,
) -> PnPResult:
    """Fixed-shape PnP RANSAC: X ``(N, 3)`` world points, p ``(N, 2)``
    normalized observations, ``thres`` the squared normalized
    reprojection threshold, ``ids (H, 6)`` in place of ``n_hyps`` draws.
    Hypotheses are scored by the truncated cost at ``16 * thres``; the
    winner is IRLS-GN refined and its inliers gated at ``thres``."""
    valid = _valid_rows(X, valid)
    if ids is None:
        ids = draw_sample_ids(generator, valid, n_hyps, 6)
    Rs, ts = dlt_pnp(X[ids], p[ids])
    errs = reprojection_error_sq(X, p, Rs, ts)  # (H, N)
    cap = 16.0 * thres
    msac = torch.sum(torch.where(valid, torch.clamp(errs, max=cap), 0.0), dim=1)
    best = torch.argmin(msac)

    # coarse-gate inlier weights -> GN polish -> final gate at thres
    w0 = ((errs[best] < cap) & valid).to(X.dtype)
    R, t = refine_pose_pnp(Rs[best], ts[best], X, p, w0, robust_scale=thres ** 0.5)
    inliers = (reprojection_error_sq(X, p, R, t) < thres) & valid
    return PnPResult(R=R, t=t, inliers=inliers, num_inliers=torch.sum(inliers))
