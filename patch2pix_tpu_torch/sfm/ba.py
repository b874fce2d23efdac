"""Schur-complement bundle adjustment, float32 on one device.

Port of ``patch2pix_tpu.sfm.ba`` (the multi-device wrapper lives in
:mod:`patch2pix_tpu_torch.sfm.dist_ba`):

  * cameras are (R (3,3), t (3,)) with LOCAL updates
    ``y = exp(dw) y0 + dt`` — analytic 2x6 / 2x3 Jacobians;
  * the Hessian blocks are segment sums over the flat observation
    array (``index_put_`` with ``accumulate=True`` into zeros of the
    segment count): U_c (6x6 per camera), V_j (3x3 per point), W_i (6x3
    per observation);
  * the Schur cross term ``W V^-1 W^T`` is one dense product: with
    ``A_i = W_i L_j`` (L_j = chol(V_j^-1)) scattered into a block matrix
    ``Bt in R^{3P x 6C}``, the whole pairwise sum is ``Bt^T Bt``, a
    float32 ``torch.matmul`` (TF32 must be off for it to be the
    function the CPU computes);
  * Huber reweighting; Levenberg-Marquardt damping driven by a host loop
    (one read of the new cost per iteration) around :func:`ba_step`.

Where ``jnp.linalg`` gives NaN (an inverse or Cholesky factor of a
non-positive-definite block, a singular reduced system), ``torch.linalg``
would raise, and on CUDA would synchronise with the host to check: the
``*_ex`` forms are used and NaN is written where their ``info`` is not 0.
Nothing in :func:`ba_step` synchronises. The segment sums are
``index_put_(accumulate=True)``, which on CUDA sorts the indices and adds
each segment's rows in order: unlike ``index_add_``'s atomics, a run
repeats bit for bit, so an incremental reconstruction on the card does
not change from run to run.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from patch2pix_tpu_torch.config import resolve_device
from patch2pix_tpu_torch.sfm.twoview import solve


class BAProblem(NamedTuple):
    """A fixed-shape bundle-adjustment problem, tensors on one device.

    Rs: (C, 3, 3), ts: (C, 3) — world->cam poses.
    X: (P, 3) points. cam_idx/pt_idx: (M,) int64 observation incidence.
    uv: (M, 2) normalized observations. obs_w: (M,) observation
    weights (0 masks padding). fixed_cams: (C,) bool — cameras
    excluded from updates (gauge).
    """

    Rs: torch.Tensor
    ts: torch.Tensor
    X: torch.Tensor
    cam_idx: torch.Tensor
    pt_idx: torch.Tensor
    uv: torch.Tensor
    obs_w: torch.Tensor
    fixed_cams: torch.Tensor


def bucket_dim(n: int, base: int = 8) -> int:
    """Shape bucket: the next value in {base*2^k, 1.5*base*2^k}.

    JAX pads to these so that a growing reconstruction reuses compiled
    programs; the port keeps the padding (and its exact semantics) so
    that the same calls build the same problems."""
    b = base
    while b < n:
        if (b * 3) // 2 >= n:
            return (b * 3) // 2
        b *= 2
    return b


def build_problem(
    Rs: np.ndarray,
    ts: np.ndarray,
    X: np.ndarray,
    cam_idx: np.ndarray,
    pt_idx: np.ndarray,
    uv: np.ndarray,
    fixed_cams: Optional[np.ndarray] = None,
    bucket: bool = False,
    device=None,
) -> BAProblem:
    """Host-side setup (sorts observations by point for locality); the
    problem's tensors go to ``device`` (CUDA unless given).

    ``bucket=True`` pads (C, P, M) to :func:`bucket_dim` buckets:
      * pad cameras are identity poses marked ``fixed_cams`` (the
        gauge path already solves them to a zero update),
      * pad points carry no observations (their damped V solves to a
        zero update),
      * pad observations have ``obs_w = 0`` and reference the last pad
        camera/point, so every Hessian/Schur contribution vanishes.
    """
    dev = resolve_device(device)
    order = np.argsort(pt_idx, kind="stable")
    C = Rs.shape[0]
    P = X.shape[0]
    M = len(order)
    if fixed_cams is None:
        fixed = np.zeros(C, bool)
        fixed[0] = True  # gauge: hold the first camera
    else:
        fixed = np.asarray(fixed_cams, bool)
    cam_s = np.asarray(cam_idx)[order]
    pt_s = np.asarray(pt_idx)[order]
    uv_s = np.asarray(uv)[order]
    obs_w = np.ones(M, np.float32)
    if bucket:
        Cb, Pb, Mb = bucket_dim(C), bucket_dim(P, 64), bucket_dim(M, 256)
        Rs = np.concatenate([Rs, np.broadcast_to(np.eye(3), (Cb - C, 3, 3))])
        ts = np.concatenate([ts, np.zeros((Cb - C, 3))])
        fixed = np.concatenate([fixed, np.ones(Cb - C, bool)])
        X = np.concatenate([X, np.zeros((Pb - P, 3))])
        cam_s = np.concatenate([cam_s, np.full(Mb - M, Cb - 1, cam_s.dtype)])
        pt_s = np.concatenate([pt_s, np.full(Mb - M, Pb - 1, pt_s.dtype)])
        uv_s = np.concatenate([uv_s, np.zeros((Mb - M, 2), uv_s.dtype)])
        obs_w = np.concatenate([obs_w, np.zeros(Mb - M, np.float32)])
    return problem_on(dev, Rs, ts, X, cam_s, pt_s, uv_s, obs_w, fixed)


def problem_on(device, Rs, ts, X, cam_idx, pt_idx, uv, obs_w, fixed_cams) -> BAProblem:
    """Host arrays as a :class:`BAProblem` on ``device``: float32 values,
    int64 indices, bool gauge mask."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def i64(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return BAProblem(Rs=f32(Rs), ts=f32(ts), X=f32(X), cam_idx=i64(cam_idx),
                     pt_idx=i64(pt_idx), uv=f32(uv), obs_w=f32(obs_w),
                     fixed_cams=torch.as_tensor(np.asarray(fixed_cams, bool), device=device))


def skew_many(v: torch.Tensor) -> torch.Tensor:
    """(…, 3) -> (…, 3, 3) skew-symmetric matrices."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (…, 3) axis-angle -> (…, 3, 3) rotation."""
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)
    k = w / torch.clamp(theta, min=1e-12)
    K = skew_many(k)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    s = torch.sin(theta)[..., None]
    c = torch.cos(theta)[..., None]
    R = eye + s * K + (1.0 - c) * (K @ K)
    return torch.where(theta[..., None] < 1e-9, eye, R)


def residuals_and_jacobians(p: BAProblem):
    """Per-observation residuals + analytic Jacobians.

    Returns (r (M, 2), Jc (M, 2, 6), Jp (M, 2, 3), w (M,)).
    """
    R = p.Rs[p.cam_idx]  # (M, 3, 3)
    y = torch.einsum("mij,mj->mi", R, p.X[p.pt_idx]) + p.ts[p.cam_idx]  # cam coords
    z = y[:, 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    r = y[:, :2] / zs[:, None] - p.uv  # (M, 2)

    inv_z = 1.0 / zs
    zero = torch.zeros_like(inv_z)
    dpdy = torch.stack([
        torch.stack([inv_z, zero, -y[:, 0] * inv_z ** 2], -1),
        torch.stack([zero, inv_z, -y[:, 1] * inv_z ** 2], -1),
    ], -2)  # (M, 2, 3)
    # dy/d(dw) = -[y]_x ; dy/d(dt) = I
    Jc = torch.cat([-(dpdy @ skew_many(y)), dpdy], dim=-1)  # (M, 2, 6)
    Jp = dpdy @ R  # (M, 2, 3)
    return r, Jc, Jp, p.obs_w


def huber_weights(r: torch.Tensor, delta) -> torch.Tensor:
    """IRLS weights for the Huber loss on the residual 2-norm."""
    nrm = torch.linalg.norm(r, dim=-1)
    return torch.where(nrm <= delta, 1.0, delta / torch.clamp(nrm, min=1e-12))


def cost(p: BAProblem, huber_delta=None) -> torch.Tensor:
    """Total (robust) cost = sum of rho(||r||^2) over observations."""
    r, _, _, w = residuals_and_jacobians(p)
    sq = torch.sum(r ** 2, dim=-1)
    if huber_delta is None:
        rho = sq
    else:
        d = huber_delta
        rho = torch.where(sq <= d * d, sq, 2 * d * torch.sqrt(sq) - d * d)
    return torch.sum(w * rho)


def segment_sum(values: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: rows of ``values`` summed into ``n``
    segments by ``ids``, in the same order on every run."""
    return values.new_zeros((n,) + values.shape[1:]).index_put_(
        (ids,), values, accumulate=True)


def _nan_where_failed(x: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    return torch.where((info == 0)[:, None, None], x, float("nan"))


def schur_blocks(p: BAProblem, lm_lambda, huber_delta, use_huber: bool, C: int):
    """Common Hessian/Schur assembly for the local and distributed
    solvers.

    Returns (S_cross_neg (C,C,6,6) — the cross term, negated, WITHOUT
    the U diagonal; U (C,6,6); b_red (C,6); W (M,6,3); Vinv (P,3,3);
    bp (P,3)).

    The cross term uses the dense-B trick: A_i = W_i chol(Vinv_j)
    accumulated into Bt (P, 3, C, 6) — flattened to (P*3*C, 6) rows, so
    that repeated (point, camera) pairs add up — and S_cross = Bt^T Bt
    over the (P, 3) axes, one float32 matmul.
    """
    P_ = p.X.shape[0]
    r, Jc, Jp, w_obs = residuals_and_jacobians(p)
    w = w_obs * huber_weights(r, huber_delta) if use_huber else w_obs
    wJc = Jc * w[:, None, None]
    wJp = Jp * w[:, None, None]

    U = segment_sum(torch.einsum("mki,mkj->mij", wJc, Jc), p.cam_idx, C)  # (C, 6, 6)
    V = segment_sum(torch.einsum("mki,mkj->mij", wJp, Jp), p.pt_idx, P_)  # (P, 3, 3)
    W = torch.einsum("mki,mkj->mij", wJc, Jp)  # (M, 6, 3)
    bc = -segment_sum(torch.einsum("mki,mk->mi", wJc, r), p.cam_idx, C)  # (C, 6)
    bp = -segment_sum(torch.einsum("mki,mk->mi", wJp, r), p.pt_idx, P_)  # (P, 3)

    eye3 = torch.eye(3, dtype=V.dtype, device=V.device)
    tr = torch.clamp(torch.diagonal(V, dim1=1, dim2=2).sum(-1) / 3.0, min=1e-6)
    V = V + lm_lambda * eye3 * tr[:, None, None]
    Vinv, info = torch.linalg.inv_ex(V + 1e-9 * eye3)
    Vinv = _nan_where_failed(Vinv, info)

    # dense-B Schur cross term: Vinv = L L^T, A_i = W_i L
    L, info = torch.linalg.cholesky_ex(Vinv + 1e-12 * eye3)  # (P, 3, 3)
    L = _nan_where_failed(L, info)
    A = W @ L[p.pt_idx]  # (M, 6, 3)
    rows = (p.pt_idx[:, None] * 3 + torch.arange(3, device=A.device)) * C + p.cam_idx[:, None]
    Bt = A.new_zeros((P_ * 3 * C, 6))
    Bt.index_put_((rows.reshape(-1),), A.transpose(1, 2).reshape(-1, 6), accumulate=True)
    Bm = Bt.view(P_ * 3, C * 6)
    S_cross = torch.matmul(Bm.T, Bm).view(C, 6, C, 6).permute(0, 2, 1, 3)

    b_red = bc - segment_sum(
        torch.einsum("mij,mj->mi", W @ Vinv[p.pt_idx], bp[p.pt_idx]), p.cam_idx, C)  # (C, 6)
    return -S_cross, U, b_red, W, Vinv, bp


def solve_reduced(S_cross_neg, U, b_red, lm_lambda, fixed_cams):
    """Damp + gauge-fix + densely solve the reduced camera system."""
    C = U.shape[0]
    eye6 = torch.eye(6, dtype=U.dtype, device=U.device)
    tr = torch.clamp(torch.diagonal(U, dim1=1, dim2=2).sum(-1) / 6.0, min=1e-6)
    U_damped = U + lm_lambda * eye6 * tr[:, None, None]
    free = (~fixed_cams).to(U.dtype)
    diag = torch.arange(C, device=U.device)
    S = S_cross_neg.clone()
    S[diag, diag] += U_damped
    S = S * (free[:, None] * free[None, :])[:, :, None, None]
    S[diag, diag] += eye6 * fixed_cams.to(U.dtype)[:, None, None]
    b = b_red * free[:, None]

    Sd = S.permute(0, 2, 1, 3).reshape(6 * C, 6 * C)
    dc = solve(Sd, b.reshape(-1, 1)).reshape(C, 6)
    return dc * free[:, None]


def backsub_points(p: BAProblem, W, Vinv, bp, dc):
    """Point updates given the camera step."""
    Wt_dc = segment_sum(torch.einsum("mij,mi->mj", W, dc[p.cam_idx]), p.pt_idx, p.X.shape[0])
    return torch.einsum("pij,pj->pi", Vinv, bp - Wt_dc)


def apply_updates(Rs, ts, X, dc, dp):
    dR = so3_exp(dc[:, :3])
    return dR @ Rs, torch.einsum("cij,cj->ci", dR, ts) + dc[:, 3:], X + dp


def ba_step(
    p: BAProblem,
    lm_lambda,
    huber_delta,
    use_huber: bool = True,
) -> Tuple[BAProblem, torch.Tensor, torch.Tensor]:
    """One damped Gauss-Newton (LM) step via dense-Schur reduction.

    Returns (updated problem, new cost, old cost) as device tensors; the
    caller accepts or rejects the step and adapts ``lm_lambda``.
    """
    C = p.Rs.shape[0]
    S_cross_neg, U, b_red, W, Vinv, bp = schur_blocks(p, lm_lambda, huber_delta, use_huber, C)
    dc = solve_reduced(S_cross_neg, U, b_red, lm_lambda, p.fixed_cams)
    dp = backsub_points(p, W, Vinv, bp, dc)
    new_Rs, new_ts, new_X = apply_updates(p.Rs, p.ts, p.X, dc, dp)
    new_p = p._replace(Rs=new_Rs, ts=new_ts, X=new_X)
    hd = huber_delta if use_huber else None
    return new_p, cost(new_p, hd), cost(p, hd)


def run_ba(
    problem: BAProblem,
    max_iters: int = 30,
    init_lambda: float = 1e-3,
    huber_delta: float = float("inf"),
    tol: float = 1e-8,
    verbose: bool = False,
    device=None,
) -> Tuple[BAProblem, float]:
    """Levenberg-Marquardt driver: a host damping loop over
    :func:`ba_step`, reading the new cost once per iteration (λ x0.5 on
    accept, x4 on reject; stop at λ >= 1e6 or a relative decrease below
    ``tol``). The problem is solved on ``device`` (CUDA unless given)."""
    dev = resolve_device(device)
    problem = BAProblem(*(t.to(dev) for t in problem))
    lam = init_lambda
    use_huber = bool(np.isfinite(huber_delta))
    hd = float(np.float32(huber_delta if use_huber else 1e9))
    cur_cost = float(cost(problem, hd if use_huber else None))
    for it in range(max_iters):
        new_p, new_cost, _ = ba_step(problem, float(np.float32(lam)), hd, use_huber)
        new_cost = float(new_cost)
        if new_cost < cur_cost:
            rel = (cur_cost - new_cost) / max(cur_cost, 1e-12)
            problem, cur_cost = new_p, new_cost
            lam = max(lam * 0.5, 1e-9)
            if verbose:
                print(f"  BA it {it}: cost {cur_cost:.6e} lam {lam:.1e}")
            if rel < tol:
                break
        else:
            lam = min(lam * 4.0, 1e6)
            if lam >= 1e6:
                break
    return problem, cur_cost


def reprojection_rmse(p: BAProblem) -> float:
    """Root-mean-square reprojection error (normalized units)."""
    r, _, _, w = residuals_and_jacobians(p)
    sq = torch.sum(r ** 2, dim=-1) * w
    return float(torch.sqrt(torch.sum(sq) / torch.clamp(torch.sum(w), min=1.0)))
