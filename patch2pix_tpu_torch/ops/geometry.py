"""Two-view epipolar geometry, differentiable.

Port of ``patch2pix_tpu.ops.geometry``:

  * the distances the training loss uses, ``sampson_dist`` and
    ``sym_epi_dist`` of ``(N, 4)`` matches (x1, y1, x2, y2) under a
    ``(3, 3)`` fundamental matrix F with ``p2^T F p1 = 0`` for a perfect
    correspondence, and their batched forms over ``(B, N, 4)`` matches
    and ``(B, 3, 3)`` F; the arithmetic runs in F's dtype and returns
    float32;
  * the F/E/pose conversions (``skew``, ``pose2ess``, ``ess2fund``,
    ``fund2ess``, ``pose2fund``, ``quat2rot``, ``rot2quat``,
    ``abs2relapose``), each over any leading batch axes. An inverse of
    a singular intrinsics matrix gives NaN (``torch.linalg.inv_ex``), as
    ``jnp.linalg.inv`` does, instead of raising.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _epi_terms(matches: torch.Tensor, F: torch.Tensor):
    """Batched epipolar algebra: matches ``(B, N, 4)``, F ``(B, 3, 3)``
    -> (dd, l1, l2) with dd ``(B, N)`` = p2^T F p1, l2 = F p1 (lines in
    image 2) and l1 = F^T p2 (lines in image 1), each ``(B, 3, N)``."""
    matches = matches.to(F.dtype)
    ones = torch.ones(matches.shape[:-1] + (1,), dtype=F.dtype, device=F.device)
    p1 = torch.cat([matches[..., 0:2], ones], dim=-1)  # (B, N, 3)
    p2 = torch.cat([matches[..., 2:4], ones], dim=-1)
    l2 = F @ p1.transpose(1, 2)
    l1 = F.transpose(1, 2) @ p2.transpose(1, 2)
    dd = torch.sum(l2.transpose(1, 2) * p2, dim=-1)
    return dd, l1, l2


def sampson_dist_batched(matches: torch.Tensor, F: torch.Tensor,
                         eps: float = 1e-8) -> torch.Tensor:
    """Sampson (first-order reprojection) distance: ``(B, N, 4)``
    matches, ``(B, 3, 3)`` F -> ``(B, N)`` float32."""
    dd, l1, l2 = _epi_terms(matches, F)
    denom = eps + l1[:, 0] ** 2 + l1[:, 1] ** 2 + l2[:, 0] ** 2 + l2[:, 1] ** 2
    return (dd ** 2 / denom).float()


def sampson_dist(matches: torch.Tensor, F: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """``(N, 4)`` matches, ``(3, 3)`` F -> ``(N,)`` float32."""
    return sampson_dist_batched(matches[None], F[None], eps)[0]


def sym_epi_dist_batched(matches: torch.Tensor, F: torch.Tensor, sqrt: bool = False,
                         eps: float = 1e-8) -> torch.Tensor:
    """Symmetric epipolar distance, ``(B, N)`` float32: squared unless
    ``sqrt`` (the reference hard-codes the squared form; the argument is
    honoured here, as in the JAX package)."""
    dd, l1, l2 = _epi_terms(matches, F)
    inv1 = 1.0 / (eps + l1[:, 0] ** 2 + l1[:, 1] ** 2)
    inv2 = 1.0 / (eps + l2[:, 0] ** 2 + l2[:, 1] ** 2)
    if sqrt:
        d = torch.abs(dd) * (torch.sqrt(inv1) + torch.sqrt(inv2))
    else:
        d = dd ** 2 * (inv1 + inv2)
    return d.float()


def sym_epi_dist(matches: torch.Tensor, F: torch.Tensor, sqrt: bool = False,
                 eps: float = 1e-8) -> torch.Tensor:
    """``(N, 4)`` matches, ``(3, 3)`` F -> ``(N,)`` float32."""
    return sym_epi_dist_batched(matches[None], F[None], sqrt, eps)[0]


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrices ``(..., 3, 3)`` of ``(...,
    3)`` vectors."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _inv(K: torch.Tensor) -> torch.Tensor:
    inv, info = torch.linalg.inv_ex(K)
    return torch.where((info == 0)[..., None, None], inv, float("nan"))


def pose2ess(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Essential matrix from relative pose: E = [t]_x R."""
    return skew(t.reshape(R.shape[:-2] + (3,))) @ R


def ess2fund(K1: torch.Tensor, K2: torch.Tensor, E: torch.Tensor) -> torch.Tensor:
    """F = K2^-T E K1^-1."""
    return _inv(K2).transpose(-1, -2) @ E @ _inv(K1)


def fund2ess(F: torch.Tensor, K2: torch.Tensor, K1: torch.Tensor) -> torch.Tensor:
    """E = K2^T F K1."""
    return K2.transpose(-1, -2) @ F @ K1


def pose2fund(K1: torch.Tensor, K2: torch.Tensor, R: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    """Fundamental matrix from intrinsics + relative pose, the
    reference's formulation: F = K2^-T R K1^T [K1 R^T t]_x."""
    t = t.reshape(R.shape[:-2] + (3, 1))
    e = (K1 @ R.transpose(-1, -2) @ t)[..., 0]
    return _inv(K2).transpose(-1, -2) @ R @ K1.transpose(-1, -2) @ skew(e)


def quat2rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (w, x, y, z) ``(..., 4)`` -> rotation matrices."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def rot2quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices ``(..., 3, 3)`` -> unit quaternions (w, x, y, z),
    branch-free (Shepperd: the construction of the largest pivot)."""
    m = R.flatten(-2).unbind(-1)
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = m
    tr = m00 + m11 + m22
    qw = torch.stack([1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22,
                      1 - m00 - m11 + m22], -1)
    qw = torch.sqrt(torch.clamp(qw, min=1e-12)) / 2.0
    a, b, c, d = (4 * qw).unbind(-1)
    w0, w1, w2, w3 = qw.unbind(-1)
    cand = torch.stack([
        torch.stack([w0, (m21 - m12) / a, (m02 - m20) / a, (m10 - m01) / a], -1),
        torch.stack([(m21 - m12) / b, w1, (m01 + m10) / b, (m02 + m20) / b], -1),
        torch.stack([(m02 - m20) / c, (m01 + m10) / c, w2, (m12 + m21) / c], -1),
        torch.stack([(m10 - m01) / d, (m02 + m20) / d, (m12 + m21) / d, w3], -1),
    ], -2)
    best = torch.argmax(qw, dim=-1)
    q = torch.take_along_dim(cand, best[..., None, None], dim=-2)[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def abs2relapose(c1: torch.Tensor, c2: torch.Tensor, q1: torch.Tensor,
                 q2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Relative pose (t12, q12) from two absolute camera poses (camera
    centres, world->cam quaternions): R12 = R2 R1^T, t12 = R2 (c1 - c2)."""
    r1, r2 = quat2rot(q1), quat2rot(q2)
    t12 = (r2 @ (c1 - c2)[..., None])[..., 0]
    return t12, rot2quat(r2 @ r1.transpose(-1, -2))
