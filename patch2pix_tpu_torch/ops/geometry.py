"""Two-view epipolar distances, differentiable.

Port of ``patch2pix_tpu.ops.geometry`` (the distances the training loss
uses): ``sampson_dist`` and ``sym_epi_dist`` of ``(N, 4)`` matches
(x1, y1, x2, y2) under a ``(3, 3)`` fundamental matrix F with
``p2^T F p1 = 0`` for a perfect correspondence, and their batched forms
over ``(B, N, 4)`` matches and ``(B, 3, 3)`` F. The arithmetic runs in
F's dtype and returns float32.
"""

from __future__ import annotations

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
