"""Closed-form (weighted) Procrustes SE(3) solvers, batched.

Counterpart of the JAX package's ``ops/procrustes.py:32-86``: the weighted
cross-covariance of centred points, a det-fixed 3x3 SVD in f32 and two
Newton steps of polar polish. All functions take a leading batch dimension;
padded rows are excluded by weight 0.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _fix_det_svd(Sxy: torch.Tensor) -> torch.Tensor:
    """R = U diag(1, 1, det(U) det(V)) V^T for a batch of 3x3 matrices. A
    matrix with a non-finite entry gives itself back (NaN in, NaN out, and
    in its gradient, as JAX's SVD), where ``torch.linalg.svd`` would raise."""
    Sxy = Sxy.float()
    finite = torch.isfinite(Sxy).all(-1, keepdim=True).all(-2, keepdim=True)
    U, _, Vt = torch.linalg.svd(torch.where(finite, Sxy, torch.zeros_like(Sxy)))
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    D = torch.ones(Sxy.shape[:-1], dtype=torch.float32, device=Sxy.device)
    D[..., 2] = det
    return torch.where(finite, torch.matmul(U * D[..., None, :], Vt), Sxy)


def _polar_polish(R: torch.Tensor, iters: int = 2) -> torch.Tensor:
    """Newton steps toward the nearest orthogonal matrix: R <- 1.5 R - 0.5 R R^T R."""
    for _ in range(iters):
        R = 1.5 * R - 0.5 * torch.matmul(torch.matmul(R, R.transpose(-1, -2)), R)
    return R


def weighted_procrustes(X: torch.Tensor, Y: torch.Tensor, w: torch.Tensor,
                        eps: float = 1.1920929e-07
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """R, t minimizing sum w |R X + t - Y|^2.

    X, Y: [..., N, 3]; w: [..., N]. Returns (R [..., 3, 3], t [..., 3])."""
    w = w.float()
    X = X.float()
    Y = Y.float()
    W1 = torch.sum(torch.abs(w), dim=-1, keepdim=True)
    wn = (w / (W1 + eps))[..., None]
    mux = torch.sum(wn * X, dim=-2, keepdim=True)
    muy = torch.sum(wn * Y, dim=-2, keepdim=True)
    Sxy = torch.matmul((Y - muy).transpose(-1, -2), wn * (X - mux))
    R = _polar_polish(_fix_det_svd(Sxy))
    t = muy[..., 0, :] - torch.matmul(R, mux[..., 0, :, None])[..., 0]
    return R, t


def procrustes(X: torch.Tensor, Y: torch.Tensor, mask: torch.Tensor | None = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unweighted alignment of [..., N, 3] point sets; with a boolean
    ``mask`` [..., N] the masked-out rows are left out."""
    w = torch.ones(X.shape[:-1], device=X.device) if mask is None else mask.float()
    return weighted_procrustes(X, Y, w)


def procrustes_batch(X: torch.Tensor, Y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unweighted alignment of a batch of point sets [B, N, 3]."""
    return weighted_procrustes(X, Y, torch.ones(X.shape[:-1], device=X.device))
