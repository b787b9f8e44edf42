"""Safeguard RANSAC over correspondences, hypotheses scored in parallel.

Counterpart of the JAX package's ``ops/ransac.py:32-106``
(``ransac_correspondence``, no distance checker): 4-point unweighted
Procrustes hypotheses, scored by inlier count then rmse, the best one refit
on its inliers twice. Draws come from a ``torch.Generator`` and cannot
reproduce ``jax.random``'s bits, so a caller (a test) may pass the
``samples`` [H, 4] both versions should use. Hypotheses are scored in
chunks so the [H, N] distance matrix never exists at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import procrustes

# Hypotheses scored per chunk (chunk x N x 3 floats of moved points).
_H_CHUNK = 1024


class RansacResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    fitness: torch.Tensor
    inlier_rmse: torch.Tensor


def _count_inliers(R, t, X, Y, thresh):
    """R [..., 3, 3], t [..., 3] against X, Y [N, 3]: (inliers, count, rmse)."""
    d2 = torch.sum((torch.matmul(X, R.transpose(-1, -2)) + t[..., None, :] - Y) ** 2,
                   dim=-1)
    inl = d2 < thresh * thresh
    cnt = torch.sum(inl.float(), dim=-1)
    rmse = torch.sqrt(torch.sum(torch.where(inl, d2, torch.zeros_like(d2)), dim=-1)
                      / torch.clamp(cnt, min=1.0))
    return inl, cnt, rmse


def ransac_correspondence(X: torch.Tensor, Y: torch.Tensor, distance_threshold: float,
                          num_hypotheses: int = 16384, refine_rounds: int = 2,
                          generator: torch.Generator | None = None,
                          samples: torch.Tensor | None = None) -> RansacResult:
    """Robust rigid fit of correspondences X[i] <-> Y[i] ([N, 3], all valid)."""
    n = X.shape[0]
    X = X.float()
    Y = Y.float()
    if samples is None:
        samples = torch.randint(0, max(n, 1), (num_hypotheses, 4),
                                generator=generator, device=X.device)
    samples = samples.to(device=X.device, dtype=torch.int64)
    Rs, ts = procrustes.procrustes_batch(X[samples], Y[samples])
    cnts, rmses = [], []
    for s in range(0, Rs.shape[0], _H_CHUNK):
        _, c, r = _count_inliers(Rs[s:s + _H_CHUNK], ts[s:s + _H_CHUNK], X, Y,
                                 distance_threshold)
        cnts.append(c)
        rmses.append(r)
    cnts, rmses = torch.cat(cnts), torch.cat(rmses)
    best = torch.argmax(cnts - rmses / (rmses + 1.0))
    R, t = Rs[best], ts[best]
    for _ in range(refine_rounds):
        inl, _, _ = _count_inliers(R, t, X, Y, distance_threshold)
        R, t = procrustes.weighted_procrustes(X, Y, inl.float())
    _, cnt, rmse = _count_inliers(R, t, X, Y, distance_threshold)
    return RansacResult(R=R, t=t, fitness=cnt / max(n, 1), inlier_rmse=rmse)
