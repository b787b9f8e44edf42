"""Safeguard RANSAC over correspondences, hypotheses scored in parallel.

Counterpart of the JAX package's ``ops/ransac.py``: 4-point unweighted
Procrustes hypotheses, scored by inlier count then rmse, the best one refit
on its inliers twice (``ransac_correspondence``); optionally Open3D's
distance checker prunes hypotheses whose own samples misfit; and the
feature-matching variant matches features by 1-NN (the CUDA kernel on the
card) before running it with the checker (``ransac_feature_matching``).
Draws come from a ``torch.Generator`` and cannot reproduce ``jax.random``'s
bits, so a caller (a test) may pass the ``samples`` [H, 4] both versions
should use. Hypotheses are scored in chunks so the [H, N] distance matrix
never exists at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import knn, procrustes

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


def _checker_distance_ok(Rs, ts, sx, sy, checker_distance: float) -> torch.Tensor:
    """Open3D's CorrespondenceCheckerBasedOnDistance on each hypothesis's own
    samples: Rs [H, 3, 3], ts [H, 3], sx/sy [H, 4, 3] -> ok [H] bool, True
    when every sampled pair lies within ``checker_distance`` once moved."""
    moved = torch.einsum("hij,hkj->hki", Rs, sx) + ts[:, None, :]
    d2 = torch.sum((moved - sy) ** 2, dim=-1)
    return torch.all(d2 < checker_distance * checker_distance, dim=1)


def ransac_correspondence(X: torch.Tensor, Y: torch.Tensor, distance_threshold: float,
                          num_hypotheses: int = 16384, refine_rounds: int = 2,
                          generator: torch.Generator | None = None,
                          samples: torch.Tensor | None = None,
                          checker_distance: float | None = None) -> RansacResult:
    """Robust rigid fit of correspondences X[i] <-> Y[i] ([N, 3], all valid).

    ``checker_distance``: when set, hypotheses whose sampled pairs misfit
    beyond it are rejected before scoring."""
    n = X.shape[0]
    X = X.float()
    Y = Y.float()
    if samples is None:
        samples = torch.randint(0, max(n, 1), (num_hypotheses, 4),
                                generator=generator, device=X.device)
    samples = samples.to(device=X.device, dtype=torch.int64)
    sx, sy = X[samples], Y[samples]
    Rs, ts = procrustes.procrustes_batch(sx, sy)
    cnts, rmses = [], []
    for s in range(0, Rs.shape[0], _H_CHUNK):
        _, c, r = _count_inliers(Rs[s:s + _H_CHUNK], ts[s:s + _H_CHUNK], X, Y,
                                 distance_threshold)
        cnts.append(c)
        rmses.append(r)
    cnts, rmses = torch.cat(cnts), torch.cat(rmses)
    if checker_distance is not None:
        ok = _checker_distance_ok(Rs, ts, sx, sy, checker_distance)
        cnts = torch.where(ok, cnts, torch.full_like(cnts, -1.0))
    best = torch.argmax(cnts - rmses / (rmses + 1.0))
    R, t = Rs[best], ts[best]
    for _ in range(refine_rounds):
        inl, _, _ = _count_inliers(R, t, X, Y, distance_threshold)
        R, t = procrustes.weighted_procrustes(X, Y, inl.float())
    _, cnt, rmse = _count_inliers(R, t, X, Y, distance_threshold)
    return RansacResult(R=R, t=t, fitness=cnt / max(n, 1), inlier_rmse=rmse)


def ransac_feature_matching(xyz0: torch.Tensor, xyz1: torch.Tensor,
                            feats0: torch.Tensor, feats1: torch.Tensor,
                            distance_threshold: float, num_hypotheses: int = 16384,
                            generator: torch.Generator | None = None,
                            samples: torch.Tensor | None = None) -> RansacResult:
    """Feature-matching RANSAC: 1-NN feature correspondences (``knn.find_nn``),
    then ``ransac_correspondence`` with the distance checker at the
    threshold. xyz0 [N0, 3], xyz1 [N1, 3], feats [N, C] (valid rows only)."""
    idx = knn.find_nn(feats0, feats1)[0].long()
    return ransac_correspondence(xyz0, xyz1[idx], distance_threshold,
                                 num_hypotheses=num_hypotheses, generator=generator,
                                 samples=samples, checker_distance=distance_threshold)
