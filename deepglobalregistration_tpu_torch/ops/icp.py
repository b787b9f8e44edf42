"""Point-to-point ICP with Open3D's convergence rule, full-scan neighbours.

Counterpart of the JAX package's ``ops/icp.py:113-234`` in its full-scan
mode (the path its pipeline takes below the 32768-row bucket): each
iteration finds every moved source point's nearest target (``knn.find_nn``:
the CUDA kernel on the card), gates pairs by the maximum correspondence
distance, solves the update by weighted Procrustes on the moved points and
composes ``rt_to_matrix(R, t) @ T``. The correspondences found when
evaluating the new pose feed the next update, so there is one neighbour
search per iteration. Stops when both |d fitness| and |d rmse| fall below
1e-6, or after 30 iterations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import knn, procrustes, se3


class ICPResult(NamedTuple):
    T: torch.Tensor
    fitness: float
    inlier_rmse: float
    iterations: int


def registration_icp(source: torch.Tensor, target: torch.Tensor,
                     max_correspondence_distance: float,
                     init: torch.Tensor | None = None, max_iteration: int = 30,
                     relative_fitness: float = 1e-6,
                     relative_rmse: float = 1e-6) -> ICPResult:
    """source [N0, 3], target [N1, 3] (valid rows only), init [4, 4] f32."""
    source = source.float().contiguous()
    target = target.float().contiguous()
    n0 = source.shape[0]
    T = torch.eye(4, device=source.device) if init is None else init.float()
    thresh2 = max_correspondence_distance ** 2

    def evaluate(T):
        moved = se3.apply_transform(source, T)
        idx, d2 = knn.find_nn(moved, target)
        inl = d2 < thresh2
        cnt = torch.sum(inl.float())
        fitness = cnt / max(n0, 1)
        rmse = torch.sqrt(torch.sum(torch.where(inl, d2, torch.zeros_like(d2)))
                          / torch.clamp(cnt, min=1.0))
        return moved, inl, target[idx.long()], fitness, rmse

    moved, inl, nn_xyz, fit, rmse = evaluate(T)
    i = 0
    while i < max_iteration:
        R, t = procrustes.weighted_procrustes(moved, nn_xyz, inl.float())
        T = torch.matmul(se3.rt_to_matrix(R, t), T)
        moved, inl, nn_xyz, fit_new, rmse_new = evaluate(T)
        i += 1
        done = bool((torch.abs(fit_new - fit) < relative_fitness)
                    & (torch.abs(rmse_new - rmse) < relative_rmse))
        fit, rmse = fit_new, rmse_new
        if done:
            break
    return ICPResult(T=T, fitness=float(fit), inlier_rmse=float(rmse), iterations=i)
