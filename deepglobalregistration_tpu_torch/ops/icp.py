"""Point-to-point ICP with Open3D's convergence rule: full scan or candidate lists.

Counterpart of the JAX package's ``ops/icp.py``. Each iteration finds every
moved source point's nearest target, gates pairs by the maximum
correspondence distance, solves the update by weighted Procrustes on the
moved points and composes ``rt_to_matrix(R, t) @ T``. The correspondences
found when evaluating the new pose feed the next update, so there is one
neighbour search per iteration. Stops when both |d fitness| and |d rmse| fall
below 1e-6, or after 30 iterations. ``f32_rmse_floor`` (default 0, the
JAX package's knob) widens the rmse rule to ``max(relative_rmse, rmse *
f32_rmse_floor)``; ``tools/icp_deviation.py`` sweeps it.

Two neighbour searches:

- the full scan (``use_candidates=False``): ``knn.find_nn`` over every
  target, the CUDA kernel on the card; exact for any init. Each pair's d2 is
  the kernel's |a|^2 - 2a.b + |b|^2, as in the JAX package's scan. (At LiDAR
  ranges of tens of metres its f32 rounding moves the rmse by more than the
  1e-6 stop rule, so the scan may run on where the candidate path, whose d2
  is a sum of squared differences, stops; the JAX package's scan does too.)
- candidate lists (``use_candidates=True``, the JAX package's path at voxel
  buckets >= 32768): targets bucketed once into cells of the correspondence
  distance, each source point (at the init pose) keeps the targets of its 27
  neighbouring cells, at most 8 a cell, and every iteration reduces over that
  fixed [N0, 216, 3] array. The lists hold while the pose stays within a
  quarter cell of the init: past it the loop stops at once and ``cand_ok``
  is False, and ``registration_icp_checked`` reruns the full scan from the
  same init.

A batch of B pairs ([B, N, 3] with per-pair row counts, as
``register_batch`` gives it) runs as the JAX package's function does under
``vmap``: one loop for all pairs, each pair frozen at its own done, stale or
``max_iteration`` stop, the host checking whether any pair is still active
once per iteration. The full scan is one batched ``knn.find_nn_batched``
launch an iteration for the whole batch; candidate lists are built pair by
pair once a call and stacked, absent slots at the sentinel. A batch has no
checked wrapper (the JAX package never uses it under ``vmap``): ``cand_ok``
comes back per pair for the caller to act on.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple, Union

import torch

from . import knn, procrustes, se3

_SENTINEL_XYZ = 1e6  # absent candidate slots: d2 ~ 1e12, never the argmin


class ICPResult(NamedTuple):
    """T [4, 4] and scalars; for a batch T [B, 4, 4] and lists of B values."""

    T: torch.Tensor
    fitness: Union[float, List[float]]
    inlier_rmse: Union[float, List[float]]
    iterations: Union[int, List[int]]
    # Candidate lists stayed valid (always True for the scan).
    cand_ok: Union[bool, List[bool]] = True


def _cell_key(c: torch.Tensor) -> torch.Tensor:
    """Pack int32 cell coordinates [..., 3] into 10-bit fields (clipped)."""
    c = torch.clamp(c, 0, 1021)
    return (c[..., 0] << 20) | (c[..., 1] << 10) | c[..., 2]


def _build_candidates(moved0: torch.Tensor, target: torch.Tensor, cell: float,
                      cap_per_cell: int = 8
                      ) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """For each source point (at its initial pose), the targets in the 27
    cells around it.

    moved0 [N0, 3], target [N1 >= 1, 3] (valid rows only, so no sentinel
    key is needed for padding rows as in the JAX package). Returns (cand_idx
    [N0, 27 * cap] int32, cand_xyz [N0, 27 * cap, 3] f32, overflow). Absent
    slots carry index -1 and coordinates 1e6. Within a cell, candidates keep
    ascending target index; cells follow the (-1, 0, 1)^3 offsets in
    ``meshgrid(indexing="ij")`` order, as in the JAX package, so the argmin's
    first-minimum rule picks the same target. ``overflow`` is True when a
    cell holds more than ``cap_per_cell`` targets (impossible for voxel-
    unique targets with cell = 2 * voxel)."""
    dev = target.device
    n0, n1 = moved0.shape[0], target.shape[0]
    tc = torch.floor(target / cell).to(torch.int32)
    base = tc.min(dim=0).values - 2
    key_t = _cell_key(tc - base)
    # Stable: equal keys keep ascending target index, as jax.lax.sort does.
    skey, sperm = torch.sort(key_t, stable=True)
    sperm = sperm.to(torch.int32)

    sc = torch.floor(moved0 / cell).to(torch.int32) - base
    r = torch.arange(-1, 2, dtype=torch.int32, device=dev)
    d = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(27, 3)
    nk = _cell_key(sc[:, None, :] + d[None, :, :])  # [N0, 27]
    starts = torch.searchsorted(skey, nk, right=False).to(torch.int32)
    counts = torch.searchsorted(skey, nk, right=True).to(torch.int32) - starts
    overflow = bool(torch.any((counts > cap_per_cell) & (nk < 2 ** 30)))

    j = torch.arange(cap_per_cell, dtype=torch.int32, device=dev)
    slot = starts[..., None] + j  # [N0, 27, cap]
    valid = j < torch.clamp(counts, max=cap_per_cell)[..., None]
    picked = sperm[torch.clamp(slot, max=n1 - 1).long()]
    cand_idx = torch.where(valid, picked, torch.full_like(picked, -1))
    cand_idx = cand_idx.reshape(n0, -1)
    cand_xyz = target[torch.clamp(cand_idx, min=0).long()]
    cand_xyz = torch.where((cand_idx >= 0)[..., None], cand_xyz,
                           torch.full_like(cand_xyz, _SENTINEL_XYZ))
    return cand_idx, cand_xyz, overflow


def _build_candidates_batched(moved0: torch.Tensor, target: torch.Tensor,
                              num0: Sequence[int], num1: Sequence[int],
                              cell: float) -> Tuple[torch.Tensor, List[bool]]:
    """Each pair's lists (``_build_candidates`` on its valid rows), stacked
    to [B, N0, 27 * 8, 3] with absent slots and padding rows at the
    sentinel; returns (cand_xyz, overflow per pair)."""
    b, n0 = moved0.shape[:2]
    cand_xyz = torch.full((b, n0, 27 * 8, 3), _SENTINEL_XYZ, device=moved0.device)
    overflow = [False] * b
    for p in range(b):
        if num0[p] and num1[p]:
            _, xyz, overflow[p] = _build_candidates(
                moved0[p, :num0[p]], target[p, :num1[p]], cell)
            cand_xyz[p, :num0[p]] = xyz
    return cand_xyz, overflow


def registration_icp(source: torch.Tensor, target: torch.Tensor,
                     max_correspondence_distance: float,
                     init: torch.Tensor | None = None, max_iteration: int = 30,
                     relative_fitness: float = 1e-6,
                     relative_rmse: float = 1e-6,
                     f32_rmse_floor: float = 0.0,
                     use_candidates: bool = False,
                     num0: Sequence[int] | None = None,
                     num1: Sequence[int] | None = None) -> ICPResult:
    """source [N0, 3], target [N1, 3] (valid rows only), init [4, 4] f32; or
    a batch: source [B, N0, 3], target [B, N1, 3], the valid rows of each
    pair ``num0`` / ``num1`` [B] (ints), init [B, 4, 4].

    ``use_candidates``: candidate-list search (see the module docstring),
    exact only from a near-converged init; check ``cand_ok``."""
    batched = source.dim() == 3
    source = source.float().contiguous()
    target = target.float().contiguous()
    dev = source.device
    n0 = source.shape[-2]
    if init is None:
        init = torch.eye(4, device=dev).expand(source.shape[:-2] + (4, 4))
    T = init.float()
    thresh2 = max_correspondence_distance ** 2
    if batched:
        num0, num1 = [int(n) for n in num0], [int(n) for n in num1]
        valid0 = (torch.arange(n0, device=dev)
                  < torch.tensor(num0, device=dev)[:, None])  # [B, N0]
        # Padding rows find no candidate (d2 = +inf, or ~1e12 against the
        # sentinel), so they are never inliers.
        den = torch.tensor(num0, dtype=torch.float32, device=dev).clamp(min=1.0)
    else:
        den = max(n0, 1)

    if use_candidates:
        moved0 = se3.apply_transform(source, T)
        if batched:
            cand_xyz, cand_overflow = _build_candidates_batched(
                moved0, target, num0, num1, cell=max_correspondence_distance)
        else:
            _, cand_xyz, cand_overflow = _build_candidates(
                moved0, target, cell=max_correspondence_distance)

        def find(moved):
            d2 = torch.sum((moved[..., None, :] - cand_xyz) ** 2, dim=-1)
            jbest = torch.argmin(d2, dim=-1, keepdim=True)  # first minimum
            return (torch.gather(d2, -1, jbest)[..., 0],
                    torch.take_along_dim(cand_xyz, jbest[..., None], dim=-2)[..., 0, :])
    elif batched:
        nums = (torch.tensor(num0, device=dev), torch.tensor(num1, device=dev))

        def find(moved):
            idx, d2 = knn.find_nn_batched(moved, target, *nums)
            return d2, torch.take_along_dim(target, idx.long()[..., None], dim=-2)
    else:
        def find(moved):
            idx, d2 = knn.find_nn(moved, target)
            return d2, target[idx.long()]

    def evaluate(T):
        moved = se3.apply_transform(source, T)
        d2, nn_xyz = find(moved)
        inl = d2 < thresh2
        cnt = torch.sum(inl.float(), dim=-1)
        fitness = cnt / den
        rmse = torch.sqrt(torch.sum(torch.where(inl, d2, torch.zeros_like(d2)), dim=-1)
                          / torch.clamp(cnt, min=1.0))
        return moved, inl, nn_xyz, fitness, rmse

    def drift2(moved):
        d = torch.sum((moved - moved0) ** 2, dim=-1)
        if batched:  # padding rows do not move with the points
            d = torch.where(valid0, d, torch.zeros_like(d))
        return torch.max(d, dim=-1).values

    drift_bound2 = (0.25 * max_correspondence_distance) ** 2
    state = evaluate(T)  # moved, inl, nn_xyz, fitness, rmse
    i = torch.zeros(source.shape[:-2], dtype=torch.int32, device=dev)
    done = torch.zeros_like(i, dtype=torch.bool)
    stale = torch.zeros_like(done)
    active = i < max_iteration
    while bool(active.any()):
        moved, inl, nn_xyz, fit, rmse = state
        R, t = procrustes.weighted_procrustes(moved, nn_xyz, inl.float())
        T_new = torch.matmul(se3.rt_to_matrix(R, t), T)
        new = evaluate(T_new)
        rmse_eps = torch.clamp(new[4] * f32_rmse_floor, min=relative_rmse)
        done_new = ((torch.abs(new[3] - fit) < relative_fitness)
                    & (torch.abs(new[4] - rmse) < rmse_eps))
        if use_candidates:
            # Lists built at the init: past the quarter-cell bound their
            # answers are no longer trusted, so stop at once (the checked
            # wrapper's full scan, or register_batch's rerun, redoes the work).
            stale = stale | (active & (drift2(new[0]) > drift_bound2))
        if batched:  # pairs already stopped keep their state
            frz = lambda a, b: torch.where(active.reshape(active.shape + (1,) * (a.dim() - 1)), a, b)
            T_new = frz(T_new, T)
            new = tuple(frz(a, b) for a, b in zip(new, state))
        T, state = T_new, new
        i = i + active.int()
        done = done | (active & done_new)
        active = ~(done | stale) & (i < max_iteration)
    fit, rmse = state[3], state[4]
    if use_candidates:
        cand_ok = (~stale & ~torch.tensor(cand_overflow, device=dev)).tolist()
    else:
        cand_ok = [True] * len(num0) if batched else True
    return ICPResult(T=T, fitness=fit.tolist(), inlier_rmse=rmse.tolist(),
                     iterations=i.tolist(), cand_ok=cand_ok)


def registration_icp_checked(source: torch.Tensor, target: torch.Tensor,
                             max_correspondence_distance: float,
                             init: torch.Tensor | None = None,
                             max_iteration: int = 30,
                             f32_rmse_floor: float = 0.0) -> ICPResult:
    """Candidate-list ICP; when its lists do not hold (``cand_ok`` False:
    the pose drifted past the quarter-cell bound, or a cell overflowed), the
    full scan reruns from the same init on the same device. The result's
    ``cand_ok`` says whether the candidate answer was kept (False: the full
    scan's answer is returned)."""
    kw = dict(init=init, max_iteration=max_iteration, f32_rmse_floor=f32_rmse_floor)
    res = registration_icp(source, target, max_correspondence_distance,
                           use_candidates=True, **kw)
    if res.cand_ok:
        return res
    full = registration_icp(source, target, max_correspondence_distance, **kw)
    return full._replace(cand_ok=False)
