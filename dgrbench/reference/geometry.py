"""Plain 1-NN search, weighted Procrustes, the SE(3) refinement and ICP.

Written from DGR's description (Choy et al., CVPR 2020, section 4: weighted
Procrustes, then gradient refinement of a 6D rotation and a translation
under a robust loss; ICP to polish), with the stop rules of DGR's code and
of Open3D's point-to-point ICP. Everything is unbatched, float32 and plain.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

EPS = 1.1920929e-07


def nn1(f0: torch.Tensor, f1: torch.Tensor, rows: int = 2048):
    """Nearest row of f1 for every row of f0, by squared distance; ties to
    the lower index. Returns (idx [N0] int64, d2 [N0])."""
    n1 = (f1 * f1).sum(1)
    idx, best = [], []
    for s in range(0, f0.shape[0], rows):
        a = f0[s:s + rows]
        d2 = (a * a).sum(1, keepdim=True) - 2 * a @ f1.T + n1[None]
        j = torch.argmin(d2, dim=1)
        idx.append(j)
        best.append(((a - f1[j]) ** 2).sum(1))
    return torch.cat(idx), torch.cat(best)


def nn_gap(f0: torch.Tensor, f1: torch.Tensor, idx: torch.Tensor) -> float:
    """The widest gap by which a match's squared distance exceeds the best
    one in (f0, f1): 0 when every row's match is a nearest row."""
    _, best = nn1(f0, f1)
    got = ((f0 - f1[idx.long()]) ** 2).sum(1)
    return float(torch.clamp(got - best, min=0).max()) if got.numel() else 0.0


def weighted_procrustes(X, Y, w):
    """R, t minimising sum w |R x + t - y|^2: the weighted cross-covariance,
    its SVD with the determinant fixed, and two Newton steps of polar
    polish (DGR's weighted Procrustes as its training graph runs it)."""
    wn = (w / (w.abs().sum() + EPS))[:, None]
    mx, my = (wn * X).sum(0), (wn * Y).sum(0)
    S = (Y - my).T @ (wn * (X - mx))
    U, _, Vt = torch.linalg.svd(S)
    d = torch.ones(3, device=X.device)
    d[2] = torch.linalg.det(U) * torch.linalg.det(Vt)
    R = (U * d) @ Vt
    for _ in range(2):
        R = 1.5 * R - 0.5 * R @ R.T @ R
    return R, my - R @ mx


def rot6d_to_matrix(p):
    x = p[:3] / torch.clamp(p[:3].norm(), min=1e-8)
    y = p[3:] - (x @ p[3:]) / torch.clamp(x @ x, min=1e-8) * x
    y = y / torch.clamp(y.norm(), min=1e-8)
    return torch.stack([x, y, torch.linalg.cross(x, y)], dim=1)


def _robust_loss(X, Y, w, quant):
    d2 = (((X - Y) / quant) ** 2).sum(1)
    sq = d2 < 1
    per = torch.where(sq, 0.5 * d2, 0.5 * (torch.sqrt(d2 + EPS) - 0.5))
    return (per * w).sum() / torch.clamp(w.sum(), min=EPS)


class Refined(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    iterations: int  # where the stop rule stopped


def refine(X, Y, w, quant: float, max_iter: int = 1000, max_break: int = 20,
           ratio: float = 1e-4, lr: float = 0.1, gamma: float = 0.999,
           steps: int | None = None) -> Refined:
    """Weighted Procrustes, then Adam (b1 0.9, b2 0.999, eps 1e-8, step
    lr * gamma^t) on (6D rotation, translation) under the smooth-L1 of the
    quantised distances; stops when the loss is under 1e-7, once
    ``max_break`` steps have changed it by less than ``ratio`` of itself,
    or after ``max_iter`` steps. With ``steps``, the pose is the one after
    exactly that many steps (the loop runs on as far as needed), and
    ``iterations`` is still where the stop rule stopped."""
    R0, t0 = weighted_procrustes(X, Y, w)
    p = [torch.cat([R0[:, 0], R0[:, 1]]).clone(), t0.clone()]
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=X.device)
    lr, gamma, b1, b2 = f32(lr), f32(gamma), f32(0.9), f32(0.999)

    def value_grad(q):
        q = [v.detach().requires_grad_(True) for v in q]
        with torch.enable_grad():
            loss = _robust_loss(X @ rot6d_to_matrix(q[0]).T + q[1], Y, w, quant)
            g = torch.autograd.grad(loss, q)
        return loss.detach(), [v.detach() for v in g]

    m = [torch.zeros_like(v) for v in p]
    v2 = [torch.zeros_like(v) for v in p]
    loss, g = value_grad(p)
    prev, breaks, it, stop, kept = loss, 0, 0, None, None
    # Every scalar in float32, as the configuration's precision states.
    while True:
        if stop is None and not (bool(loss >= 1e-7) and breaks < max_break
                                 and it < max_iter):
            stop = it
        if it == steps:
            kept = p
        if stop is not None and (steps is None or it >= steps):
            break
        step = lr * gamma ** f32(float(it))
        m = [(1 - 0.9) * gi + 0.9 * mi for gi, mi in zip(g, m)]
        v2 = [(1 - 0.999) * gi * gi + 0.999 * vi for gi, vi in zip(g, v2)]
        c1, c2 = 1 - b1 ** f32(float(it + 1)), 1 - b2 ** f32(float(it + 1))
        p = [pi - step * ((mi / c1) / (torch.sqrt(vi / c2) + 1e-8))
             for pi, mi, vi in zip(p, m, v2)]
        if bool(torch.abs(prev - loss) < prev * ratio):
            breaks += 1
        prev = loss
        loss, g = value_grad(p)
        it += 1
    p = p if kept is None else kept
    return Refined(rot6d_to_matrix(p[0]), p[1], stop)


def icp_fitness(source, target, max_dist: float, T: torch.Tensor, expanded: bool) -> float:
    """ICP's fitness at pose T: the share of source points whose nearest
    target lies within ``max_dist``."""
    moved = source @ T[:3, :3].float().T + T[:3, 3].float()
    d2, _ = _nearest(moved, target, expanded)
    return float((d2 < max_dist ** 2).sum()) / max(source.shape[0], 1)


class ICP(NamedTuple):
    T: torch.Tensor
    iterations: int  # where the stop rule stopped


def _nearest(moved, target, expanded: bool, rows: int = 4096):
    """Each moved point's nearest target and its squared distance: the sum
    of squared differences, or with ``expanded`` |a|^2 - 2 a.b + |b|^2 (the
    norms summed in coordinate order), as a 1-NN scan computes it."""
    d2s, nns = [], []
    sq1 = target[:, 0] ** 2 + target[:, 1] ** 2 + target[:, 2] ** 2
    for s in range(0, moved.shape[0], rows):
        a = moved[s:s + rows]
        if expanded:
            sq0 = a[:, 0] ** 2 + a[:, 1] ** 2 + a[:, 2] ** 2
            d2 = sq0[:, None] - 2.0 * (a @ target.T) + sq1[None]
        else:
            d2 = torch.zeros((a.shape[0], target.shape[0]), device=a.device)
            for c in range(3):
                d2 += (a[:, c:c + 1] - target[None, :, c]) ** 2
        best, j = torch.min(d2, dim=1)
        d2s.append(best)
        nns.append(target[j])
    return torch.cat(d2s), torch.cat(nns)


def icp(source, target, max_dist: float, init: torch.Tensor, max_iter: int = 30,
        rel_fitness: float = 1e-6, rel_rmse: float = 1e-6,
        steps: int | None = None, expanded: bool = False) -> ICP:
    """Point-to-point ICP from ``init`` [4, 4]: every moved source point's
    nearest target within ``max_dist`` is a correspondence; each step solves
    the update by Procrustes and composes it on the left; stops when fitness
    and inlier rmse both change by less than their tolerances, or after
    ``max_iter`` steps. With ``steps``, the pose is the one after exactly
    that many steps, and ``iterations`` is still where the rule stopped."""
    T = init.float().clone()

    def evaluate(T):
        moved = source @ T[:3, :3].T + T[:3, 3]
        d2, nn = _nearest(moved, target, expanded)
        inl = d2 < max_dist ** 2
        cnt = inl.sum()
        fit = float(cnt) / max(source.shape[0], 1)
        rmse = float(torch.sqrt(torch.where(inl, d2, torch.zeros_like(d2)).sum()
                                / torch.clamp(cnt.float(), min=1.0)))
        return moved, inl, nn, fit, rmse

    state = evaluate(T)
    it, stop, kept = 0, None, None
    while True:
        if it == steps:
            kept = T
        if stop is not None and (steps is None or it >= steps):
            break
        moved, inl, nn, fit, rmse = state
        R, t = weighted_procrustes(moved, nn, inl.float())
        step = torch.eye(4, device=T.device)
        step[:3, :3], step[:3, 3] = R, t
        T = step @ T
        state = evaluate(T)
        it += 1
        if stop is None and ((abs(state[3] - fit) < rel_fitness
                              and abs(state[4] - rmse) < rel_rmse) or it >= max_iter):
            stop = it
    return ICP(T if kept is None else kept, stop)


def pose_gap(Ta: torch.Tensor, Tb: torch.Tensor):
    """(rotation angle between the two poses in degrees, distance between
    their translations)."""
    Ta, Tb = Ta.double().cpu(), Tb.double().cpu()
    # |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2): well conditioned at small angles,
    # where the arccos of the trace is not.
    s = torch.clamp((Ta[:3, :3] - Tb[:3, :3]).norm() / (2 * 2 ** 0.5), max=1.0)
    ang = torch.rad2deg(2 * torch.asin(s))
    return float(ang), float((Ta[:3, 3] - Tb[:3, 3]).norm())
