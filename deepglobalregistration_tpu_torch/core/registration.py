"""SE(3) refinement: weighted Procrustes init, then Adam on (rot6d, trans).

Counterpart of the JAX package's ``core/registration.py:35-127``. The Adam
step is written out to match ``optax.adam(optax.exponential_decay(0.1, 1,
0.999))`` exactly: the step at update t (from 0) is ``lr * gamma**t``,
moments ``m = (1-b1) g + b1 m`` and ``v = (1-b2) g^2 + b2 v``, bias
correction by ``1 - b**(t+1)``, and ``eps`` added outside the square root.
(``torch.optim.Adam`` with ``ExponentialLR`` decays at another point.)

Stop rules as the reference: loss < 1e-7, ``max_break_count`` consecutive
steps with ``|loss_prev - loss| < loss_prev * break_threshold_ratio``, or
``max_iter`` steps. The loop runs ``unroll`` steps per host check, each step
masked by the same ``active`` flag the JAX package carries, so the result
is exact while the host syncs once per ``unroll`` steps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import losses, procrustes, se3


class RefineResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    iterations: int
    loss: float
    break_count: int


def global_registration(points: torch.Tensor, trans_points: torch.Tensor,
                        weights: torch.Tensor, max_iter: int = 1000,
                        max_break_count: int = 20,
                        break_threshold_ratio: float = 1e-4,
                        quantization_size: float = 1.0, lr: float = 1e-1,
                        gamma: float = 0.999, unroll: int = 8,
                        b1: float = 0.9, b2: float = 0.999,
                        adam_eps: float = 1e-8) -> RefineResult:
    """points, trans_points [N, 3], weights [N] -> refined (R, t)."""
    eps = 1.1920929e-07
    points = points.float()
    trans_points = trans_points.float()
    weights = weights.float()
    w1 = torch.sum(weights)

    R0, t0 = procrustes.weighted_procrustes(points, trans_points, weights, eps=eps)
    params = [se3.rotation_to_rot6d(R0)[None].clone(), t0[None].clone()]

    def value_and_grad(p):
        p = [x.detach().requires_grad_(True) for x in p]
        with torch.enable_grad():
            R = se3.ortho2rotation(p[0])[0]
            moved = torch.matmul(points, R.T) + p[1]
            loss = losses.high_dim_smooth_l1(moved, trans_points, weights,
                                             quantization_size=quantization_size,
                                             eps=eps, w1=w1)
            grads = torch.autograd.grad(loss, p)
        return loss.detach(), [g.detach() for g in grads]

    dev = points.device
    mu = [torch.zeros_like(x) for x in params]
    nu = [torch.zeros_like(x) for x in params]
    loss_cur, grads = value_and_grad(params)
    loss_prev = loss_cur
    break_count = torch.zeros((), dtype=torch.int32, device=dev)
    i = torch.zeros((), dtype=torch.int32, device=dev)

    def is_active():
        return (loss_cur >= 1e-7) & (break_count < max_break_count) & (i < max_iter)

    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    lr_t, gamma_t, b1_t, b2_t = f32(lr), f32(gamma), f32(b1), f32(b2)
    while bool(is_active()):
        for _ in range(max(1, unroll)):
            # optax's step count advances only on active steps, so it equals i.
            active = is_active()
            step = lr_t * gamma_t ** i.float()
            c1 = 1 - b1_t ** (i + 1).float()
            c2 = 1 - b2_t ** (i + 1).float()
            new_mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, mu)]
            new_nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads, nu)]
            new_params = [x - step * ((m / c1) / (torch.sqrt(v / c2) + adam_eps))
                          for x, m, v in zip(params, new_mu, new_nu)]
            plateau = torch.abs(loss_prev - loss_cur) < loss_prev * break_threshold_ratio
            new_break = torch.where(plateau, break_count + 1, break_count)
            new_loss, new_grads = value_and_grad(new_params)
            sel = lambda new, old: [torch.where(active, a, b) for a, b in zip(new, old)]
            params, mu, nu = sel(new_params, params), sel(new_mu, mu), sel(new_nu, nu)
            loss_prev = torch.where(active, loss_cur, loss_prev)
            loss_cur = torch.where(active, new_loss, loss_cur)
            grads = sel(new_grads, grads)
            break_count = torch.where(active, new_break, break_count)
            i = torch.where(active, i + 1, i)
    R = se3.ortho2rotation(params[0])[0]
    return RefineResult(R=R, t=params[1][0], iterations=int(i),
                        loss=float(loss_cur), break_count=int(break_count))
