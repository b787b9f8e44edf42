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

A batch of B pairs ([B, N, 3], padding rows at weight 0) runs as the JAX
package's function does under ``vmap``: one loop for all pairs, each pair
frozen by its own ``active`` flag once its own stop rule fires, while the
host checks ``any(active)`` once per ``unroll`` steps.
"""

from __future__ import annotations

from typing import List, NamedTuple, Union

import torch

from ..ops import losses, procrustes, se3


class RefineResult(NamedTuple):
    """R [3, 3], t [3] and scalars; for a batch R [B, 3, 3], t [B, 3] and
    lists of B values."""

    R: torch.Tensor
    t: torch.Tensor
    iterations: Union[int, List[int]]
    loss: Union[float, List[float]]
    break_count: Union[int, List[int]]


def _col(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """v (a scalar, or one value a pair) shaped to broadcast against ``like``."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


def global_registration(points: torch.Tensor, trans_points: torch.Tensor,
                        weights: torch.Tensor, max_iter: int = 1000,
                        max_break_count: int = 20,
                        break_threshold_ratio: float = 1e-4,
                        quantization_size: float = 1.0, lr: float = 1e-1,
                        gamma: float = 0.999, unroll: int = 8,
                        b1: float = 0.9, b2: float = 0.999,
                        adam_eps: float = 1e-8) -> RefineResult:
    """points, trans_points [N, 3], weights [N] -> refined (R, t); or a batch
    [B, N, 3], [B, N] -> one (R, t) a pair. A batch of one runs the
    unbatched ops, so its result is exactly the unbatched call's."""
    kw = dict(max_iter=max_iter, max_break_count=max_break_count,
              break_threshold_ratio=break_threshold_ratio,
              quantization_size=quantization_size, lr=lr, gamma=gamma,
              unroll=unroll, b1=b1, b2=b2, adam_eps=adam_eps)
    if points.dim() == 3 and points.shape[0] == 1:
        r = global_registration(points[0], trans_points[0], weights[0], **kw)
        return RefineResult(r.R[None], r.t[None], [r.iterations], [r.loss],
                            [r.break_count])
    eps = 1.1920929e-07
    batched = points.dim() == 3
    points = points.float()
    trans_points = trans_points.float()
    weights = weights.float()
    w1 = torch.sum(weights, dim=-1)

    R0, t0 = procrustes.weighted_procrustes(points, trans_points, weights, eps=eps)
    rot6d = se3.rotation_to_rot6d(R0)
    if batched:  # [B, 6], [B, 1, 3]
        params = [rot6d.clone(), t0[:, None].clone()]
    else:  # [1, 6], [1, 3]
        params = [rot6d[None].clone(), t0[None].clone()]

    def value_and_grad(p):
        p = [x.detach().requires_grad_(True) for x in p]
        with torch.enable_grad():
            R = se3.ortho2rotation(p[0])
            if not batched:
                R = R[0]
            moved = torch.matmul(points, R.transpose(-1, -2)) + p[1]
            loss = losses.high_dim_smooth_l1(moved, trans_points, weights,
                                             quantization_size=quantization_size,
                                             eps=eps, w1=w1)
            # Pairs share no parameter, so the sum's gradient is each pair's.
            grads = torch.autograd.grad(loss.sum(), p)
        return loss.detach(), [g.detach() for g in grads]

    dev = points.device
    mu = [torch.zeros_like(x) for x in params]
    nu = [torch.zeros_like(x) for x in params]
    loss_cur, grads = value_and_grad(params)
    loss_prev = loss_cur
    break_count = torch.zeros(w1.shape, dtype=torch.int32, device=dev)
    i = torch.zeros(w1.shape, dtype=torch.int32, device=dev)

    def is_active():
        return (loss_cur >= 1e-7) & (break_count < max_break_count) & (i < max_iter)

    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    lr_t, gamma_t, b1_t, b2_t = f32(lr), f32(gamma), f32(b1), f32(b2)
    while bool(is_active().any()):
        for _ in range(max(1, unroll)):
            # optax's step count advances only on active steps, so it equals i.
            active = is_active()
            step = lr_t * gamma_t ** i.float()
            c1 = 1 - b1_t ** (i + 1).float()
            c2 = 1 - b2_t ** (i + 1).float()
            new_mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, mu)]
            new_nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads, nu)]
            new_params = [x - _col(step, x) * ((m / _col(c1, m))
                                               / (torch.sqrt(v / _col(c2, v)) + adam_eps))
                          for x, m, v in zip(params, new_mu, new_nu)]
            plateau = torch.abs(loss_prev - loss_cur) < loss_prev * break_threshold_ratio
            new_break = torch.where(plateau, break_count + 1, break_count)
            new_loss, new_grads = value_and_grad(new_params)
            sel = lambda new, old: [torch.where(_col(active, a), a, b)
                                    for a, b in zip(new, old)]
            params, mu, nu = sel(new_params, params), sel(new_mu, mu), sel(new_nu, nu)
            loss_prev = torch.where(active, loss_cur, loss_prev)
            loss_cur = torch.where(active, new_loss, loss_cur)
            grads = sel(new_grads, grads)
            break_count = torch.where(active, new_break, break_count)
            i = torch.where(active, i + 1, i)
    R = se3.ortho2rotation(params[0])
    R, t = (R, params[1][:, 0]) if batched else (R[0], params[1][0])
    return RefineResult(R=R, t=t, iterations=i.tolist(), loss=loss_cur.tolist(),
                        break_count=break_count.tolist())
