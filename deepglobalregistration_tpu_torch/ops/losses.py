"""High-dimensional smooth-L1 loss of the refinement loop (the JAX package's
``ops/losses.py:high_dim_smooth_l1``; reference core/loss.py:42-61)."""

from __future__ import annotations

import torch


def high_dim_smooth_l1(X: torch.Tensor, Y: torch.Tensor, weights: torch.Tensor,
                       quantization_size: float = 1.0,
                       eps: float = 1.1920929e-07,
                       w1: torch.Tensor | None = None) -> torch.Tensor:
    """sum(w * l(d2)) / sum(w) with d2 the quantization-normalized squared
    distance and l(d2) = 0.5 d2 below 1, else 0.5 (sqrt(d2 + eps) - 0.5).

    X, Y [..., N, 3], weights [..., N], w1 [...]: one loss per leading index
    (a pair of a batch), summed over N."""
    d2 = torch.sum(((X - Y) / quantization_size) ** 2, dim=-1)
    use_sq = (d2 < 1.0).float() * 0.5
    loss = (0.5 - use_sq) * (torch.sqrt(d2 + eps) - 0.5) + use_sq * d2
    if w1 is None:
        w1 = torch.sum(weights, dim=-1)
    return torch.sum(loss * weights, dim=-1) / torch.clamp(w1, min=eps)
