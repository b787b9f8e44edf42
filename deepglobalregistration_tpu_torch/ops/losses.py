"""Losses: the inlier BCE (plain and class-balanced) and the high-dimensional
smooth-L1 of the refinement loop.

Counterpart of the JAX package's ``ops/losses.py`` (reference core/loss.py:
13-61), with validity masks for padded rows.
"""

from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits, in the stable form
    ``max(x, 0) - x y + log1p(exp(-|x|))``."""
    return torch.clamp(logits, min=0) - logits * labels \
        + torch.log1p(torch.exp(-torch.abs(logits)))


def unbalanced_loss(logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor | None = None, total=None) -> torch.Tensor:
    """Masked-mean BCE (core/loss.py:13-21 UnbalancedLoss). ``total``: the
    rows are one rank's shard and ``total`` sums a count over the ranks
    (``parallel/data_parallel.global_sum``); the mean is then over every
    rank's masked rows, and the value returned is this rank's share of it
    (the ranks' values sum to the loss of the whole batch)."""
    per = bce_with_logits(logits, labels.float())
    if mask is None:
        mask = torch.ones_like(per)
    m = mask.float()
    cnt = torch.sum(m) if total is None else total(torch.sum(m))
    return torch.sum(per * m) / torch.clamp(cnt, min=1.0)


def balanced_loss(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None, total=None) -> torch.Tensor:
    """Class-balanced BCE: the mean within each class, each present class
    weighted 1/2; an absent class contributes 0 (core/loss.py:24-39
    BalancedLoss skips it). ``total``: as ``unbalanced_loss``; a class's
    count, and whether it is absent, are those of every rank's rows."""
    labels = labels.float()
    per = bce_with_logits(logits, labels)
    m = torch.ones_like(per) if mask is None else mask.float()
    sels = [m * (labels == cls) for cls in (0.0, 1.0)]
    counts = torch.stack([torch.sum(sel) for sel in sels])
    if total is not None:
        counts = total(counts)
    out = per.new_zeros(())
    for sel, cnt in zip(sels, counts):
        mean = torch.sum(per * sel) / torch.clamp(cnt, min=1.0)
        out = out + torch.where(cnt > 0, mean, torch.zeros_like(mean)) / 2.0
    return out


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
