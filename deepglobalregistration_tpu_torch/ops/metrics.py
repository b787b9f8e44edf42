"""Registration metrics: rotation/translation errors, success criteria, pdist.

Counterpart of the JAX package's ``ops/metrics.py`` (reference
core/metrics.py:11-69, scripts/test_3dmatch.py:38-46 for ``rte_rre``).
Plain f32 torch functions; the JAX module pins ``Precision.HIGHEST`` on
every matmul, and here ``utils/device.set_precision`` keeps TF32 off on the
card. The clamps (0.9999 for one pair, 0.999 batched) are the reference's.
"""

from __future__ import annotations

import torch


def rotation_error(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """arccos((tr(R1^T R2) - 1) / 2), clamped as the reference (metrics.py:15-17)."""
    tr = torch.trace(torch.matmul(R1.T, R2))
    return torch.arccos(torch.clamp((tr - 1.0) / 2.0, -0.9999, 0.9999))


def translation_error(t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum((t1 - t2) ** 2))


def batch_rotation_error(rots1: torch.Tensor, rots2: torch.Tensor) -> torch.Tensor:
    """Batched geodesic rotation error; clamp +/-0.999 as metrics.py:25-34.

    rots1/rots2: [B, 3, 3] or [B, 9].
    """
    tr = torch.sum(rots1.reshape(-1, 9) * rots2.reshape(-1, 9), dim=1)
    return torch.arccos(torch.clamp((tr - 1.0) / 2.0, -0.999, 0.999))


def batch_translation_error(t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(t1 - t2, dim=1)


def rte_rre(T_pred: torch.Tensor, T_gt: torch.Tensor, rte_thresh: float,
            rre_thresh_deg: float):
    """Success criterion and errors (scripts/test_3dmatch.py:38-46).

    Returns (success, rte, rre_deg) as 0-d tensors."""
    rte = torch.linalg.norm(T_pred[:3, 3] - T_gt[:3, 3])
    rre = torch.rad2deg(rotation_error(T_pred[:3, :3], T_gt[:3, :3]))
    return (rte < rte_thresh) & (rre < rre_thresh_deg), rte, rre


def corr_dist(est: torch.Tensor, gth: torch.Tensor, xyz0: torch.Tensor,
              weight: torch.Tensor | None = None, max_dist: float = 1.0,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean clipped distance between points under two transforms (metrics.py:53-59)."""
    a = torch.matmul(xyz0, est[:3, :3].T) + est[:3, 3]
    b = torch.matmul(xyz0, gth[:3, :3].T) + gth[:3, 3]
    d = torch.clamp(torch.sqrt(torch.sum((a - b) ** 2, dim=1)), max=max_dist)
    if weight is not None:
        d = d * weight
    if mask is None:
        return torch.mean(d)
    m = mask.to(torch.float32)
    return torch.sum(d * m) / torch.clamp(torch.sum(m), min=1.0)


def pdist(A: torch.Tensor, B: torch.Tensor, dist_type: str = "L2") -> torch.Tensor:
    """Dense pairwise distances (metrics.py:62-69). Prefer ops/knn.py for large N."""
    d2 = torch.sum(A ** 2, 1)[:, None] - 2 * torch.matmul(A, B.T) \
        + torch.sum(B ** 2, 1)[None, :]
    d2 = torch.clamp(d2, min=0.0)
    if dist_type == "L2":
        return torch.sqrt(d2 + 1e-7)
    if dist_type == "SquareL2":
        return d2
    raise NotImplementedError(dist_type)
