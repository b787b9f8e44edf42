"""SE(3) parameterization and transform utilities (batched, full f32).

Counterpart of the JAX package's ``ops/se3.py``. Matmuls run in full f32:
``utils.device.set_precision`` keeps TF32 off, as the JAX package pins
``Precision.HIGHEST`` for geometry.
"""

from __future__ import annotations

import math

import torch


def ortho2rotation(poses: torch.Tensor) -> torch.Tensor:
    """6D rotation parameters [B, 6] -> rotation matrices [B, 3, 3] by
    Gram-Schmidt (columns x, y, z = x cross y)."""
    def normalize(v):
        mag = torch.sqrt(torch.sum(v ** 2, dim=1, keepdim=True))
        return v / torch.clamp(mag, min=1e-8)

    x_raw = poses[:, 0:3]
    y_raw = poses[:, 3:6]
    x = normalize(x_raw)
    inner = torch.sum(x * y_raw, dim=1, keepdim=True)
    norm2 = torch.clamp(torch.sum(x ** 2, dim=1, keepdim=True), min=1e-8)
    y = normalize(y_raw - (inner / norm2) * x)
    z = torch.linalg.cross(x, y, dim=1)
    return torch.stack([x, y, z], dim=2)


def rotation_to_rot6d(R: torch.Tensor) -> torch.Tensor:
    """First two columns of R -> [..., 6]."""
    return torch.cat([R[..., :, 0], R[..., :, 1]], dim=-1)


def apply_transform(xyz: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 (or 3x4) transform to [..., N, 3] points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.matmul(xyz, R.transpose(-1, -2)) + t[..., None, :]


def rt_to_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] + translation [..., 3] -> [..., 4, 4]."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def matrix_inverse_se3(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of rigid transforms [..., 4, 4]: (R^T, -R^T t)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return rt_to_matrix(Rt, -torch.matmul(Rt, T[..., :3, 3, None])[..., 0])


def random_rotation(generator: torch.Generator,
                    rotation_range_deg: float = 360.0) -> torch.Tensor:
    """A rotation [3, 3] about a uniformly drawn axis by an angle uniform in
    +/- range / 2 (Rodrigues' formula; the JAX package draws from a key,
    this from ``generator``, on its device)."""
    dev = generator.device
    axis = torch.randn(3, generator=generator, device=dev)
    axis = axis / torch.clamp(torch.linalg.norm(axis), min=1e-8)
    angle = (torch.rand((), generator=generator, device=dev) - 0.5) \
        * math.radians(rotation_range_deg)
    zero = torch.zeros((), device=dev)
    K = torch.stack([torch.stack([zero, -axis[2], axis[1]]),
                     torch.stack([axis[2], zero, -axis[0]]),
                     torch.stack([-axis[1], axis[0], zero])])
    return (torch.eye(3, device=dev) + torch.sin(angle) * K
            + (1 - torch.cos(angle)) * torch.matmul(K, K))
