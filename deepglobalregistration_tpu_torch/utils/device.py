"""Device policy, matmul precision and random generators for the port.

Entry points run on the card unless the caller asks for the CPU: a default
``"cuda"`` request without a visible card raises instead of falling back.
Geometry runs in full float32 (the JAX package pins ``Precision.HIGHEST``
there), so TF32 is switched off for both cuBLAS and cuDNN.
"""

from __future__ import annotations

import torch


def set_precision() -> None:
    """Full-f32 matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return the requested device; raise if it is CUDA and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run the plain PyTorch versions")
    set_precision()
    return dev


def generator(seed: int, device: str | torch.device = "cpu") -> torch.Generator:
    """A seeded generator on the given device."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g
