"""Building blocks: sparse conv and norm modules, and parameter initialisation.

Counterpart of the JAX package's ``models/common.py``. Parameter names mirror
MinkowskiEngine's state_dict (``conv.kernel`` [K, Cin, Cout], ``conv.bias``,
``norm.weight``/``norm.bias`` with running statistics ``norm.mean``/
``norm.var``), so the JAX package's trees convert by flattening
(``utils/convert.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import sparse_conv as sc
from ..ops.edge_conv import EdgeMap

Tree = Dict[str, Any]


class Conv(nn.Module):
    """Sparse convolution weights [K, Cin, Cout] (+ bias)."""

    def __init__(self, k: int, cin: int, cout: int, bias: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(k, cin, cout), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False) \
            if bias else None

    def forward(self, feats: torch.Tensor, em: EdgeMap | None) -> torch.Tensor:
        """em None = kernel size 1 on the input's own grid."""
        if em is None:
            return sc.linear(feats, self.kernel, self.bias)
        return sc.sparse_conv(feats, self.kernel, em, self.bias)


class Norm(nn.Module):
    """Inference BatchNorm ('BN') or nothing ('NONE', folded into the conv)."""

    def __init__(self, norm_type: str, c: int):
        super().__init__()
        if norm_type not in ("BN", "NONE"):
            raise NotImplementedError(f"norm type {norm_type} is not ported yet")
        self.enabled = norm_type == "BN"
        if self.enabled:
            self.weight = nn.Parameter(torch.ones(c), requires_grad=False)
            self.bias = nn.Parameter(torch.zeros(c), requires_grad=False)
            self.register_buffer("mean", torch.zeros(c))
            self.register_buffer("var", torch.ones(c))

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        if not self.enabled:
            return feats
        return sc.batch_norm_infer(feats, self.weight, self.bias, self.mean, self.var)


def init_conv(gen: torch.Generator, k: int, cin: int, cout: int,
              bias: bool = False) -> Tree:
    """Kaiming-normal fan-in init (the JAX package's ``init_conv``: std
    sqrt(2 / (K * Cin))), drawn from ``gen``."""
    std = (2.0 / (k * cin)) ** 0.5
    p = {"kernel": (torch.randn((k, cin, cout), generator=gen) * std).numpy()}
    if bias:
        p["bias"] = np.zeros((cout,), np.float32)
    return p


def init_norm(norm_type: str, c: int) -> Tuple[Tree, Tree]:
    if norm_type == "BN":
        return ({"weight": np.ones((c,), np.float32), "bias": np.zeros((c,), np.float32)},
                {"mean": np.zeros((c,), np.float32), "var": np.ones((c,), np.float32)})
    raise NotImplementedError(f"norm type {norm_type} is not ported yet")
