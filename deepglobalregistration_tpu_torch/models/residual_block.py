"""Residual block over sparse features (the JAX package's
``models/residual_block.py``): conv(k3) - norm - relu - conv(k3) - norm -
(+ skip) - relu, both convs on one stride-1 map."""

from __future__ import annotations

import torch
from torch import nn

from ..ops import sparse_conv as sc
from ..ops.edge_conv import EdgeMap
from . import common


class BasicBlock(nn.Module):
    def __init__(self, norm_type: str, c: int, kernel_volume: int):
        super().__init__()
        folded = norm_type == "NONE"
        self.conv1 = common.Conv(kernel_volume, c, c, bias=folded)
        self.norm1 = common.Norm(norm_type, c)
        self.conv2 = common.Conv(kernel_volume, c, c, bias=folded)
        self.norm2 = common.Norm(norm_type, c)

    def forward(self, feats: torch.Tensor, em: EdgeMap) -> torch.Tensor:
        out = sc.relu(self.norm1(self.conv1(feats, em)))
        out = self.norm2(self.conv2(out, em))
        return sc.relu(out + feats)


def init_block(gen: torch.Generator, norm_type: str, c: int, kernel_volume: int):
    n1p, n1s = common.init_norm(norm_type, c)
    n2p, n2s = common.init_norm(norm_type, c)
    params = {"conv1": common.init_conv(gen, kernel_volume, c, c), "norm1": n1p,
              "conv2": common.init_conv(gen, kernel_volume, c, c), "norm2": n2p}
    return params, {"norm1": n1s, "norm2": n2s}
