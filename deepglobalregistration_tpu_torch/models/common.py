"""Building blocks: sparse conv and norm modules, and parameter initialisation.

Counterpart of the JAX package's ``models/common.py``. Parameter names mirror
MinkowskiEngine's state_dict (``conv.kernel`` [K, Cin, Cout], ``conv.bias``,
``norm.weight``/``norm.bias`` with running statistics ``norm.mean``/
``norm.var``), so the JAX package's trees convert by flattening
(``utils/convert.py``).

The modules follow PyTorch's conventions: parameters are trainable and a
norm reads ``nn.Module.training`` (batch statistics in train mode, running
statistics in eval mode; the JAX package's ``apply_norm(train=...)``).
Inference runs eval-mode nets under ``torch.no_grad()``
(``core/pipeline.build_net`` also freezes their parameters).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import sparse_conv as sc
from ..ops.edge_conv import EdgeMap

Tree = Dict[str, Any]
NORM_TYPES = ("BN", "IN", "INBN", "NONE")


class Net(nn.Module):
    """Base of the model families: ``cfg``, the norms' momentum and the
    weight rounding."""

    def set_bn_momentum(self, momentum: float) -> None:
        """The running-statistics momentum of every norm (``cfg.bn_momentum``)."""
        for m in self.modules():
            if isinstance(m, Norm):
                m.momentum = float(momentum)

    def set_bn_group(self, group) -> None:
        """The process group over which every train-mode BN takes its batch
        statistics (None: this process's rows alone); data-parallel
        training sets it to its mesh's group."""
        for m in self.modules():
            if isinstance(m, Norm):
                m.group = group

    def round_weights(self, dtype: torch.dtype) -> None:
        """Round every weight to ``dtype`` (kept in f32 storage): the convs
        then compute exactly as on bf16 weights with f32 accumulation."""
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(p.to(dtype).float())


class Conv(nn.Module):
    """Sparse convolution weights [K, Cin, Cout] (+ bias)."""

    def __init__(self, k: int, cin: int, cout: int, bias: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(k, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, feats: torch.Tensor, em: EdgeMap | None) -> torch.Tensor:
        """em None = kernel size 1 on the input's own grid."""
        if em is None:
            return sc.linear(feats, self.kernel, self.bias)
        return sc.sparse_conv(feats, self.kernel, em, self.bias)


def first_conv(conv: Conv, plan, feats: torch.Tensor) -> torch.Tensor:
    """A net's first conv on level 0: the occupancy product when the plan was
    built for an all-ones input, else the conv over the plan's conv1 map."""
    if plan.conv1_ones is not None:
        return sc.conv1_ones(plan.conv1_ones, conv.kernel, conv.bias, feats.dtype)
    return conv(feats, plan.conv1)


class Norm(nn.Module):
    """'BN', 'IN' (per cloud, no parameters), 'INBN' (IN then BN) or 'NONE'
    (a BN folded into the conv before it). ``seg`` = (cloud index of each
    row, clouds), for IN. BN in train mode normalises with the statistics
    of every row of the batch (all clouds, MinkowskiEngine's semantics) and
    updates ``mean``/``var`` with ``momentum``; in eval mode it reads them.
    ``group`` (``Net.set_bn_group``) makes the train-mode statistics those
    of every rank's rows; eval-mode BN and IN stay local."""

    def __init__(self, norm_type: str, c: int):
        super().__init__()
        if norm_type not in NORM_TYPES:
            raise ValueError(f"norm type {norm_type} not defined")
        self.instance = norm_type in ("IN", "INBN")
        self.batch = norm_type in ("BN", "INBN")
        self.momentum = 0.1  # Net.set_bn_momentum sets cfg.bn_momentum
        self.group = None  # Net.set_bn_group
        if self.batch:
            self.weight = nn.Parameter(torch.ones(c))
            self.bias = nn.Parameter(torch.zeros(c))
            self.register_buffer("mean", torch.zeros(c))
            self.register_buffer("var", torch.ones(c))

    def forward(self, feats: torch.Tensor, seg) -> torch.Tensor:
        if self.instance:
            feats = sc.instance_norm(feats, *seg)
        if self.batch and self.training:
            feats, mean, var = sc.batch_norm_train(
                feats, self.weight, self.bias, self.mean, self.var, self.momentum,
                group=self.group)
            with torch.no_grad():
                self.mean.copy_(mean)
                self.var.copy_(var)
        elif self.batch:
            feats = sc.batch_norm_infer(feats, self.weight, self.bias, self.mean,
                                        self.var)
        return feats


def act(kind: str, feats: torch.Tensor) -> torch.Tensor:
    """The reference's ``get_nonlinearity``: ReLU or ELU."""
    if kind == "ReLU":
        return sc.relu(feats)
    if kind == "ELU":
        return sc.elu(feats)
    raise ValueError(f"nonlinearity {kind} not defined")


def init_conv(gen: torch.Generator, k: int, cin: int, cout: int,
              bias: bool = False, fan: str = "in") -> Tree:
    """Kaiming-normal init, drawn from ``gen``: std sqrt(2 / (K * Cin))
    (fan "in", MinkowskiEngine's default) or sqrt(2 / (K * Cout)) (fan
    "out", the v2 family's), as the JAX package's ``init_conv``."""
    std = (2.0 / (k * (cin if fan == "in" else cout))) ** 0.5
    p = {"kernel": (torch.randn((k, cin, cout), generator=gen) * std).numpy()}
    if bias:
        p["bias"] = np.zeros((cout,), np.float32)
    return p


def init_norm(norm_type: str, c: int) -> Tuple[Tree, Tree]:
    """(params, state) of a norm: identity BN for 'BN' and 'INBN', empty
    trees for 'IN' and 'NONE'."""
    if norm_type in ("BN", "INBN"):
        return ({"weight": np.ones((c,), np.float32), "bias": np.zeros((c,), np.float32)},
                {"mean": np.zeros((c,), np.float32), "var": np.ones((c,), np.float32)})
    if norm_type in ("IN", "NONE"):
        return {}, {}
    raise ValueError(f"norm type {norm_type} not defined")
