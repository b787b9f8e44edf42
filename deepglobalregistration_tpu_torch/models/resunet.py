"""Residual sparse U-Nets of the v1 family (ResUNet / ResUNet2).

Counterpart of the JAX package's ``models/resunet.py:80-81, 209-311`` for
the "v1_3" and "v1_4" families: encoder conv -> norm -> block (the block's
output is the skip) -> relu; decoder conv_tr -> norm -> block -> relu ->
concat(skip); tail conv1_tr (k1) -> relu -> final (k1, bias); optional
feature normalisation ``x / (sqrt(max(sum x^2, 1e-24)) + 1e-8)`` in f32.
Works in 3D (FCGF) and 6D (inlier net). The v2 and SP families are not on
this slice's path.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from ..ops import kernel_map
from ..ops import sparse_conv as sc
from . import common, residual_block
from .unet_plan import UNetPlan


@dataclasses.dataclass(frozen=True)
class ResUNetConfig:
    name: str
    family: str  # v1_3 | v1_4
    norm_type: str
    channels: Tuple[int, ...]
    tr_channels: Tuple[int, ...]
    block_norm_type: str = "BN"
    region_type: int = kernel_map.HYPER_CUBE
    in_channels: int = 1
    out_channels: int = 32
    conv1_kernel_size: int = 3
    normalize_feature: bool = False
    D: int = 3

    @property
    def levels(self) -> int:
        return len(self.channels) - 1


_C3 = dict(channels=(0, 32, 64, 128), tr_channels=(0, 32, 64, 64))
_C4 = (0, 32, 64, 128, 256)
_VARIANTS = {
    "ResUNetBN": dict(_C3, family="v1_3", norm_type="BN"),
    "ResUNetBNF": dict(family="v1_3", norm_type="BN", channels=(0, 16, 32, 64),
                       tr_channels=(0, 16, 32, 64)),
    "ResUNetBNFX": dict(family="v1_3", norm_type="BN", channels=(0, 16, 32, 64),
                        tr_channels=(0, 16, 32, 64),
                        region_type=kernel_map.HYPER_CROSS),
    "ResUNetBN2": dict(family="v1_4", norm_type="BN", channels=_C4,
                       tr_channels=(0, 32, 64, 64, 128)),
    "ResUNetBN2B": dict(family="v1_4", norm_type="BN", channels=_C4,
                        tr_channels=(0, 64, 64, 64, 64)),
    "ResUNetBN2C": dict(family="v1_4", norm_type="BN", channels=_C4,
                        tr_channels=(0, 64, 64, 64, 128)),
    "ResUNetBN2D": dict(family="v1_4", norm_type="BN", channels=_C4,
                        tr_channels=(0, 64, 64, 128, 128)),
    "ResUNetBN2E": dict(family="v1_4", norm_type="BN", channels=(0, 128, 128, 128, 256),
                        tr_channels=(0, 64, 128, 128, 128)),
    "ResUNetBN2F": dict(family="v1_4", norm_type="BN", channels=(0, 16, 32, 64, 128),
                        tr_channels=(0, 16, 32, 64, 128)),
}
_VARIANTS["ResUNetBN2CX"] = dict(_VARIANTS["ResUNetBN2C"],
                                 region_type=kernel_map.HYPER_CROSS)
_VARIANTS["ResUNetBN2FX"] = dict(_VARIANTS["ResUNetBN2F"],
                                 region_type=kernel_map.HYPER_CROSS)


def make_config(name: str, in_channels: int, out_channels: int,
                conv1_kernel_size: int = 3, normalize_feature: bool = False,
                D: int = 3) -> ResUNetConfig:
    if name not in _VARIANTS:
        raise NotImplementedError(f"model {name} is not ported yet; ported: "
                                  f"{sorted(_VARIANTS)}")
    return ResUNetConfig(name=name, in_channels=in_channels,
                         out_channels=out_channels,
                         conv1_kernel_size=conv1_kernel_size,
                         normalize_feature=normalize_feature, D=D,
                         **_VARIANTS[name])


def _kvol(cfg: ResUNetConfig, ks: int) -> int:
    return kernel_map.kernel_offsets(ks, cfg.D, cfg.region_type).shape[0]


class ResUNet(nn.Module):
    """The network; parameter names follow the JAX package's trees."""

    def __init__(self, cfg: ResUNetConfig):
        super().__init__()
        self.cfg = cfg
        C, TR, L = cfg.channels, cfg.tr_channels, cfg.levels
        k3, k1 = _kvol(cfg, 3), _kvol(cfg, cfg.conv1_kernel_size)
        folded = cfg.norm_type == "NONE"

        def add(name, module):
            self.add_module(name, module)

        add("conv1", common.Conv(k1, cfg.in_channels, C[1], bias=folded))
        add("norm1", common.Norm(cfg.norm_type, C[1]))
        add("block1", residual_block.BasicBlock(cfg.block_norm_type, C[1], k3))
        for i in range(2, L + 1):
            add(f"conv{i}", common.Conv(k3, C[i - 1], C[i], bias=folded))
            add(f"norm{i}", common.Norm(cfg.norm_type, C[i]))
            add(f"block{i}", residual_block.BasicBlock(cfg.block_norm_type, C[i], k3))
        for i in range(L, 1, -1):
            cin = C[L] if i == L else C[i] + TR[i + 1]
            add(f"conv{i}_tr", common.Conv(k3, cin, TR[i], bias=folded))
            add(f"norm{i}_tr", common.Norm(cfg.norm_type, TR[i]))
            add(f"block{i}_tr", residual_block.BasicBlock(cfg.block_norm_type, TR[i], k3))
        add("conv1_tr", common.Conv(1, C[1] + TR[2], TR[1]))
        add("final", common.Conv(1, TR[1], cfg.out_channels, bias=True))

    def round_weights(self, dtype: torch.dtype) -> None:
        """Round every weight to ``dtype`` (kept in f32 storage): the convs
        then compute exactly as on bf16 weights with f32 accumulation."""
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(p.to(dtype).float())

    @torch.no_grad()
    def forward(self, plan: UNetPlan, feats: torch.Tensor) -> torch.Tensor:
        """feats [N_0, Cin] in the compute dtype -> [N_0, out_channels]."""
        L = self.cfg.levels
        m = self._modules
        skips = []
        out = feats
        for i in range(1, L + 1):
            lvl = i - 1
            if i == 1:
                if plan.conv1_ones is not None:
                    out = sc.conv1_ones(plan.conv1_ones, m["conv1"].kernel,
                                        m["conv1"].bias, feats.dtype)
                else:
                    out = m["conv1"](out, plan.conv1)
            else:
                out = m[f"conv{i}"](out, plan.downs[i - 2])
            out = m[f"block{i}"](m[f"norm{i}"](out), plan.selfs[lvl])
            skips.append(out)
            out = sc.relu(out)
        for i in range(L, 1, -1):
            lvl = i - 2
            out = m[f"norm{i}_tr"](m[f"conv{i}_tr"](out, plan.ups[lvl]))
            out = sc.relu(m[f"block{i}_tr"](out, plan.selfs[lvl]))
            out = torch.cat([out, skips[lvl]], dim=-1)
        out = sc.relu(m["conv1_tr"](out, None))
        out = m["final"](out, None)
        if self.cfg.normalize_feature:
            out = out.float()
            n2 = torch.sum(out * out, dim=-1, keepdim=True)
            out = out / (torch.sqrt(torch.clamp(n2, min=1e-24)) + 1e-8)
        return out


def init_params(gen: torch.Generator, cfg: ResUNetConfig):
    """Random (params, state) trees in the JAX package's layout, with the
    distribution of its ``resunet.init`` (kaiming fan-in, BN identity)."""
    C, TR, L = cfg.channels, cfg.tr_channels, cfg.levels
    k3, k1 = _kvol(cfg, 3), _kvol(cfg, cfg.conv1_kernel_size)
    params, state = {}, {}

    def norm(name, c):
        params[name], state[name] = common.init_norm(cfg.norm_type, c)

    def block(name, c):
        params[name], state[name] = residual_block.init_block(
            gen, cfg.block_norm_type, c, k3)

    params["conv1"] = common.init_conv(gen, k1, cfg.in_channels, C[1])
    norm("norm1", C[1])
    block("block1", C[1])
    for i in range(2, L + 1):
        params[f"conv{i}"] = common.init_conv(gen, k3, C[i - 1], C[i])
        norm(f"norm{i}", C[i])
        block(f"block{i}", C[i])
    for i in range(L, 1, -1):
        cin = C[L] if i == L else C[i] + TR[i + 1]
        params[f"conv{i}_tr"] = common.init_conv(gen, k3, cin, TR[i])
        norm(f"norm{i}_tr", TR[i])
        block(f"block{i}_tr", TR[i])
    params["conv1_tr"] = common.init_conv(gen, 1, C[1] + TR[2], TR[1])
    params["final"] = common.init_conv(gen, 1, TR[1], cfg.out_channels, bias=True)
    return params, state
