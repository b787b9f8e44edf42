"""Residual sparse U-Nets: the ResUNet families.

Counterpart of the JAX package's ``models/resunet.py``, one engine for five
families:

- "v1_3" / "v1_4" (ResUNet, ResUNet2): encoder conv -> norm -> block (the
  block's output is the skip) -> relu; decoder conv_tr -> norm -> block ->
  relu -> concat(skip).
- "v2" (ResUNet2v2): relu before the block stack on both sides, blocks are
  Sequential stacks (``block1.0.conv1.kernel``), kaiming fan-out init.
- "sp3" (ResUNetSP): k2/s2 sum pooling then a k1 conv going down; going up
  the pooling transpose then a k1 conv at stage L, a k1 conv then the
  pooling transpose at the inner stages (the reference's order).
- "sp4" (ResUNet2SP): sum pooling then a k3 stride-1 conv going down,
  strided conv_tr going up.

Every family ends in conv1_tr (k1) -> relu -> final (k1, bias), with the
optional feature normalisation ``x / (sqrt(max(sum x^2, 1e-24)) + 1e-8)``
in f32. Works in 3D (FCGF) and 6D (inlier net).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..ops import kernel_map
from ..ops import sparse_conv as sc
from . import common, residual_block
from .unet_plan import UNetPlan


@dataclasses.dataclass(frozen=True)
class ResUNetConfig:
    name: str
    family: str  # v1_3 | v1_4 | v2 | sp3 | sp4
    norm_type: str
    channels: Tuple[int, ...]
    tr_channels: Tuple[int, ...]
    block_norm_type: str = "BN"
    depths: Tuple[int, ...] = ()  # block-stack depth per level (v2 / SP)
    region_type: int = kernel_map.HYPER_CUBE
    in_channels: int = 1
    out_channels: int = 32
    conv1_kernel_size: int = 3
    normalize_feature: bool = False
    D: int = 3

    @property
    def levels(self) -> int:
        return len(self.channels) - 1

    @property
    def with_pooling(self) -> bool:
        return self.family.startswith("sp")


_C3 = dict(channels=(0, 32, 64, 128), tr_channels=(0, 32, 64, 64))
_C4 = (0, 32, 64, 128, 256)
_VARIANTS = {
    # 3-level v1
    "ResUNetBN": dict(_C3, family="v1_3", norm_type="BN"),
    "ResUNetBNF": dict(family="v1_3", norm_type="BN", channels=(0, 16, 32, 64),
                       tr_channels=(0, 16, 32, 64)),
    "ResUNetBNFX": dict(family="v1_3", norm_type="BN", channels=(0, 16, 32, 64),
                        tr_channels=(0, 16, 32, 64),
                        region_type=kernel_map.HYPER_CROSS),
    # 4-level v1
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
    # v2: one block a level
    "ResUNetBN2v2": dict(family="v2", norm_type="BN", channels=_C4,
                         tr_channels=(0, 32, 64, 64, 128), depths=(1,) * 8),
    "ResUNetBN2Bv2": dict(family="v2", norm_type="BN", channels=_C4,
                          tr_channels=(0, 64, 64, 64, 64), depths=(1,) * 8),
    "ResUNetBN2Cv2": dict(family="v2", norm_type="BN", channels=_C4,
                          tr_channels=(0, 64, 64, 64, 128), depths=(1,) * 8),
    "ResUNetBN2Dv2": dict(family="v2", norm_type="BN", channels=_C4,
                          tr_channels=(0, 64, 64, 128, 128), depths=(1,) * 8),
    "ResUNetBN2Ev2": dict(family="v2", norm_type="BN", channels=(0, 128, 128, 128, 256),
                          tr_channels=(0, 64, 128, 128, 128), depths=(1,) * 8),
    "ResUNetBN2Fv2": dict(family="v2", norm_type="BN", channels=(0, 16, 32, 64, 128),
                          tr_channels=(0, 16, 32, 64, 128), depths=(1,) * 8),
    # SP: sum pooling down, pooling transpose (sp3) or strided conv_tr (sp4) up
    "ResUNetSP": dict(_C3, family="sp3", norm_type="BN", depths=(1,) * 6),
    "ResUNetBNSPC": dict(_C3, family="sp3", norm_type="BN", depths=(1,) * 6,
                         region_type=kernel_map.HYPER_CROSS),
    "ResUNetINBNSPC": dict(_C3, family="sp3", norm_type="INBN", depths=(1,) * 6,
                           region_type=kernel_map.HYPER_CROSS),
    "ResUNet2SP": dict(family="sp4", norm_type="BN", channels=_C4,
                       tr_channels=(0, 64, 64, 64, 128), depths=(1,) * 8),
    "ResUNetBN2SPC": dict(family="sp4", norm_type="BN", channels=_C4,
                          tr_channels=(0, 64, 64, 64, 128), depths=(1,) * 8),
    "ResUNetBN2SPCX": dict(family="sp4", norm_type="BN", channels=_C4,
                           tr_channels=(0, 64, 64, 64, 128), depths=(1,) * 8,
                           region_type=kernel_map.HYPER_CROSS),
}
_VARIANTS["ResUNetBN2CX"] = dict(_VARIANTS["ResUNetBN2C"],
                                 region_type=kernel_map.HYPER_CROSS)
_VARIANTS["ResUNetBN2FX"] = dict(_VARIANTS["ResUNetBN2F"],
                                 region_type=kernel_map.HYPER_CROSS)


def make_config(name: str, in_channels: int, out_channels: int,
                conv1_kernel_size: int = 3, normalize_feature: bool = False,
                D: int = 3) -> ResUNetConfig:
    if name not in _VARIANTS:
        raise ValueError(f"unknown ResUNet variant {name}")
    return ResUNetConfig(name=name, in_channels=in_channels,
                         out_channels=out_channels,
                         conv1_kernel_size=conv1_kernel_size,
                         normalize_feature=normalize_feature, D=D,
                         **_VARIANTS[name])


def _kvol(cfg: ResUNetConfig, ks: int) -> int:
    return kernel_map.kernel_offsets(ks, cfg.D, cfg.region_type).shape[0]


def _depth(cfg: ResUNetConfig, name: str) -> int:
    """Blocks in the stack ``name`` (block{i} or block{i}_tr: depths[i])."""
    if not cfg.depths:
        return 1
    i = int(name[len("block"):].replace("_tr", ""))
    return cfg.depths[min(i, len(cfg.depths) - 1)]


def _layout(cfg: ResUNetConfig):
    """(name, Cin, Cout, kernel volume) of every conv but the k1 tail, the
    (name suffix, C) of every norm-and-block stage, and the k3 volume."""
    C, TR, L = cfg.channels, cfg.tr_channels, cfg.levels
    k3, k1 = _kvol(cfg, 3), _kvol(cfg, cfg.conv1_kernel_size)
    kin = 1 if cfg.family == "sp3" else k3  # sp3's inner convs are k1
    convs = [("conv1", cfg.in_channels, C[1], k1)]
    stages = [("1", C[1])]
    for i in range(2, L + 1):
        convs.append((f"conv{i}", C[i - 1], C[i], kin))
        stages.append((f"{i}", C[i]))
    for i in range(L, 1, -1):
        convs.append((f"conv{i}_tr", C[L] if i == L else C[i] + TR[i + 1], TR[i], kin))
        stages.append((f"{i}_tr", TR[i]))
    return convs, stages, k3


class ResUNet(common.Net):
    """The network; parameter names follow the JAX package's trees."""

    def __init__(self, cfg: ResUNetConfig):
        super().__init__()
        self.cfg = cfg
        C, TR = cfg.channels, cfg.tr_channels
        folded = cfg.norm_type == "NONE"
        stacked = cfg.family in ("v2", "sp3", "sp4")
        convs, stages, k3 = _layout(cfg)
        for name, cin, cout, kv in convs:
            self.add_module(name, common.Conv(kv, cin, cout, bias=folded))
        for sfx, c in stages:
            self.add_module(f"norm{sfx}", common.Norm(cfg.norm_type, c))
            block = (residual_block.BlockStack(_depth(cfg, f"block{sfx}"),
                                               cfg.block_norm_type, c, k3)
                     if stacked else
                     residual_block.BasicBlock(cfg.block_norm_type, c, k3))
            self.add_module(f"block{sfx}", block)
        self.conv1_tr = common.Conv(1, C[1] + TR[2], TR[1])
        self.final = common.Conv(1, TR[1], cfg.out_channels, bias=True)

    @torch.no_grad()
    def forward(self, plan: UNetPlan, feats: torch.Tensor) -> torch.Tensor:
        """feats [N_0, Cin] in the compute dtype -> [N_0, out_channels]."""
        L, fam = self.cfg.levels, self.cfg.family
        m = self._modules
        skips = []
        out = feats
        for i in range(1, L + 1):
            lvl = i - 1
            seg = plan.seg(lvl)
            if i == 1:
                out = common.first_conv(m["conv1"], plan, out)
            elif fam in ("sp3", "sp4"):
                out = sc.sparse_sum_pool(out, plan.pool_downs[i - 2])
                out = m[f"conv{i}"](out, None if fam == "sp3" else plan.selfs[lvl])
            else:
                out = m[f"conv{i}"](out, plan.downs[i - 2])
            out = m[f"norm{i}"](out, seg)
            if fam == "v2":
                out = m[f"block{i}"](sc.relu(out), plan.selfs[lvl], seg)
                skips.append(out)
            else:
                out = m[f"block{i}"](out, plan.selfs[lvl], seg)
                skips.append(out)
                out = sc.relu(out)
        for i in range(L, 1, -1):
            lvl = i - 2
            seg = plan.seg(lvl)
            conv = m[f"conv{i}_tr"]
            if fam == "sp3" and i == L:
                out = conv(sc.sparse_sum_pool(out, plan.pool_ups[lvl]), None)
            elif fam == "sp3":
                out = sc.sparse_sum_pool(conv(out, None), plan.pool_ups[lvl])
            else:
                out = conv(out, plan.ups[lvl])
            out = m[f"norm{i}_tr"](out, seg)
            if fam in ("v2", "sp3", "sp4"):
                out = m[f"block{i}_tr"](sc.relu(out), plan.selfs[lvl], seg)
            else:
                out = sc.relu(m[f"block{i}_tr"](out, plan.selfs[lvl], seg))
            out = torch.cat([out, skips[lvl]], dim=-1)
        out = sc.relu(self.conv1_tr(out, None))
        out = self.final(out, None)
        if self.cfg.normalize_feature:
            out = out.float()
            n2 = torch.sum(out * out, dim=-1, keepdim=True)
            out = out / (torch.sqrt(torch.clamp(n2, min=1e-24)) + 1e-8)
        return out


def init_params(gen: torch.Generator, cfg: ResUNetConfig):
    """Random (params, state) trees in the JAX package's layout, with the
    distribution of its ``resunet.init`` (kaiming fan-in, fan-out for v2;
    identity BN)."""
    C, TR = cfg.channels, cfg.tr_channels
    fan = "out" if cfg.family == "v2" else "in"
    stacked = cfg.family in ("v2", "sp3", "sp4")
    convs, stages, k3 = _layout(cfg)
    params, state = {}, {}
    for name, cin, cout, kv in convs:
        params[name] = common.init_conv(gen, kv, cin, cout, fan=fan)
    for sfx, c in stages:
        params[f"norm{sfx}"], state[f"norm{sfx}"] = common.init_norm(cfg.norm_type, c)
        name = f"block{sfx}"
        if stacked:
            params[name], state[name] = {}, {}
            for d in range(_depth(cfg, name)):
                params[name][str(d)], state[name][str(d)] = residual_block.init_block(
                    gen, cfg.block_norm_type, c, k3, fan=fan)
        else:
            params[name], state[name] = residual_block.init_block(
                gen, cfg.block_norm_type, c, k3, fan=fan)
    params["conv1_tr"] = common.init_conv(gen, 1, C[1] + TR[2], TR[1], fan=fan)
    params["final"] = common.init_conv(gen, 1, TR[1], cfg.out_channels, bias=True,
                                       fan=fan)
    return params, state
