"""SimpleNet family: non-residual sparse U-Nets of three depths.

Counterpart of the JAX package's ``models/simpleunet.py``. Encoder: conv
(stride 2 past level 1) -> norm, the norm's output is the skip, then relu.
Decoder: conv_tr -> norm -> relu -> concat(skip). Tail: conv1_tr (k3, its
own norm) -> relu -> final (k1, bias). The feature normalisation is this
family's own, ``x / max(sqrt(max(sum x^2, 1e-24)), 1e-12)`` in the compute
dtype.

Depths: SimpleNet (3 levels: IN, BN, BNE, INE), SimpleNet2 (4: IN2, BN2,
BN2B-E, IN2E) and SimpleNet3 (5: IN3, BN3, BN3B-E, IN3E).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..ops import kernel_map
from ..ops import sparse_conv as sc
from . import common
from .unet_plan import UNetPlan


@dataclasses.dataclass(frozen=True)
class SimpleNetConfig:
    name: str
    norm_type: str
    channels: Tuple[int, ...]  # (0, c1, .., cL)
    tr_channels: Tuple[int, ...]
    in_channels: int = 1
    out_channels: int = 32
    conv1_kernel_size: int = 3
    normalize_feature: bool = False
    D: int = 3
    bn_momentum: float = 0.1  # running statistics (train-mode BN)
    region_type: int = kernel_map.HYPER_CUBE

    @property
    def levels(self) -> int:
        return len(self.channels) - 1

    @property
    def with_pooling(self) -> bool:
        return False


_BASE1 = dict(channels=(0, 32, 64, 128), tr_channels=(0, 32, 32, 64))
_BASE1E = dict(channels=(0, 16, 32, 32), tr_channels=(0, 16, 16, 32))
_BASE2 = dict(channels=(0, 32, 64, 128, 256), tr_channels=(0, 32, 32, 64, 64))
_BASE3 = dict(channels=(0, 32, 64, 128, 256, 512), tr_channels=(0, 32, 32, 64, 64, 128))
_C2 = (0, 32, 64, 128, 256)
_C3 = (0, 32, 64, 128, 256, 512)

_VARIANTS = {
    "SimpleNetIN": dict(_BASE1, norm_type="IN"),
    "SimpleNetBN": dict(_BASE1, norm_type="BN"),
    "SimpleNetBNE": dict(_BASE1E, norm_type="BN"),
    "SimpleNetINE": dict(_BASE1E, norm_type="IN"),
    "SimpleNetIN2": dict(_BASE2, norm_type="IN"),
    "SimpleNetBN2": dict(_BASE2, norm_type="BN"),
    "SimpleNetBN2B": dict(norm_type="BN", channels=_C2, tr_channels=(0, 64, 64, 64, 64)),
    "SimpleNetBN2C": dict(norm_type="BN", channels=_C2, tr_channels=(0, 32, 64, 64, 128)),
    "SimpleNetBN2D": dict(norm_type="BN", channels=_C2, tr_channels=(0, 32, 64, 64, 128)),
    "SimpleNetBN2E": dict(norm_type="BN", channels=(0, 16, 32, 64, 128),
                          tr_channels=(0, 16, 32, 32, 64)),
    "SimpleNetIN2E": dict(norm_type="IN", channels=(0, 16, 32, 64, 128),
                          tr_channels=(0, 16, 32, 32, 64)),
    "SimpleNetIN3": dict(_BASE3, norm_type="IN"),
    "SimpleNetBN3": dict(_BASE3, norm_type="BN"),
    "SimpleNetBN3B": dict(norm_type="BN", channels=_C3,
                          tr_channels=(0, 64, 64, 64, 64, 128)),
    "SimpleNetBN3C": dict(norm_type="BN", channels=_C3,
                          tr_channels=(0, 32, 64, 64, 128, 128)),
    "SimpleNetBN3D": dict(norm_type="BN", channels=_C3,
                          tr_channels=(0, 32, 64, 64, 128, 128)),
    "SimpleNetBN3E": dict(norm_type="BN", channels=(0, 16, 32, 64, 128, 256),
                          tr_channels=(0, 16, 32, 32, 64, 128)),
    "SimpleNetIN3E": dict(norm_type="IN", channels=(0, 16, 32, 64, 128, 256),
                          tr_channels=(0, 16, 32, 32, 64, 128)),
}


def make_config(name: str, in_channels: int, out_channels: int,
                conv1_kernel_size: int = 3, normalize_feature: bool = False,
                D: int = 3, bn_momentum: float = 0.1) -> SimpleNetConfig:
    if name not in _VARIANTS:
        raise ValueError(f"unknown SimpleNet variant {name}")
    return SimpleNetConfig(name=name, in_channels=in_channels,
                           out_channels=out_channels,
                           conv1_kernel_size=conv1_kernel_size,
                           normalize_feature=normalize_feature, D=D,
                           bn_momentum=bn_momentum,
                           **_VARIANTS[name])


def _layout(cfg: SimpleNetConfig):
    """(name, Cin, Cout, kernel volume) of every conv but ``final``; each
    has a norm of its own name (``conv2_tr`` -> ``norm2_tr``)."""
    C, TR, L = cfg.channels, cfg.tr_channels, cfg.levels
    kv = lambda ks: kernel_map.kernel_offsets(ks, cfg.D, cfg.region_type).shape[0]
    k3 = kv(3)
    convs = [("conv1", cfg.in_channels, C[1], kv(cfg.conv1_kernel_size))]
    convs += [(f"conv{i}", C[i - 1], C[i], k3) for i in range(2, L + 1)]
    convs += [(f"conv{i}_tr", C[L] if i == L else C[i] + TR[i + 1], TR[i], k3)
              for i in range(L, 1, -1)]
    convs.append(("conv1_tr", C[1] + TR[2], TR[1], k3))
    return convs


class SimpleNet(common.Net):
    """The network; parameter names follow the JAX package's trees."""

    def __init__(self, cfg: SimpleNetConfig):
        super().__init__()
        self.cfg = cfg
        folded = cfg.norm_type == "NONE"
        for name, cin, cout, kv in _layout(cfg):
            self.add_module(name, common.Conv(kv, cin, cout, bias=folded))
            self.add_module(name.replace("conv", "norm"),
                            common.Norm(cfg.norm_type, cout))
        self.final = common.Conv(1, cfg.tr_channels[1], cfg.out_channels, bias=True)
        self.set_bn_momentum(cfg.bn_momentum)

    def forward(self, plan: UNetPlan, feats: torch.Tensor) -> torch.Tensor:
        """feats [N_0, Cin] in the compute dtype -> [N_0, out_channels]."""
        L = self.cfg.levels
        m = self._modules
        skips = []
        out = feats
        for i in range(1, L + 1):
            if i == 1:
                out = common.first_conv(m["conv1"], plan, out)
            else:
                out = m[f"conv{i}"](out, plan.downs[i - 2])
            out = m[f"norm{i}"](out, plan.seg(i - 1))
            skips.append(out)
            out = sc.relu(out)
        for i in range(L, 1, -1):
            out = m[f"norm{i}_tr"](m[f"conv{i}_tr"](out, plan.ups[i - 2]),
                                   plan.seg(i - 2))
            out = torch.cat([sc.relu(out), skips[i - 2]], dim=-1)
        out = self.norm1_tr(self.conv1_tr(out, plan.selfs[0]), plan.seg(0))
        out = self.final(sc.relu(out), None)
        if self.cfg.normalize_feature:
            n2 = torch.sum(out * out, dim=-1, keepdim=True)
            out = out / torch.clamp(torch.sqrt(torch.clamp(n2, min=1e-24)), min=1e-12)
        return out


def init_params(gen: torch.Generator, cfg: SimpleNetConfig):
    """Random (params, state) trees in the JAX package's layout (kaiming
    fan-in, identity BN)."""
    params, state = {}, {}
    for name, cin, cout, kv in _layout(cfg):
        params[name] = common.init_conv(gen, kv, cin, cout)
        norm = name.replace("conv", "norm")
        params[norm], state[norm] = common.init_norm(cfg.norm_type, cout)
    params["final"] = common.init_conv(gen, 1, cfg.tr_channels[1], cfg.out_channels,
                                       bias=True)
    return params, state
