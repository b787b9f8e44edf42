"""PyramidNet family: recursive hourglass nets.

Counterpart of the JAX package's ``models/pyramidnet.py``. A head conv ->
norm -> ELU, then the outermost PyramidModule, then a tail of a k3 conv ->
norm -> ELU (``final.0``) and a k1 conv without bias (``final.1``). A
module at level l: strided conv -> norm -> ELU into level l + 1, ``depth``
residual blocks there (ReLU inside, as everywhere), the next module inward
unless l + 1 is the last level but one, a transposed conv -> norm -> ELU
back to level l, concat(x, y) with the module's input first, and a k1 conv
-> norm -> ELU. Parameter names mirror the torch Sequentials
(``pyramid.conv.0.0.kernel``, ``pyramid.convtr.1.weight``,
``pyramid.inner_module...``). The feature normalisation is
``x / (sqrt(max(sum x^2, 1e-24)) + 1e-8)`` in the compute dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from ..ops import kernel_map
from . import common, residual_block
from .unet_plan import UNetPlan


@dataclasses.dataclass(frozen=True)
class PyramidNetConfig:
    name: str
    norm_type: str
    channels: Tuple[int, ...]
    tr_channels: Tuple[int, ...]
    depths: Tuple[int, ...]
    in_channels: int = 1
    out_channels: int = 32
    conv1_kernel_size: int = 3
    normalize_feature: bool = False
    D: int = 3
    bn_momentum: float = 0.1  # running statistics (train-mode BN)
    region_type: int = kernel_map.HYPER_CUBE
    nonlinearity: str = "ELU"

    @property
    def levels(self) -> int:
        return len(self.depths)

    @property
    def with_pooling(self) -> bool:
        return False


_C6 = dict(channels=(32, 64, 128, 192, 256, 256),
           tr_channels=(64, 128, 192, 192, 256, 256))
_C8 = dict(channels=(32, 64, 128, 128, 192, 192, 256, 256),
           tr_channels=(64, 128, 128, 192, 192, 192, 256, 256))
_VARIANTS = {
    "PyramidNet": dict(norm_type="BN", channels=(32, 64, 128, 128),
                       tr_channels=(64, 128, 128, 128), depths=(1, 1, 1, 1)),
    "PyramidNet6": dict(_C6, norm_type="BN", depths=(1,) * 6),
    "PyramidNet6NoBlock": dict(_C6, norm_type="BN", depths=(0,) * 6),
    "PyramidNet6INBN": dict(_C6, norm_type="INBN", depths=(1,) * 6),
    "PyramidNet8": dict(_C8, norm_type="BN", depths=(1,) * 8),
    "PyramidNet8INBN": dict(_C8, norm_type="INBN", depths=(1,) * 8),
}


def make_config(name: str, in_channels: int, out_channels: int,
                conv1_kernel_size: int = 3, normalize_feature: bool = False,
                D: int = 3, bn_momentum: float = 0.1) -> PyramidNetConfig:
    if name not in _VARIANTS:
        raise ValueError(f"unknown PyramidNet variant {name}")
    return PyramidNetConfig(name=name, in_channels=in_channels,
                            out_channels=out_channels,
                            conv1_kernel_size=conv1_kernel_size,
                            normalize_feature=normalize_feature, D=D,
                            bn_momentum=bn_momentum,
                            **_VARIANTS[name])


def _kvol(cfg: PyramidNetConfig, ks: int) -> int:
    return kernel_map.kernel_offsets(ks, cfg.D, cfg.region_type).shape[0]


def _cnn(kv: int, cin: int, cout: int, norm_type: str) -> nn.Sequential:
    """conv_norm_non: {"0": conv, "1": norm} (only indexed, never called)."""
    return nn.Sequential(common.Conv(kv, cin, cout, bias=norm_type == "NONE"),
                common.Norm(norm_type, cout))


class PyramidModule(nn.Module):
    def __init__(self, cfg: PyramidNetConfig, level: int):
        super().__init__()
        self.cfg, self.level = cfg, level
        C, TR, nt = cfg.channels, cfg.tr_channels, cfg.norm_type
        k3 = _kvol(cfg, 3)
        inc, inner = C[level], C[level + 1]
        blocks = [residual_block.BasicBlock(nt, inner, k3)
                  for _ in range(cfg.depths[level + 1])]
        self.conv = nn.Sequential(_cnn(k3, inc, inner, nt), *blocks)
        if level + 1 < cfg.levels - 1:
            self.inner_module = PyramidModule(cfg, level + 1)
        self.convtr = _cnn(k3, TR[level + 1], TR[level + 1], nt)
        self.cat_conv = _cnn(1, TR[level + 1] + inc, TR[level], nt)

    def forward(self, plan: UNetPlan, x: torch.Tensor) -> torch.Tensor:
        lvl, f = self.level, self.cfg.nonlinearity
        seg, seg1 = plan.seg(lvl), plan.seg(lvl + 1)
        conv = list(self.conv.children())
        cnn = conv[0]
        y = common.act(f, cnn[1](cnn[0](x, plan.downs[lvl]), seg1))
        for block in conv[1:]:
            y = block(y, plan.selfs[lvl + 1], seg1)
        if "inner_module" in self._modules:
            y = self.inner_module(plan, y)
        tr = self.convtr
        y = common.act(f, tr[1](tr[0](y, plan.ups[lvl]), seg))
        y = torch.cat([x, y], dim=-1)
        cat = self.cat_conv
        return common.act(f, cat[1](cat[0](y, None), seg))


class PyramidNet(common.Net):
    """The network; parameter names follow the JAX package's trees."""

    def __init__(self, cfg: PyramidNetConfig):
        super().__init__()
        self.cfg = cfg
        TR, nt = cfg.tr_channels, cfg.norm_type
        self.conv = _cnn(_kvol(cfg, cfg.conv1_kernel_size), cfg.in_channels,
                         cfg.channels[0], nt)
        self.pyramid = PyramidModule(cfg, 0)
        self.final = nn.Sequential(_cnn(_kvol(cfg, 3), TR[0], TR[0], nt),
                          common.Conv(1, TR[0], cfg.out_channels))
        self.set_bn_momentum(cfg.bn_momentum)

    def forward(self, plan: UNetPlan, feats: torch.Tensor) -> torch.Tensor:
        """feats [N_0, Cin] in the compute dtype -> [N_0, out_channels]."""
        f, seg = self.cfg.nonlinearity, plan.seg(0)
        head = self.conv
        out = common.act(f, head[1](common.first_conv(head[0], plan, feats), seg))
        out = self.pyramid(plan, out)
        tail = self.final[0]
        out = common.act(f, tail[1](tail[0](out, plan.selfs[0]), seg))
        out = self.final[1](out, None)
        if self.cfg.normalize_feature:
            n2 = torch.sum(out * out, dim=-1, keepdim=True)
            out = out / (torch.sqrt(torch.clamp(n2, min=1e-24)) + 1e-8)
        return out


def init_params(gen: torch.Generator, cfg: PyramidNetConfig):
    """Random (params, state) trees in the JAX package's layout (kaiming
    fan-in, identity BN)."""
    C, TR, nt = cfg.channels, cfg.tr_channels, cfg.norm_type
    k3 = _kvol(cfg, 3)

    def cnn(kv, cin, cout):
        p, s = common.init_norm(nt, cout)
        return {"0": common.init_conv(gen, kv, cin, cout), "1": p}, {"1": s}

    def module(level):
        inc, inner = C[level], C[level + 1]
        p, s = {"conv": {}}, {"conv": {}}
        p["conv"]["0"], s["conv"]["0"] = cnn(k3, inc, inner)
        for d in range(cfg.depths[level + 1]):
            p["conv"][str(d + 1)], s["conv"][str(d + 1)] = residual_block.init_block(
                gen, nt, inner, k3)
        if level + 1 < cfg.levels - 1:
            p["inner_module"], s["inner_module"] = module(level + 1)
        p["convtr"], s["convtr"] = cnn(k3, TR[level + 1], TR[level + 1])
        p["cat_conv"], s["cat_conv"] = cnn(1, TR[level + 1] + inc, TR[level])
        return p, s

    params, state = {}, {}
    params["conv"], state["conv"] = cnn(_kvol(cfg, cfg.conv1_kernel_size),
                                        cfg.in_channels, C[0])
    params["pyramid"], state["pyramid"] = module(0)
    f0p, f0s = cnn(k3, TR[0], TR[0])
    params["final"] = {"0": f0p, "1": common.init_conv(gen, 1, TR[0], cfg.out_channels)}
    state["final"] = {"0": f0s}
    return params, state
