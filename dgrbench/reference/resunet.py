"""Plain residual sparse U-Nets (FCGF's ResUNetBN2C / BN2F family, "v1_4").

Written from the published architecture (Choy et al., FCGF, ICCV 2019; the
DGR repository's ``model/resunet.py``): four levels; each encoder level a
conv (k = conv1 at level 0, k3 stride 2 below), BN and a basic residual
block, its output kept as the skip and passed on through ReLU; each decoder
level a k3 stride-2 transposed conv, BN, a block and ReLU, then the skip
concatenated; a k1 conv, ReLU and the final k1 conv with bias; FCGF
normalises each row to unit length. A basic block is conv-BN-ReLU-conv-BN,
plus its input, then ReLU. BatchNorm is unfolded: eval mode reads the
running statistics, train mode the batch's (biased variance, every row of
the batch). Parameters are a nested dict in MinkowskiEngine's state-dict
names, which is also the layout the benchmark hands the program.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch

from . import sparse

ARCHS = {
    "ResUNetBN2C": ((32, 64, 128, 256), (64, 64, 64, 128)),
    "ResUNetBN2F": ((16, 32, 64, 128), (16, 32, 64, 128)),
}
EPS = 1e-5


class Arch(NamedTuple):
    name: str
    in_channels: int
    out_channels: int
    conv1_kernel_size: int
    ndim: int
    normalize: bool

    @property
    def channels(self):
        return (0,) + ARCHS[self.name][0]

    @property
    def tr_channels(self):
        return (0,) + ARCHS[self.name][1]


def conv_shapes(arch: Arch) -> List[tuple]:
    """(path, kernel volume, Cin, Cout, bias) of every conv, in draw order."""
    C, TR, L = arch.channels, arch.tr_channels, 4
    k3, k1 = 3 ** arch.ndim, arch.conv1_kernel_size ** arch.ndim
    out = [(("conv1",), k1, arch.in_channels, C[1], False)]
    for i in range(2, L + 1):
        out.append(((f"conv{i}",), k3, C[i - 1], C[i], False))
    for i in range(L, 1, -1):
        out.append(((f"conv{i}_tr",), k3, C[L] if i == L else C[i] + TR[i + 1], TR[i],
                    False))
    for sfx, c in _stages(arch):
        out.append(((f"block{sfx}", "conv1"), k3, c, c, False))
        out.append(((f"block{sfx}", "conv2"), k3, c, c, False))
    out.append((("conv1_tr",), 1, C[1] + TR[2], TR[1], False))
    out.append((("final",), 1, TR[1], arch.out_channels, True))
    return out


def _stages(arch: Arch):
    C, TR = arch.channels, arch.tr_channels
    return [(f"{i}", C[i]) for i in range(1, 5)] + [(f"{i}_tr", TR[i])
                                                    for i in range(4, 1, -1)]


def _put(tree, path, value):
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def init_tree(arch: Arch, generator: torch.Generator, device) -> tuple:
    """(params, state) drawn from ``generator`` in one call on ``device``:
    kaiming-normal kernels (std sqrt(2 / (K Cin)), MinkowskiEngine's
    default), identity BatchNorms, a zero final bias."""
    shapes = conv_shapes(arch)
    sizes = [k * cin * cout for _, k, cin, cout, _ in shapes]
    flat = torch.randn(sum(sizes), generator=generator, device=device)
    params, state = {}, {}
    for (path, k, cin, cout, bias), w in zip(shapes, flat.split(sizes)):
        _put(params, path + ("kernel",), w.view(k, cin, cout) * (2.0 / (k * cin)) ** 0.5)
        if bias:
            _put(params, path + ("bias",), torch.zeros(cout, device=device))
    for sfx, c in _stages(arch):
        for path in ((f"norm{sfx}",), (f"block{sfx}", "norm1"), (f"block{sfx}", "norm2")):
            _put(params, path + ("weight",), torch.ones(c, device=device))
            _put(params, path + ("bias",), torch.zeros(c, device=device))
            _put(state, path + ("mean",), torch.zeros(c, device=device))
            _put(state, path + ("var",), torch.ones(c, device=device))
    return params, state


def leaves(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The tree's tensors under dotted names."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


class Maps(NamedTuple):
    grids: List[torch.Tensor]
    conv1: sparse.EdgeList
    selfs: List[sparse.EdgeList]
    downs: List[sparse.EdgeList]


def build_maps(grid0: torch.Tensor, arch: Arch) -> Maps:
    """The four levels of a batched grid and every map the net reads."""
    grids = [grid0]
    for level in range(1, 4):
        grids.append(sparse.stride_down(grids[-1], 2 ** level))
    off3 = sparse.hypercube_offsets(3, arch.ndim)
    selfs = [sparse.kernel_map(g, g, off3, 2 ** i) for i, g in enumerate(grids)]
    conv1 = selfs[0] if arch.conv1_kernel_size == 3 else sparse.kernel_map(
        grid0, grid0, sparse.hypercube_offsets(arch.conv1_kernel_size, arch.ndim), 1)
    downs = [sparse.kernel_map(grids[i], grids[i + 1], off3, 2 ** i) for i in range(3)]
    return Maps(grids, conv1, selfs, downs)


def conv_work(maps: Maps, arch: Arch) -> List[tuple]:
    """(edges, Cin, Cout, rows out, rows in) of every conv of one forward,
    in ``conv_shapes`` order but the blocks last; k1 convs count one edge a
    row."""
    C, TR = arch.channels, arch.tr_channels
    n0 = maps.grids[0].shape[0]
    work = [(maps.conv1.k.numel(), arch.in_channels, C[1], n0, n0)]
    for i in range(2, 5):
        d = maps.downs[i - 2]
        work.append((d.k.numel(), C[i - 1], C[i], d.n_out, d.n_in))
    for i in range(4, 1, -1):
        d = maps.downs[i - 2]
        work.append((d.k.numel(), C[4] if i == 4 else C[i] + TR[i + 1], TR[i], d.n_in,
                     d.n_out))
    for lvl, (sfx, c) in zip([0, 1, 2, 3, 2, 1, 0], _stages(arch)):
        s = maps.selfs[lvl]
        work += [(s.k.numel(), c, c, s.n_out, s.n_in)] * 2
    work.append((n0, C[1] + TR[2], TR[1], n0, n0))
    work.append((n0, TR[1], arch.out_channels, n0, n0))
    return work


def _norm(x, p, s, train: bool):
    if train:
        mean = x.mean(0)
        var = ((x - mean) ** 2).mean(0)
    else:
        mean, var = s["mean"], s["var"]
    return (x - mean) * torch.rsqrt(var + EPS) * p["weight"] + p["bias"]


def _block(x, p, s, em, train):
    out = torch.relu(_norm(sparse.conv(x, p["conv1"]["kernel"], em), p["norm1"],
                           s.get("norm1"), train))
    out = _norm(sparse.conv(out, p["conv2"]["kernel"], em), p["norm2"], s.get("norm2"),
                train)
    return torch.relu(out + x)


def forward(params: Dict, state: Dict, maps: Maps, feats: torch.Tensor, arch: Arch,
            train: bool = False) -> torch.Tensor:
    """feats [N_0, Cin] -> [N_0, out_channels], in float32."""
    skips = []
    out = feats.float()
    st = lambda k: state.get(k, {})
    for i in range(1, 5):
        em = maps.conv1 if i == 1 else maps.downs[i - 2]
        out = sparse.conv(out, params[f"conv{i}"]["kernel"], em)
        out = _norm(out, params[f"norm{i}"], st(f"norm{i}"), train)
        out = _block(out, params[f"block{i}"], st(f"block{i}"), maps.selfs[i - 1], train)
        skips.append(out)
        out = torch.relu(out)
    for i in range(4, 1, -1):
        out = sparse.conv(out, params[f"conv{i}_tr"]["kernel"],
                          maps.downs[i - 2].transposed())
        out = _norm(out, params[f"norm{i}_tr"], st(f"norm{i}_tr"), train)
        out = torch.relu(_block(out, params[f"block{i}_tr"], st(f"block{i}_tr"),
                                maps.selfs[i - 2], train))
        out = torch.cat([out, skips[i - 2]], dim=1)
    out = torch.relu(out @ params["conv1_tr"]["kernel"][0])
    out = out @ params["final"]["kernel"][0] + params["final"]["bias"]
    if arch.normalize:
        n = torch.sqrt(torch.clamp(torch.sum(out * out, dim=1, keepdim=True), min=1e-24))
        out = out / (n + 1e-8)
    return out
