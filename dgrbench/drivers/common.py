"""What every driver shares: its state, its generators, and the glue that
hands the benchmark's weights to the program."""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List

import torch

from ..reference import resunet

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def repo_path(path: str) -> str:
    return os.path.join(ROOT, path)


def program_keys(cfg: Dict, defaults) -> Dict:
    """The configuration's keys that the program's configuration has."""
    return {k: v for k, v in cfg.items() if hasattr(defaults, k)}


def numpy_tree(tree):
    """(params, state) of tensors as numpy trees, the program's layout."""
    def conv(t):
        return {k: conv(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.detach().float().cpu().numpy()
    return conv(tree[0]), conv(tree[1])


def net_work(arch: resunet.Arch, clouds: List[torch.Tensor], net: str,
             trained: bool = False) -> List[Dict]:
    """Every conv of one forward of ``arch`` over the clouds (voxel
    coordinates, one batch column each), by the benchmark's own maps:
    edges, Cin, Cout, rows out and in, its kind ("first", "sparse" or the
    kernel-size-1 tail "k1"), the net's name and whether it is trained."""
    grid = torch.cat([torch.cat([torch.full_like(c[:, :1], i), c.long()], 1)
                      for i, c in enumerate(clouds)])
    work = resunet.conv_work(resunet.build_maps(grid, arch), arch)
    kinds = ["first"] + ["sparse"] * (len(work) - 3) + ["k1", "k1"]
    keys = ("edges", "cin", "cout", "rows_out", "rows_in")
    return [dict(zip(keys, w), kind=k, net=net, trained=trained)
            for w, k in zip(work, kinds)]


def arches(cfg: Dict):
    """The reference's (FCGF, inlier net) architectures of a configuration."""
    return (resunet.Arch(cfg["feat_model"], 1, cfg["feat_model_n_out"],
                         cfg["feat_conv1_kernel_size"], 3, cfg["normalize_feature"]),
            resunet.Arch(cfg["inlier_model"], 1, 1, cfg["inlier_conv1_kernel_size"], 6,
                         False))


def make_trees(cfg: Dict, seed: int, device: str) -> Dict:
    """The benchmark's weights of a configuration, {net: (arch, (params,
    state))}: FCGF from the configuration's weights file where it names one,
    else from the seed; the inlier net from the seed. Drawn on the device,
    one call a net."""
    from ..reference import weights as ref_weights
    out = {}
    for net, arch in zip(("fcgf", "inlier"), arches(cfg)):
        path = cfg.get(f"{net}_weights")
        if path:
            sd = ref_weights.load(repo_path(path), device)["state_dict"]
            out[net] = (arch, (sd["params"], sd["state"]))
        else:
            out[net] = (arch, resunet.init_tree(arch, seeded(seed, net, device), device))
    return out


def weights_seed(mix: Dict, seed: int) -> int:
    """The seed that the benchmark's random nets are drawn from: the mix's
    ``weights_seed`` where it fixes one (one net for every run, as one
    trained checkpoint would serve them all), else the run's own."""
    return int(mix.get("weights_seed", seed))


def seeded(seed: int, name: str, device: str) -> torch.Generator:
    """A generator on the device seeded from (seed, name)."""
    h = hashlib.sha256(f"{seed}:{name}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(h[:8], "little") >> 1)
    return g


class Driver:
    """A cell's program and its traffic. ``setup`` builds both and warms up;
    ``call`` runs one unit of the window and returns the pairs it completed
    (``traced=True``: a profiled call after the window, kept for
    ``traced_work``); ``layer_context`` and ``traced_work`` feed the metric
    readers; ``check`` frees the program and returns each compared number."""

    kind = ""
    min_calls = 0  # window calls the check needs

    def __init__(self, config: Dict, mix: Dict, seed: int, device: str, trace: bool):
        self.config, self.mix, self.seed = config, mix, int(seed)
        self.device, self.trace = device, trace
        self.attempted = self.failed = 0

