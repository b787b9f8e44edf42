"""Golden FCGF parity check: settle the kernel K-axis order in one command.

Counterpart of the repo's ``tools/golden_fcgf.py``. The checkpoint
converter (``utils/checkpoint.convert_state_dict``) assumes MinkowskiEngine
enumerates HYPER_CUBE kernel offsets dimension-0-fastest from the
most-negative corner (``ops/kernel_map.kernel_offsets``). That convention is
derived from ME's public kernel_region.hpp; with real pretrained weights and
a reference feature dump, this tool decides it, and names the correction
if one is needed.

Usage:
    python -m deepglobalregistration_tpu_torch.tools.golden_fcgf \\
        --weights ResUNetBN2C-feat32-3dmatch-v0.05.pth \\
        [--golden golden.npz] [--voxel 0.05] [--atol 1e-3] [--device cpu]

``--weights`` is a reference ``.pth`` or a native ``.pkl`` with an FCGF tree
and its config. golden.npz schema (from running the reference FCGF on any
fragment):
    xyz      [N, 3] float32 raw points (pre-quantization)
    feats    [M, 32] float32 reference output features
    coords   [M, 3] int32 voxel coordinates of the reference's M outputs
Without --golden, the tool runs every K-order candidate and prints feature
statistics per candidate (inconclusive, but it runs the load path end to end).

Candidates tried (permutations of the converted kernel's K axis):
    identity      the converter's documented order (dim-0 fastest, -corner)
    reversed      dim-0 fastest from the most-positive corner
    dimlast       C-order odometer (last dimension fastest)

The FCGF runs in f32, BN live, on ``--device`` (default ``cuda``: raises
without a card).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models import load_model
from ..models.unet_plan import build_unet_plan
from ..ops import kernel_map as km
from ..ops import sparse_grid
from ..utils import checkpoint as ckpt
from ..utils import convert
from ..utils.device import resolve_device


def k_order_candidates(k: int, ndim: int):
    """Return {name: perm} where perm reindexes the documented offset order
    into the candidate order: kernel_candidate = kernel_converted[perm]."""
    base = np.asarray(km.kernel_offsets(k, ndim, km.HYPER_CUBE))

    def perm_to(target: np.ndarray) -> np.ndarray:
        base_keys = {tuple(row): i for i, row in enumerate(base)}
        return np.array([base_keys[tuple(row)] for row in target], np.int64)

    r = k // 2
    ranges = [np.arange(-r, r + 1) for _ in range(ndim)]
    mesh = np.meshgrid(*ranges, indexing="ij")  # C-order: last dim fastest
    dimlast = np.stack([m.ravel() for m in mesh], axis=1).astype(np.int32)

    return {
        "identity": np.arange(len(base)),
        "reversed": perm_to(base[::-1]),
        "dimlast": perm_to(dimlast),
    }


def permute_kernels(params, perm_for):
    """Apply a K-axis permutation to every conv kernel ([K, Cin, Cout]) of a
    numpy parameter tree. perm_for(K) -> permutation or None (leave k=1 and
    even kernels alone)."""
    if isinstance(params, dict):
        return {k: permute_kernels(v, perm_for) for k, v in params.items()}
    if getattr(params, "ndim", 0) == 3:
        p = perm_for(params.shape[0])
        if p is not None:
            return params[p]
    return params


def run_fcgf(spec, cfg, params, state, xyz: np.ndarray, voxel: float,
             device: str | torch.device = "cuda"):
    """Voxelize, plan and run the FCGF in f32 with live BN on ``device``;
    returns (features [M, C], voxel coordinates [M, 3] int32), numpy."""
    dev = resolve_device(device)
    net = spec.module(cfg)
    net.load_state_dict(convert.from_jax_params(params, state, cfg))
    net = net.to(dev).eval()
    _, grid = sparse_grid.voxelize(torch.as_tensor(xyz, device=dev), voxel, 0)
    plan = build_unet_plan(grid, 1, cfg.conv1_kernel_size, cfg.region_type,
                           cfg.levels, with_pooling=cfg.with_pooling)
    with torch.no_grad():
        out = net(plan, torch.ones((grid.shape[0], 1), device=dev))
    return (out.float().cpu().numpy(),
            grid[:, 1:].to(torch.int32).cpu().numpy())


def load_fcgf(weights: str):
    """(spec, cfg, params, state, k1) of a ``.pth`` or native checkpoint."""
    if str(weights).endswith((".pth", ".pt")):
        state = ckpt.load_torch_checkpoint(weights)
        params, net_state = state["fcgf_params"], state["fcgf_state"]
    else:
        state = ckpt.load_checkpoint(weights)
        params, net_state = state["state_dict"]["params"], state["state_dict"]["state"]
    netcfg = state["config"]
    get = netcfg.get if isinstance(netcfg, dict) else lambda k: getattr(netcfg, k)
    feat_model = get("feat_model") if "feat_model" in netcfg else get("model")
    n_out = get("feat_model_n_out") if "feat_model_n_out" in netcfg else get("model_n_out")
    k1 = get("feat_conv1_kernel_size") if "feat_conv1_kernel_size" in netcfg \
        else get("conv1_kernel_size")
    spec = load_model(feat_model)
    cfg = spec.make_config(1, n_out, bn_momentum=get("bn_momentum"),
                           conv1_kernel_size=k1,
                           normalize_feature=get("normalize_feature"), D=3)
    return spec, cfg, params, net_state, k1


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", required=True)
    ap.add_argument("--golden", default=None,
                    help=".npz with xyz/feats/coords from the reference FCGF")
    ap.add_argument("--voxel", type=float, default=0.05)
    ap.add_argument("--atol", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    spec, cfg, params, net_state, k1 = load_fcgf(args.weights)
    if args.golden:
        g = np.load(args.golden)
        xyz, ref_feats, ref_coords = g["xyz"], g["feats"], g["coords"]
    else:
        rng = np.random.RandomState(0)
        xyz = (rng.rand(5000, 3) * 3.0).astype(np.float32)
        ref_feats = ref_coords = None

    cands27 = k_order_candidates(3, 3)
    cands_k1 = k_order_candidates(k1, 3) if k1 != 3 else cands27

    results = {}
    for name in cands27:
        def perm_for(K, name=name):
            if K == 27:
                return cands27[name]
            if K == k1 ** 3:
                return cands_k1[name]
            return None

        p = permute_kernels(params, perm_for)
        feats, coords = run_fcgf(spec, cfg, p, net_state, xyz, args.voxel, args.device)
        if ref_feats is not None:
            # align by voxel coordinate (both sides dedup; order differs)
            ours = {tuple(c): f for c, f in zip(coords, feats)}
            matched, err = 0, 0.0
            for c, f in zip(ref_coords, ref_feats):
                got = ours.get(tuple(c))
                if got is not None:
                    matched += 1
                    err = max(err, float(np.abs(got - f).max()))
            results[name] = {"matched": matched, "of": len(ref_coords),
                             "max_abs_err": err,
                             "pass": matched > 0 and err < args.atol}
        else:
            results[name] = {"feat_mean": float(feats.mean()),
                             "feat_std": float(feats.std()),
                             "n_out": len(feats)}

    print(json.dumps(results, indent=2))
    if ref_feats is not None:
        winners = [n for n, r in results.items() if r["pass"]]
        if winners == ["identity"]:
            print("VERDICT: documented K-order CONFIRMED — no action needed.")
        elif len(winners) == 1:
            print(f"VERDICT: K-order is '{winners[0]}' — update "
                  "ops/kernel_map.kernel_offsets (the centralized flip point).")
        else:
            print(f"VERDICT: inconclusive (winners={winners}); tighten --atol "
                  "or use a larger fragment.")
    return results


if __name__ == "__main__":
    main()
