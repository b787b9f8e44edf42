"""The slot-sum kernels (``csrc/slot_sum.cu``) at the main path's maps and
widths: each kernel held bit for bit to its plain version and timed warm,
L2-cold and beside ``index_add_``, so that two commits can be compared on
one card in turns.

    python3 deepglobalregistration_tpu_torch/tools/slot_sum_bench.py
        [--root DIR] [--label NAME]

Maps (``slot_maps``): bench pair 0's FCGF plan (``synthetic_pair(n=30000,
seed=0)`` at the bench configuration with the committed weights, as
register() builds it: the level-0 same-stride map at 32 -> 32, the
stride-2 down map at 32 -> 64, the transposed up map at 128 -> 64), its 6D
inlier plan's level-0 map (32 -> 32), a KITTI-scale level-0 map
(``lidar_like_pair(seed=0)``, 0.3 m, conv1 = 5, 32 -> 32) and the 6D
plan's level-3 map at the inlier net's widest convs (256 -> 256, what a
train step's backward sums): the forward, dx and dk slot sums on random
products (``conv_products``); sum pooling on
the SP families' plan of pair 0 (0 -> 1 at C = 32, its transpose at C =
64), forward and dx. dk goes through ``slot_sum_runs_cuda`` where the
checkout has it, else through ``slot_sum_cuda`` over ``arange`` tiles (the
earlier form). Each case prints its kernel's mean ms over CUDA-graph
replays, its L2-cold ms (``cold_ms``) and ``index_add_``'s ms, in one JSON
line with the card's name and power limit.

``--root``: the checkout whose package (and ``chip_smoke.py``, for the
plans) is imported; default, the one holding this file. To compare two
commits, unpack the other with ``git archive`` into a gitignored directory
and run both in turns (parent, this, this, parent) in one call.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[2]
# The KITTI-scale configuration of chip_smoke.KITTI (tools/kitti_scale_smoke.py).
KITTI_VOXEL, KITTI_CONV1 = 0.3, 5
COLD_BYTES = 64 * 2 ** 20  # written before each cold call: more than the 50 MB L2


def cold_ms(fn, reps: int = 10) -> float:
    """Mean ms of one ``fn()`` with the L2 cold: a 64 MB buffer is written
    just before each call, and the call alone sits between CUDA events. The
    card first sleeps ~1 ms, so that the host has queued the call before
    the events' span starts and its launch cost stays outside."""
    flush = torch.empty(COLD_BYTES // 4, device="cuda")
    fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for e0, e1 in events:
        torch.cuda._sleep(2_000_000)
        flush.zero_()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in events) / reps


def conv_products(em, cin: int, cout: int, g) -> dict:
    """A conv map's three slot sums' inputs on random features and kernels
    at its widths, on the card: {kind: (P, ptr, slots, dst, rows, C,
    sources)} for the forward (P by the output rows' lists), the input
    gradient (dy through W^T, by the input rows' lists) and the kernel
    gradient (each tile's g^T dy, by offset over the run of its tiles:
    ``slots`` None). ``dst``: each source row's target, for ``index_add_``;
    ``sources``: the rows of P the sum reads."""
    t, n_tiles = em.tile, em.tile_k.shape[0]
    k = int(em.tile_k[-1]) + 1
    x = torch.randn(em.n_in + 1, cin, device="cuda", generator=g)
    dy = torch.randn(em.n_out + 1, cout, device="cuda", generator=g)
    x[-1], dy[-1] = 0, 0  # the zero rows padding slots read
    w = torch.randn(k, cin, cout, device="cuda", generator=g) / (k * cin) ** 0.5
    gx = x.index_select(0, em.tile_in).view(-1, t, cin)
    gy = dy.index_select(0, em.tile_out).view(-1, t, cout)
    fwd = torch.bmm(gx, w.index_select(0, em.tile_k)).view(-1, cout)
    bwd = torch.bmm(gy, w.transpose(1, 2).index_select(0, em.tile_k)).view(-1, cin)
    dkp = torch.bmm(gx.transpose(1, 2), gy).view(n_tiles, cin * cout)
    k_ptr = torch.searchsorted(em.tile_k, torch.arange(k + 1, device="cuda")).int()
    e = em.n_edges
    return {"forward": (fwd, em.out_ptr, em.out_slots, em.tile_out, em.n_out, cout, e),
            "dx": (bwd, em.in_ptr, em.in_slots, em.tile_in, em.n_in, cin, e),
            "dk": (dkp, k_ptr, None, em.tile_k, k, cin * cout, n_tiles)}


def slot_maps(plans) -> tuple:
    """([(label, map, Cin, Cout)] of the conv maps, [(label, map, C)] of the
    pooling maps) from pair 0's plans (``chip_smoke._pair_plans``: its
    ``grid``, ``plan3``, ``plan6``), with the KITTI-scale and SP plans built
    here."""
    from deepglobalregistration_tpu_torch.models.unet_plan import build_unet_plan
    from deepglobalregistration_tpu_torch.ops import sparse_grid
    from deepglobalregistration_tpu_torch.utils.synthetic import lidar_like_pair

    plan3, plan6 = plans["plan3"], plans["plan6"]
    xk0, xk1, _, _ = lidar_like_pair(seed=0)
    gk = torch.cat([sparse_grid.voxelize(torch.as_tensor(x, device="cuda"), KITTI_VOXEL,
                                         b)[1] for b, x in enumerate((xk0, xk1))])
    plank = build_unet_plan(gk, 2, KITTI_CONV1, 0, 4, ones_input=True)
    plan_sp = build_unet_plan(plans["grid"], 2, 7, 0, 4, ones_input=True,
                              with_pooling=True)
    conv = [("bench FCGF level-0 same-stride", plan3.selfs[0], 32, 32),
            ("bench FCGF stride-2 down 0->1", plan3.downs[0], 32, 64),
            ("bench FCGF transposed up 1->0", plan3.ups[0], 128, 64),
            ("bench 6D level-0 same-stride", plan6.selfs[0], 32, 32),
            ("KITTI-scale level-0 same-stride", plank.selfs[0], 32, 32),
            ("bench 6D level-3 same-stride", plan6.selfs[3], 256, 256)]
    pool = [("bench SP pool 0->1", plan_sp.pool_downs[0], 32),
            ("bench SP pool transpose 1->0", plan_sp.pool_ups[0], 64)]
    return conv, pool


def slot_cases(plans, g) -> list:
    """Every slot-sum case at ``slot_maps``' maps on random values from the
    card generator ``g``, as dicts: ``case`` (its label), ``map``, ``kind``,
    ``pool``; ``kernel`` and ``plain`` (out -> out, the same sum on the same
    inputs); ``out0`` (zeros [rows, C]); ``library`` (the sum by one
    ``index_add_``); ``bound``, what the sum must move and do: (source
    bytes, rows, C, slot-list entries, adds); and for the conv maps ``P``,
    ``ptr`` and ``slots`` (None: the runs form). dk goes through
    ``slot_sum_runs`` where the package has it, else through ``slot_sum``
    over ``arange`` tiles (its earlier form)."""
    from deepglobalregistration_tpu_torch.ops import slot_sum as ss

    runs = hasattr(ss, "slot_sum_runs_cuda")
    conv, pool = slot_maps(plans)
    out = []
    for label, em, cin, cout in conv:
        for kind, (P, ptr, slots, dst, rows, c, n_src) in conv_products(
                em, cin, cout, g).items():
            if slots is None and not runs:
                slots = torch.arange(P.shape[0], dtype=torch.int32, device="cuda")
            if slots is None:
                kernel = lambda o, P=P, p=ptr: ss.slot_sum_runs_cuda(o, P, 0, p)
                plain = lambda o, P=P, p=ptr: ss.slot_sum_runs_plain(o, P, 0, p)
            else:
                kernel = lambda o, P=P, p=ptr, sl=slots: ss.slot_sum_cuda(o, P, 0, p, sl)
                plain = lambda o, P=P, p=ptr, sl=slots: ss.slot_sum_plain(o, P, 0, p, sl)
            lib_out = torch.zeros(rows + 1, c, device="cuda")
            out.append({
                "case": f"{label} {kind} ({rows} rows, C={c})", "map": label, "kind": kind,
                "pool": False, "kernel": kernel, "plain": plain,
                "out0": torch.zeros(rows, c, device="cuda"),
                "library": lambda o=lib_out, d=dst, P=P: o.index_add_(0, d, P),
                "bound": (n_src * c * 4, rows, c, 0 if slots is None else slots.shape[0],
                          n_src * c),
                "P": P, "ptr": ptr, "slots": slots})
    for label, em, c in pool:
        s = em.tile_in.shape[0]
        for kind, n_src, rows, src_rows, ptr, slots, dst in (
                ("forward", em.n_in, em.n_out, em.tile_in, em.out_ptr, em.out_slots,
                 em.tile_out),
                ("dx", em.n_out, em.n_in, em.tile_out, em.in_ptr, em.in_slots, em.tile_in)):
            x = torch.randn(n_src, c, device="cuda", generator=g)
            xp = torch.cat([x, x.new_zeros((1, c))])
            lib_out = torch.zeros(rows + 1, c, device="cuda")
            out.append({
                "case": f"{label} {kind} ({rows} rows, C={c})", "map": label, "kind": kind,
                "pool": True,
                "kernel": lambda o, x=x, a=src_rows, p=ptr, sl=slots: ss.slot_sum_rows_cuda(
                    o, x, a, 0, s, p, sl),
                "plain": lambda o, x=x, a=src_rows, p=ptr, sl=slots: ss.slot_sum_rows_plain(
                    o, x, a, 0, s, p, sl),
                "out0": torch.zeros(rows, c, device="cuda"),
                "library": lambda o=lib_out, d=dst, a=src_rows, xp=xp: o.index_add_(
                    0, d, xp.index_select(0, a)),
                # The rows read, their int64 row numbers, out, the lists.
                "bound": (n_src * c * 4 + 8 * em.n_edges, rows, c, em.n_edges,
                          em.n_edges * c)})
    return out


def run(root: Path) -> list:
    """Every case of the checkout at ``root`` (its package imported): bit
    for bit against the plain version, CUDA-graph ms, L2-cold ms and
    ``index_add_``'s ms."""
    sys.path.insert(0, str(root))
    import chip_smoke as cs

    from deepglobalregistration_tpu_torch.config import default_config
    from deepglobalregistration_tpu_torch.core.pipeline import DeepGlobalRegistration
    from deepglobalregistration_tpu_torch.tools.gather_bench import time_ms
    from deepglobalregistration_tpu_torch.utils import cuda_build, device
    from deepglobalregistration_tpu_torch.utils.synthetic import synthetic_pair

    device.set_precision()
    cuda_build.build()
    dgr = DeepGlobalRegistration(default_config(bf16=True, **cs.BENCH), device="cuda")
    plans = cs._pair_plans(dgr, synthetic_pair(n=30000, seed=0))
    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    out = []
    for c in slot_cases(plans, g):
        kernel, o0 = c["kernel"], c["out0"]
        got, want = kernel(o0.clone()), c["plain"](o0.clone())
        o = o0.clone()
        out.append({"case": c["case"], "rows": int(o0.shape[0]), "c": int(o0.shape[1]),
                    "bit_for_bit": bool(torch.equal(got.view(torch.int32),
                                                    want.view(torch.int32))),
                    "ms": time_ms(lambda: kernel(o)), "cold_ms": cold_ms(lambda: kernel(o)),
                    "library_ms": cs.cuda_ms(c["library"])})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("slot_sum_bench: no CUDA device", flush=True)
        return 2
    root = args.root.resolve()
    cases = run(root)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"slot_sum_bench": {"root": str(root), "label": args.label or root.name,
                                         "card": card, "cases": cases}}), flush=True)
    return 0 if all(c["bit_for_bit"] for c in cases) else 1


if __name__ == "__main__":
    sys.exit(main())
