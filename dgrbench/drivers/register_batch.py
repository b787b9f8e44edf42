"""Driver: closed-loop ``register_batch(..., force_vmapped=True)`` calls.

Set-up builds ``DeepGlobalRegistration`` from the configuration, gives it
the benchmark's nets (FCGF from the configuration's weights file or from
the seed, the inlier net from the mix's ``weights_seed`` or the seed, drawn
on the card in one call each by the reference's layout), draws the mix's
pool of pairs and warms up by making every call of the pool once, so that
every bucket, ICP path and rerun that the window meets has run before it.
Each window call registers the next of the pool's fixed groups of
``batch`` pairs, in an order of the groups drawn from the seed (cycled). One call, drawn from
the seed among the window's first ``check_among`` calls, runs with thin
wrappers around the program's stage functions that keep what each stage
returned; after the window the plain reference judges those answers.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import numpy as np
import torch

from ..reference import judge, sparse
from ..traffic import pairs
from . import common


class Recorder:
    """Wraps the program's stage functions for one call and keeps, in call
    order, what each returned: ("vox", points, grid), ("fcgf", grid,
    features), ("inlier", 6D grid, logits), ("solve", iterations),
    ("icp", init, T, iterations, full scans), ("rerun", pose)."""

    def __init__(self, dgr):
        self.dgr = dgr
        self.events: List[tuple] = []

    @contextlib.contextmanager
    def active(self):
        from deepglobalregistration_tpu_torch.core import registration
        from deepglobalregistration_tpu_torch.ops import icp as icp_ops
        from deepglobalregistration_tpu_torch.ops import sparse_grid
        dgr, ev = self.dgr, self.events
        saved = [(sparse_grid, "voxelize"), (registration, "global_registration"),
                 (icp_ops, "registration_icp"), (icp_ops, "registration_icp_checked")]
        saved = [(m, n, getattr(m, n)) for m, n in saved]
        orig = {n: f for _, n, f in saved}
        depth = [0]

        def voxelize(xyz, voxel_size, batch_index=0):
            sel, grid = orig["voxelize"](xyz, voxel_size, batch_index)
            ev.append(("vox", sel, grid))
            return sel, grid

        def fcgf(grid, batch_size, cap):
            feats, ov = type(dgr)._fcgf_forward(dgr, grid, batch_size, cap)
            ev.append(("fcgf", grid, feats))
            return feats, ov

        def inlier(c6, ifeat, cap, batch_size=1):
            logits, ov = type(dgr)._inlier_logits(dgr, c6, ifeat, cap, batch_size)
            ev.append(("inlier", c6, logits))
            return logits, ov

        def solve(points, trans_points, weights, **kw):
            res = orig["global_registration"](points, trans_points, weights, **kw)
            ev.append(("solve", res.iterations))
            return res

        def icp_wrap(name):
            def f(*a, **kw):
                depth[0] += 1
                try:
                    res = orig[name](*a, **kw)
                finally:
                    depth[0] -= 1
                if depth[0] == 0:
                    # Full scans (one 1-NN launch a pair) the ICP made: the
                    # iterations plus the first evaluation, where it scanned.
                    cand = name.endswith("checked") or kw.get("use_candidates", False)
                    ok = res.cand_ok if isinstance(res.cand_ok, list) else [res.cand_ok]
                    it = res.iterations if isinstance(res.iterations, list) \
                        else [res.iterations]
                    scans = [0 if cand and c else i + 1 for i, c in zip(it, ok)]
                    if not isinstance(res.iterations, list):
                        it, scans = it[0], scans[0]
                    ev.append(("icp", kw["init"], res.T, it, scans))
                return res
            return f

        def register(xyz0, xyz1, inlier_thr=0.0):
            T = type(dgr).register(dgr, xyz0, xyz1, inlier_thr)
            ev.append(("rerun", T))
            return T

        try:
            sparse_grid.voxelize = voxelize
            registration.global_registration = solve
            icp_ops.registration_icp = icp_wrap("registration_icp")
            icp_ops.registration_icp_checked = icp_wrap("registration_icp_checked")
            dgr._fcgf_forward, dgr._inlier_logits, dgr.register = fcgf, inlier, register
            yield
        finally:
            for m, n, f in saved:
                setattr(m, n, f)
            for n in ("_fcgf_forward", "_inlier_logits", "register"):
                dgr.__dict__.pop(n, None)


def _stages(ev: List[tuple], b: int):
    """Per pair, the first stages of ``b`` pairs: 2b voxelizations (pair p's
    clouds in columns 2p, 2p + 1), one FCGF forward over them and one
    inlier-net forward over the pairs' correspondences. Returns (outputs,
    the events left)."""
    vox, ev = ev[:2 * b], ev[2 * b:]
    (_, _, feats), (_, c6, logits), ev = ev[0], ev[1], ev[2:]
    feats = feats.split([v[2].shape[0] for v in vox])
    outs = []
    for p in range(b):
        o = {"sel0": vox[2 * p][1], "c0": vox[2 * p][2][:, 1:],
             "sel1": vox[2 * p + 1][1], "c1": vox[2 * p + 1][2][:, 1:],
             "f0": feats[2 * p], "f1": feats[2 * p + 1]}
        rows = c6[:, 0] == p
        o["idx1"] = _match_rows(o["c1"], c6[rows, 4:7])
        o["logits"] = logits[rows, 0]
        outs.append(o)
    return outs, ev


def _match_rows(c1: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Row of c1 (distinct voxel coordinates) holding each row of q."""
    g1 = torch.cat([torch.zeros_like(c1[:, :1]), c1.long()], 1)
    gq = torch.cat([torch.zeros_like(q[:, :1]), q.long()], 1)
    j, hit = sparse.KeyTable(g1, 0).find(gq)
    return torch.where(hit, j, torch.full_like(j, -1))


def _refined(o: Dict, solve, icp, k=None) -> None:
    """Put a pair's refinement and ICP answers (row k of a batch) into o."""
    pick = (lambda x: x) if k is None else (lambda x: x[k])
    if solve is not None:
        o["solve_iters"] = pick(solve[1])
    _, init, T, iters, scans = icp
    o.update(icp_init=pick(init), icp_T=pick(T), icp_iters=pick(iters),
             icp_scans=pick(scans))


def outputs(idx, T, events, lb, sub_batch: int) -> List[Dict]:
    """What one register_batch call produced, pair by pair, from its events:
    its sub-batches in order, then each rerun (``register()``) in pair order."""
    outs, ev = [], list(events)
    for s in range(0, len(idx), sub_batch):
        b = len(idx[s:s + sub_batch])
        o, ev = _stages(ev, b)
        ok = [p for p in range(b) if lb["gate"][s + p]]
        if ok:
            solve, icp, ev = ev[0], ev[1], ev[2:]
            for k, p in enumerate(ok):
                _refined(o[p], solve, icp, k)
        outs += o
    for p, o in enumerate(outs):
        o["gate"] = bool(lb["gate"][p])
        o["final"] = T[p]
        o["rerun"] = bool(lb["rerun"][p])
        if o["rerun"]:
            _, ev = _stages(ev, 1)
            solve = ev.pop(0) if ev[0][0] == "solve" else None
            o.pop("solve_iters", None)
            _refined(o, solve, ev.pop(0))
            ev.pop(0)
    return outs


def schedule(seed: int, mix: Dict):
    """(the order in which calls take the pool's pairs, the window call the
    check reads). The pool stands in fixed groups of ``batch`` pairs (group
    g: pairs ``batch * g`` onwards), one call each, and the seed orders the
    groups, so that every seed makes the same calls in another order. The
    window's first call takes the order's second group."""
    b, n = int(mix["batch"]), int(mix["pool"])
    if n % b:
        raise ValueError(f"a pool of {n} pairs does not split into calls of {b}")
    rng = pairs.rng_for(seed, 2 ** 32 - 1)
    order = (rng.permutation(n // b)[:, None] * b + np.arange(b)).ravel()
    return order, int(rng.randint(int(mix["check_among"])))


def checked_pairs(seed: int, mix: Dict) -> List[int]:
    """Pool indices of the pairs of the call the check reads."""
    order, call = schedule(seed, mix)
    b = int(mix["batch"])
    return [int(order[(b * (call + 1) + j) % len(order)]) for j in range(b)]


class Driver(common.Driver):
    kind = "register"

    def setup(self):
        from deepglobalregistration_tpu_torch.config import default_config
        from deepglobalregistration_tpu_torch.core import pipeline
        from deepglobalregistration_tpu_torch.models import load_model

        cfg, dev = self.config, self.device
        self.pcfg = default_config(**common.program_keys(cfg, default_config()))
        self.dgr = pipeline.DeepGlobalRegistration(self.pcfg, device=dev)
        self.trees = common.make_trees(cfg, common.weights_seed(self.mix, self.seed), dev)
        for net, (arch, tree) in self.trees.items():
            spec = load_model(arch.name)
            pc = spec.make_config(arch.in_channels, arch.out_channels,
                                  conv1_kernel_size=arch.conv1_kernel_size,
                                  normalize_feature=arch.normalize, D=arch.ndim)
            built = pipeline.build_net(spec, common.numpy_tree(tree), pc, self.pcfg.fold_bn,
                                       self.dgr.compute_dtype, self.dgr.device)
            setattr(self.dgr, net, built)
            setattr(self.dgr, f"{net}_cfg", built.cfg)
        self.pool = pairs.pool(self.mix["pool_seed"], self.mix)
        self.order, self.check_call = schedule(self.seed, self.mix)
        self.min_calls = self.check_call + 1
        self.next = 0
        self.stats = {"pairs": 0, "reruns": 0, "refine": [], "icp": []}
        self.traced_calls = []
        # warm-up: every pair of the pool once, every kernel loaded, every path taken
        for _ in range(-(-len(self.pool) // int(self.mix["batch"]))):
            self._call(record=False)
        self.next = int(self.mix["batch"])
        self.calls = 0
        self.checked = None
        self.dgr_sub_batch = self.dgr._MAX_SUB_BATCH
        self.reset_window()

    def reset_window(self):
        self.stats = {"pairs": 0, "reruns": 0, "refine": [], "icp": []}
        self.attempted = self.failed = 0
        for t in self.dgr.batch_stage_timers.values():
            t.reset()

    def _take(self):
        b = int(self.mix["batch"])
        idx = [int(self.order[(self.next + j) % len(self.pool)]) for j in range(b)]
        self.next += b
        return idx

    def _call(self, record: bool, traced: bool = False) -> int:
        idx = self._take()
        xs = [self.pool[i]["xyz0"] for i in idx]
        ys = [self.pool[i]["xyz1"] for i in idx]
        rec = Recorder(self.dgr) if (record or traced) else None
        with (rec.active() if rec else contextlib.nullcontext()):
            T = self.dgr.register_batch(xs, ys, force_vmapped=True)
        lb = self.dgr.last_batch
        self.stats["pairs"] += len(idx)
        self.stats["reruns"] += sum(lb["rerun"])
        self.stats["refine"] += [r for r, g in zip(lb["refine"], lb["gate"]) if g]
        self.stats["icp"] += [i for i, g in zip(lb["icp"], lb["gate"]) if g]
        self.failed += int(sum(not np.isfinite(t).all() for t in T))
        self.attempted += len(idx)
        if record:
            self.checked = (idx, T, rec.events, dict(lb))
        if traced:
            self.traced_calls.append((idx, T, rec.events, dict(lb)))
        return len(idx)

    def call(self, traced: bool = False) -> int:
        if traced:
            return self._call(record=False, traced=True)
        n = self._call(record=self.calls == self.check_call)
        self.calls += 1
        return n

    def layer_context(self) -> Dict:
        st = {k: t.total_time for k, t in self.dgr.batch_stage_timers.items()}
        s = self.stats
        return {"stage_s": st, "pairs": s["pairs"], "reruns": s["reruns"],
                "refine_iters": list(s["refine"]), "icp_iters": list(s["icp"])}

    def _outputs(self, call) -> List[Dict]:
        idx, T, events, lb = call
        return outputs(idx, T, events, lb, self.dgr_sub_batch)

    def traced_work(self) -> Dict:
        """Work of the traced calls, counted by the benchmark's own maps and
        the iterations the program reported: every conv's edges and widths,
        and every 1-NN search's (kind, rows, rows, width, launches)."""
        fa, ia = self.trees["fcgf"][0], self.trees["inlier"][0]
        convs, nn1 = [], []
        for call in self.traced_calls:
            for o in self._outputs(call):
                runs = 2 if o["rerun"] else 1
                n0, n1 = o["c0"].shape[0], o["c1"].shape[0]
                g6 = torch.cat([o["c0"], o["c1"][o["idx1"].clamp(min=0)]], 1)
                convs += (common.net_work(fa, [o["c0"], o["c1"]], "fcgf")
                          + common.net_work(ia, [g6], "inlier")) * runs
                nn1 += [("mma", n0, n1, fa.out_channels, runs)]
                if "icp_scans" in o and o["icp_scans"]:
                    nn1.append(("scan", n0, n1, 3, int(o["icp_scans"])))
        return {"convs": convs, "nn1": nn1}

    def check(self) -> Dict[str, float]:
        idx = self.checked[0]
        outs = self._outputs(self.checked)
        self.release()
        cell = self.cell()
        gaps: Dict[str, float] = {}
        for i, o in zip(idx, outs):
            p = self.pool[i]
            for k, v in judge.judge_register(o, p["xyz0"], p["xyz1"], cell).items():
                gaps[k] = max(gaps.get(k, 0.0), v if math.isfinite(v) else math.inf)
        return gaps

    def release(self):
        """Free the program's state before the reference runs."""
        self.dgr = None
        self.checked = None
        self.traced_calls = []
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def cell(self) -> Dict:
        return cell(self.config, self.mix, self.trees, self.device)


def cell(config: Dict, mix: Dict, trees: Dict, device: str) -> Dict:
    """What the judge needs of a registration cell."""
    (fa, ft), (ia, it) = trees["fcgf"], trees["inlier"]
    return {"voxel_size": config["voxel_size"], "voxel_floor": mix["voxel_floor"],
            "device": device, "fcgf_tree": ft, "fcgf_arch": fa, "inlier_tree": it,
            "inlier_arch": ia, "clip_weight_thresh": config["clip_weight_thresh"]}
