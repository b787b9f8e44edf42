"""Judging what the timed path produced, stage by stage, against the plain
reference; and the control: the same reference run in the program's place.

Every stage is judged on the inputs that the program's own previous stage
handed it (its voxels, its matches, its weights, its solved pose), and each
of those is judged in its own right, so a near-tie in one stage does not
carry over as a gap into the next. Each number is a gap that is 0 for an
answer equal to the reference's; ``correct`` compares each with its limit.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from . import geometry, resunet, sparse, train


def _grid(coords: torch.Tensor, col: int) -> torch.Tensor:
    return torch.cat([torch.full_like(coords[:, :1], col), coords], 1)


def voxel_mismatch(xyz: np.ndarray, voxel: float, sel: torch.Tensor,
                   coords: torch.Tensor, arithmetic: str = "float32"):
    """(rows at fault in the program's voxel selection, its points, its
    coordinates). A cloud's selection is one row a voxel: the voxel
    ``floor(x / voxel)`` and its point of smallest index. Where x / voxel
    lies within rounding of an integer (``arithmetic``'s precision, a few
    units in the last place), a point may fall in either voxel, since
    float32 programs round the quotient in more than one way (a division,
    or a product with the reciprocal). A row is at fault where its point's
    voxel is neither; where its point is not the first of its voxel's points
    (points that may fall in it counted); where a voxel holding a point
    that can fall nowhere else is missing; and where a voxel repeats. Later
    stages read the program's rows, whose order is its own."""
    pts = np.asarray(xyz, np.float32)
    q = pts.astype(np.float64) / float(voxel)
    base = np.floor(q)
    frac = q - base
    tol = 4 * np.finfo(np.dtype(arithmetic)).eps * np.maximum(np.abs(q), 1.0)
    low, high = frac < tol, frac > 1 - tol  # may round down a voxel / up a voxel
    alt = base - low + high
    sel_np = np.ascontiguousarray(sel.float().cpu().numpy())
    c_np = coords.long().cpu().numpy()
    rows = lambda a: np.ascontiguousarray(a).view(np.dtype((np.void, 12))).ravel()
    keys, first = np.unique(rows(pts), return_index=True)
    q_keys = rows(sel_np)
    at = np.clip(np.searchsorted(keys, q_keys), 0, len(keys) - 1)
    idx = np.where(keys[at] == q_keys, first[at], -1)
    bad = len(c_np) - len(np.unique(c_np, axis=0))
    bad += int((idx < 0).sum())
    ok = idx >= 0
    i_ok = idx[ok]
    fits = ((c_np[ok] == base[i_ok]) | (c_np[ok] == alt[i_ok])).all(1)
    bad += int((~fits).sum())
    # every voxel of an unambiguous point is present, and its row's point is
    # no later than the first unambiguous point in it
    sure = ~(low | high).any(1)
    sure_c = base[sure].astype(np.int64)
    sure_i = np.nonzero(sure)[0]
    uniq, first_sure = np.unique(sure_c, axis=0, return_index=True)
    have = {tuple(c): int(i) for c, i in zip(c_np[ok].tolist(), i_ok.tolist())}
    for c, k in zip(map(tuple, uniq.tolist()), sure_i[first_sure].tolist()):
        got = have.get(c)
        bad += got is None or got > k
    return bad, sel.float(), coords.long()


def features(tree, arch: resunet.Arch, clouds: List[torch.Tensor]) -> List[torch.Tensor]:
    """FCGF of each voxelized cloud (one batched forward, eval mode)."""
    grid = torch.cat([_grid(c, i) for i, c in enumerate(clouds)])
    maps = resunet.build_maps(grid, arch)
    out = resunet.forward(*tree, maps, torch.ones((grid.shape[0], 1), device=grid.device),
                          arch)
    # stride_down reorders nothing at level 0: rows are in input order.
    return list(out.split([c.shape[0] for c in clouds]))


def logits6(tree, arch: resunet.Arch, c0: torch.Tensor, c1: torch.Tensor,
            idx1: torch.Tensor) -> torch.Tensor:
    grid = torch.cat([torch.zeros_like(c0[:, :1]), c0, c1[idx1]], 1)
    maps = resunet.build_maps(grid, arch)
    return resunet.forward(*tree, maps, torch.ones((grid.shape[0], 1), device=grid.device),
                           arch)[:, 0]


def clipped(logits: torch.Tensor, clip: float) -> torch.Tensor:
    w = torch.sigmoid(logits)
    return torch.where(w < clip, torch.zeros_like(w), w)


def _rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max(1, max |b|)."""
    if a.shape != b.shape:
        return float("inf")
    return float((a.float() - b.float()).abs().max() / max(1.0, float(b.abs().max())))


def judge_register(pair_out: Dict, xyz0: np.ndarray, xyz1: np.ndarray, cell: Dict
                   ) -> Dict[str, float]:
    """The gaps of one registered pair. ``pair_out`` holds what the program
    produced: ``sel0``/``sel1`` points, ``c0``/``c1`` voxel coordinates,
    ``f0``/``f1`` features, ``idx1`` matches, ``logits``, ``gate``, and for a
    pair it refined, ``solve_iters`` (the refinement's steps), ``icp_init``,
    ``icp_T``, ``icp_iters`` and ``final`` (the pose returned).

    The refinement and ICP are judged together, end to end: the reference
    refines from the weights of the program's own logits, runs ICP from its
    own refined pose, and compares ICP's objective at its pose and at the
    program's. The two stop where a change falls under a tolerance, which
    rounding decides, so the reference takes as many steps of each as the
    program reports. A pair whose refinement the program skipped (its
    safeguard) starts the reference's ICP from the program's start."""
    v = cell["voxel_size"]
    g = {}
    b0, s0, c0 = voxel_mismatch(xyz0, v, pair_out["sel0"], pair_out["c0"],
                                cell["voxel_floor"])
    b1, s1, c1 = voxel_mismatch(xyz1, v, pair_out["sel1"], pair_out["c1"],
                                cell["voxel_floor"])
    g["voxel_mismatch"] = float(b0 + b1)
    f0, f1 = features(cell["fcgf_tree"], cell["fcgf_arch"], [c0, c1])
    g["fcgf_gap"] = max(_rel_gap(pair_out["f0"], f0), _rel_gap(pair_out["f1"], f1))
    idx1 = pair_out["idx1"].long()
    g["match_gap"] = geometry.nn_gap(f0, f1, idx1)
    lr = logits6(cell["inlier_tree"], cell["inlier_arch"], c0, c1, idx1)
    g["logit_gap"] = _rel_gap(pair_out["logits"], lr)
    wsum = float(clipped(lr, cell["clip_weight_thresh"]).sum())
    gate = wsum >= max(200.0, 0.05 * c0.shape[0])
    g["gate_mismatch"] = float(gate != bool(pair_out["gate"]))
    if "icp_T" in pair_out:
        init = pair_out["icp_init"].float()
        if "solve_iters" in pair_out:
            w = clipped(pair_out["logits"].float(), cell["clip_weight_thresh"])
            ref = geometry.refine(s0, s1[idx1], w, quant=2 * v,
                                  steps=int(pair_out["solve_iters"]))
            init = torch.eye(4, device=s0.device)
            init[:3, :3], init[:3, 3] = ref.R, ref.t
        # The full scan's distances are |a|^2 - 2 a.b + |b|^2, the candidate
        # lists' a sum of squared differences (the program's ICP says which).
        scan = bool(pair_out.get("icp_scans", 1))
        icp = geometry.icp(s0, s1, 2 * v, init, steps=int(pair_out["icp_iters"]),
                           expanded=scan)
        # ICP's objective (the share of points within reach) at both poses:
        # where rounding flips nearest-neighbour choices of the batched
        # program, the pose moves along directions in which it is flat.
        g["icp_fit_gap"] = abs(geometry.icp_fitness(s0, s1, 2 * v, pair_out["icp_T"], scan)
                               - geometry.icp_fitness(s0, s1, 2 * v, icp.T, scan))
        g["pose_mismatch"] = float(not torch.equal(
            torch.as_tensor(pair_out["final"], dtype=torch.float64).cpu(),
            pair_out["icp_T"].double().cpu()))
    return g


def control_register(xyz0: np.ndarray, xyz1: np.ndarray, cell: Dict) -> Dict:
    """The reference in the program's place: every stage of one pair as the
    reference computes it, in the precision the caller has set (the control
    runs with TF32 on)."""
    v = cell["voxel_size"]
    dev = cell["device"]
    out = {}
    for k, xyz in (("0", xyz0), ("1", xyz1)):
        idx, c = sparse.voxelize(xyz, v, cell["voxel_floor"])
        out["sel" + k] = torch.as_tensor(np.asarray(xyz, np.float32)[idx], device=dev)
        out["c" + k] = torch.as_tensor(c, device=dev)
    out["f0"], out["f1"] = features(cell["fcgf_tree"], cell["fcgf_arch"],
                                    [out["c0"], out["c1"]])
    out["idx1"] = geometry.nn1(out["f0"], out["f1"])[0]
    out["logits"] = logits6(cell["inlier_tree"], cell["inlier_arch"], out["c0"],
                            out["c1"], out["idx1"])
    w = clipped(out["logits"], cell["clip_weight_thresh"])
    out["gate"] = float(w.sum()) >= max(200.0, 0.05 * out["c0"].shape[0])
    ref = geometry.refine(out["sel0"], out["sel1"][out["idx1"]], w, quant=2 * v)
    out["solve_iters"] = ref.iterations
    T = torch.eye(4, device=dev)
    T[:3, :3], T[:3, 3] = ref.R, ref.t
    out["icp_init"] = T
    icp = geometry.icp(out["sel0"], out["sel1"], 2 * v, T, expanded=True)
    out["icp_T"] = out["final"] = icp.T
    out["icp_iters"] = icp.iterations
    return out


def _leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep=None) -> float:
    """The worst leaf's |norm(program) - norm(reference)| over the larger of
    the reference leaf's norm and the median leaf's."""
    names = [k for k in ref if keep is None or keep[k]]
    rn = {k: float(ref[k].norm()) for k in names}
    med = float(np.median(list(rn.values())))
    return max(abs(float(prog[k].norm()) - rn[k]) / max(rn[k], med, 1e-30)
               for k in names)


def judge_train(out: Dict, steps: List[List[Dict]], cell: Dict) -> Dict[str, float]:
    """The gaps of the first training steps. ``steps`` holds, per step, the
    raw pairs (``xyz0``, ``xyz1``, ``T``, ``radius``). ``out`` holds what the
    program produced: ``sel0``/``sel1``/``c0``/``c1`` per pair of every step,
    ``feats`` (step 1's FCGF of every cloud, pairs' cloud 0 then cloud 1),
    ``nn`` per pair of every step, ``labels`` and ``logits`` of step 1 (each
    pair's rows, concatenated), ``losses``, ``bufs`` (the optimizer's
    momentum after step 1, by leaf) and ``params`` (after the last step)."""
    v = cell["voxel_size"]
    if any(len(o) != len(p) for o, p in zip(out["nn"], steps)):
        # the program answered for fewer pairs than its batches hold
        return {k: math.inf for k in ("voxel_mismatch", "fcgf_gap", "match_gap",
                                      "label_mismatch", "logit_gap", "loss1_gap",
                                      "grad_gap", "change_gap")}
    g = {"voxel_mismatch": 0.0, "label_mismatch": 0.0}
    ref_steps = []
    for s, pairs in enumerate(steps):
        rp = []
        for p, raw in enumerate(pairs):
            b0, s0, c0 = voxel_mismatch(raw["xyz0"], v, out["sel0"][s][p], out["c0"][s][p],
                                        cell["voxel_floor"])
            b1, s1, c1 = voxel_mismatch(raw["xyz1"], v, out["sel1"][s][p], out["c1"][s][p],
                                        cell["voxel_floor"])
            g["voxel_mismatch"] += b0 + b1
            T = torch.as_tensor(raw["T"], dtype=torch.float32, device=s0.device)
            nn = out["nn"][s][p].long()
            lab = train.labels_of(train.positives(s0, s1, T, raw["radius"]), nn,
                                  s1.shape[0])
            rp.append(train.PairInput(s0, s1, c0, c1, nn, lab, T))
        ref_steps.append(rp)
    first = ref_steps[0]
    feats = features(cell["fcgf_tree"], cell["fcgf_arch"],
                     [p.c0 for p in first] + [p.c1 for p in first])
    g["fcgf_gap"] = max(_rel_gap(a, b) for a, b in zip(out["feats"], feats))
    nb = len(first)
    g["match_gap"] = max(geometry.nn_gap(feats[p], feats[nb + p], first[p].nn)
                         for p in range(nb))
    lab = torch.cat([p.labels for p in first])
    got = out["labels"].float()
    g["label_mismatch"] = float((got != lab).sum()) if got.shape == lab.shape else math.inf
    losses, logits, bufs, params, grads = train.follow(
        cell["inlier_tree"][0], cell["inlier_tree"][1], cell["inlier_arch"], ref_steps,
        cell["train"])
    g["logit_gap"] = _rel_gap(out["logits"], logits)
    # Step 1's loss: the later steps' losses carry each side's rounding of
    # the update forward, and their gaps swing from seed to seed.
    g["loss1_gap"] = abs(out["losses"][0] - losses[0]) / max(abs(losses[0]), 1e-30)
    g["grad_gap"] = _leaf_gap(out["bufs"], bufs)
    gn = {k: float(v.norm()) for k, v in grads.items()}
    med = float(np.median(list(gn.values())))
    keep = {k: gn[k] >= 1e-3 * med for k in gn}
    p0 = resunet.leaves(cell["inlier_tree"][0])
    dp = {k: out["params"][k] - p0[k] for k in p0}
    dr = {k: params[k] - p0[k] for k in p0}
    g["change_gap"] = _leaf_gap(dp, dr, keep)
    g["leaves_left_out"] = float(sum(not k for k in keep.values()))
    return g


def control_train(steps: List[List[Dict]], cell: Dict, keep: int | None = None) -> Dict:
    """The first training steps as the reference computes them, in the
    program's place (the control runs with TF32 on). ``keep``: a planted
    fault, each step trains on its first ``keep`` pairs alone (the mean
    taken over them) while the data, features and matches are the whole
    batch's."""
    v = cell["voxel_size"]
    dev = cell["device"]
    out = {k: [] for k in ("sel0", "sel1", "c0", "c1", "nn")}
    ref_steps = []
    for s, pairs in enumerate(steps):
        for k in ("sel0", "sel1", "c0", "c1", "nn"):
            out[k].append([])
        rp = []
        for raw in pairs:
            got = {}
            for k, xyz in (("0", raw["xyz0"]), ("1", raw["xyz1"])):
                idx, c = sparse.voxelize(xyz, v, cell["voxel_floor"])
                got["sel" + k] = torch.as_tensor(np.asarray(xyz, np.float32)[idx],
                                                 device=dev)
                got["c" + k] = torch.as_tensor(c, device=dev)
            rp.append(got)
        feats = features(cell["fcgf_tree"], cell["fcgf_arch"],
                         [p["c0"] for p in rp] + [p["c1"] for p in rp])
        if s == 0:
            out["feats"] = feats
        pi = []
        for p, (got, raw) in enumerate(zip(rp, pairs)):
            nn = geometry.nn1(feats[p], feats[len(rp) + p])[0]
            T = torch.as_tensor(raw["T"], dtype=torch.float32, device=dev)
            lab = train.labels_of(train.positives(got["sel0"], got["sel1"], T,
                                                  raw["radius"]), nn, got["sel1"].shape[0])
            for k in ("sel0", "sel1", "c0", "c1"):
                out[k][s].append(got[k])
            out["nn"][s].append(nn)
            pi.append(train.PairInput(got["sel0"], got["sel1"], got["c0"], got["c1"], nn,
                                      lab, T))
        ref_steps.append(pi[:keep])
    out["labels"] = torch.cat([p.labels for p in ref_steps[0]])
    losses, logits, bufs, params, _ = train.follow(
        cell["inlier_tree"][0], cell["inlier_tree"][1], cell["inlier_arch"], ref_steps,
        cell["train"])
    out.update(losses=losses, logits=logits, bufs=bufs, params=params)
    return out
