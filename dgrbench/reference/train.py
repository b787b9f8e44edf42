"""The plain training step of DGR's inlier net (DGR's ``core/trainer.py``,
``WeightedProcrustesTrainer._train_epoch``): a 6D net over each pair's
feature matches in train-mode BatchNorm, sigmoid weights clipped at a
threshold, weighted Procrustes per pair, the pose loss (rotation angle plus
translation error over the pairs whose weights sum past 10) plus the
binary cross-entropy of the logits against the ground-truth labels, and
SGD with momentum, dampening and weight decay (``torch.optim.SGD``'s rule,
written out)."""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch

from . import geometry, resunet


class PairInput(NamedTuple):
    xyz0: torch.Tensor    # [N0, 3] selected points of cloud 0
    xyz1: torch.Tensor    # [N1, 3]
    c0: torch.Tensor      # [N0, 3] int64 voxel coordinates
    c1: torch.Tensor      # [N1, 3]
    nn: torch.Tensor      # [N0] int64 match of each cloud-0 row
    labels: torch.Tensor  # [N0] float, the match is a ground-truth pair
    T_gt: torch.Tensor    # [4, 4]


def positives(p0: torch.Tensor, p1: torch.Tensor, T: torch.Tensor, radius: float,
              rows: int = 4096) -> torch.Tensor:
    """Every (i, j) with |T p0[i] - p1[j]| < radius, as [P, 2] int64."""
    moved = p0 @ T[:3, :3].T + T[:3, 3]
    out = []
    for s in range(0, moved.shape[0], rows):
        a = moved[s:s + rows]
        d2 = torch.zeros((a.shape[0], p1.shape[0]), device=a.device)
        for c in range(3):
            d2 += (a[:, c:c + 1] - p1[None, :, c]) ** 2
        i, j = torch.nonzero(d2 < radius * radius, as_tuple=True)
        out.append(torch.stack([i + s, j], 1))
    return torch.cat(out)


def labels_of(pos: torch.Tensor, nn: torch.Tensor, n1: int) -> torch.Tensor:
    """1.0 where (i, nn[i]) is a positive pair, else 0.0."""
    keys = pos[:, 0] * n1 + pos[:, 1]
    q = torch.arange(nn.shape[0], device=nn.device) * n1 + nn
    return torch.isin(q, keys).float()


def grid6(pairs: List[PairInput]) -> torch.Tensor:
    return torch.cat([torch.cat([torch.full_like(p.c0[:, :1], b), p.c0, p.c1[p.nn]], 1)
                      for b, p in enumerate(pairs)])


def loss(params: Dict, state: Dict, arch: resunet.Arch, pairs: List[PairInput],
         maps: resunet.Maps, cfg: Dict):
    """(loss, logits of every pair's rows concatenated) of one batch."""
    n = sum(p.nn.shape[0] for p in pairs)
    logits = resunet.forward(params, state, maps, torch.ones((n, 1), device=maps.grids[0].device),
                             arch, train=True)[:, 0]
    rot, trans, ok = [], [], []
    bce_sum = 0.0
    start = 0
    for p in pairs:
        lg = logits[start:start + p.nn.shape[0]]
        start += p.nn.shape[0]
        w = torch.sigmoid(lg)
        w = w * (w > cfg["clip_weight_thresh"])
        R, t = geometry.weighted_procrustes(p.xyz0, p.xyz1[p.nn], w)
        c = ((R * p.T_gt[:3, :3]).sum() - 1) / 2
        rot.append(torch.arccos(torch.clamp(c, -0.999, 0.999)))
        trans.append((t - p.T_gt[:3, 3]).norm())
        ok.append(w.sum() > 10)
        bce_sum = bce_sum + (torch.clamp(lg, min=0) - lg * p.labels
                             + torch.log1p(torch.exp(-lg.abs()))).sum()
    ok = torch.stack(ok)
    pose = torch.stack(rot) + cfg["trans_weight"] * torch.stack(trans)
    pose_loss = torch.where(ok, pose, torch.zeros_like(pose)).sum() / torch.clamp(
        ok.float().sum(), min=1.0)
    total = cfg["procrustes_loss_weight"] * pose_loss \
        + cfg["inlier_direct_loss_weight"] * bce_sum / n
    return total, logits


def sgd(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
        bufs: Dict[str, torch.Tensor], cfg: Dict) -> Dict[str, torch.Tensor]:
    """One SGD update in place; returns the momentum buffers."""
    new = {}
    with torch.no_grad():
        for k, p in params.items():
            d = grads[k] + cfg["weight_decay"] * p
            b = d.clone() if k not in bufs else cfg["sgd_momentum"] * bufs[k] \
                + (1 - cfg["sgd_dampening"]) * d
            new[k] = b
            p -= cfg["lr"] * b
    return new


def follow(params0: Dict, state: Dict, arch: resunet.Arch, steps: List[List[PairInput]],
           cfg: Dict):
    """The first steps of training from ``params0`` (a tree), each on its
    batch. Returns (losses, the first step's logits, the first step's
    momentum buffers by leaf name, the parameters after the last step by
    leaf name, the first step's gradients by leaf name)."""
    flat = {k: v.detach().clone().requires_grad_(True)
            for k, v in resunet.leaves(params0).items()}
    tree = {}
    for k, v in flat.items():
        resunet._put(tree, tuple(k.split(".")), v)
    bufs, losses, first_logits, first_bufs, first_grads = {}, [], None, None, None
    for pairs in steps:
        maps = resunet.build_maps(grid6(pairs), arch)
        with torch.enable_grad():
            total, logits = loss(tree, state, arch, pairs, maps, cfg)
            grads = torch.autograd.grad(total, list(flat.values()))
        g = dict(zip(flat.keys(), grads))
        losses.append(float(total.detach()))
        bufs = sgd(flat, g, bufs, cfg)
        if first_logits is None:
            first_logits = logits.detach()
            first_bufs = {k: v.clone() for k, v in bufs.items()}
            first_grads = g
        del maps
    return losses, first_logits, first_bufs, {k: v.detach() for k, v in flat.items()}, \
        first_grads
