"""FCGF self-training: the hardest-contrastive step, on the card.

Counterpart of the JAX package's ``core/fcgf_train.py`` (FCGF, Choy et al.,
ICCV 2019, eq. 5):

    L = mean_pos [d(f0_i, f1_j) - m_pos]_+^2
      + 1/2 (mean_i [m_neg - min_k d(f0_i, f1_k)]_+^2 +
             mean_j [m_neg - min_k d(f1_j, f0_k)]_+^2)

with the hardest negative of each anchor mined over a random candidate
subset of the other cloud, leaving out candidates within ``neg_radius`` (in
3D, after the ground-truth alignment) of the anchor's true correspondent.
The random draws (``num_pos`` positives, ``num_neg`` candidates a side, each
a modulo draw over the valid rows) come from ``draw_indices`` with an
explicit ``torch.Generator`` and enter the loss as arguments, so a caller
can feed it any draws (the tests feed the JAX package's).
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from ..data.collate import PairBatch
from .train_step import fcgf_features, grads_finite


class FCGFLossConfig(NamedTuple):
    pos_margin: float = 0.1
    neg_margin: float = 1.4
    num_pos: int = 1024  # sampled positive pairs per cloud pair
    num_neg: int = 1024  # negative candidates per anchor side
    neg_radius: float = 0.1  # 3D exclusion radius around the true match (m)


class Draws(NamedTuple):
    pos: torch.Tensor   # [num_pos] rows of pos_pairs
    cand1: torch.Tensor  # [num_neg] cloud-1 candidates of the cloud-0 anchors
    cand0: torch.Tensor  # [num_neg] cloud-0 candidates of the cloud-1 anchors


def draw_indices(gen: torch.Generator, pos_num: int, num0: int, num1: int,
                 cfg: FCGFLossConfig) -> Draws:
    """One pair's draws: uniform over [0, 2^30), modulo the valid count (as
    the JAX package's ``randint(..., 0, 1 << 30) % n``)."""
    def draw(n, size):
        r = torch.randint(0, 1 << 30, (size,), generator=gen, device=gen.device)
        return r % max(int(n), 1)

    return Draws(draw(pos_num, cfg.num_pos), draw(num1, cfg.num_neg),
                 draw(num0, cfg.num_neg))


def _hardest(anchors, anchor_xyz, cand_f, cand_xyz, cfg: FCGFLossConfig):
    """Mean squared hinge of each anchor's nearest candidate (in feature
    space) outside the 3D exclusion ball; rows with every candidate
    excluded carry no negative signal."""
    d2 = (anchors * anchors).sum(-1)[:, None] + (cand_f * cand_f).sum(-1)[None] \
        - 2.0 * anchors @ cand_f.T
    d = torch.sqrt(torch.clamp(d2, min=1e-12))
    near = ((anchor_xyz[:, None] - cand_xyz[None]) ** 2).sum(-1) < cfg.neg_radius ** 2
    dmin = torch.where(near, torch.full_like(d, float("inf")), d).min(1).values
    ok = torch.isfinite(dmin)
    neg = torch.where(ok, torch.clamp(cfg.neg_margin - dmin, min=0.0),
                      torch.zeros_like(dmin))
    return (neg ** 2).sum() / torch.clamp(ok.float().sum(), min=1.0)


def hardest_contrastive_loss(f0, f1, xyz0, xyz1, T_gt, pos_pairs, pos_num,
                             draws: Draws, cfg: FCGFLossConfig):
    """One pair's loss and stats. f0 / f1 [N, C]; xyz in each cloud's own
    frame; T_gt maps cloud 0 into cloud 1; pos_pairs [P, 2] padded, with
    ``pos_num`` valid rows. A pair without positives gives 0."""
    pi, pj = pos_pairs[draws.pos, 0].long(), pos_pairs[draws.pos, 1].long()
    a0, a1 = f0[pi], f1[pj]
    d_pos = torch.linalg.norm(a0 - a1 + 1e-12, dim=-1)
    pos_loss = torch.mean(torch.clamp(d_pos - cfg.pos_margin, min=0.0) ** 2)
    xyz0_in1 = xyz0 @ T_gt[:3, :3].T + T_gt[:3, 3]
    c1, c0 = draws.cand1, draws.cand0
    neg0 = _hardest(a0, xyz1[pj], f1[c1], xyz1[c1], cfg)
    neg1 = _hardest(a1, xyz0_in1[pi], f0[c0], xyz0_in1[c0], cfg)
    neg_loss = 0.5 * (neg0 + neg1)
    loss = torch.where(torch.as_tensor(pos_num) > 0, pos_loss + neg_loss,
                       torch.zeros_like(pos_loss))
    return loss, {"pos_loss": pos_loss, "neg_loss": neg_loss,
                  "d_pos_mean": d_pos.mean()}


def make_fcgf_train_step(fcgf, loss_cfg: FCGFLossConfig,
                         optimizer: torch.optim.Optimizer):
    """``step(batch, draws) -> stats`` and ``loss_fn(batch, draws) -> (loss,
    stats)`` over the FCGF net (train mode: BN over the stacked 2B clouds,
    as MinkowskiEngine's batched tensors in the upstream FCGF trainer).
    ``draws`` is a list of one ``Draws`` a pair (``draw_indices``). A
    non-finite gradient skips the update."""
    params = [p for p in fcgf.parameters() if p.requires_grad]

    def loss_fn(batch: PairBatch, draws: List[Draws]):
        b = batch.xyz0.shape[0]
        feats = fcgf_features(fcgf, batch)
        per = [hardest_contrastive_loss(
            feats[i], feats[b + i], batch.xyz0[i], batch.xyz1[i], batch.T_gt[i],
            batch.pos_pairs[i], batch.pos_num[i], draws[i], loss_cfg) for i in range(b)]
        loss = torch.stack([p[0] for p in per]).mean()
        stats = {k: torch.stack([p[1][k] for p in per]).mean() for k in per[0][1]}
        return loss, dict(stats, loss=loss)

    def step(batch: PairBatch, draws: List[Draws]):
        optimizer.zero_grad(set_to_none=True)
        loss, stats = loss_fn(batch, draws)
        loss.backward()
        finite = grads_finite(params)
        if finite:
            optimizer.step()
        return dict({k: v.detach() for k, v in stats.items()}, grad_finite=finite)

    return step, loss_fn
