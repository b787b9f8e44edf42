"""The WeightedProcrustes training step on the card.

Counterpart of the JAX package's ``core/train_step.py`` (reference
core/trainer.py:157-351):

  frozen FCGF features of both clouds of every pair (one eval-mode forward
  over the 2B clouds) -> per-pair feature 1-NN (``ops/knn.find_nn_batched``:
  one ``nn1_mma_batched`` launch for the batch on the card) -> ground-truth
  labels of the matches -> 6D inlier net over every pair's correspondences
  (train-mode BN over the whole batch) -> sigmoid, clip, per-pair weighted
  Procrustes -> pose loss (rotation + ``trans_weight`` x translation over
  the pairs whose weights sum past 10) + the direct BCE on the logits ->
  gradients of the inlier net only -> ``torch.optim`` SGD or Adam, skipped
  when a gradient is not finite.

The JAX step pads every pair to the batch's capacity; the port's nets take
each pair's valid rows only (flat over the batch), and the step scatters the
logits back to the padded [B, N] layout, so that its stats have the JAX
step's keys and shapes and compare row for row.

With a ``mesh`` (``parallel/data_parallel.py``) each rank runs its shard of
the batch and the step computes the one-process step over the whole batch:
the inlier net's train-mode BN takes every rank's rows, the pose loss and
the BCE divide by whole-batch counts, so each rank's loss is its share and
the shares sum to the one-process loss, and the gradients are summed over
the ranks before the finiteness check and the update.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.utils.checkpoint

from ..data.collate import PairBatch
from ..models.unet_plan import build_unet_plan
from ..ops import knn, losses, metrics, procrustes
from ..parallel import data_parallel as dp
from ..utils import spans
from .correspondence import find_correct_correspondence


def batch_to(batch: PairBatch, device) -> PairBatch:
    """A collated (numpy) ``PairBatch`` as tensors on ``device``."""
    with spans.span("train.batch_to"):
        return PairBatch(*(torch.as_tensor(np.array(x), device=device) for x in batch))


def make_optimizer(name: str, params, config) -> torch.optim.Optimizer:
    """SGD or Adam at ``config.lr`` (trainer.py:92-108): the JAX package's
    ``torch_sgd`` is ``torch.optim.SGD``'s update, its Adam chain
    (``add_decayed_weights`` -> ``scale_by_adam`` -> lr) ``torch.optim.Adam``'s."""
    if name == "SGD":
        return torch.optim.SGD(params, lr=config.lr, momentum=config.sgd_momentum,
                               dampening=config.sgd_dampening,
                               weight_decay=config.weight_decay)
    if name == "Adam":
        return torch.optim.Adam(params, lr=config.lr,
                                betas=(config.adam_beta1, config.adam_beta2),
                                weight_decay=config.weight_decay)
    raise ValueError(f"optimizer {name} not supported")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The epoch's learning rate into every parameter group."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def grads_finite(params) -> bool:
    """Whether every gradient is finite (one device sync)."""
    flags = [torch.isfinite(p.grad).all() for p in params if p.grad is not None]
    return bool(torch.stack(flags).all()) if flags else True


@contextlib.contextmanager
def kept_bn_state(net: torch.nn.Module):
    """Restore ``net``'s buffers (BN running statistics) on exit: for
    forwards whose statistic updates must not stick (the rematerialised
    forward, validation's train-mode forward)."""
    saved = [b.clone() for b in net.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, s in zip(net.buffers(), saved):
                b.copy_(s)


class InlierInput(NamedTuple):
    grid6: torch.Tensor      # [M, 7] int64: pair, c0 (3), c1 at the match (3)
    feats6: torch.Tensor     # [M, Cin] f32, the inlier net's input
    nn_idx: torch.Tensor     # [B, N * k] int64, the matched cloud-1 row
    is_correct: torch.Tensor  # [B, N * k] bool, the match is a GT positive
    valid: torch.Tensor      # [B, N * k] bool, row < num0 * k
    rows: tuple              # (pair, row) of each of the M flat rows
    batch: PairBatch         # with xyz0 / coords0 repeated k times, num0 * k


def _flat_rows(num):
    """(pair, row) of every valid row of a padded [B, N] layout, pair by
    pair (the port's flat row order)."""
    dev = num.device
    b = torch.repeat_interleave(torch.arange(num.shape[0], device=dev), num.long())
    start = torch.cumsum(num.long(), 0) - num.long()
    return b, torch.arange(b.shape[0], device=dev) - start[b]


def _padded(flat: torch.Tensor, rows, b: int, n: int) -> torch.Tensor:
    out = flat.new_zeros((b, n) + flat.shape[1:])
    out[rows] = flat
    return out


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, C] at rows idx [B, M] -> [B, M, C]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def fcgf_features(fcgf, batch: PairBatch) -> torch.Tensor:
    """FCGF over the 2B clouds of a batch as one batched grid (cloud c < B
    is pair c's cloud 0, c >= B pair c - B's cloud 1), all-ones input;
    returns the features padded to [2B, N, C] f32."""
    cfg = fcgf.cfg
    coords = torch.cat([batch.coords0, batch.coords1]).long()
    num = torch.cat([batch.num0, batch.num1]).long()
    rows = _flat_rows(num)
    grid = torch.cat([rows[0][:, None], coords[rows]], 1)
    plan = build_unet_plan(grid, coords.shape[0], cfg.conv1_kernel_size,
                           cfg.region_type, cfg.levels,
                           ones_input=cfg.in_channels == 1,
                           with_pooling=cfg.with_pooling)
    ones = torch.ones((grid.shape[0], cfg.in_channels), device=grid.device)
    return _padded(fcgf(plan, ones).float(), rows, coords.shape[0], coords.shape[1])


def generate_inlier_input(fcgf, batch: PairBatch, inlier_feature_type: str,
                          inlier_knn: int = 1, nn_idx: torch.Tensor | None = None,
                          stage=None) -> InlierInput:
    """Frozen FCGF forward, per-pair matching and the 6D input
    (trainer.py:630-658 ``generate_inlier_input`` / ``find_pairs``).

    ``fcgf`` is an eval-mode net; it runs without gradients. 1-NN goes
    through ``knn.find_nn_batched`` (the ``nn1_mma_batched`` kernel for CUDA
    tensors of width 8 < C <= 64), unless ``nn_idx`` [B, N] gives the
    matches; ``inlier_knn > 1`` takes each cloud-0 point's k nearest
    (``knn.find_knn_batched``), flattened into the correspondence axis as
    rows i * k + j, with source index ``row // k``. ``stage(name)`` is a
    context manager around the "fcgf" and "match" stages."""
    stage = stage or (lambda name: contextlib.nullcontext())
    b, n = batch.xyz0.shape[:2]
    with stage("fcgf"), torch.no_grad():
        feats = fcgf_features(fcgf, batch)
    f0, f1 = feats[:b], feats[b:]
    k = max(int(inlier_knn), 1)
    with stage("match"):
        if k > 1:
            nn_idx = knn.find_knn_batched(f0, f1, batch.num0, batch.num1, k)[0]
            nn_idx = nn_idx.reshape(b, n * k)
            rep = lambda x: torch.repeat_interleave(x, k, dim=1)
            batch = batch._replace(xyz0=rep(batch.xyz0), coords0=rep(batch.coords0),
                                   num0=batch.num0 * k)
            f0 = rep(f0)
            n = n * k
        elif nn_idx is None:
            nn_idx = knn.find_nn_batched(f0, f1, batch.num0, batch.num1)[0]
    nn_idx = nn_idx.long()
    rows = _flat_rows(batch.num0)
    c1 = _take(batch.coords1, nn_idx)
    grid6 = torch.cat([rows[0][:, None], batch.coords0[rows].long(), c1[rows].long()], 1)
    if inlier_feature_type == "ones":
        feats6 = torch.ones((grid6.shape[0], 1), device=grid6.device)
    elif inlier_feature_type == "feats":
        feats6 = torch.cat([f0[rows], _take(f1, nn_idx)[rows]], 1)
    elif inlier_feature_type == "coords":
        feats6 = torch.cat([torch.cos(batch.xyz0[rows]),
                            torch.cos(_take(batch.xyz1, nn_idx)[rows])], 1)
    else:
        raise TypeError(f"undefined inlier feature type {inlier_feature_type}")
    src = torch.arange(n, device=nn_idx.device) // k
    pred = torch.stack([src[None].expand(b, -1), nn_idx], -1)
    is_correct = find_correct_correspondence(batch.pos_pairs, batch.pos_num, pred,
                                             batch.num0)
    valid = torch.arange(n, device=nn_idx.device)[None] < batch.num0[:, None]
    return InlierInput(grid6, feats6, nn_idx, is_correct, valid, rows, batch)


def make_train_step(fcgf, inlier, config, optimizer: torch.optim.Optimizer,
                    timers: Dict | None = None, mesh=None):
    """The step closures over the frozen ``fcgf`` (eval mode) and the
    ``inlier`` net (train mode): ``loss_fn(batch, nn_idx=None) -> (loss,
    stats)`` and ``step(batch, nn_idx=None) -> stats``, the JAX package's
    ``make_train_step`` pair. ``batch`` is a ``PairBatch`` of tensors on the
    nets' device (``batch_to``); ``nn_idx`` [B, N] replaces the 1-NN match.

    ``config.remat`` runs the inlier net under ``torch.utils.checkpoint``
    (its activations recomputed in backward; the recompute's BN statistic
    update is undone). Each call of ``step`` is the span ``train.step`` (with
    its step number) and each stage a span under it (``utils/spans.py``):
    ``train.fcgf``, ``train.match``, ``train.plan6``, ``train.inlier``,
    ``train.loss``, ``train.backward``, ``train.optimizer``. ``timers`` (name
    -> ``utils.timer.Timer``, without the prefix) times each stage: on the
    card a pair of CUDA events on the current stream, read when the timer is
    read (the stage's interval on the card's timeline), so timing stops
    nothing; on the CPU the host clock.

    ``mesh`` (a rank's ``data_parallel.Mesh``): ``batch`` (and ``nn_idx``)
    are this rank's shard, ``loss`` this rank's share of the whole batch's
    loss, the stats the whole batch's (gathered rank by rank), and ``step``
    sums the gradients over the ranks. It sets the inlier net's BN group
    (``Net.set_bn_group``). Every rank must call the closures in the same
    order, a rank whose shard has no valid row included."""
    icfg = inlier.cfg
    group = mesh.group if mesh is not None and mesh.size > 1 else None
    if group is not None:
        inlier.set_bn_group(group)

    def total(x: torch.Tensor) -> torch.Tensor:  # a count of the whole batch
        return dp.global_sum(mesh, x)

    clip = config.clip_weight_thresh
    params = [p for p in inlier.parameters() if p.requires_grad]
    cuda = params[0].is_cuda

    def stage(name):
        if timers is None:
            return spans.span("train." + name)
        return spans.span("train." + name, timers[name], cuda=cuda)

    steps = itertools.count()

    def loss_fn(batch: PairBatch, nn_idx: torch.Tensor | None = None):
        inp = generate_inlier_input(fcgf, batch, config.inlier_feature_type,
                                    int(config.inlier_knn), nn_idx, stage)
        batch = inp.batch
        b, n = batch.xyz0.shape[:2]
        with stage("plan6"):
            plan6 = build_unet_plan(inp.grid6, b, icfg.conv1_kernel_size,
                                    icfg.region_type, icfg.levels,
                                    with_pooling=icfg.with_pooling)
        with stage("inlier"):
            if config.remat:
                out = torch.utils.checkpoint.checkpoint(inlier, plan6, inp.feats6,
                                                        use_reentrant=False)
            else:
                out = inlier(plan6, inp.feats6)
        with stage("loss"):
            logits = _padded(out[:, 0].float(), inp.rows, b, n)
            valid = inp.valid
            weights = torch.sigmoid(logits)
            if clip > 0:  # not in place (trainer.py:227-231)
                weights = weights * (weights > clip)
            weights = weights * valid
            xyz1_nn = _take(batch.xyz1, inp.nn_idx)
            R, t = procrustes.weighted_procrustes(batch.xyz0, xyz1_nn, weights)
            pair_valid = weights.sum(1) > 10.0  # trainer.py:246
            rot_err = metrics.batch_rotation_error(R, batch.T_gt[:, :3, :3])
            trans_err = metrics.batch_translation_error(t, batch.T_gt[:, :3, 3])
            pose_each = rot_err + config.trans_weight * trans_err
            n_valid = torch.clamp(total(pair_valid.float().sum()), min=1.0)
            pose_loss = torch.where(pair_valid, pose_each,
                                    torch.zeros_like(pose_each)).sum() / n_valid
            labels = inp.is_correct.float()
            bce = losses.balanced_loss if config.use_balanced_loss \
                else losses.unbalanced_loss
            inlier_loss = bce(logits, labels, valid, total=total)
            loss = config.procrustes_loss_weight * pose_loss
            if config.inlier_use_direct_loss:
                loss = loss + config.inlier_direct_loss_weight * inlier_loss
        stats = {"loss": loss, "pose_loss": pose_loss, "inlier_loss": inlier_loss,
                 "valid_pairs": pair_valid.sum(), "rot_err": rot_err,
                 "trans_err": trans_err, "logits": logits, "labels": labels,
                 "valid": valid, "R": R, "t": t, "nn_idx": inp.nn_idx}
        if group is not None:  # the whole batch's
            for k, v in stats.items():
                stats[k] = total(v) if v.dim() == 0 else dp.all_gather_cat(mesh, v)
        stats["rot_err_deg"] = torch.rad2deg(stats.pop("rot_err").mean())
        stats["trans_err"] = stats["trans_err"].mean()
        return loss, stats

    def step(batch: PairBatch, nn_idx: torch.Tensor | None = None):
        """One update; a non-finite gradient skips ``optimizer.step()``, so
        the parameters and the optimizer's state stay as they were
        (trainer.py:286-293)."""
        with spans.span("train.step", step=next(steps)):
            optimizer.zero_grad(set_to_none=True)
            loss, stats = loss_fn(batch, nn_idx)
            with stage("backward"):
                if config.remat:
                    with kept_bn_state(inlier):
                        loss.backward()
                else:
                    loss.backward()
            with stage("optimizer"):
                if group is not None:
                    dp.all_reduce_grads(mesh, params)
                finite = grads_finite(params)
                if finite:
                    optimizer.step()
            stats = {k: v.detach() for k, v in stats.items()}
            stats["grad_finite"] = finite
            return stats

    return step, loss_fn
