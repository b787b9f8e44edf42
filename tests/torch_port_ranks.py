"""Rank programs of the data-parallel tests, for
``parallel.data_parallel.spawn`` (which imports them by name in each rank's
process, so this module imports no JAX)."""

import functools

import numpy as np
import torch
import torch.distributed as dist

from deepglobalregistration_tpu_torch.config import get_config
from deepglobalregistration_tpu_torch.core.trainer import WeightedProcrustesTrainer
from deepglobalregistration_tpu_torch.data.factory import make_data_loader
from deepglobalregistration_tpu_torch.ops import losses, sparse_conv
from deepglobalregistration_tpu_torch.parallel import data_parallel as dp
from deepglobalregistration_tpu_torch.utils.convert import to_jax_params


def raise_on_rank1(mesh):
    """Rank 1 raises; rank 0 waits for it in a barrier it never reaches."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier(group=mesh.group)


def _split(x, rows):
    return torch.from_numpy(np.ascontiguousarray(x[rows]))


def loss_pieces(mesh, logits, labels, mask, splits):
    """Each rank's share of the two BCE losses over its rows
    (``splits[rank]``, a slice of the flat rows), and its share's gradient
    on those rows."""
    rows = splits[mesh.rank]
    out = {}
    for name, fn in (("balanced", losses.balanced_loss),
                     ("unbalanced", losses.unbalanced_loss)):
        x = _split(logits, rows).requires_grad_(True)
        share = fn(x, _split(labels, rows), _split(mask, rows),
                   total=functools.partial(dp.global_sum, mesh))
        share.backward()
        out[name] = (float(share), x.grad)
    return out


def bn_pieces(mesh, feats, weight, bias, splits):
    """Train-mode BN over every rank's rows (``splits[rank]``; a rank may
    have none): its output and input gradient on this rank's rows, the
    scale and bias gradients summed over the ranks, the new running
    statistics. The loss is sum(out * w) with a fixed w, shared by rows."""
    rows = splits[mesh.rank]
    x = _split(feats, rows).requires_grad_(True)
    scale = torch.from_numpy(weight).requires_grad_(True)
    shift = torch.from_numpy(bias).requires_grad_(True)
    c = feats.shape[1]
    out, mean, var = sparse_conv.batch_norm_train(
        x, scale, shift, torch.zeros(c), torch.ones(c), 0.1, group=mesh.group)
    w = torch.linspace(-1, 1, c)
    (out * w).sum().backward()
    grads = torch.cat([scale.grad, shift.grad])
    dist.all_reduce(grads, group=mesh.group)
    return {"out": out.detach(), "x_grad": x.grad, "param_grad": grads,
            "mean": mean, "var": var}


def pieces(mesh, loss_args, bn_args):
    """``loss_pieces`` and ``bn_pieces`` in one launch."""
    return {"loss": loss_pieces(mesh, *loss_args), "bn": bn_pieces(mesh, *bn_args)}


def trained_inlier(mesh, argv):
    """One rank of a data-parallel training run without validation, as
    ``train.main`` runs it on each rank: the rank's inlier net after
    training, as (params, state) numpy trees."""
    config = get_config(argv)
    loader = make_data_loader(config, config.train_phase, config.batch_size,
                              num_workers=config.train_num_workers)
    trainer = WeightedProcrustesTrainer(config, loader, mesh=mesh)
    trainer.train()
    return to_jax_params(trainer.inlier)
