"""Rank programs that hold the data-parallel paths against one process.

``train_rank`` and ``fanout_rank`` run on every rank of
``parallel.data_parallel.spawn(fn, n, *args, devices=...)``, and with
``mesh=None`` in the caller's own process as the one-process reference;
``chip_smoke.py`` (phase 14, on the card) and the CPU tests
(``tests/test_torch_port_parallel*.py``) compare what they return. Each
returns host tensors and numpy: the results, the kernels' launches of the
counted run (``ops/knn``'s counters, per process), and with ``timed`` /
``reps`` the time (host clock between device synchronisations) and the
peak device memory of the rank's process.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..core import train_step as ts
from ..core.pipeline import DeepGlobalRegistration
from ..core.trainer import build_nets
from ..ops import knn
from ..parallel import data_parallel as dp
from ..utils import device as device_utils

KERNELS = ("nn1_scan", "nn1_mma", "nn1_scan_batched", "nn1_mma_batched")


def reset_launches() -> None:
    for name in KERNELS + ("find_nn_cuda",):
        getattr(knn, name).launches = 0


def launches() -> dict:
    return {name: getattr(knn, name).launches for name in KERNELS}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak_gib(device: torch.device):
    return torch.cuda.max_memory_allocated(device) / 2 ** 30 \
        if device.type == "cuda" else None


def _host(tensors: dict) -> dict:
    return {k: v.detach().cpu().clone() for k, v in tensors.items()}


def _ranks_agree(mesh, tensors) -> bool:
    """Whether every rank holds rank 0's ``tensors`` bit for bit (f32)."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    ref = flat.clone()
    dist.broadcast(ref, src=0, group=mesh.group)
    same = torch.tensor([float(torch.equal(flat, ref))], device=flat.device)
    dist.all_reduce(same, op=dist.ReduceOp.MIN, group=mesh.group)
    return bool(same.item() == 1.0)


def _match_inputs(fcgf, batch, mesh, device) -> dict:
    """The feature match's inputs on this process's pairs (a rank's shard):
    the FCGF features F0, F1 [b, N, C] and the counts, on the host."""
    mine = ts.batch_to(batch if mesh is None else dp.shard_batch(mesh, batch), device)
    with torch.no_grad():
        feats = ts.fcgf_features(fcgf, mine)
    b = mine.num0.shape[0]
    return {"F0": feats[:b].cpu(), "F1": feats[b:].cpu(),
            "num0": mine.num0.tolist(), "num1": mine.num1.tolist()}


def train_rank(mesh, config, batch, steps: int = 1, timed: int = 0, nn_idx=None,
               trees=None) -> dict:
    """``steps`` train steps on the whole collated ``batch`` (numpy
    ``PairBatch``), the nets as the trainer builds them (``trees`` in their
    place), SGD/Adam as ``config`` says; with a mesh through
    ``make_sharded_train_step`` after ``replicate``. ``nn_idx`` [B, N]
    replaces the first step's 1-NN match. Returns per step the loss and the
    launches; the first step's whole-batch stats and BN statistics, the
    feature match's inputs on this process's pairs (``match``: the frozen
    FCGF's features of the rank's shard, which the 1-NN of the step ran
    on), and (on rank 0, or without a mesh) its gradients and updated
    parameters; with a
    mesh whether every rank's parameters and BN statistics equal rank 0's
    bit for bit after the last step; with ``timed`` the median s/step of
    ``timed`` more steps after one warm-up and the peak memory over
    them."""
    device = mesh.device if mesh is not None else device_utils.resolve_device(config.device)
    fcgf, inlier = build_nets(config, device, trees)
    optimizer = ts.make_optimizer(config.optimizer, inlier.parameters(), config)
    if mesh is None:
        one, _ = ts.make_train_step(fcgf, inlier, config, optimizer)

        def step(b, idx=None):
            return one(ts.batch_to(b, device),
                       None if idx is None else torch.as_tensor(idx).to(device))
    else:
        dp.replicate(mesh, fcgf)
        dp.replicate(mesh, inlier)
        step, _ = dp.make_sharded_train_step(mesh, fcgf, inlier, config, optimizer)
    full = mesh is None or mesh.rank == 0  # the leaves leave rank 0 alone
    out = {"loss": [], "launches": [], "grad_finite": []}
    for k in range(steps):
        _sync(device)
        reset_launches()
        stats = step(batch, nn_idx if k == 0 else None)
        _sync(device)
        out["launches"].append(launches())
        out["loss"].append(float(stats["loss"]))
        out["grad_finite"].append(stats["grad_finite"])
        if k == 0:
            out["stats"] = _host({k: v for k, v in stats.items() if k != "grad_finite"})
            out["buffers"] = _host(dict(inlier.named_buffers()))
            out["match"] = _match_inputs(fcgf, batch, mesh, device)
            if full:
                out["grads"] = _host({n: p.grad for n, p in inlier.named_parameters()})
                out["params_first"] = _host(dict(inlier.named_parameters()))
    if mesh is not None:
        out["ranks_agree"] = _ranks_agree(
            mesh, list(inlier.parameters()) + list(inlier.buffers()))
    if timed:
        step(batch)
        _sync(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        times = []
        for _ in range(timed):
            t0 = time.perf_counter()
            step(batch)
            _sync(device)
            times.append(time.perf_counter() - t0)
        out["s_per_step"] = float(np.median(times))
        out["peak_gib"] = _peak_gib(device)
    return out


def fanout_rank(mesh, config, clouds0, clouds1, reps: int = 0,
                state_dicts=None) -> dict:
    """``register_batch`` of the pairs: with a mesh the fan-out, without the
    one-process batched program (``force_vmapped=True``), on a fresh
    instance (``state_dicts`` = (FCGF, inlier) in place of its nets). The
    first call is counted: its poses, ``last_batch`` and launches; then
    ``reps`` timed calls give their poses, the median s/pair and the peak
    memory over them."""
    device = mesh.device if mesh is not None else device_utils.resolve_device(config.device)
    dgr = DeepGlobalRegistration(config, device=device)
    if state_dicts is not None:
        dgr.fcgf.load_state_dict(state_dicts[0])
        dgr.inlier.load_state_dict(state_dicts[1])

    def call():
        return dgr.register_batch(clouds0, clouds1, mesh=mesh, force_vmapped=True)

    _sync(device)
    reset_launches()
    T = call()
    _sync(device)
    out = {"T": [T], "last_batch": dgr.last_batch, "launches": launches()}
    if reps:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out["T"].append(call())
            _sync(device)
            times.append(time.perf_counter() - t0)
        out["s_per_pair"] = float(np.median(times)) / len(clouds0)
        out["peak_gib"] = _peak_gib(device)
    return out
