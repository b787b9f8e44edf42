"""Data parallelism over registration pairs: one process per rank.

Counterpart of the JAX package's ``parallel/data_parallel.py``. There a 1-D
"data" mesh shards the pair batch over the devices of one program and GSPMD
inserts the gradient psum and the whole-batch BatchNorm reductions. Here,
in PyTorch's SPMD idiom, every rank is a process (``spawn``) that holds its
device and a ``torch.distributed`` group, and the collectives are written
out:

- the train step (``core/train_step.make_train_step(..., mesh=)``): each
  rank runs its contiguous shard of the batch (``shard_batch``); train-mode
  BN takes the moments of every rank's rows (``ops/sparse_conv.
  masked_moments``) and the losses take global normalisers, so the ranks'
  losses sum to the one-process loss; after backward the gradients are
  summed over the ranks. It computes the one-process step over the whole
  batch, as GSPMD's sharded ``jit`` computes the unsharded function;
- the fan-out (``core/pipeline.register_batch(..., mesh=)``): each rank
  registers its shard of the pairs, and the reruns run on rank 0.

The backend follows from the devices: NCCL when every rank has a card of
its own; gloo on the CPU, and when ranks share a card (``devices=
["cuda:0", "cuda:0"]``), which NCCL cannot do. Nothing falls back: a mesh
that cannot be had raises.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..data.collate import PairBatch
from ..utils import device as device_utils


class Mesh(NamedTuple):
    """One device a rank and the backend. ``make_mesh`` returns the plan
    (rank 0, no group); inside ``spawn`` each rank gets its own ``rank`` and
    the ``group``."""

    devices: Tuple[str, ...]
    backend: str  # "nccl" | "gloo"
    rank: int = 0
    group: object = None  # torch.distributed.ProcessGroup inside a rank

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        return torch.device(self.devices[self.rank])


def _device_name(d) -> str:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", 0)
    return str(d)


def make_mesh(n_devices: int = 0, devices=None, backend: str | None = None) -> Mesh:
    """The plan of a launch over ``n_devices`` ranks.

    ``devices`` None: one card a rank, ``cuda:0`` .. ``cuda:n-1`` (0: every
    visible card); more cards than are visible raise (the JAX ``make_mesh``
    takes what there is). Else one device a rank, as named (``"cpu"`` may
    repeat; so may a card, through gloo). The backend follows from the
    devices: NCCL when every rank has a card of its own, else gloo.
    ``backend`` names the one the caller expects, and raises where the
    devices cannot have it (NCCL where ranks share a card or use the
    CPU)."""
    if devices is None:
        visible = torch.cuda.device_count()
        n = int(n_devices) or visible
        if not 1 <= n <= visible:
            raise RuntimeError(f"make_mesh({n_devices}): {n} cards asked for, "
                               f"{visible} visible")
        devices = [f"cuda:{i}" for i in range(n)]
    devices = tuple(_device_name(d) for d in devices)
    if not devices or (n_devices and int(n_devices) != len(devices)):
        raise ValueError(f"make_mesh({n_devices}): devices {devices}")
    cards = [torch.device(d) for d in devices if d.startswith("cuda")]
    if cards and not torch.cuda.is_available():
        raise RuntimeError(f"make_mesh: devices {devices} name a card, and "
                           "torch.cuda.is_available() is False")
    for d in cards:
        if d.index >= torch.cuda.device_count():
            raise RuntimeError(f"make_mesh: {d} asked for, "
                               f"{torch.cuda.device_count()} cards visible")
    own = len(cards) == len(devices) == len(set(devices))
    if backend == "nccl" and not own:
        raise ValueError(f"NCCL needs a card of its own for every rank: {devices}")
    if backend not in (None, "nccl" if own else "gloo"):
        raise ValueError(f"backend {backend!r} for devices {devices}")
    return Mesh(devices, "nccl" if own else "gloo")


def spawn(fn, n_devices: int = 0, *args, devices=None):
    """Run ``fn(mesh, *args)`` on every rank of ``make_mesh(n_devices,
    devices)``, one process each (``torch.multiprocessing``, the
    spawn start method: a parent that has touched CUDA cannot fork), and
    return the ranks' return values, rank by rank (written with
    ``torch.save``: return host tensors and numpy). ``fn`` must be
    importable by name (a module's function, not ``__main__``'s).

    The group starts from a file store in a temporary directory (no port;
    concurrent launches cannot collide), each rank on its device with TF32
    off (``utils/device.set_precision``). A rank that raises makes this
    raise (``torch.multiprocessing.ProcessRaisedException``, with the
    rank's traceback), after the other ranks are stopped."""
    mesh = make_mesh(n_devices, devices)
    tmp = tempfile.mkdtemp(prefix="dgr-ranks-")
    try:
        torch.multiprocessing.start_processes(
            _rank_main, args=(mesh, fn, args, tmp), nprocs=mesh.size, join=True,
            start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(mesh.size)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(rank: int, mesh: Mesh, fn, args, tmp: str) -> None:
    device_utils.set_precision()
    mesh = mesh._replace(rank=rank)
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    dist.init_process_group(mesh.backend, init_method="file://" + os.path.join(tmp, "store"),
                            rank=rank, world_size=mesh.size)
    # No teardown when fn raises: a peer may be inside a collective, and
    # the launcher stops every rank once one has failed.
    out = fn(mesh._replace(group=dist.group.WORLD), *args)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


# ----------------------------------------------------------------------
# collectives
# ----------------------------------------------------------------------
def all_gather_cat(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along axis 0, rank by
    rank, on ``x``'s device, without a gradient. gloo gathers host tensors
    only, so a card's tensor goes through the host there."""
    src = x.detach()
    if mesh.backend == "gloo":
        src = src.cpu()
    if src.dtype == torch.bool:  # not every backend gathers bool
        src = src.to(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src.contiguous(), group=mesh.group)
    return torch.cat(parts).to(x.device, x.dtype)


def global_sum(mesh: Mesh | None, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks (no mesh, or one rank: ``x``), without a
    gradient: for counts and normalisers, and the step's logged scalars."""
    if mesh is None or mesh.size == 1:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=mesh.group)
    return x


def all_reduce_grads(mesh: Mesh, params) -> None:
    """Sum every parameter's gradient over the ranks, in place, as one
    flattened buffer (a missing gradient counts as zeros, so that every
    rank sends the same layout)."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=mesh.group)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p.grad))


def barrier(mesh: Mesh) -> None:
    """Wait until every rank is here."""
    if mesh.backend == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)


def gather_objects(mesh: Mesh, obj) -> list:
    """Every rank's picklable ``obj``, rank by rank, on every rank."""
    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def broadcast_object(mesh: Mesh, obj):
    """Rank 0's picklable ``obj`` on every rank (the others pass None)."""
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return box[0]


# ----------------------------------------------------------------------
# the JAX module's functions
# ----------------------------------------------------------------------
def shard_batch(mesh: Mesh, batch):
    """This rank's contiguous slice ``[r B / W, (r + 1) B / W)`` of a
    collated batch (a ``PairBatch`` or one array, leading axis = pairs): the
    pairs the JAX ``P("data")`` placement puts on device r."""
    if isinstance(batch, PairBatch):
        return PairBatch(*(shard_batch(mesh, x) for x in batch))
    b = batch.shape[0]
    if b % mesh.size:
        raise ValueError(f"a batch of {b} pairs does not split over {mesh.size} ranks")
    per = b // mesh.size
    return batch[mesh.rank * per:(mesh.rank + 1) * per]


def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank (broadcast in place, as
    DDP does when built); then checks that the ranks agree and raises if
    not. Returns ``module``."""
    tensors = list(module.parameters()) + list(module.buffers())
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0, group=mesh.group)
        sums = torch.stack([t.double().sum() for t in tensors])
    lo, hi = sums.clone(), sums.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.group)
    if not torch.equal(lo, hi):
        raise RuntimeError("replicate: the ranks' parameters differ after the broadcast")
    return module


def make_sharded_train_step(mesh: Mesh, fcgf, inlier, config, optimizer,
                            timers=None):
    """``core/train_step.make_train_step(..., mesh=mesh)`` behind
    ``shard_batch``: ``step(batch, nn_idx=None)`` and ``loss_fn(batch,
    nn_idx=None)`` take the whole collated batch (numpy ``PairBatch``, the
    same on every rank; ``nn_idx`` [B, N]) and run this rank's shard on
    ``mesh.device``; their stats are the whole batch's."""
    from ..core import train_step as ts

    step, loss_fn = ts.make_train_step(fcgf, inlier, config, optimizer, timers,
                                       mesh=mesh)

    def local(batch, nn_idx):
        batch = ts.batch_to(shard_batch(mesh, batch), mesh.device)
        if nn_idx is not None:
            nn_idx = torch.as_tensor(shard_batch(mesh, nn_idx)).to(mesh.device)
        return batch, nn_idx

    return (lambda batch, nn_idx=None: step(*local(batch, nn_idx)),
            lambda batch, nn_idx=None: loss_fn(*local(batch, nn_idx)))


def synthetic_pair_batch(rng: np.random.RandomState, b: int, n: int, p: int,
                         voxel: float = 0.05) -> PairBatch:
    """Tiny synthetic batch for dry runs and tests: the JAX function's
    arrays from the same ``rng``, as numpy."""
    from scipy.spatial.transform import Rotation

    xyz0 = np.zeros((b, n, 3), np.float32)
    xyz1 = np.zeros((b, n, 3), np.float32)
    c0 = np.full((b, n, 3), 32766, np.int32)
    c1 = np.full((b, n, 3), 32766, np.int32)
    n0 = np.zeros(b, np.int32)
    n1 = np.zeros(b, np.int32)
    pos = np.zeros((b, p, 2), np.int32)
    pos_n = np.zeros(b, np.int32)
    T = np.zeros((b, 4, 4), np.float32)
    for i in range(b):
        m = n * 3 // 4
        pts = (rng.rand(m, 3) * (voxel * 20)).astype(np.float32)
        coords = np.floor(pts / voxel).astype(np.int32)
        _, sel = np.unique(coords, axis=0, return_index=True)
        m = len(sel)
        R = Rotation.random(random_state=rng).as_matrix().astype(np.float32)
        t = rng.randn(3).astype(np.float32) * 0.1
        moved = pts[sel] @ R.T + t
        xyz0[i, :m], xyz1[i, :m] = pts[sel], moved
        c0[i, :m] = coords[sel]
        c1[i, :m] = np.floor(moved / voxel).astype(np.int32)
        n0[i] = n1[i] = m
        k = min(p, m)
        pos[i, :k, 0] = pos[i, :k, 1] = np.arange(k)
        pos_n[i] = k
        T[i, :3, :3], T[i, :3, 3], T[i, 3, 3] = R, t, 1.0
    return PairBatch(xyz0, xyz1, c0, c1, n0, n1, pos, pos_n, T)


def _tiny_config(**kw):
    from ..config import default_config

    return default_config(feat_model="ResUNetBN2F", feat_model_n_out=8,
                          inlier_model="ResUNetBN2FX", **kw)


def dryrun_step(n_devices: int, devices=None) -> float:
    """One data-parallel training step on tiny shapes over ``n_devices``
    ranks (a validation hook, as the JAX ``dryrun_step``); prints
    ``dryrun_multichip(n): loss=... ok`` and returns the loss."""
    return spawn(_dryrun_step_rank, n_devices, devices=devices)[0]


def _dryrun_step_rank(mesh: Mesh) -> float:
    from ..core import train_step as ts
    from ..core.trainer import build_nets

    config = _tiny_config(batch_size=mesh.size, feat_conv1_kernel_size=3,
                          inlier_conv1_kernel_size=3)
    fcgf, inlier = build_nets(config, mesh.device)
    replicate(mesh, inlier)
    before = [p.detach().clone() for p in inlier.parameters()]
    optimizer = ts.make_optimizer("SGD", inlier.parameters(), config)
    step, _ = make_sharded_train_step(mesh, fcgf, inlier, config, optimizer)
    batch = synthetic_pair_batch(np.random.RandomState(0), b=mesh.size, n=256, p=64)
    loss = float(step(batch)["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun loss not finite: {loss}")
    if all(torch.equal(a, p) for a, p in zip(before, inlier.parameters())):
        raise RuntimeError("dryrun step did not update parameters")
    if mesh.rank == 0:
        print(f"dryrun_multichip({mesh.size}): loss={loss:.4f} ok", flush=True)
    return loss


def dryrun_fanout(n_devices: int, devices=None) -> np.ndarray:
    """One ``register_batch(mesh=...)`` fan-out of ``n_devices`` tiny pairs
    over ``n_devices`` ranks (the JAX ``dryrun_fanout``); prints
    ``dryrun_fanout(n): n pairs ok`` and returns the [n, 4, 4] poses."""
    return spawn(_dryrun_fanout_rank, n_devices, devices=devices)[0]


def _dryrun_fanout_rank(mesh: Mesh) -> np.ndarray:
    from ..core.pipeline import DeepGlobalRegistration

    config = _tiny_config(voxel_size=0.05, inlier_feature_type="ones")
    dgr = DeepGlobalRegistration(config, device=mesh.device)
    rng = np.random.RandomState(0)
    xs, ys = [], []
    for _ in range(mesh.size):
        base = rng.rand(600, 3).astype(np.float32) * 1.5
        shift = rng.rand(3).astype(np.float32) * 0.1
        xs.append(base)
        ys.append(base + shift)
    Ts = dgr.register_batch(xs, ys, mesh=mesh)
    if Ts.shape != (mesh.size, 4, 4) or not np.isfinite(Ts).all():
        raise RuntimeError(f"fan-out gave {Ts.shape} poses, finite {np.isfinite(Ts).all()}")
    if mesh.rank == 0:
        print(f"dryrun_fanout({mesh.size}): {len(xs)} pairs ok", flush=True)
    return Ts
