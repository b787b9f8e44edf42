"""End-to-end synthetic chain on the card: self-train FCGF -> train the inlier
net -> validate -> benchmark recall.

Counterpart of the repo's ``tools/synthetic_e2e.py``. The reference proves
itself by train -> validate -> benchmark (core/trainer.py:120-155 +
scripts/test_3dmatch.py:87-156) on 3DMatch; with no datasets or pretrained
checkpoints at hand, the same chain runs on the procedural synthetic
datasets:

  A. FCGF self-training (``core/fcgf_train.py``, hardest-contrastive, Adam
     at 1e-3 * 0.3^(step / fcgf_steps)), with a 1-NN hit probe on a fixed
     validation batch (``ops/knn.find_nn_batched``: one ``nn1_mma_batched``
     launch on the card); writes ``fcgf_selftrained.pkl``.
  B. Inlier-net training through ``WeightedProcrustesTrainer`` (frozen FCGF
     from A), validated each epoch; writes ``checkpoint.pkl`` and
     ``best_val_checkpoint.pkl``.
  C. The best checkpoint through ``DeepGlobalRegistration``: the room
     profile over the held-out ``SyntheticTrajectoryDataset`` with the port's
     ``scripts.test_3dmatch.evaluate``, the lidar profile over the held-out
     lidar pairs with ``scripts.test_kitti.evaluate``; the stats npz in the
     reference schema and ``summary.json`` (the JAX tool's keys, plus the
     card, each stage's seconds and its 1-NN kernel launches).

Run: python -m deepglobalregistration_tpu_torch.tools.synthetic_e2e
         [--quick] [--profile room|lidar] [--out_dir DIR] [--device cpu]

Every flag of the JAX tool, plus ``--device`` (default ``cuda``: raises
without a card). ``build_config``, ``stage_a``, ``stage_b`` and ``stage_c``
are separate so that a caller can run the stages with other nets by editing
the config between them.
"""

from __future__ import annotations

import argparse
import json
import logging
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import torch
import torch.utils.data

from ..config import default_config
from ..core import fcgf_train as ft
from ..core import train_step as ts
from ..data.factory import make_data_loader
from ..models import load_model
from ..ops import knn
from ..utils import checkpoint as ckpt_utils
from ..utils import convert
from ..utils.device import generator, resolve_device

# The stats npz of each profile's benchmark script.
STATS_NAME = {False: "3dmatch-stats.npz", True: "kitti-stats.npz"}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out_dir", default="outputs/synthetic_e2e")
    ap.add_argument("--quick", action="store_true",
                    help="tiny budget smoke (CI): few steps, small clouds")
    ap.add_argument("--fcgf_steps", type=int, default=None)
    ap.add_argument("--max_epoch", type=int, default=None)
    ap.add_argument("--iters_per_epoch", type=int, default=None)
    ap.add_argument("--synthetic_points", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=2)
    ap.add_argument("--workers", type=int, default=0,
                    help="DataLoader worker processes (default 0: generation "
                         "is ~0.03 s/pair at 15k points). Workers start with "
                         "the spawn method: a process that has initialised "
                         "CUDA must not fork")
    ap.add_argument("--resume_b", default=None,
                    help="resume inlier-net training from this checkpoint")
    ap.add_argument("--skip_a", default=None,
                    help="reuse an existing FCGF checkpoint path")
    ap.add_argument("--skip_b", default=None,
                    help="reuse an existing trained checkpoint path (stage C only)")
    ap.add_argument("--balanced", action="store_true",
                    help="class-balanced inlier BCE (ops/losses.balanced_loss): "
                         "at rotation-augmented train hit ratios of ~5-15% the "
                         "plain BCE collapses the classifier to all-negative")
    ap.add_argument("--profile", choices=["room", "lidar"], default="room",
                    help="room: indoor 3DMatch analogue (5 cm voxels, "
                         "trajectory recall via scripts/test_3dmatch); "
                         "lidar: outdoor KITTI analogue (30 cm voxels, "
                         "conv1=5, TE<0.6m/RE<5deg via scripts/test_kitti)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (raises without a card) or 'cpu' (the "
                         "kernels' plain PyTorch versions)")
    return ap.parse_args(argv)


class Run(NamedTuple):
    """A chain's budget and switches, the flags resolved per profile."""
    quick: bool
    lidar: bool
    n_points: int
    fcgf_steps: int
    max_epoch: int
    iters: int
    workers: int
    out_dir: Path
    resume_b: str | None
    skip_a: str | None
    skip_b: str | None


def build_config(args: argparse.Namespace):
    """(config, run): the JAX tool's profile configs (tools/synthetic_e2e.py:
    105-142) in the port's ``Config``, on ``args.device``."""
    quick = args.quick
    lidar = args.profile == "lidar"
    n_points = args.synthetic_points or (4000 if quick else (30000 if lidar else 15000))
    fcgf_steps = args.fcgf_steps if args.fcgf_steps is not None else (6 if quick else 1200)
    max_epoch = args.max_epoch if args.max_epoch is not None else (1 if quick else 3)
    iters = args.iters_per_epoch if args.iters_per_epoch is not None else (
        2 if quick else 120)
    out_dir = Path(args.out_dir)
    resolve_device(args.device)
    config = default_config(
        dataset="SyntheticLidarPairDataset" if lidar else "SyntheticPairDataset",
        synthetic_points=n_points,
        # The outdoor profile follows the reference KITTI recipe where it
        # differs (scripts/train_kitti.sh: voxel 0.3, conv1=5); the success
        # thresholds are the KITTI test constants.
        voxel_size=0.3 if lidar else 0.05,
        feat_model="ResUNetBN2C", feat_model_n_out=32,
        feat_conv1_kernel_size=5 if lidar else 7,
        inlier_model="ResUNetBN2C", inlier_conv1_kernel_size=3,
        inlier_feature_type="ones",
        optimizer="SGD", lr=1e-1, exp_gamma=0.99,
        batch_size=args.batch_size,
        max_epoch=max_epoch, num_train_iter=iters,
        val_epoch_freq=1, val_max_iter=(2 if quick else 16),
        stat_freq=20, test_valid=False,
        out_dir=str(out_dir),
        success_rte_thresh=0.6 if lidar else 0.3,
        success_rre_thresh=5.0 if lidar else 15.0,
        # f1, not succ_rate: the weighted-Procrustes success saturates within
        # an epoch (it is weight-scale invariant) while the classifier, whose
        # sigmoid mass drives the pipeline's safeguard gate, is still
        # all-negative.
        best_val_metric="f1",
        use_balanced_loss=args.balanced,
        # The port's maps are exact: dense_extent and edge_budget_scale only
        # feed its overflow accounting (the JAX package's dense kernel-map
        # box and 6D edge budgets).
        dense_extent="384,384,128" if lidar else "256,256,256",
        edge_budget_scale=2.5,
        remat=lidar,
        bf16=True,
        device=args.device)
    return config, Run(quick, lidar, n_points, fcgf_steps, max_epoch, iters,
                       args.workers, out_dir, args.resume_b, args.skip_a, args.skip_b)


def fcgf_lr(step: int, fcgf_steps: int) -> float:
    """Stage A's learning rate at ``step`` (0-based): ``optax.exponential_decay(
    1e-3, fcgf_steps, 0.3)``, not staircase, so step 0 runs at 1e-3."""
    return 1e-3 * 0.3 ** (step / fcgf_steps)


def fcgf_net(config, device, seed: int = 0):
    """The FCGF net to self-train (train mode, f32), from a seeded generator."""
    spec = load_model(config.feat_model)
    cfg = spec.make_config(1, config.feat_model_n_out, bn_momentum=config.bn_momentum,
                           conv1_kernel_size=config.feat_conv1_kernel_size,
                           normalize_feature=True, D=3)
    params, state = spec.init_params(generator(seed), cfg)
    net = spec.module(cfg)
    net.load_state_dict(convert.from_jax_params(params, state, cfg))
    return net.to(device).train()


@torch.no_grad()
def probe_match(net, batch):
    """The hit probe's features [2B, N, C] f32 (eval-mode BN) and each
    pair's feature 1-NN [B, N] (``knn.find_nn_batched``)."""
    was = net.training
    net.eval()
    try:
        feats = ts.fcgf_features(net, batch)
    finally:
        net.train(was)
    b = batch.xyz0.shape[0]
    idx = knn.find_nn_batched(feats[:b], feats[b:], batch.num0, batch.num1)[0]
    return feats, idx


def hit_ratio(batch, idx: torch.Tensor, radius: float) -> float:
    """The share of valid rows whose feature 1-NN lies within ``radius`` of
    the row's ground-truth position in cloud 1 (tools/synthetic_e2e.py:
    182-205 of the JAX tool)."""
    n = batch.xyz0.shape[1]
    T = batch.T_gt.float()
    x0in1 = torch.einsum("bij,bnj->bni", T[:, :3, :3], batch.xyz0.float()) \
        + T[:, None, :3, 3]
    nn_xyz = torch.gather(batch.xyz1.float(), 1, idx.long()[..., None].expand(-1, -1, 3))
    d = torch.linalg.norm(x0in1 - nn_xyz, dim=-1)
    valid = torch.arange(n, device=idx.device)[None, :] < batch.num0[:, None]
    return float(((d < radius) & valid).sum() / torch.clamp(valid.sum(), min=1))


def hit_probe(net, batch, radius: float) -> float:
    return hit_ratio(batch, probe_match(net, batch)[1], radius)


def _launches() -> dict:
    return {"nn1_scan": knn.nn1_scan.launches, "nn1_mma": knn.nn1_mma.launches,
            "nn1_scan_batched": knn.nn1_scan_batched.launches,
            "nn1_mma_batched": knn.nn1_mma_batched.launches}


def _loader(config, phase: str, workers: int = 0):
    return make_data_loader(config, phase, config.batch_size, num_workers=workers,
                            multiprocessing_context="spawn" if workers > 0 else None)


def stage_a(config, run: Run, summary: dict) -> dict:
    """FCGF self-training; writes ``fcgf_selftrained.pkl`` in the JAX schema.
    Returns the checkpoint's path, the net, the probe batch and the losses."""
    dev = resolve_device(config.device)
    print(f"[A] FCGF self-training: {run.fcgf_steps} steps "
          f"({run.n_points} pts/cloud)", flush=True)
    net = fcgf_net(config, dev)
    opt = torch.optim.Adam(net.parameters(), lr=fcgf_lr(0, run.fcgf_steps))
    n = 256 if run.quick else 1024
    loss_cfg = ft.FCGFLossConfig(num_pos=n, num_neg=n, neg_radius=2 * config.voxel_size)
    step, _ = ft.make_fcgf_train_step(net, loss_cfg, opt)

    val_loader = make_data_loader(config, "val", config.batch_size, num_workers=0)
    probe_batch = ts.batch_to(next(iter(val_loader))["pair_batch"], dev)
    radius = config.voxel_size * config.positive_pair_search_voxel_size_multiplier

    it = iter(_loader(config, "train", run.workers))
    gen = generator(42, dev)
    losses = []
    t0 = time.time()
    for i in range(run.fcgf_steps):
        batch = ts.batch_to(next(it)["pair_batch"], dev)
        draws = [ft.draw_indices(gen, batch.pos_num[k], batch.num0[k], batch.num1[k],
                                 loss_cfg) for k in range(batch.xyz0.shape[0])]
        ts.set_lr(opt, fcgf_lr(i, run.fcgf_steps))
        stats = step(batch, draws)
        losses.append(float(stats["loss"]))
        if i % 20 == 0 or i == run.fcgf_steps - 1:
            hit = hit_probe(net, probe_batch, radius) \
                if (i % 100 == 0 or i == run.fcgf_steps - 1) else None
            print(f"[A] step {i}: loss {losses[-1]:.4f} "
                  f"pos {float(stats['pos_loss']):.4f} "
                  f"neg {float(stats['neg_loss']):.4f}"
                  + (f" val_hit {hit:.3f}" if hit is not None else "")
                  + f" ({time.time() - t0:.0f}s)", flush=True)
    summary["fcgf_final_loss"] = losses[-1] if losses else None
    summary["fcgf_val_hit_ratio"] = hit_probe(net, probe_batch, radius)
    path = str(run.out_dir / "fcgf_selftrained.pkl")
    params, state = convert.to_jax_params(net)
    ckpt_utils.save_checkpoint(path, epoch=0, params=params, state=state)
    print(f"[A] saved {path}", flush=True)
    return {"ckpt": path, "net": net, "probe_batch": probe_batch, "losses": losses,
            "radius": radius}


def stage_b(config, run: Run, fcgf_ckpt: str, summary: dict) -> dict:
    """Inlier-net training from stage A's FCGF; returns the best (else the
    last) checkpoint's path and the trainer."""
    from ..core.trainer import WeightedProcrustesTrainer

    print(f"[B] inlier-net training: {run.max_epoch} epochs x {run.iters} iters",
          flush=True)
    config.weights = fcgf_ckpt
    if run.resume_b:
        config.resume = run.resume_b
    train_loader = _loader(config, "train", run.workers)
    val_loader = _loader(config, "val")
    trainer = WeightedProcrustesTrainer(config, train_loader, val_loader)
    trainer.train()
    best = Path(config.out_dir) / "best_val_checkpoint.pkl"
    best_ckpt = str(best if best.exists() else Path(config.out_dir) / "checkpoint.pkl")
    summary["best_val"] = trainer.best_val
    summary["best_val_epoch"] = trainer.best_val_epoch
    print(f"[B] best ckpt {best_ckpt} ({trainer.best_val_metric} "
          f"{trainer.best_val:.4f})", flush=True)
    return {"ckpt": best_ckpt, "trainer": trainer}


def _identity(batch):
    return batch


def stage_c(config, run: Run, best_ckpt: str, summary: dict) -> dict:
    """The benchmark of the best checkpoint; fills the summary's recall, TE,
    RE, time and pair count; returns the stats [N, 5] and the pipeline."""
    from ..core.pipeline import DeepGlobalRegistration

    config.weights = best_ckpt
    dgr = DeepGlobalRegistration(config, device=config.device)
    if run.lidar:
        print("[C] KITTI-analogue benchmark on held-out lidar pairs", flush=True)
        from ..scripts.test_kitti import evaluate as evaluate_kitti

        loader = make_data_loader(config, "test", batch_size=1, num_workers=0,
                                  shuffle=False)
        if run.quick:
            loader.dataset.files = loader.dataset.files[:2]
        s = evaluate_kitti(config, loader, dgr)
    else:
        print("[C] benchmark on held-out synthetic trajectories", flush=True)
        from ..data.synthetic import SyntheticTrajectoryDataset
        from ..scripts.test_3dmatch import evaluate

        dset = SyntheticTrajectoryDataset(n_points=run.n_points,
                                          n_scenes=2 if run.quick else 4,
                                          pairs_per_scene=1 if run.quick else 8)
        loader = torch.utils.data.DataLoader(dset, batch_size=1, shuffle=False,
                                             num_workers=0, collate_fn=_identity)
        s = evaluate([dgr], ["DGR-torch-synthetic"], loader, config)[0]
    succ = s[:, 0]
    summary.update(
        recall=float(succ.mean()),
        te=float(s[succ > 0, 1].mean()) if succ.any() else None,
        re=float(s[succ > 0, 2].mean()) if succ.any() else None,
        mean_time_s=float(s[:, 3].mean()),
        n_pairs=int(s.shape[0]),
        stats_npz=str(Path(config.out_dir) / STATS_NAME[run.lidar]))
    return {"stats": s, "dgr": dgr}


def card(device) -> str:
    """The card's ``nvidia-smi`` name and power limit, or the device's name."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return str(dev)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip().splitlines()
        return out[dev.index or 0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"


def main(argv=None) -> dict:
    """Run the chain; writes and returns the summary."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(asctime)s %(name)s %(message)s",
                        datefmt="%m/%d %H:%M:%S")
    config, run = build_config(args)
    run.out_dir.mkdir(parents=True, exist_ok=True)
    summary = {"n_points": run.n_points, "fcgf_steps": run.fcgf_steps,
               "max_epoch": run.max_epoch, "iters_per_epoch": run.iters}
    extra = {"device": config.device, "card": card(config.device), "stage_s": {},
             "launches": {}}

    def timed(name, fn, *a):
        before = _launches()
        t0 = time.time()
        out = fn(*a)
        if torch.device(config.device).type == "cuda":
            torch.cuda.synchronize()
        extra["stage_s"][name] = time.time() - t0
        extra["launches"][name] = {k: v - before[k] for k, v in _launches().items()}
        return out

    fcgf_ckpt = run.skip_a
    if fcgf_ckpt is None:
        a = timed("a", stage_a, config, run, summary)
        fcgf_ckpt, extra["fcgf_losses"] = a["ckpt"], a["losses"]
    best_ckpt = run.skip_b
    if best_ckpt is None:
        best_ckpt = timed("b", stage_b, config, run, fcgf_ckpt, summary)["ckpt"]
    timed("c", stage_c, config, run, best_ckpt, summary)
    summary.update(extra)
    with open(run.out_dir / "summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    print("[C] summary:", json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
