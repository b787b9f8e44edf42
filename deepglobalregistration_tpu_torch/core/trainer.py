"""WeightedProcrustesTrainer: the training loop of the inlier net, on the card.

Counterpart of the JAX package's ``core/trainer.py`` (reference
core/trainer.py:38-679): the step of ``core/train_step.py`` over the host
data loader, per-epoch training with gradient accumulation (``iter_size``)
and a NaN check before each update, the epoch learning rate
``lr * exp_gamma ** epoch``, ``checkpoint.pkl`` every epoch and
``best_val_checkpoint.pkl`` on ``best_val_metric``, resume, and the
reference's validation metrics (hit ratio, precision / recall / F1,
balanced accuracy, RTE / RRE, success rate). Scalars go to
``scalars.jsonl`` (and to tensorboardX when it imports) under the JAX
trainer's tags.

The nets and batches live on ``config.device`` (``"cuda"`` unless the
caller asks for ``"cpu"``; no card raises). The FCGF net is frozen: eval
mode, BN unfolded, f32. Validation runs the inlier net as the JAX
trainer's validation does, in train-mode BN, with the running statistics
restored afterwards.

``num_devices`` N > 1 trains data-parallel: one trainer a rank of a mesh
(``parallel/data_parallel.py``; ``train.main`` launches them), on the
rank's device. Rank 0 draws each batch from its loader and broadcasts it;
every rank runs its shard (``make_sharded_train_step``), so every rank
holds the same parameters after every update. Rank 0 validates alone,
unsharded, with the inlier net's BN group off, while the other ranks wait
at a barrier: the JAX trainer's validation is unsharded too, so any
``val_batch_size`` works (the default is 1), the validation loader is
drawn once, and no card but rank 0's is needed for it. Only rank 0 writes
checkpoints, scalars and logs; a resume reads on every rank.
"""

from __future__ import annotations

import json
import logging
import os.path as osp
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ..models import load_model
from ..ops import metrics as metric_ops
from ..parallel import data_parallel as dp
from ..utils import checkpoint as ckpt_utils
from ..utils import convert, device as device_utils
from ..utils.timer import AverageMeter, Timer
from . import train_step as ts
from .pipeline import build_net


class ScalarWriter:
    """JSONL scalar stream, plus tensorboardX where it imports."""

    def __init__(self, out_dir: str):
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        self._f = open(osp.join(out_dir, "scalars.jsonl"), "a")
        try:
            from tensorboardX import SummaryWriter  # type: ignore

            self._tb = SummaryWriter(out_dir)
        except Exception:
            self._tb = None

    def add_scalar(self, tag: str, value: float, step: int):
        self._f.write(json.dumps({"tag": tag, "value": float(value), "step": step}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class _NoWriter:
    """The scalar stream of a rank other than 0: writes nothing."""

    def add_scalar(self, tag: str, value: float, step: int):
        pass

    def close(self):
        pass


def _classification_stats(logits: np.ndarray, labels: np.ndarray, valid: np.ndarray):
    """Precision / recall / F1 / TPR / TNR / balanced accuracy over the
    valid rows (trainer.py:306-341, 353-489); logit > 0 is sigmoid > 0.5."""
    pred = (logits > 0.0) & valid
    gt = (labels > 0.5) & valid
    tp = float((pred & gt).sum())
    fp = float((pred & ~gt & valid).sum())
    fn = float((~pred & gt).sum())
    tn = float((~pred & ~gt & valid).sum())
    precision = tp / max(tp + fp, 1.0)
    recall = tp / max(tp + fn, 1.0)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    tnr = tn / max(tn + fp, 1.0)
    return dict(precision=precision, recall=recall, f1=f1, tpr=recall, tnr=tnr,
                balanced_accuracy=(recall + tnr) / 2)


def _hit_ratio(labels: np.ndarray, valid: np.ndarray) -> float:
    """The ground-truth positive rate of the predicted matches
    (trainer.py:395)."""
    return float((labels * valid).sum() / max(valid.sum(), 1))


def _config_dict(config) -> dict:
    return {k: v for k, v in vars(config).items()
            if isinstance(v, (int, float, str, bool, type(None)))}


def build_nets(config, device, trees=None):
    """The trainer's nets on ``device``: the frozen FCGF (eval mode, BN
    unfolded, f32) from ``config.weights`` or a seeded generator, and the
    trainable 6D inlier net (train mode) from another (trainer.py:60-108).
    ``trees`` = (FCGF tree, inlier tree), each (params, state) in the JAX
    layout, takes their place. Returns (fcgf, inlier)."""
    fcgf_spec = load_model(config.feat_model)
    fcgf_cfg = fcgf_spec.make_config(
        1, config.feat_model_n_out, conv1_kernel_size=config.feat_conv1_kernel_size,
        normalize_feature=config.normalize_feature, D=3,
        bn_momentum=config.bn_momentum)
    inlier_in = {"coords": 6, "feats": 2 * config.feat_model_n_out}.get(
        config.inlier_feature_type, 1)
    inlier_spec = load_model(config.inlier_model)
    inlier_cfg = inlier_spec.make_config(
        inlier_in, 1, conv1_kernel_size=config.inlier_conv1_kernel_size,
        normalize_feature=False, D=6, bn_momentum=config.bn_momentum)
    if trees is not None:
        fcgf_tree, inlier_tree = trees
    else:
        seed = int(getattr(config, "seed", 0))
        fcgf_tree = fcgf_spec.init_params(device_utils.generator(seed), fcgf_cfg)
        inlier_tree = inlier_spec.init_params(device_utils.generator(seed + 1),
                                              inlier_cfg)
        # Pretrained FCGF from --weights (trainer.py:69-90).
        if config.weights:
            if str(config.weights).endswith((".pth", ".pt")):
                state = ckpt_utils.load_torch_checkpoint(config.weights)
                fcgf_tree = (state["fcgf_params"], state["fcgf_state"])
            else:
                sd = ckpt_utils.load_checkpoint(config.weights)["state_dict"]
                fcgf_tree = (sd["params"], sd["state"])
    fcgf = build_net(fcgf_spec, fcgf_tree, fcgf_cfg, False, torch.float32, device)
    inlier = inlier_spec.module(inlier_cfg)
    inlier.load_state_dict(convert.from_jax_params(*inlier_tree, inlier_cfg))
    return fcgf, inlier.to(device).train()


class WeightedProcrustesTrainer:
    """``mesh``: this rank's ``data_parallel.Mesh`` when ``config.num_devices``
    > 1 (one trainer a rank, each given the same loaders)."""

    def __init__(self, config, data_loader, val_data_loader=None, mesh=None):
        n_dev = int(config.num_devices or 1)
        if config.batch_size % n_dev:
            raise ValueError(f"batch_size {config.batch_size} not divisible by "
                             f"num_devices {n_dev}")
        if (mesh.size if mesh is not None else 1) != n_dev:
            raise ValueError(
                f"num_devices={n_dev} trains on {n_dev} ranks, one trainer each "
                f"(mesh: {mesh}); launch them through train.main or "
                "parallel.data_parallel.spawn")
        self.mesh = mesh if n_dev > 1 else None
        self.is_main = self.mesh is None or self.mesh.rank == 0
        self.config = config
        self.device = self.mesh.device if self.mesh is not None \
            else device_utils.resolve_device(config.device)
        self.data_loader = data_loader
        self.val_data_loader = val_data_loader
        self.out_dir = config.out_dir
        self.writer = ScalarWriter(self.out_dir) if self.is_main else _NoWriter()
        self.log = logging.getLogger("trainer")
        self.log.disabled = not self.is_main

        self.fcgf, self.inlier = build_nets(config, self.device)
        self.optimizer = ts.make_optimizer(config.optimizer, self.inlier.parameters(),
                                           config)
        # The unsharded closures (validation's, and the step without a mesh).
        self.step_fn, self.loss_fn = ts.make_train_step(
            self.fcgf, self.inlier, config, self.optimizer)
        self._val_loss_fn = self.loss_fn
        if self.mesh is not None:
            self.step_fn, self.loss_fn = dp.make_sharded_train_step(
                self.mesh, self.fcgf, self.inlier, config, self.optimizer)

        self.start_epoch = 0
        self.best_val = -1e8
        self.best_val_epoch = -1
        self.best_val_metric = config.best_val_metric
        self.curr_iter = 0
        if self.is_main:
            with open(osp.join(self.out_dir, "config.json"), "w") as f:
                json.dump(_config_dict(config), f, indent=2)
        if config.resume:
            self._load_weights(config.resume)
        if self.mesh is not None:
            dp.replicate(self.mesh, self.fcgf)
            dp.replicate(self.mesh, self.inlier)

    def epoch_lr(self, epoch: int) -> float:
        """ExponentialLR stepped once an epoch (trainer.py:110)."""
        return self.config.lr * (self.config.exp_gamma ** epoch)

    def _batch(self, data_iter, local: bool = False):
        """The next batch: tensors on the device; with a mesh (unless
        ``local``), rank 0's collated (numpy) batch on every rank, which the
        sharded step slices."""
        if self.mesh is None or local:
            return ts.batch_to(next(data_iter)["pair_batch"], self.device)
        return dp.broadcast_object(
            self.mesh, next(data_iter)["pair_batch"] if self.is_main else None)


    # ------------------------------------------------------------------
    def train(self):
        """Epoch loop with validation gating (trainer.py:120-155); closes
        the scalar stream at the end."""
        try:
            self._train()
        finally:
            self.writer.close()

    def _validate(self) -> Dict[str, float] | None:
        """``_valid_epoch``; with a mesh on rank 0 alone, the BN group off,
        while the other ranks wait (they return None)."""
        if self.mesh is None:
            return self._valid_epoch()
        out = None
        if self.is_main:
            self.inlier.set_bn_group(None)
            try:
                out = self._valid_epoch()
            finally:
                self.inlier.set_bn_group(self.mesh.group)
        dp.barrier(self.mesh)
        return out

    def _train(self):
        if self.config.test_valid and self.val_data_loader is not None:
            val_dict = self._validate()
            for k, v in (val_dict or {}).items():
                self.writer.add_scalar(f"val/{k}", v, self.start_epoch)

        for epoch in range(self.start_epoch, self.config.max_epoch):
            lr = self.epoch_lr(epoch)
            ts.set_lr(self.optimizer, lr)
            self.log.info("epoch %d lr %.3e", epoch, lr)
            self._train_epoch(epoch)
            self._save_checkpoint(epoch)
            if self.val_data_loader is not None and \
                    (epoch + 1) % self.config.val_epoch_freq == 0:
                val_dict = self._validate()
                if val_dict is None:  # a rank other than 0
                    continue
                for k, v in val_dict.items():
                    self.writer.add_scalar(f"val/{k}", v, epoch)
                if self.best_val < val_dict[self.best_val_metric]:
                    self.best_val = val_dict[self.best_val_metric]
                    self.best_val_epoch = epoch
                    self._save_checkpoint(epoch, "best_val_checkpoint")

    def _train_epoch(self, epoch: int):
        config = self.config
        iter_size = config.iter_size
        data_timer, step_timer = Timer(), Timer()
        loss_meter = AverageMeter()
        data_iter = iter(self.data_loader) if self.is_main else None
        num_iter = len(self.data_loader) // iter_size
        if config.num_train_iter > 0:
            num_iter = min(num_iter, config.num_train_iter)
        params = list(self.inlier.parameters())
        for it in range(num_iter):
            if iter_size == 1:
                data_timer.tic()
                batch = self._batch(data_iter)
                data_timer.toc()
                step_timer.tic()
                stats = self.step_fn(batch)
                loss = float(stats["loss"])
                step_timer.toc()
            else:
                # Gradient accumulation (trainer.py:198): the mean of the
                # sub-batches' gradients, one NaN check, one update.
                self.optimizer.zero_grad(set_to_none=True)
                loss = 0.0
                for _ in range(iter_size):
                    data_timer.tic()
                    batch = self._batch(data_iter)
                    data_timer.toc()
                    sub_loss, stats = self.loss_fn(batch)
                    (sub_loss / iter_size).backward()
                    loss += float(stats["loss"].detach()) / iter_size
                if self.mesh is not None:
                    dp.all_reduce_grads(self.mesh, params)
                if ts.grads_finite(params):
                    self.optimizer.step()
                else:
                    self.log.warning("NaN accumulated grads, skipping step")

            loss_meter.update(loss)
            self.curr_iter += 1
            if self.curr_iter % config.stat_freq == 0:
                labels = stats["labels"].cpu().numpy()
                valid = stats["valid"].cpu().numpy()
                cls = _classification_stats(stats["logits"].detach().cpu().numpy(),
                                            labels, valid)
                cls["hit_ratio"] = _hit_ratio(labels, valid)
                self.writer.add_scalar("train/loss", loss_meter.avg, self.curr_iter)
                for k, v in cls.items():
                    self.writer.add_scalar(f"train/{k}", v, self.curr_iter)
                self.log.info(
                    "epoch %d iter %d loss %.4f data %.3fs step %.3fs f1 %.3f "
                    "hit %.3f", epoch, it, loss_meter.avg, data_timer.avg,
                    step_timer.avg, cls["f1"], cls["hit_ratio"])
                loss_meter.reset()

    @torch.no_grad()
    def _valid_epoch(self) -> Dict[str, float]:
        """Validation metrics (trainer.py:353-489): classification stats and
        the per-pair weighted Procrustes' RTE / RRE / success."""
        config = self.config
        agg = {k: 0.0 for k in ["precision", "recall", "f1", "tpr", "tnr",
                                "balanced_accuracy", "hit_ratio"]}
        rtes, rres, succ = [], [], []
        it = iter(self.val_data_loader)
        num_iter = min(len(self.val_data_loader), config.val_max_iter)
        with ts.kept_bn_state(self.inlier):
            for _ in range(num_iter):
                batch = self._batch(it, local=True)
                stats = self._val_loss_fn(batch)[1]
                labels = stats["labels"].cpu().numpy()
                valid = stats["valid"].cpu().numpy()
                cls = _classification_stats(stats["logits"].cpu().numpy(), labels, valid)
                cls["hit_ratio"] = _hit_ratio(labels, valid)
                for k in agg:
                    agg[k] += cls[k]
                R, t, T_gt = stats["R"], stats["t"], batch.T_gt
                for i in range(R.shape[0]):
                    rte = float(torch.linalg.norm(t[i] - T_gt[i, :3, 3]))
                    rre = float(torch.rad2deg(metric_ops.rotation_error(
                        R[i], T_gt[i, :3, :3])))
                    rtes.append(rte)
                    rres.append(rre)
                    succ.append(rte < config.success_rte_thresh and
                                rre < config.success_rre_thresh)
        out = {k: v / max(num_iter, 1) for k, v in agg.items()}
        out.update(rte=float(np.mean(rtes)), rre=float(np.mean(rres)),
                   succ_rate=float(np.mean(succ)))
        self.log.info("validation: %s", {k: round(v, 4) for k, v in out.items()})
        return out

    # ------------------------------------------------------------------
    def _save_checkpoint(self, epoch: int, filename: str = "checkpoint"):
        """The reference's checkpoint schema (trainer.py:527-549), with the
        JAX trainer's size knobs (--ckpt_dtype / --ckpt_compress /
        --ckpt_save_optimizer / --ckpt_save_fcgf). Rank 0 alone writes."""
        if not self.is_main:
            return
        path = osp.join(self.out_dir, filename + ".pkl")
        cfg = self.config
        fcgf = convert.to_jax_params(self.fcgf) if cfg.ckpt_save_fcgf else (None, None)
        inlier = convert.to_jax_params(self.inlier)
        ckpt_utils.save_checkpoint(
            path, epoch=epoch, params=fcgf[0], state=fcgf[1],
            inlier_params=inlier[0], inlier_state=inlier[1],
            opt_state=self.optimizer.state_dict() if cfg.ckpt_save_optimizer else None,
            config=_config_dict(cfg), best_val=self.best_val,
            best_val_epoch=self.best_val_epoch, best_val_metric=self.best_val_metric,
            dtype=str(cfg.ckpt_dtype or "f32"), compress=bool(cfg.ckpt_compress))
        self.log.info("saved checkpoint %s (epoch %d)", path, epoch)

    def _load_weights(self, resume_path: str):
        """Resume epoch, nets, optimizer state when saved, and best-val
        (trainer.py:491-525). A checkpoint without the FCGF tree
        (``--ckpt_save_fcgf false``) keeps the ``--weights`` FCGF."""
        state = ckpt_utils.load_checkpoint(resume_path)
        self.start_epoch = state["epoch"] + 1
        if state.get("state_dict") is not None:
            sd = state["state_dict"]
            self.fcgf.load_state_dict(convert.from_jax_params(
                sd["params"], sd["state"], self.fcgf.cfg))
        else:
            self.log.info("checkpoint has no FCGF tree; keeping current "
                          "feature-net weights")
        si = state["state_dict_inlier"]
        self.inlier.load_state_dict(convert.from_jax_params(
            si["params"], si["state"], self.inlier.cfg))
        if state.get("optimizer") is not None:
            self.optimizer.load_state_dict(_as_tensors(state["optimizer"]))
        self.best_val = state.get("best_val", -1e8)
        self.best_val_epoch = state.get("best_val_epoch", -1)
        self.log.info("resumed from %s at epoch %d", resume_path, self.start_epoch)


def _as_tensors(tree):
    """An optimizer state_dict read back from numpy (arrays -> tensors)."""
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_tensors(v) for v in tree]
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    return tree
