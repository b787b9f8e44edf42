"""DeepGlobalRegistration — the end-to-end registration pipeline on the card.

Counterpart of the JAX package's ``core/pipeline.py:71-202`` (construction)
and of ``register()`` in its fused form (``:374-422``, ``register_fused``):

  voxelize both clouds -> FCGF forward (one batch of B = 2 clouds) ->
  feature 1-NN (CUDA kernel) -> 6D inlier net on the correspondences ->
  sigmoid, clip at ``clip_weight_thresh`` -> weighted-sum gate
  ``wsum >= max(200, 0.05 * N0)`` -> Procrustes + Adam refinement, or the
  safeguard RANSAC -> full-scan ICP (CUDA kernel every iteration).

PyTorch runs eagerly, so the port needs none of the JAX package's static
buckets, padding or speculative rebucketing: every stage runs at the true
voxel counts, and its maps are exact. ``overflow_count`` still counts the
pairs on which the JAX package's fixed capacities would have dropped
kernel-map entries (``models/unet_plan.py``), so both report alike.
"""

from __future__ import annotations

import logging
import time
from typing import Dict

import numpy as np
import torch

from ..models import resunet
from ..models.unet_plan import build_unet_plan
from ..ops import icp as icp_ops
from ..ops import knn, ransac, se3, sparse_grid
from ..utils import checkpoint, convert, device as device_utils
from ..utils.fold_bn import fold_batch_norms
from . import registration

log = logging.getLogger(__name__)

_DEFAULT_BUCKETS = (8192, 16384, 32768, 65536, 131072)
STAGES = ("voxelize", "fcgf", "match", "inlier", "solve", "icp")


class Timer:
    """tic/toc stopwatch with call averaging (the JAX package's utils/timer)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.avg = 0.0

    def tic(self):
        self.start_time = time.perf_counter()

    def toc(self) -> float:
        diff = time.perf_counter() - self.start_time
        self.total_time += diff
        self.calls += 1
        self.avg = self.total_time / self.calls
        return diff


def _bucket_for(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"cloud with {n} points exceeds the largest bucket {buckets[-1]}")


def _get(cfg, key, default=None):
    return cfg.get(key, default) if isinstance(cfg, dict) else getattr(cfg, key, default)


class DeepGlobalRegistration:
    """Pairwise registration; ``register(xyz0, xyz1)`` returns a 4x4 float64
    transform taking xyz0 into xyz1's frame.

    ``device`` defaults to ``"cuda"`` and raises when no card is visible;
    pass ``device="cpu"`` to run the plain PyTorch versions of the kernels.
    With ``config.weights`` the checkpoint's embedded config picks voxel size
    and models; a feature-only checkpoint gets a random inlier net drawn from
    a seeded generator (``inlier_trained`` is then False)."""

    def __init__(self, config, device: str | torch.device = "cuda"):
        self.device = device_utils.resolve_device(device)
        self.config = config
        self.clip_weight_thresh = config.clip_weight_thresh
        self.feat_timer = Timer()
        self.stage_timers: Dict[str, Timer] = {s: Timer() for s in STAGES}
        self.overflow_count = 0
        self.buckets = tuple(int(b) for b in str(config.point_buckets).split(",")
                             if b) or _DEFAULT_BUCKETS
        self.level_shrink = int(config.level_shrink)
        self.level_shrink_6d = int(config.level_shrink_6d)
        de = str(config.dense_extent or "")
        self.dense_extent = tuple(int(x) for x in de.split(",")) if de else None
        self.ransac_hypotheses = int(config.ransac_hypotheses)
        self.compute_dtype = torch.bfloat16 if config.bf16 else torch.float32
        self._rng = device_utils.generator(0, self.device)

        inlier_tree = None
        if config.weights:
            if str(config.weights).endswith((".pth", ".pt")):
                raise NotImplementedError(".pth checkpoints are not ported yet")
            state = checkpoint.load_checkpoint(config.weights)
            net = state["config"]
            self.voxel_size = _get(net, "voxel_size")
            self.inlier_feature_type = _get(net, "inlier_feature_type")
            feat_model = _get(net, "feat_model", _get(net, "model"))
            feat_n_out = _get(net, "feat_model_n_out", _get(net, "model_n_out"))
            feat_k1 = _get(net, "feat_conv1_kernel_size",
                           _get(net, "conv1_kernel_size"))
            normalize = _get(net, "normalize_feature")
            inlier_model = _get(net, "inlier_model")
            inlier_k1 = _get(net, "inlier_conv1_kernel_size")
            fcgf_tree = (state["state_dict"]["params"], state["state_dict"]["state"])
            if state.get("state_dict_inlier") is not None:
                si = state["state_dict_inlier"]
                inlier_tree = (si["params"], si["state"])
        else:
            self.voxel_size = config.voxel_size
            self.inlier_feature_type = config.inlier_feature_type
            feat_model, feat_n_out = config.feat_model, config.feat_model_n_out
            feat_k1, normalize = config.feat_conv1_kernel_size, config.normalize_feature
            inlier_model = config.inlier_model
            inlier_k1 = config.inlier_conv1_kernel_size
            fcgf_tree = None
        self.fcgf_cfg = resunet.make_config(
            feat_model, 1, feat_n_out, conv1_kernel_size=feat_k1, normalize_feature=normalize, D=3)
        inlier_in = {"coords": 6, "feats": 2 * feat_n_out}.get(
            self.inlier_feature_type, 1)
        self.inlier_cfg = resunet.make_config(
            inlier_model, inlier_in, 1, conv1_kernel_size=inlier_k1, normalize_feature=False, D=6)
        if fcgf_tree is None:
            fcgf_tree = resunet.init_params(device_utils.generator(0), self.fcgf_cfg)
        self.inlier_trained = inlier_tree is not None
        if inlier_tree is None:
            inlier_tree = resunet.init_params(device_utils.generator(1), self.inlier_cfg)
        self.fcgf = self._module(fcgf_tree, self.fcgf_cfg)
        self.inlier = self._module(inlier_tree, self.inlier_cfg)
        self.fcgf_cfg, self.inlier_cfg = self.fcgf.cfg, self.inlier.cfg

    def _module(self, tree, cfg) -> resunet.ResUNet:
        params, state, cfg = fold_batch_norms(*tree, cfg)
        net = resunet.ResUNet(cfg)
        net.load_state_dict(convert.from_jax_params(params, state, cfg))
        if self.compute_dtype != torch.float32:
            net.round_weights(self.compute_dtype)
        return net.to(self.device).eval()

    def _as_tensor(self, pcd) -> torch.Tensor:
        if hasattr(pcd, "points"):
            pcd = pcd.points
        return torch.as_tensor(np.asarray(pcd, np.float32), device=self.device)

    def _stage(self, name: str, start: bool):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = self.stage_timers[name]
        t.tic() if start else t.toc()

    def features(self, xyz0: torch.Tensor, xyz1: torch.Tensor):
        """Voxelize both clouds and run FCGF on them as one batch.

        Returns (selected points 0, 1, voxel grids 0, 1, features 0, 1, the
        JAX package's overflow count for the 3D plan)."""
        self._stage("voxelize", True)
        sel0, g0 = sparse_grid.voxelize(xyz0, self.voxel_size, 0)
        sel1, g1 = sparse_grid.voxelize(xyz1, self.voxel_size, 1)
        self._stage("voxelize", False)
        n0 = g0.shape[0]
        self._cap = _bucket_for(max(n0, g1.shape[0]), self.buckets)
        self._stage("fcgf", True)
        self.feat_timer.tic()
        plan = build_unet_plan(
            torch.cat([g0, g1]), 2, self.fcgf_cfg.conv1_kernel_size,
            self.fcgf_cfg.region_type, self.fcgf_cfg.levels, capacity=self._cap,
            level_shrink=self.level_shrink, dense_extent=self.dense_extent,
            ones_input=self.fcgf_cfg.in_channels == 1)
        ones = torch.ones((plan.grids[0].shape[0], 1), dtype=self.compute_dtype,
                          device=self.device)
        feats = self.fcgf(plan, ones).float()
        self._stage("fcgf", False)
        self.feat_timer.toc()
        return sel0, sel1, g0, g1, feats[:n0], feats[n0:], plan.overflow

    def inlier_weights(self, sel0, sel1, g0, g1, f0, f1, idx1):
        """6D inlier net on the correspondences (row i <-> idx1[i]); returns
        (clipped sigmoid weights [N0], overflow count of the 6D plan)."""
        n0 = g0.shape[0]
        c6 = torch.cat([torch.zeros_like(g0[:, :1]), g0[:, 1:], g1[idx1, 1:]], dim=1)
        if self.inlier_feature_type == "ones":
            ifeat = torch.ones((n0, 1), device=self.device)
        elif self.inlier_feature_type == "feats":
            ifeat = torch.cat([f0, f1[idx1]], dim=1)
        elif self.inlier_feature_type == "coords":
            ifeat = torch.cat([torch.cos(sel0), torch.cos(sel1[idx1])], dim=1)
        else:
            raise TypeError(f"undefined inlier feature type {self.inlier_feature_type}")
        cfg = self.inlier_cfg
        plan = build_unet_plan(c6, 1, cfg.conv1_kernel_size, cfg.region_type,
                               cfg.levels, capacity=self._cap,
                               level_shrink=self.level_shrink_6d,
                               dense_extent=self.dense_extent)
        logits = self.inlier(plan, ifeat.to(self.compute_dtype))
        w = torch.sigmoid(logits[:, 0].float())
        if self.clip_weight_thresh > 0:
            w = torch.where(w < self.clip_weight_thresh, torch.zeros_like(w), w)
        return w, plan.overflow

    @torch.no_grad()
    def register(self, xyz0, xyz1) -> np.ndarray:
        """Register xyz0 onto xyz1; returns the 4x4 float64 transform."""
        xyz0, xyz1 = self._as_tensor(xyz0), self._as_tensor(xyz1)
        sel0, sel1, g0, g1, f0, f1, ov3 = self.features(xyz0, xyz1)
        self._stage("match", True)
        idx1 = knn.find_nn(f0, f1)[0].long()
        self._stage("match", False)
        self._stage("inlier", True)
        w, ov6 = self.inlier_weights(sel0, sel1, g0, g1, f0, f1, idx1)
        wsum = float(torch.sum(w))
        self._stage("inlier", False)
        if ov3 or ov6:
            self.overflow_count += 1
            log.warning("the JAX package's fixed kernel-map capacities would "
                        "drop entries on this pair (3D: %d, 6D: %d)", ov3, ov6)
        n0 = g0.shape[0]
        thresh = max(200.0, 0.05 * n0)
        log.info("Weighted sum %.2f %s threshold %.1f", wsum,
                 ">=" if wsum >= thresh else "<", thresh)
        self.last_branch = "refine" if wsum >= thresh else "ransac"
        self._stage("solve", True)
        x1c = sel1[idx1]
        if wsum >= thresh:
            res = registration.global_registration(
                sel0, x1c, w, break_threshold_ratio=1e-4,
                quantization_size=2 * self.voxel_size)
        else:
            res = ransac.ransac_correspondence(
                sel0, x1c, distance_threshold=2 * self.voxel_size,
                num_hypotheses=self.ransac_hypotheses, generator=self._rng)
        T = se3.rt_to_matrix(res.R, res.t)
        self.last_iterations = {"refine": getattr(res, "iterations", 0)}
        self._stage("solve", False)
        self._stage("icp", True)
        res = icp_ops.registration_icp(sel0, sel1, 2 * self.voxel_size, init=T)
        self.last_iterations["icp"] = res.iterations
        self._stage("icp", False)
        T = res.T
        return T.double().cpu().numpy()

    def register_many(self, xyz0_list, xyz1_list) -> np.ndarray:
        """Sequential ``register`` over pairs; returns [B, 4, 4]."""
        return np.stack([self.register(a, b) for a, b in zip(xyz0_list, xyz1_list)])
