"""DeepGlobalRegistration — the end-to-end registration pipeline on the card.

Counterpart of the JAX package's ``core/pipeline.py:71-202`` (construction),
of ``register()`` (``:821-979``), of ``register_batch`` (``:427-591``) and
of the staged API (``:607-728``):

  voxelize both clouds -> FCGF forward (one batch of B = 2 clouds) ->
  feature 1-NN (CUDA kernel, or a host KD-tree with
  ``knn_search_method="cpu"``) -> 6D inlier net on the correspondences ->
  sigmoid, clip at ``clip_weight_thresh`` -> weighted-sum gate
  ``wsum >= max(200, 0.05 * N0)`` -> Procrustes + Adam refinement, or the
  safeguard RANSAC (on the correspondences, or with
  ``safeguard_method="feature_matching"`` on fresh feature matches with the
  distance checker) -> ICP polish: the full scan (CUDA kernel every
  iteration) below the 32768 voxel bucket, candidate lists with a checked
  full-scan fallback from it up (``icp_candidates`` auto | on | off).

PyTorch runs eagerly, so the port needs none of the JAX package's static
buckets, padding, speculative rebucketing or split/fused programs
(``default_config`` drops ``split_register``): every stage runs at the true
voxel counts, and its maps are exact. The voxel bucket is still computed,
because the ICP mode keys on it as in the JAX package. ``overflow_count``
counts the pairs on which the JAX package's fixed capacities would have
dropped kernel-map entries (``models/unet_plan.py``), so both report alike.

``register_batch(..., force_vmapped=True)`` runs B pairs as one batched
program (the JAX package's vmapped ``register_pair_device``): one FCGF
forward over the 2B clouds, one batched 1-NN launch, one 6D forward over
the B pairs' correspondences, the refinement and ICP over all pairs with
per-pair freezing; pairs whose gate or candidate lists fail rerun through
``register()``.
"""

from __future__ import annotations

import logging
import time
from typing import Dict

import numpy as np
import torch
from torch.nn.utils.rnn import pad_sequence

from ..models import load_model
from ..models.resunet import ResUNetConfig
from ..models.unet_plan import build_unet_plan
from ..ops import icp as icp_ops
from ..ops import knn, ransac, se3, sparse_grid
from ..utils import checkpoint, convert, device as device_utils
from ..utils.fold_bn import fold_batch_norms
from . import registration

log = logging.getLogger(__name__)

_DEFAULT_BUCKETS = (8192, 16384, 32768, 65536, 131072)
STAGES = ("voxelize", "fcgf", "match", "inlier", "solve", "icp")
# Voxel bucket from which icp_candidates="auto" takes candidate lists (the
# JAX package's ``_ICP_CAND_MIN_CAP``).
_ICP_CAND_MIN_CAP = 32768


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


def build_net(spec, tree, cfg, fold_bn: bool, dtype: torch.dtype,
              device: torch.device):
    """The registry model ``spec`` with the (params, state) ``tree`` on
    ``device`` in eval mode: BN folded if ``fold_bn``, weights rounded to
    ``dtype`` (kept in f32 storage)."""
    params, state = tree
    if fold_bn:
        params, state, cfg = fold_batch_norms(params, state, cfg)
    net = spec.module(cfg)
    net.load_state_dict(convert.from_jax_params(params, state, cfg))
    if dtype != torch.float32:
        net.round_weights(dtype)
    return net.to(device).eval()


def _get(cfg, key, default=None):
    return cfg.get(key, default) if isinstance(cfg, dict) else getattr(cfg, key, default)


class DeepGlobalRegistration:
    """Pairwise registration; ``register(xyz0, xyz1)`` returns a 4x4 float64
    transform taking xyz0 into xyz1's frame.

    ``device`` defaults to ``"cuda"`` and raises when no card is visible;
    pass ``device="cpu"`` to run the plain PyTorch versions of the kernels.
    Both nets come from ``models.load_model`` (any registered family, the
    inlier net in 6D). With ``config.weights`` (a reference ``.pth``/``.pt``
    or a native checkpoint) the checkpoint's embedded config picks voxel size
    and models; a feature-only checkpoint gets a random inlier net drawn from
    a seeded generator (``inlier_trained`` is then False). Without weights
    both nets are drawn from seeded generators. BatchNorm is folded into the
    convs unless ``config.fold_bn`` is off."""

    def __init__(self, config, device: str | torch.device = "cuda"):
        self.device = device_utils.resolve_device(device)
        self.config = config
        self.clip_weight_thresh = config.clip_weight_thresh
        self.safeguard_method = "correspondence"  # | "feature_matching"
        self.use_icp = True
        self.knn_search_method = str(config.knn_search_method)  # "cpu": host KD-tree
        self.icp_candidates = str(config.icp_candidates)
        if self.icp_candidates not in ("auto", "on", "off"):
            raise ValueError("icp_candidates must be auto|on|off, got "
                             f"{self.icp_candidates!r}")
        self.feat_timer = Timer()
        self.stage_timers: Dict[str, Timer] = {s: Timer() for s in STAGES}
        # The batched program's stages, one tic/toc a sub-batch (its pairs'
        # reruns count in stage_timers, through register()).
        self.batch_stage_timers: Dict[str, Timer] = {s: Timer() for s in STAGES}
        self.last_batch: Dict[str, list] = {}
        self.overflow_count = 0
        self.cand_fallbacks = 0  # pairs whose candidate ICP fell back to the scan
        self.last_iterations: Dict[str, object] = {}
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
                state = checkpoint.load_torch_checkpoint(config.weights)
                fcgf_tree = (state["fcgf_params"], state["fcgf_state"])
                if "inlier_params" in state:
                    inlier_tree = (state["inlier_params"], state["inlier_state"])
            else:
                state = checkpoint.load_checkpoint(config.weights)
                fcgf_tree = (state["state_dict"]["params"], state["state_dict"]["state"])
                if state.get("state_dict_inlier") is not None:
                    si = state["state_dict_inlier"]
                    inlier_tree = (si["params"], si["state"])
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
        else:
            self.voxel_size = config.voxel_size
            self.inlier_feature_type = config.inlier_feature_type
            feat_model, feat_n_out = config.feat_model, config.feat_model_n_out
            feat_k1, normalize = config.feat_conv1_kernel_size, config.normalize_feature
            inlier_model = config.inlier_model
            inlier_k1 = config.inlier_conv1_kernel_size
            fcgf_tree = None
        fcgf_spec, inlier_spec = load_model(feat_model), load_model(inlier_model)
        fcgf_cfg = fcgf_spec.make_config(
            1, feat_n_out, conv1_kernel_size=feat_k1, normalize_feature=normalize, D=3)
        inlier_in = {"coords": 6, "feats": 2 * feat_n_out}.get(
            self.inlier_feature_type, 1)
        inlier_cfg = inlier_spec.make_config(
            inlier_in, 1, conv1_kernel_size=inlier_k1, normalize_feature=False, D=6)
        if fcgf_tree is None:
            fcgf_tree = fcgf_spec.init_params(device_utils.generator(0), fcgf_cfg)
        self.inlier_trained = inlier_tree is not None
        if inlier_tree is None:
            inlier_tree = inlier_spec.init_params(device_utils.generator(1), inlier_cfg)
        dtype, dev = self.compute_dtype, self.device
        self.fcgf = build_net(fcgf_spec, fcgf_tree, fcgf_cfg, config.fold_bn, dtype, dev)
        self.inlier = build_net(inlier_spec, inlier_tree, inlier_cfg, config.fold_bn,
                                dtype, dev)
        self.fcgf_cfg, self.inlier_cfg = self.fcgf.cfg, self.inlier.cfg

    def _as_tensor(self, pcd) -> torch.Tensor:
        if hasattr(pcd, "points"):
            pcd = pcd.points
        # A copy: the caller's array may be read-only.
        return torch.as_tensor(np.array(pcd, np.float32), device=self.device)

    def _stage(self, name: str, start: bool, timers=None):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = (timers or self.stage_timers)[name]
        t.tic() if start else t.toc()

    def _fcgf_forward(self, grid: torch.Tensor, batch_size: int, cap: int):
        """FCGF on a batched voxel grid [N, 4]; returns (features [N, C] f32,
        the JAX package's overflow count for the 3D plan)."""
        cfg = self.fcgf_cfg
        plan = build_unet_plan(
            grid, batch_size, cfg.conv1_kernel_size, cfg.region_type, cfg.levels,
            capacity=cap, level_shrink=self.level_shrink,
            dense_extent=self.dense_extent, ones_input=cfg.in_channels == 1,
            with_pooling=cfg.with_pooling)
        ones = torch.ones((grid.shape[0], 1), dtype=self.compute_dtype,
                          device=self.device)
        return self.fcgf(plan, ones).float(), plan.overflow

    def _inlier_logits(self, c6: torch.Tensor, ifeat: torch.Tensor, cap: int,
                       batch_size: int = 1):
        """6D inlier net on a grid [M, 7]; returns (logits [M, 1] f32, the JAX
        package's overflow count for the 6D plan)."""
        cfg = self.inlier_cfg
        # The JAX package keys a 6D plan's box on c0 only in
        # build_paired_unet_plan, which serves every ResUNet family but SP.
        paired = isinstance(cfg, ResUNetConfig) and not cfg.with_pooling
        plan = build_unet_plan(c6, batch_size, cfg.conv1_kernel_size, cfg.region_type,
                               cfg.levels, capacity=cap,
                               level_shrink=self.level_shrink_6d,
                               dense_extent=self.dense_extent if paired else None,
                               with_pooling=cfg.with_pooling)
        return self.inlier(plan, ifeat.to(self.compute_dtype)).float(), plan.overflow

    def features(self, xyz0: torch.Tensor, xyz1: torch.Tensor):
        """Voxelize both clouds and run FCGF on them as one batch.

        Returns (selected points 0, 1, voxel grids 0, 1, features 0, 1, the
        JAX package's overflow count for the 3D plan). Sets ``_cap``, the
        voxel bucket of the pair."""
        self._stage("voxelize", True)
        sel0, g0 = sparse_grid.voxelize(xyz0, self.voxel_size, 0)
        sel1, g1 = sparse_grid.voxelize(xyz1, self.voxel_size, 1)
        self._stage("voxelize", False)
        n0 = g0.shape[0]
        self._cap = _bucket_for(max(n0, g1.shape[0]), self.buckets)
        self._stage("fcgf", True)
        self.feat_timer.tic()
        feats, overflow = self._fcgf_forward(torch.cat([g0, g1]), 2, self._cap)
        self._stage("fcgf", False)
        self.feat_timer.toc()
        return sel0, sel1, g0, g1, feats[:n0], feats[n0:], overflow

    def _inlier_inputs(self, sel0, sel1, g0, g1, f0, f1, idx1, column: int = 0):
        """The 6D grid rows [N0, 7] (batch column ``column``) and the net's
        input features of one pair's correspondences (row i <-> idx1[i])."""
        n0 = g0.shape[0]
        c6 = torch.cat([torch.full_like(g0[:, :1], column), g0[:, 1:], g1[idx1, 1:]],
                       dim=1)
        if self.inlier_feature_type == "ones":
            ifeat = torch.ones((n0, 1), device=self.device)
        elif self.inlier_feature_type == "feats":
            ifeat = torch.cat([f0, f1[idx1]], dim=1)
        elif self.inlier_feature_type == "coords":
            ifeat = torch.cat([torch.cos(sel0), torch.cos(sel1[idx1])], dim=1)
        else:
            raise TypeError(f"undefined inlier feature type {self.inlier_feature_type}")
        return c6, ifeat

    def _weights(self, logits: torch.Tensor) -> torch.Tensor:
        """Sigmoid of the inlier logits [M, 1], clipped at clip_weight_thresh."""
        w = torch.sigmoid(logits[:, 0])
        if self.clip_weight_thresh > 0:
            w = torch.where(w < self.clip_weight_thresh, torch.zeros_like(w), w)
        return w

    def inlier_weights(self, sel0, sel1, g0, g1, f0, f1, idx1):
        """6D inlier net on the correspondences (row i <-> idx1[i]); returns
        (clipped sigmoid weights [N0], overflow count of the 6D plan)."""
        c6, ifeat = self._inlier_inputs(sel0, sel1, g0, g1, f0, f1, idx1)
        logits, overflow = self._inlier_logits(c6, ifeat, self._cap)
        return self._weights(logits), overflow

    def use_cand_for(self, cap: int) -> bool:
        """Whether ICP takes candidate lists at voxel bucket ``cap``."""
        if self.icp_candidates == "auto":
            return cap >= _ICP_CAND_MIN_CAP
        return self.icp_candidates == "on"

    def icp_polish(self, sel0: torch.Tensor, sel1: torch.Tensor,
                   T: torch.Tensor) -> torch.Tensor:
        """ICP from T at ``max_correspondence_distance = 2 * voxel``: the full
        scan, or at the pair's bucket (``_cap``) candidate lists with the
        checked full-scan fallback. Records ``last_iterations["icp"]`` and
        ``["icp_mode"]``; a fallback adds one to ``cand_fallbacks``."""
        self._stage("icp", True)
        mcd = 2 * self.voxel_size
        if self.use_cand_for(self._cap):
            res = icp_ops.registration_icp_checked(sel0, sel1, mcd, init=T)
            mode = "candidates"
            if not res.cand_ok:
                self.cand_fallbacks += 1
                log.warning("ICP candidate lists went stale (pose drift > "
                            "quarter cell); the full-scan ICP fallback ran")
        else:
            res = icp_ops.registration_icp(sel0, sel1, mcd, init=T)
            mode = "full"
        self.last_iterations.update(icp=res.iterations, icp_mode=mode)
        self._stage("icp", False)
        return res.T

    @torch.no_grad()
    def register(self, xyz0, xyz1, inlier_thr: float = 0.0) -> np.ndarray:
        """Register xyz0 onto xyz1; returns the 4x4 float64 transform.

        ``inlier_thr`` is the JAX package's (and the reference's) argument;
        it is unused there too."""
        xyz0, xyz1 = self._as_tensor(xyz0), self._as_tensor(xyz1)
        sel0, sel1, g0, g1, f0, f1, ov3 = self.features(xyz0, xyz1)
        self._stage("match", True)
        if self.knn_search_method == "cpu":
            idx = knn.find_knn_cpu(f0.cpu().numpy(), f1.cpu().numpy())
            idx1 = torch.as_tensor(np.asarray(idx).reshape(-1), dtype=torch.long,
                                   device=self.device)
        else:
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
        voxel2 = 2 * self.voxel_size
        if wsum >= thresh:
            res = registration.global_registration(
                sel0, sel1[idx1], w, break_threshold_ratio=1e-4,
                quantization_size=voxel2)
        elif self.safeguard_method == "correspondence":
            res = ransac.ransac_correspondence(
                sel0, sel1[idx1], distance_threshold=voxel2,
                num_hypotheses=self.ransac_hypotheses, generator=self._rng)
        else:
            res = ransac.ransac_feature_matching(
                sel0, sel1, f0, f1, distance_threshold=voxel2,
                num_hypotheses=self.ransac_hypotheses, generator=self._rng)
        T = se3.rt_to_matrix(res.R, res.t)
        self.last_iterations = {"refine": getattr(res, "iterations", 0)}
        self._stage("solve", False)
        if self.use_icp:
            T = self.icp_polish(sel0, sel1, T)
        return T.double().cpu().numpy()

    def register_many(self, xyz0_list, xyz1_list) -> np.ndarray:
        """Sequential ``register`` over pairs; returns [B, 4, 4]."""
        return np.stack([self.register(a, b) for a, b in zip(xyz0_list, xyz1_list)])

    # Pairs in one batched program. The JAX package set 4 for TPU v5e memory
    # (its 6D plans at the 16384 bucket); kept for parity until the card's
    # own peak memory per sub-batch sets it.
    _MAX_SUB_BATCH = 4

    def register_batch(self, xyz0_list, xyz1_list, mesh=None,
                       force_vmapped: bool = False) -> np.ndarray:
        """Register many pairs; returns [B, 4, 4] float64.

        Without ``force_vmapped`` this is ``register_many`` (the JAX package's
        single-chip route). ``force_vmapped=True`` (the JAX package's keyword;
        here it means the batched program, there is no ``vmap``) runs the
        pairs in sub-batches of ``_MAX_SUB_BATCH``, in order, each as one
        batched program that gives every pair the answer it would get alone
        up to rounding. ``last_batch`` then holds, per pair, ``gate`` (the
        weighted-sum gate bit), ``cand_ok``, ``rerun`` and the iterations
        (``refine``, ``icp``), and per sub-batch ``icp_mode`` and ``cap``
        (its voxel bucket). ``mesh`` (fan-out over devices) needs
        ``parallel/``, which is not ported yet."""
        if mesh is not None:
            raise NotImplementedError("register_batch(mesh=...) fans pairs out "
                                      "over devices through parallel/, which "
                                      "is not ported yet")
        if not force_vmapped:
            return self.register_many(xyz0_list, xyz1_list)
        clouds0, clouds1 = list(xyz0_list), list(xyz1_list)
        if len(clouds0) != len(clouds1):
            raise ValueError(f"{len(clouds0)} source clouds for {len(clouds1)} targets")
        self.last_batch = {k: [] for k in ("gate", "cand_ok", "rerun", "refine",
                                           "icp", "icp_mode", "cap")}
        out = np.zeros((len(clouds0), 4, 4))
        m = self._MAX_SUB_BATCH
        for s in range(0, len(clouds0), m):
            out[s:s + m] = self._register_sub_batch(clouds0[s:s + m], clouds1[s:s + m])
        return out

    @torch.no_grad()
    def _register_sub_batch(self, clouds0, clouds1) -> np.ndarray:
        """One batched program over B <= _MAX_SUB_BATCH pairs (the JAX
        package's ``register_pair_device`` under ``vmap``), then the rerun of
        every pair whose gate bit or ``cand_ok`` is false through
        ``register()``, one after another in pair order, so the seeded RANSAC
        draws in a fixed order. Adds nothing to ``overflow_count``."""
        b = len(clouds0)
        timers = self.batch_stage_timers
        xyz0 = [self._as_tensor(x) for x in clouds0]
        xyz1 = [self._as_tensor(x) for x in clouds1]

        self._stage("voxelize", True, timers)
        sel0, sel1, g0, g1 = [], [], [], []
        for p in range(b):  # batch column 2p: cloud 0 of pair p, 2p + 1: cloud 1
            for xyz, sel, g, col in ((xyz0[p], sel0, g0, 2 * p),
                                     (xyz1[p], sel1, g1, 2 * p + 1)):
                s, grid = sparse_grid.voxelize(xyz, self.voxel_size, col)
                sel.append(s)
                g.append(grid)
        self._stage("voxelize", False, timers)
        n0 = [g.shape[0] for g in g0]
        n1 = [g.shape[0] for g in g1]
        cap = _bucket_for(max(n0 + n1), self.buckets)  # the ICP rule keys on it

        self._stage("fcgf", True, timers)
        clouds = [g for pair in zip(g0, g1) for g in pair]
        feats, _ = self._fcgf_forward(torch.cat(clouds), 2 * b, cap)
        feats = feats.split([g.shape[0] for g in clouds])
        f0, f1 = feats[0::2], feats[1::2]
        self._stage("fcgf", False, timers)

        self._stage("match", True, timers)
        idx = knn.find_nn_batched(pad_sequence(f0, batch_first=True),
                                  pad_sequence(f1, batch_first=True), n0, n1)[0]
        idx1 = [idx[p, :n0[p]].long() for p in range(b)]
        self._stage("match", False, timers)

        self._stage("inlier", True, timers)
        rows = [self._inlier_inputs(sel0[p], sel1[p], g0[p], g1[p], f0[p], f1[p],
                                    idx1[p], column=p) for p in range(b)]
        logits, _ = self._inlier_logits(torch.cat([r[0] for r in rows]),
                                        torch.cat([r[1] for r in rows]), cap,
                                        batch_size=b)
        w = self._weights(logits).split(n0)
        wsum = torch.stack([torch.sum(wp) for wp in w]).tolist()
        gate = [wsum[p] >= max(200.0, 0.05 * n0[p]) for p in range(b)]
        self._stage("inlier", False, timers)

        # The JAX package refines every pair and then discards the answer of
        # a gate-failing one; here such pairs are left out of the refinement
        # and ICP, because the rerun replaces their answer anyway.
        ok = [p for p in range(b) if gate[p]]
        T = torch.zeros((0, 4, 4), device=self.device)
        refine, icp_iters = [0] * b, [0] * b
        cand_ok = [True] * b
        mode = "candidates" if self.use_cand_for(cap) else "full"
        if ok:
            self._stage("solve", True, timers)
            res = registration.global_registration(
                pad_sequence([sel0[p] for p in ok], batch_first=True),
                pad_sequence([sel1[p][idx1[p]] for p in ok], batch_first=True),
                pad_sequence([w[p] for p in ok], batch_first=True),
                break_threshold_ratio=1e-4, quantization_size=2 * self.voxel_size)
            T = se3.rt_to_matrix(res.R, res.t)
            for k, p in enumerate(ok):
                refine[p] = res.iterations[k]
            self._stage("solve", False, timers)
            if self.use_icp:
                self._stage("icp", True, timers)
                # No checked wrapper: pairs whose lists go stale are rerun.
                ires = icp_ops.registration_icp(
                    pad_sequence([sel0[p] for p in ok], batch_first=True),
                    pad_sequence([sel1[p] for p in ok], batch_first=True),
                    2 * self.voxel_size, init=T, use_candidates=mode == "candidates",
                    num0=[n0[p] for p in ok], num1=[n1[p] for p in ok])
                T = ires.T
                for k, p in enumerate(ok):
                    icp_iters[p], cand_ok[p] = ires.iterations[k], ires.cand_ok[k]
                self._stage("icp", False, timers)
        out = np.zeros((b, 4, 4))
        out[ok] = T.double().cpu().numpy()
        rerun = [not (gate[p] and cand_ok[p]) for p in range(b)]
        lb = self.last_batch
        for key, vals in (("gate", gate), ("cand_ok", cand_ok), ("rerun", rerun),
                          ("refine", refine), ("icp", icp_iters)):
            lb[key].extend(vals)
        lb["icp_mode"].append(mode if self.use_icp else "off")
        lb["cap"].append(cap)
        for p in range(b):
            if rerun[p]:
                log.info("register_batch: pair %d failed the weighted-sum gate "
                         "or its ICP candidate lists went stale; rerunning it "
                         "through register()", p)
                out[p] = self.register(clouds0[p], clouds1[p])
        return out

    # ------------------------------------------------------------------
    # Staged API (the reference's deep_global_registration.py:134-236):
    # numpy in, numpy out, each stage on the instance's device.
    # ------------------------------------------------------------------
    @torch.no_grad()
    def preprocess(self, pcd):
        """Voxelize a raw cloud. Returns (xyz [M, 3] f32, one point per voxel;
        coords [M, 3] int32 voxel coordinates; feats [M, 1] ones)."""
        sel, grid = sparse_grid.voxelize(self._as_tensor(pcd), self.voxel_size, 0)
        m = grid.shape[0]
        return (sel.cpu().numpy(), grid[:, 1:].to(torch.int32).cpu().numpy(),
                np.ones((m, 1), np.float32))

    @torch.no_grad()
    def fcgf_feature_extraction(self, feats, coords) -> np.ndarray:
        """FCGF features [M, C] f32 for voxel coords [M, 3]. ``feats`` is
        accepted for the reference's signature (the net consumes ones)."""
        c = torch.as_tensor(np.asarray(coords), dtype=torch.int64, device=self.device)
        grid = torch.cat([torch.zeros_like(c[:, :1]), c], dim=1)
        out, _ = self._fcgf_forward(grid, 1, _bucket_for(len(c), self.buckets))
        return out.cpu().numpy()

    @torch.no_grad()
    def fcgf_feature_matching(self, feats0, feats1):
        """1-NN feature correspondences. Returns (corres_idx0 = arange int64,
        corres_idx1 int32) as numpy."""
        f0, f1 = self._as_tensor(feats0), self._as_tensor(feats1)
        idx1 = knn.find_nn(f0, f1)[0]
        return np.arange(len(f0), dtype=np.int64), idx1.cpu().numpy()

    def inlier_feature_generation(self, xyz0, xyz1, coords0, coords1,
                                  fcgf_feats0, fcgf_feats1,
                                  corres_idx0, corres_idx1) -> np.ndarray:
        """The 6D net's input features for the correspondences (numpy)."""
        i0 = np.asarray(corres_idx0)
        i1 = np.asarray(corres_idx1)
        if self.inlier_feature_type == "ones":
            return np.ones((len(i0), 1), np.float32)
        if self.inlier_feature_type == "feats":
            return np.concatenate([np.asarray(fcgf_feats0)[i0],
                                   np.asarray(fcgf_feats1)[i1]], axis=1)
        if self.inlier_feature_type == "coords":
            return np.concatenate([np.cos(np.asarray(xyz0)[i0]),
                                   np.cos(np.asarray(xyz1)[i1])],
                                  axis=1).astype(np.float32)
        raise TypeError(f"undefined inlier feature type {self.inlier_feature_type}")

    @torch.no_grad()
    def inlier_prediction(self, inlier_feats, coords) -> np.ndarray:
        """Inlier logits [M, 1] f32 for 6D coords [M, 6]."""
        c = torch.as_tensor(np.asarray(coords), dtype=torch.int64, device=self.device)
        c6 = torch.cat([torch.zeros_like(c[:, :1]), c], dim=1)
        logits, _ = self._inlier_logits(c6, self._as_tensor(inlier_feats),
                                        _bucket_for(len(c), self.buckets))
        return logits.cpu().numpy()

    @torch.no_grad()
    def safeguard_registration(self, pcd0, pcd1, idx0, idx1, feats0, feats1,
                               distance_threshold, num_iterations) -> np.ndarray:
        """Safeguard RANSAC; returns a 4x4 float64 transform.

        ``num_iterations`` is the hypothesis budget, clamped to [1024, 65536];
        ``safeguard_method`` picks RANSAC on the given correspondences or on
        fresh feature matches with the distance checker."""
        xyz0, xyz1 = self._as_tensor(pcd0), self._as_tensor(pcd1)
        h = int(min(max(num_iterations, 1024), 65536))
        thresh = float(distance_threshold)
        if self.safeguard_method == "correspondence":
            i0 = torch.as_tensor(np.asarray(idx0), dtype=torch.long, device=self.device)
            i1 = torch.as_tensor(np.asarray(idx1), dtype=torch.long, device=self.device)
            res = ransac.ransac_correspondence(xyz0[i0], xyz1[i1], thresh,
                                               num_hypotheses=h, generator=self._rng)
        else:
            res = ransac.ransac_feature_matching(
                xyz0, xyz1, self._as_tensor(feats0), self._as_tensor(feats1),
                thresh, num_hypotheses=h, generator=self._rng)
        T = np.eye(4)
        T[:3, :3] = res.R.cpu().numpy()
        T[:3, 3] = res.t.cpu().numpy()
        return T
