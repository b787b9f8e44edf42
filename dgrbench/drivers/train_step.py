"""Driver: the inlier net's training step at the published batch.

Set-up builds the trainer's nets as ``core/trainer.build_nets`` does (the
frozen FCGF in eval mode from the configuration's weights file, the 6D
inlier net in train mode from the seed), the configuration's optimizer and
``make_train_step``'s step (with stage timers in a traced run), and a pool
of batches: the seed's raw pairs voxelized, matched and collated by the
program's own data layer (``native.voxelize``, ``native.radius_pairs``,
``data/collate.make_pair_batch``). It then drives that same step through
its first three steps on batches 0-2, through the window's own call,
keeping what the check reads; the window goes on from batch 3, cycling.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..reference import judge
from ..traffic import pairs
from . import common

STAGES = ("fcgf", "match", "plan6", "inlier", "loss", "backward", "optimizer")
CHECKED_STEPS = 3
TRAIN_KEYS = ("clip_weight_thresh", "trans_weight", "procrustes_loss_weight",
              "inlier_direct_loss_weight", "lr", "sgd_momentum", "sgd_dampening",
              "weight_decay")


def raw_pairs(cfg: Dict, mix: Dict, seed: int) -> list:
    """The pool's raw pairs, batch after batch in the order the seed draws
    for its batches, each with its ground-truth matching radius (the
    positive-pair search voxel, scaled with the pair)."""
    b, n = int(mix["batch"]), int(mix["pool_batches"])
    raw = pairs.pool(mix["pool_seed"], mix, n * b)
    order = pairs.rng_for(seed, 2 ** 32 - 2).permutation(n)
    raw = [raw[i * b + j] for i in order for j in range(b)]
    for r in raw:
        r["radius"] = cfg["voxel_size"] * cfg["positive_pair_search_voxel_size_multiplier"] \
            * r["scale"]
    return raw


def checked_steps(raw: list, mix: Dict) -> list:
    """The raw pairs of the steps the check reads (steps 1-3: batches 0-2)."""
    b = int(mix["batch"])
    return [raw[i * b:(i + 1) * b] for i in range(CHECKED_STEPS)]


class Driver(common.Driver):
    kind = "train"

    def setup(self):
        from deepglobalregistration_tpu_torch import native
        from deepglobalregistration_tpu_torch.config import default_config
        from deepglobalregistration_tpu_torch.core import pipeline
        from deepglobalregistration_tpu_torch.core import train_step as ts
        from deepglobalregistration_tpu_torch.data import collate
        from deepglobalregistration_tpu_torch.models import load_model
        from deepglobalregistration_tpu_torch.utils import convert
        from deepglobalregistration_tpu_torch.utils.timer import Timer

        cfg, mix, dev = self.config, self.mix, self.device
        self.ts = ts
        self.pcfg = pc = default_config(**common.program_keys(cfg, default_config()))
        self.trees = common.make_trees(cfg, self.seed, dev)
        fa, ia = self.trees["fcgf"][0], self.trees["inlier"][0]
        fspec, ispec = load_model(fa.name), load_model(ia.name)
        fcfg = fspec.make_config(1, fa.out_channels, conv1_kernel_size=fa.conv1_kernel_size,
                                 normalize_feature=fa.normalize, D=3,
                                 bn_momentum=pc.bn_momentum)
        icfg = ispec.make_config(1, 1, conv1_kernel_size=ia.conv1_kernel_size,
                                 normalize_feature=False, D=6, bn_momentum=pc.bn_momentum)
        fcgf = pipeline.build_net(fspec, common.numpy_tree(self.trees["fcgf"][1]), fcfg,
                                  False, torch.float32, torch.device(dev))
        inlier = ispec.module(icfg)
        inlier.load_state_dict(convert.from_jax_params(
            *common.numpy_tree(self.trees["inlier"][1]), icfg))
        self.inlier = inlier.to(dev).train()
        self.optimizer = ts.make_optimizer(pc.optimizer, self.inlier.parameters(), pc)
        self.timers = {s: Timer() for s in STAGES} if self.trace else None
        self.step, _ = ts.make_train_step(fcgf, self.inlier, pc, self.optimizer,
                                          timers=self.timers)
        self.fcgf = fcgf

        b = int(mix["batch"])
        self.raw = raw_pairs(cfg, mix, self.seed)
        voxel = cfg["voxel_size"]
        items = []
        for r in self.raw:
            p0, c0 = native.voxelize(r["xyz0"], voxel)
            p1, c1 = native.voxelize(r["xyz1"], voxel)
            T = r["T"].astype(np.float32)
            m = native.radius_pairs(p0, p1, T, r["radius"])
            ones0, ones1 = np.ones((len(p0), 1), np.float32), np.ones((len(p1), 1), np.float32)
            items.append((p0, p1, c0, c1, ones0, ones1, m, T, {}))
        self.batches = [collate.make_pair_batch(items[i:i + b])
                        for i in range(0, len(items), b)]
        self.next = 0
        self.traced_steps = []
        self._first_steps()
        self.reset_window()

    def reset_window(self):
        self.attempted = self.failed = 0
        if self.timers:
            for t in self.timers.values():
                t.reset()
        self.steps = 0

    def _first_steps(self):
        """Steps 1-3 through the window's call, keeping what the check reads."""
        ts, out = self.ts, {"losses": [], "nn": [], "feats": None}
        names = [n for n, _ in self.inlier.named_parameters()]
        orig = ts.fcgf_features

        def fcgf_features(fcgf, batch):
            f = orig(fcgf, batch)
            if out["feats"] is None:
                n = torch.cat([batch.num0, batch.num1]).tolist()
                out["feats"] = [f[c, :k] for c, k in enumerate(n)]
            return f

        ts.fcgf_features = fcgf_features
        try:
            for s in range(CHECKED_STEPS):
                hb = self.batches[self.next % len(self.batches)]
                stats = self._run(hb)
                num0 = hb.num0.tolist()
                out["losses"].append(float(stats["loss"]))
                got = stats["nn_idx"].shape[0]  # the pairs the step saw
                out["nn"].append([stats["nn_idx"][p, :n] for p, n in enumerate(num0[:got])])
                if s == 0:
                    rows = lambda x: torch.cat([x[p, :n] for p, n in enumerate(num0[:got])])
                    out["logits"], out["labels"] = rows(stats["logits"]), rows(stats["labels"])
                    st = self.optimizer.state
                    # A step that never updated leaves no buffer: nothing moved.
                    out["bufs"] = {n: st[p].get("momentum_buffer",
                                                torch.zeros_like(p)).detach().clone()
                                   for n, p in zip(names, self.inlier.parameters())}
            out["params"] = {n: p.detach().clone() for n, p in self.inlier.named_parameters()}
        finally:
            ts.fcgf_features = orig
        for k, side in (("sel", "xyz"), ("c", "coords")):
            for c in "01":
                out[k + c] = [[torch.as_tensor(getattr(hb, side + c)[p, :n], device=self.device)
                               for p, n in enumerate(getattr(hb, "num" + c).tolist())]
                              for hb in self.batches[:CHECKED_STEPS]]
        self.checked = out

    def _run(self, hb):
        b = self.ts.batch_to(hb, self.device)
        stats = self.step(b)
        self.next += 1
        n = hb.num0.shape[0]
        self.attempted += n
        self.failed += 0 if stats["grad_finite"] else n
        return stats

    def call(self, traced: bool = False) -> int:
        hb = self.batches[self.next % len(self.batches)]
        stats = self._run(hb)
        if traced:  # the step's own matches: the 6D net's grid
            self.traced_steps.append((hb, [stats["nn_idx"][p, :n].long() for p, n
                                           in enumerate(hb.num0.tolist())]))
        else:
            self.steps += 1
        return int(hb.num0.shape[0])

    def layer_context(self) -> Dict:
        st = {k: t.total_time for k, t in self.timers.items()} if self.timers else {}
        return {"train_stage_s": st, "steps": self.steps}

    def traced_work(self) -> Dict:
        """Every conv and every 1-NN search of the traced steps, by the
        benchmark's own maps; the inlier net's convs are trained (forward,
        dx and dk)."""
        fa, ia = self.trees["fcgf"][0], self.trees["inlier"][0]
        convs, nn1 = [], []
        for hb, nn in self.traced_steps:
            n0, n1 = hb.num0.tolist(), hb.num1.tolist()
            c0 = [torch.as_tensor(hb.coords0[p, :n], device=self.device)
                  for p, n in enumerate(n0)]
            c1 = [torch.as_tensor(hb.coords1[p, :n], device=self.device)
                  for p, n in enumerate(n1)]
            convs += common.net_work(fa, c0 + c1, "fcgf")
            g6 = [torch.cat([a, b[j]], 1) for a, b, j in zip(c0, c1, nn)]
            convs += common.net_work(ia, g6, "inlier", trained=True)
            nn1 += [("mma", a, b, fa.out_channels, 1) for a, b in zip(n0, n1)]
        return {"convs": convs, "nn1": nn1}

    def check(self) -> Dict[str, float]:
        out = self.checked
        self.release()
        return judge.judge_train(out, checked_steps(self.raw, self.mix), self.cell())

    def release(self):
        for k in ("step", "inlier", "fcgf", "optimizer", "batches", "checked",
                  "traced_steps"):
            setattr(self, k, None)
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def cell(self) -> Dict:
        return cell(self.config, self.mix, self.trees, self.device, self.pcfg)


def cell(config: Dict, mix: Dict, trees: Dict, device: str, pcfg=None) -> Dict:
    """What the judge needs of a training cell. The training settings are
    the program's configuration's (its defaults under the configuration's
    keys); without the program, the configuration's own keys."""
    (fa, ft), (ia, it) = trees["fcgf"], trees["inlier"]
    get = (lambda k: getattr(pcfg, k)) if pcfg is not None else config.__getitem__
    return {"voxel_size": config["voxel_size"], "voxel_floor": mix["voxel_floor"],
            "device": device, "fcgf_tree": ft, "fcgf_arch": fa, "inlier_tree": it,
            "inlier_arch": ia, "train": {k: get(k) for k in TRAIN_KEYS}}

