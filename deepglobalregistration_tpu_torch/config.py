"""Configuration: every flag of the JAX package's ``config.py``, plus ``--device``.

One argparse parser shared by the demo and the evaluation scripts, with the
same groups, names, types and defaults as the JAX package's (itself the
reference's config.py:24-141), so the reference's shell scripts
(``scripts/train_3dmatch.sh``, ``scripts/train_kitti.sh``) carry over. The
port adds one flag, ``--device`` (default ``cuda``, resolved by
``utils/device.resolve_device``, so it raises without a card), in place of
the JAX package's ``utils/platform.select_platform``.

``Config`` is a dataclass with one field a flag, made from the parser, so the
two cannot drift apart. Flags that no port module reads yet are accepted and
stored; the comment at each group says which modules read its flags.
"""

from __future__ import annotations

import argparse
import dataclasses

parser = argparse.ArgumentParser(
    description="DeepGlobalRegistration (PyTorch/CUDA port)")


def str2bool(v) -> bool:
    """Shell-script-friendly boolean flag values ('true'/'false'/'1'/'0')."""
    return str(v).lower() in ("true", "1")


logging_arg = parser.add_argument_group("Logging")
logging_arg.add_argument("--out_dir", type=str, default="outputs")

# Trainer and Optimizer groups: data/ reads the augmentation flags
# (use_random_*, min/max_scale, rotation_range, the positive-pair
# multiplier) and icp_cache_path, register() and the train step
# clip_weight_thresh; core/trainer.py and core/train_step.py the rest,
# ckpt_* included, except save_epoch_freq, eval_registration, momentum and
# scheduler, which neither package's trainer reads.
trainer_arg = parser.add_argument_group("Trainer")
trainer_arg.add_argument("--trainer", type=str, default="WeightedProcrustesTrainer")
trainer_arg.add_argument("--batch_size", type=int, default=4)
trainer_arg.add_argument("--val_batch_size", type=int, default=1)
trainer_arg.add_argument("--train_phase", type=str, default="train")
trainer_arg.add_argument("--val_phase", type=str, default="val")
trainer_arg.add_argument("--test_phase", type=str, default="test")
trainer_arg.add_argument("--use_random_scale", type=str2bool, default=False)
trainer_arg.add_argument("--min_scale", type=float, default=0.8)
trainer_arg.add_argument("--max_scale", type=float, default=1.2)
trainer_arg.add_argument("--use_random_rotation", type=str2bool, default=True)
trainer_arg.add_argument("--rotation_range", type=float, default=360)
trainer_arg.add_argument("--positive_pair_search_voxel_size_multiplier", type=float, default=1.5)
trainer_arg.add_argument("--save_epoch_freq", type=int, default=1)
trainer_arg.add_argument("--val_epoch_freq", type=int, default=1)
trainer_arg.add_argument("--stat_freq", type=int, default=40)
trainer_arg.add_argument("--test_valid", type=str2bool, default=True)
trainer_arg.add_argument("--val_max_iter", type=int, default=400)
trainer_arg.add_argument("--use_balanced_loss", type=str2bool, default=False)
trainer_arg.add_argument("--inlier_direct_loss_weight", type=float, default=1.0)
trainer_arg.add_argument("--procrustes_loss_weight", type=float, default=1.0)
trainer_arg.add_argument("--trans_weight", type=float, default=1)
trainer_arg.add_argument("--eval_registration", type=str2bool, default=True)
trainer_arg.add_argument("--clip_weight_thresh", type=float, default=0.05,
                         help="Weight threshold for detecting inliers")
trainer_arg.add_argument("--best_val_metric", type=str, default="succ_rate")
# Checkpoint size controls (TPU addition): the 6D inlier net's dense
# [729, Cin, Cout] kernels make a raw-f32 checkpoint ~1 GB; bf16 storage +
# zlib and optional optimizer/FCGF trees keep epoch checkpoints < 500 MB.
trainer_arg.add_argument("--ckpt_dtype", type=str, default="bf16",
                         help="checkpoint array storage: 'bf16' | 'f32'")
trainer_arg.add_argument("--ckpt_compress", type=str2bool, default=True)
trainer_arg.add_argument("--ckpt_save_optimizer", type=str2bool, default=False,
                         help="include optimizer state (momentum) in epoch "
                              "checkpoints; off by default — resume restarts "
                              "momentum at zero")
trainer_arg.add_argument("--ckpt_save_fcgf", type=str2bool, default=True,
                         help="include the frozen FCGF trees (small; keeps "
                              "checkpoints self-contained for inference)")

inlier_arg = parser.add_argument_group("Inlier")
inlier_arg.add_argument("--inlier_model", type=str, default="ResUNetBN2C")
inlier_arg.add_argument("--inlier_feature_type", type=str, default="ones")
inlier_arg.add_argument("--inlier_conv1_kernel_size", type=int, default=3)
inlier_arg.add_argument("--inlier_knn", type=int, default=1)
inlier_arg.add_argument("--knn_search_method", type=str, default="gpu")
inlier_arg.add_argument("--inlier_use_direct_loss", type=str2bool, default=True)

feat_arg = parser.add_argument_group("feat")
feat_arg.add_argument("--feat_model", type=str, default="SimpleNetBN2C")
feat_arg.add_argument("--feat_model_n_out", type=int, default=16)
feat_arg.add_argument("--feat_conv1_kernel_size", type=int, default=3)
feat_arg.add_argument("--normalize_feature", type=str2bool, default=True)
feat_arg.add_argument("--use_xyz_feature", type=str2bool, default=False)
feat_arg.add_argument("--dist_type", type=str, default="L2")

opt_arg = parser.add_argument_group("Optimizer")
opt_arg.add_argument("--optimizer", type=str, default="SGD")
opt_arg.add_argument("--max_epoch", type=int, default=100)
opt_arg.add_argument("--lr", type=float, default=1e-1)
opt_arg.add_argument("--momentum", type=float, default=0.8)
opt_arg.add_argument("--sgd_momentum", type=float, default=0.9)
opt_arg.add_argument("--sgd_dampening", type=float, default=0.1)
opt_arg.add_argument("--adam_beta1", type=float, default=0.9)
opt_arg.add_argument("--adam_beta2", type=float, default=0.999)
opt_arg.add_argument("--weight_decay", type=float, default=1e-4)
opt_arg.add_argument("--iter_size", type=int, default=1, help="accumulate gradient")
opt_arg.add_argument("--bn_momentum", type=float, default=0.05)
opt_arg.add_argument("--exp_gamma", type=float, default=0.99)
opt_arg.add_argument("--scheduler", type=str, default="ExpLR")
opt_arg.add_argument("--num_train_iter", type=int, default=-1)
opt_arg.add_argument("--icp_cache_path", type=str, default="icp")

# Misc: weights and test_num_workers are read here; resume*, train/val
# workers by train.py and the trainer; fast_validation, use_gpu,
# weights_dir and nn_max_n by nothing (--device replaces use_gpu).
misc_arg = parser.add_argument_group("Misc")
misc_arg.add_argument("--use_gpu", type=str2bool, default=True)  # kept for CLI parity
misc_arg.add_argument("--weights", type=str, default=None)
misc_arg.add_argument("--weights_dir", type=str, default=None)  # parity-only (unused in the reference too, config.py:106)
misc_arg.add_argument("--resume", type=str, default=None)
misc_arg.add_argument("--resume_dir", type=str, default=None)
misc_arg.add_argument("--train_num_workers", type=int, default=2)
misc_arg.add_argument("--val_num_workers", type=int, default=1)
misc_arg.add_argument("--test_num_workers", type=int, default=2)
misc_arg.add_argument("--fast_validation", type=str2bool, default=False)
misc_arg.add_argument("--nn_max_n", type=int, default=250,
                      help="kept for config parity; the TPU KNN tiles internally")

data_arg = parser.add_argument_group("Data")
data_arg.add_argument("--dataset", type=str, default="ThreeDMatchPairDataset03")
data_arg.add_argument("--voxel_size", type=float, default=0.025)
data_arg.add_argument("--threed_match_dir", type=str, default=".")
data_arg.add_argument("--kitti_dir", type=str, default=None)
data_arg.add_argument("--kitti_max_time_diff", type=int, default=3)
data_arg.add_argument("--kitti_date", type=str, default="2011_09_26")
data_arg.add_argument("--synthetic_points", type=int, default=20000,
                      help="points per procedural cloud (SyntheticPairDataset)")

# kitti_date, hit_ratio_thresh and test_random_*: read by no module of
# either package (the trainers' validation reads the success thresholds).
eval_arg = parser.add_argument_group("Eval")
eval_arg.add_argument("--hit_ratio_thresh", type=float, default=0.1)
eval_arg.add_argument("--success_rte_thresh", type=float, default=0.3)
eval_arg.add_argument("--success_rre_thresh", type=float, default=15)
eval_arg.add_argument("--test_random_crop", action="store_true")
eval_arg.add_argument("--test_random_rotation", type=str2bool, default=False)

demo_arg = parser.add_argument_group("Demo")
demo_arg.add_argument("--pcd0", default="redkitchen_000.ply", type=str)
demo_arg.add_argument("--pcd1", default="redkitchen_010.ply", type=str)

# TPU group: register() reads point_buckets, ransac_hypotheses,
# level_shrink*, fold_bn, bf16, dense_extent and icp_candidates. The train
# step reads remat; train.main reads num_devices (N > 1: N data-parallel
# ranks, parallel/data_parallel.py); edge_budget_scale sizes the JAX
# package's fixed 6D edge budgets, which the port's exact maps do not have.
tpu_arg = parser.add_argument_group("TPU")
tpu_arg.add_argument("--point_buckets", type=str, default="8192,16384,32768,65536,131072",
                     help="static padded-capacity ladder for point buffers")
tpu_arg.add_argument("--ransac_hypotheses", type=int, default=16384)
tpu_arg.add_argument("--level_shrink", type=int, default=2,
                     help="per-level pyramid capacity divisor (1 = no shrink)")
tpu_arg.add_argument("--level_shrink_6d", type=int, default=1,
                     help="capacity divisor for the 6D inlier pyramid "
                          "(outlier rows barely merge under 6D stride-down; "
                          "edge-compacted convs make full capacity cheap)")
tpu_arg.add_argument("--num_devices", type=int, default=0,
                     help="data-parallel ranks for training, one process and "
                          "device each (0 or 1 = one process; N > 1: cuda:0.."
                          "N-1 over NCCL, or N CPU ranks with --device cpu)")
tpu_arg.add_argument("--fold_bn", type=str2bool, default=True,
                     help="fold inference BatchNorm into conv weights at load")
tpu_arg.add_argument("--remat", type=str2bool, default=False,
                     help="rematerialize the inlier net in backward (memory "
                          "for one extra forward; jax.checkpoint)")
tpu_arg.add_argument("--bf16", type=str2bool, default=False,
                     help="bf16 conv compute (f32 accumulate + f32 matching/"
                          "solvers) — the MXU-native inference path")
tpu_arg.add_argument("--dense_extent", type=str, default="",
                     help="static X,Y,Z voxel box enabling the dense-index "
                          "kernel-map fast path for 3D nets (empty = hash tables)")
tpu_arg.add_argument("--icp_candidates", type=str, default="auto",
                     choices=["auto", "on", "off"],
                     help="ICP neighbor strategy: 'auto' picks candidate "
                          "lists only above the capacity where the full "
                          "spatial scan loses (~32k points); 'on'/'off' force")
tpu_arg.add_argument("--split_register", type=str2bool, default=False,
                     help="route register() through the staged per-stage jits "
                          "(features / match+inlier / refine|ransac / icp) "
                          "instead of the single fused program — ~4 extra "
                          "dispatch round trips per pair, but each stage "
                          "compiles separately and far faster (cold-start "
                          "latency knob; the fused path is the throughput "
                          "configuration)")
tpu_arg.add_argument("--edge_budget_scale", type=float, default=1.0,
                     help="multiplier on the 6D edge-map budgets/degree caps "
                          "(tuned at 3DMatch bench density; raise to ~2.5 for "
                          "denser clouds, e.g. synthetic rooms — see "
                          "models/unet_plan.build_paired_unet_plan)")


device_arg = parser.add_argument_group("Device")
device_arg.add_argument("--device", type=str, default="cuda",
                        help="torch device the entry points run on: 'cuda' "
                             "(raises without a card) or 'cpu' (the kernels' "
                             "plain PyTorch versions)")


def _annotation(action: argparse.Action):
    if action.type is None:  # store_true
        return bool
    return bool if action.type is str2bool else action.type


# Flags that change nothing in the port: split_register picks per-stage
# programs over one fused program in the JAX package; the port runs eagerly
# and has one path, so two configs that differ only there are equal.
_NO_EFFECT = ("split_register",)

Config = dataclasses.make_dataclass("Config", [
    (a.dest, _annotation(a),
     dataclasses.field(default=a.default, compare=a.dest not in _NO_EFFECT))
    for a in parser._actions if a.dest != "help"])
Config.__doc__ = "Every flag of ``parser`` as a field, at its default."


def get_config(argv=None) -> Config:
    """Parse ``argv`` (``sys.argv[1:]`` when None) into a ``Config``."""
    return Config(**vars(parser.parse_args(argv)))


def default_config(**overrides) -> Config:
    """Defaults plus keyword overrides; an unknown key raises."""
    cfg = Config()
    for k, v in overrides.items():
        if not hasattr(cfg, k):
            raise ValueError(f"unknown config key {k}")
        setattr(cfg, k, v)
    return cfg
