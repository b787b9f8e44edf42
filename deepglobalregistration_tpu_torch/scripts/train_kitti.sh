#!/bin/bash
# KITTI training recipe (reference scripts/train_kitti.sh:8-72): conv1 kernel 5,
# ResUNetBN2C inlier net, SGD lr 1e-2, voxel 30 cm, success thresholds 2 m / 5 deg
# during training; benchmark after.
#
# The PyTorch/CUDA port's copy of the repo's scripts/train_kitti.sh: the same
# flags, through the port's entry points, on the card unless DEVICE=cpu.
# Run from the repo root.
set -e

export DATASET=${DATASET:-KITTINMPairDataset}
export KITTI_DIR=${KITTI_DIR:-./dataset/kitti}
export FCGF_WEIGHTS=${FCGF_WEIGHTS:-}
export INLIER_MODEL=${INLIER_MODEL:-ResUNetBN2C}
export FEAT_MODEL=${FEAT_MODEL:-ResUNetBN2C}
export MODEL_N_OUT=${MODEL_N_OUT:-32}
export CONV1_KERNEL_SIZE=${CONV1_KERNEL_SIZE:-5}
export OPTIMIZER=${OPTIMIZER:-SGD}
export LR=${LR:-1e-2}
export BATCH_SIZE=${BATCH_SIZE:-8}
export MAX_EPOCH=${MAX_EPOCH:-100}
export VOXEL_SIZE=${VOXEL_SIZE:-0.3}
export POSITIVE_PAIR_SEARCH_VOXEL_SIZE_MULTIPLIER=${POSITIVE_PAIR_SEARCH_VOXEL_SIZE_MULTIPLIER:-4}
export SUCCESS_RTE_THRESH=${SUCCESS_RTE_THRESH:-2}
export SUCCESS_RRE_THRESH=${SUCCESS_RRE_THRESH:-5}
export DEVICE=${DEVICE:-cuda}
export OUT_DIR=${OUT_DIR:-outputs/kitti_$(date +%F_%H-%M-%S)}

python -m deepglobalregistration_tpu_torch.train \
  --dataset ${DATASET} \
  --kitti_dir ${KITTI_DIR} \
  ${FCGF_WEIGHTS:+--weights ${FCGF_WEIGHTS}} \
  --inlier_model ${INLIER_MODEL} \
  --feat_model ${FEAT_MODEL} \
  --feat_model_n_out ${MODEL_N_OUT} \
  --feat_conv1_kernel_size ${CONV1_KERNEL_SIZE} \
  --optimizer ${OPTIMIZER} \
  --lr ${LR} \
  --batch_size ${BATCH_SIZE} \
  --max_epoch ${MAX_EPOCH} \
  --voxel_size ${VOXEL_SIZE} \
  --positive_pair_search_voxel_size_multiplier ${POSITIVE_PAIR_SEARCH_VOXEL_SIZE_MULTIPLIER} \
  --success_rte_thresh ${SUCCESS_RTE_THRESH} \
  --success_rre_thresh ${SUCCESS_RRE_THRESH} \
  --out_dir ${OUT_DIR} \
  --device ${DEVICE} \
  "$@"

python -m deepglobalregistration_tpu_torch.scripts.test_kitti \
  --kitti_dir ${KITTI_DIR} \
  --weights ${OUT_DIR}/best_val_checkpoint.pkl \
  --out_dir ${OUT_DIR} \
  --device ${DEVICE}
