#!/bin/bash
# 3DMatch training recipe (reference scripts/train_3dmatch.sh:4-75):
# env-var parameterized; non-default choices: conv1 kernel 7, positive-pair
# search multiplier 4, ResUNetBNF-class inlier net, batch 8, SGD lr 1e-1,
# voxel 5 cm; benchmark immediately after training.
#
# The PyTorch/CUDA port's copy of the repo's scripts/train_3dmatch.sh: the same
# flags, through the port's entry points, on the card unless DEVICE=cpu.
# Run from the repo root.
set -e

export DATASET=${DATASET:-ThreeDMatchPairDataset03}
export THREED_MATCH_DIR=${THREED_MATCH_DIR:-./dataset/threedmatch}
export FCGF_WEIGHTS=${FCGF_WEIGHTS:-}
export INLIER_MODEL=${INLIER_MODEL:-ResUNetBN2F}
export FEAT_MODEL=${FEAT_MODEL:-ResUNetBN2C}
export MODEL_N_OUT=${MODEL_N_OUT:-32}
export CONV1_KERNEL_SIZE=${CONV1_KERNEL_SIZE:-7}
export OPTIMIZER=${OPTIMIZER:-SGD}
export LR=${LR:-1e-1}
export BATCH_SIZE=${BATCH_SIZE:-8}
export MAX_EPOCH=${MAX_EPOCH:-100}
export VOXEL_SIZE=${VOXEL_SIZE:-0.05}
export POSITIVE_PAIR_SEARCH_VOXEL_SIZE_MULTIPLIER=${POSITIVE_PAIR_SEARCH_VOXEL_SIZE_MULTIPLIER:-4}
export DEVICE=${DEVICE:-cuda}
export OUT_DIR=${OUT_DIR:-outputs/3dmatch_$(date +%F_%H-%M-%S)}

python -m deepglobalregistration_tpu_torch.train \
  --dataset ${DATASET} \
  --threed_match_dir ${THREED_MATCH_DIR} \
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
  --out_dir ${OUT_DIR} \
  --device ${DEVICE} \
  "$@"

python -m deepglobalregistration_tpu_torch.scripts.test_3dmatch \
  --threed_match_dir ${THREED_MATCH_DIR} \
  --weights ${OUT_DIR}/best_val_checkpoint.pkl \
  --out_dir ${OUT_DIR} \
  --device ${DEVICE}
