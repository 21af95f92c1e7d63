#!/bin/bash
# Experiment launcher of the PyTorch port, with the arguments of the JAX
# package's scripts/train.sh (the reference driver's code/train.sh): ACDC
# semi-supervised splits {3,7}, BraTS {25,50}, AMOS {15,30}. It runs from
# icl_tpu_torch/, one level below the repo root as scripts/ is, so the
# relative paths (the data under ../, the snapshots under ../experiments)
# name what the JAX launcher's do. Each CLI trains on the CUDA card.
set -e
cd "$(dirname "$0")/.."
export PYTHONPATH="$(cd .. && pwd)${PYTHONPATH:+:$PYTHONPATH}"
run() { python -P -m "icl_tpu_torch.scripts.$@"; }

# --- ACDC, ICL 2D UNet ---
run train_inherent_consistent_unet_2D --root_path ../ACDC \
  --exp ACDC/Inherent_Consistent_Learning --model icl_unet --labeled_num 7 \
  --num_tries "${NUM_TRIES:-1}"
# run train_inherent_consistent_unet_2D --root_path ../ACDC \
#   --exp ACDC/Inherent_Consistent_Learning --model icl_unet --labeled_num 3

# --- ACDC, ICL SwinUNet ---
# run train_inherent_consistent_swinunet_2D --root_path ../ACDC \
#   --model icl_swinunet --labeled_num 7 --patch_size 224 224

# --- BraTS2019, ICL 3D UNet ---
# run train_inherent_consistent_unet_3D_BraTS --root_path ../data/BraTS2019 \
#   --model unet_3D_icl --labeled_num 25

# --- BraTS2019, ICL SwinUNETR ---
# run train_inherent_consistent_swinunetr_3D_BraTS --root_path ../data/BraTS2019 \
#   --model swinunetr_icl --labeled_num 25

# --- AMOS22, ICL 3D UNet ---
# run train_inherent_consistent_unet_3D_AMOS22 \
#   --split_path ../data/AMOS22/dataset_semi_ct.json --labeled_num 30
