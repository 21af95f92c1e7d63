#!/bin/bash
# Offline evaluation launcher of the PyTorch port, with the arguments of
# the JAX package's scripts/test.sh (the reference driver's code/test.sh).
# It works in icl_tpu_torch/, so that its relative paths name what that
# launcher's do (see train.sh). Each CLI evaluates on the CUDA card.
set -e
cd "$(dirname "$0")/.."
export PYTHONPATH="$(cd .. && pwd)${PYTHONPATH:+:$PYTHONPATH}"
run() { python -P -m "icl_tpu_torch.scripts.$@"; }

run test_2D_ACDC --root_path ../ACDC \
  --exp ACDC/Inherent_Consistent_Learning --model icl_unet --labeled_num 7

# run test_3D_BraTS --root_path ../data/BraTS2019 --model unet_3D_icl --labeled_num 25
# run test_3D_AMOS --split_path ../data/AMOS22/dataset_semi_ct.json --model unet_3D_icl
