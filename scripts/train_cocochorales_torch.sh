#!/bin/bash
# Train a CocoChorales 16 kHz stem model with the PyTorch + CUDA port
# (babe_tpu_torch): the overrides of scripts/train_cocochorales.sh.  On
# more than one card: TORCHRUN="torchrun --nproc_per_node 4".
set -euo pipefail
cd "$(dirname "$0")/.."

STEMS=${STEMS:-strings}
MODEL_DIR=${MODEL_DIR:-experiments/cocochorales_${STEMS}_16k}
mkdir -p "$MODEL_DIR"

${TORCHRUN:-python} -m babe_tpu_torch.train \
  model_dir="$MODEL_DIR" \
  dset=CocoChorales_stems \
  network=cqtdiff+ \
  diff_params=edm_chorales \
  exp=CocoChorales_16k_8s \
  tester=only_uncond \
  logging=base_logging \
  "$@"
