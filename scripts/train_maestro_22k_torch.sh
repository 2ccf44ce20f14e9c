#!/bin/bash
# Train the flagship MAESTRO 22.05 kHz model with the PyTorch + CUDA port
# (babe_tpu_torch): the overrides of scripts/train_maestro_22k.sh.  On
# more than one card: TORCHRUN="torchrun --nproc_per_node 4" (data
# parallel; exp.batch must divide the process count).
set -euo pipefail
cd "$(dirname "$0")/.."

MODEL_DIR=${MODEL_DIR:-experiments/maestro_22k_8s}
mkdir -p "$MODEL_DIR"

${TORCHRUN:-python} -m babe_tpu_torch.train \
  model_dir="$MODEL_DIR" \
  dset=maestro_allyears \
  network=cqtdiff+ \
  diff_params=edm \
  exp=maestro22k_8s \
  tester=only_uncond \
  logging=base_logging \
  "$@"
