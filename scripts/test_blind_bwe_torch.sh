#!/bin/bash
# Run zero-shot blind BWE inference with the PyTorch + CUDA port
# (babe_tpu_torch): the overrides of scripts/test_blind_bwe.sh.  On more
# than one card: TORCHRUN="torchrun --nproc_per_node 4" (the tester spreads
# its sharded modes over the processes).
set -euo pipefail
cd "$(dirname "$0")/.."

MODEL_DIR=${MODEL_DIR:-experiments/maestro_22k_8s}
CKPT=${CKPT:-MAESTRO_22k_8s-850000.pt}   # a .ckpt or a reference .pt

${TORCHRUN:-python} -m babe_tpu_torch.test \
  model_dir="$MODEL_DIR" \
  dset=maestro_allyears \
  network=cqtdiff+ \
  diff_params=edm \
  exp=maestro22k_8s \
  tester=blind_bwe \
  logging=base_logging \
  tester.checkpoint="$CKPT" \
  tester.filter_out_cqt_DC_Nyq=True \
  "$@"
