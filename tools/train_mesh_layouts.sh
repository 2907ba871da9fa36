#!/bin/bash
# qwen3-8b at full size (bf16 parameters, float32 AdamW) trained through
# launch/train.py on four cards in two layouts, in one run: (4, 1), FSDP
# over four data ranks, and (2, 2), data x model; 4x1, 2x2, 4x1, 2 steps
# of 8 x 4,096 tokens each (the second step is the warm one, which the
# "[train] last step" line reports).
# Run from the root of a checkout on a host with four cards:
#   tools/train_mesh_layouts.sh
cd "$(dirname "$0")/.." || exit 2
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for m in 4x1 2x2 4x1; do
  echo "== $m $(date +%T)"
  PYTHONPATH=src python3 -m repro_torch.launch.train --arch qwen3-8b \
    --mesh "$m" --steps 2 --batch 8 --seq 4096 2>&1 | grep "^\[train\]" \
    || exit 1
done
