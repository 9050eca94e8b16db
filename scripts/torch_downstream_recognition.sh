#!/bin/sh
# M-CR/S-CR recognition eval with the PyTorch port on NVIDIA GPUs: the
# torchrun counterpart of scripts/downstream_recognition.sh (reference:
# downstream_recognition.sh); the items are sharded over the ranks.
# Usage: [NPROC_PER_NODE=8] scripts/torch_downstream_recognition.sh --data-path <root> --resume <ckpt>
# (TORCHRUN_ARGS as in scripts/torch_pretrain.sh.)
set -e
cd "$(dirname "$0")/.."
exec python -m torch.distributed.run --nproc_per_node="${NPROC_PER_NODE:-1}" \
    ${TORCHRUN_ARGS:---standalone} -m mvlt_tpu_torch.cli --config configs/finetune_exp48.py \
    --eval-recognition "$@"
