#!/bin/sh
# Zero-shot ITR + TIR retrieval with the PyTorch port on NVIDIA GPUs: the
# torchrun counterpart of scripts/downstream_retrieval.sh (reference:
# downstream_retrieval.sh); the bundles are sharded over the ranks.
# Usage: [NPROC_PER_NODE=8] scripts/torch_downstream_retrieval.sh --data-path <root> --resume <ckpt>
# (TORCHRUN_ARGS as in scripts/torch_pretrain.sh.)
set -e
cd "$(dirname "$0")/.."
for mode in --eval-retrieval-itr --eval-retrieval-tir; do
    python -m torch.distributed.run --nproc_per_node="${NPROC_PER_NODE:-1}" \
        ${TORCHRUN_ARGS:---standalone} -m mvlt_tpu_torch.cli --config configs/pretrain_exp21.py \
        "$mode" "$@"
done
