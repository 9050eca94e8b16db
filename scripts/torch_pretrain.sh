#!/bin/sh
# Pre-training with the PyTorch port on NVIDIA GPUs: the torchrun counterpart of
# scripts/pretrain.sh (reference: scripts_dws/dws_mvlt_exp21.sh).
# One process a GPU: NPROC_PER_NODE ranks on this node (default 1); other
# torchrun options (--nnodes, --node_rank, --rdzv_endpoint ...) in
# TORCHRUN_ARGS (default --standalone). Every argument goes to the CLI, e.g.
#   NPROC_PER_NODE=8 scripts/torch_pretrain.sh --data-path <root> --tp-size 2 --zero1
# --tp-size must divide NPROC_PER_NODE: a model group stays inside a node.
set -e
cd "$(dirname "$0")/.."
exec python -m torch.distributed.run --nproc_per_node="${NPROC_PER_NODE:-1}" \
    ${TORCHRUN_ARGS:---standalone} -m mvlt_tpu_torch.cli --config configs/pretrain_exp21.py "$@"
