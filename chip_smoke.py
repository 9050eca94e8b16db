#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU: retrieval serving
(pvlt_tiny, pvlt_v2_tiny, pvlt_v2_linear_tiny, pvlt_swin_tiny and the
registry's deeper models), recognition at B = 500, the pre-training step
of the v1, v2, linear-SR v2 and Swin backbones, with dropout and with
--remat, pre-training through the command line, the downstream evals
through the command line on an on-disk tree, data and tensor
parallelism (every backbone, dropout, --remat) and sequence parallelism
(v1, v2, linear v2) over gloo ranks on the one card; with ``--cards 4``,
data, tensor and sequence parallelism over NCCL across four cards
instead.

    python3 chip_smoke.py
    python3 chip_smoke.py --cards 4

run from the root of a checkout, on a machine with a CUDA card, the CUDA
toolkit (nvcc) and PyTorch built for CUDA; JAX is not needed. Phases, one
JSON line each; a failed phase raises and the script exits non-zero:

  1. device: card name and power limit (nvidia-smi), torch/CUDA/nvcc versions;
     TF32 off (matmul and cuDNN) for the fp32 comparisons;
  2. build: g++ builds the native host library (data/native.py) and
     nvcc compiles mvlt_tpu_torch/csrc/*.cu for sm_90a; ptxas's
     registers and spills per kernel, and the HGMMA instructions in the SASS
     of each wgmma kernel (WGMMA_KERNELS: the training attention kernels,
     the MLM CE kernels, the LN-MLP forward's and backward's product
     kernels, the fused attention backward's, kernel F, kernel E's q/k/v
     and out-projection products and kernel A's SR conv and K/V products;
     cuobjdump), which each must hold, and the instantiations of #10's,
     #12's, F's and A's product kernels under the route tags of the chains
     of kernels A, B, C, D and E and of the fused attention forward
     (WGMMA_ROUTES);
  3. kernels: kernel A (SR-KV, a chain of LN1, the SR conv on a gathered
     operand with its contraction split, SR-LN and the K/V product) and
     kernel B (whole block, a chain of LN1, Q, #10's forward, the
     out-projection and #12's forward) against their plain PyTorch versions
     on the card in bf16, bound max|kernel - plain| / max|plain| <= 2e-2,
     and A's output bit-equal over two calls (its split sums), at the four
     pvlt_tiny stage shapes (B = 4), one ragged shape, one with two heads
     (the head stride of the Q and A views), stage 1 at 224 input (M =
     177, off #10's 64-row chunk), v2's ragged shape (D = 96, h != w, head
     dim 32), and the four stage shapes at B = 101, where each kernel's
     time is also taken beside the plain version's, with A's and B's device
     time and a bf16 PyTorch composition of each one's work (LayerNorm,
     cuDNN's conv, cuBLAS, SDPA; yardsticks);
  4. uint8 / 255 on the card, bit-equal to the host's float32 division;
  5. the serving slice: pvlt_tiny (itm head only, bf16, 256x256, 128
     tokens, seeded random weights) scores three synthetic 101-candidate
     bundles through evaluate_retrieval(make_itm_scorer(model)); every score
     finite and in (0, 1); each serving kernel launched 8 times per forward
     and no training kernel. Then every block of a B = 101 forward within
     2e-2 of the plain versions on that block's input, and the ITM logits of
     two pairs within 3e-2 (relative to the largest) of the same weights run
     in fp32 on the CPU through the plain path, printed beside the plain
     path's own bf16 error on the CPU;
  6. serving throughput at B = 101 on pre-staged device tensors, peak device
     memory, and a torch.profiler breakdown of device time by kernel;
  6b. PVT-v2 serving: kernels C (attention half, kernel B's attention-half
     chain under its own route tag) and D (DWConv MLP) against their plain
     versions in bf16 (every output within 2e-2 as in phase 3) at the four
     pvlt_v2_tiny stage shapes (B = 4), a ragged shape (grid 12x20, T = 7,
     head dim 32) and the stage shapes at B = 101 with times and bounds,
     C's and D's device time and a bf16 PyTorch composition of each one's
     work (LayerNorm, cuBLAS, SDPA, cuDNN's depthwise conv; yardsticks);
     pvlt_v2_tiny (itm only, bf16, seeded weights) scores three
     bundles through evaluate_retrieval (kernels A, C and D each launched 8
     times per forward, no other kernel); every block of a B = 101 forward
     (K/V, attention half, block output) within 2e-2 of the plain versions;
     ITM logits of two pairs within 3e-2 of the fp32 CPU model; pairs/s,
     peak memory and a profile, as phases 5-6 for pvlt_tiny;
  6c. Swin serving: kernels E (whole Swin block + pooled LN1 rows) and F
     (windowed joint attention) against their plain versions in bf16 (every
     output within 2e-2 as in phase 3), unshifted and shifted, E at the four
     pvlt_swin_tiny stage shapes at 256 and a ragged 16x24 grid, F at the
     three window-path stage shapes at 224 and a ragged 10x6 grid, at B = 4,
     then the stage shapes at B = 101 with times, bounds and, for F,
     F.scaled_dot_product_attention's (F and SDPA by CUDA events and by
     torch.profiler device time), for E its device time and the window
     path's own PyTorch ops in bf16 on SDPA with a float mask (a
     yardstick); pvlt_swin_tiny (itm only, bf16,
     seeded weights) at 224 scores three bundles (kernel E 2, F 6 and the
     LN-MLP forward 6 launches per forward, no other kernel), every block
     within 2e-2 of the plain versions, ITM logits within 3e-2 of the fp32
     CPU model, pairs/s and a profile; then the same at 256 (E 8 launches
     per forward and nothing else), where the ITM logits with create_model's
     own initialisation are also measured on the card and on the CPU in
     bf16 against the CPU fp32 model (a measurement, not a check);
  6d. recognition (M-CR / S-CR) at the protocol's batch of 500:
     recognition_kernels holds kernels A and B (v1 stage 1), C and D (v2
     stage 1) and E (Swin stage 1 at 256) to their plain versions in bf16
     (every output within 2e-2) at B = 500 and the valid split's ragged last
     batch of 28, where each scratch is largest, A bit-equal over two calls
     at each, with each kernel's time by events and by device time beside
     its plain version's; recognition scores 528 in-memory items with
     FashionGenRecognition's schema through
     evaluate_recognition(make_cls_scorer(model)) over the CLI's loader at
     B = 500 (pvlt_tiny, the fine-tune heads, bf16, 256x256, 128 tokens,
     seeded weights): kernels A and B 8 launches per forward and no other
     kernel, 528 predictions in the artifact, the sup/sub logits of 4 rows
     of the B = 500 call within 3e-2 of the CPU fp32 model; then images/s at
     B = 500 on pre-staged uint8 device tensors, peak memory, the caching
     allocator's snapshot (utils/profiling.py) and a profile;
  7. training kernels: attention forward (o, lse) and backward (dq, dk,
     dv, fed the plain forward's o and lse) and LN-MLP forward/backward
     against their plain versions in bf16 (every output, bound 2e-2 as in
     phase 3) at the four stage shapes at B = 4 and B = 150, a ragged shape
     (M = 22, head dim 32), stage 1 at 224 input (M = 177) and M = 272 (two
     K/V groups of the backward, head dim 32) at B = 4; at B = 150 two
     LN-MLP backward calls bit-equal, and each kernel's time beside its
     plain version's, its bound, and for attention
     F.scaled_dot_product_attention's (a yardstick the port never calls),
     for the LN-MLP forward and backward their device time and a bf16
     PyTorch composition of their work (cuBLAS products; yardsticks too);
  8. the MLM CE kernels (forward: logits on wgmma with per-tile partials
     merged in order; backward: dl recomputed once, then dx, dE and db)
     against their plain versions in bf16 (nll, lse and the three gradients
     within 2e-2) at the path's R = 3,072 gathered rows (~15% labeled), a
     ragged R = 1,000, a ragged vocabulary of 4,099 with every logit below
     0 and labels in its last columns, and with every row ignored (exact
     zeros); two calls of each at R = 3,072 bit-equal; their times at R =
     3,072 beside the plain versions', the bounds and the cuBLAS logits +
     F.cross_entropy yardstick (by CUDA events and by torch.profiler device
     time);
  9. the training slice: pvlt_tiny pre-training (ITM + MLM + T2I at 1/1/10,
     bf16, B = 150, DropPath 0.1, BERT dropout 0.1, AdamW, the MLM loss
     through the MLM CE kernels) takes 6 steps through
     train_one_epoch(make_train_step(...)) on one repeated synthetic batch
     (warmup 0): every loss finite, each block kernel launched 8 times per
     step and each MLM CE kernel once, no serving kernel, the loss of
     steps 4 and 5 below that of steps 0 and 1 (the parities alternate clean
     and masked images), BatchNorm statistics changed. Then every block of a
     B = 150 step (output; input and parameter gradients for the step's
     upstream gradient) within 2e-2 of the plain versions (the step on 4
     samples against the CPU comes after phase 10b);
 10. training throughput at B = 150: ms/step and samples/s, peak memory,
     and a torch.profiler breakdown;
 10a. scan_steps: make_train_step(scan_steps=2) (pvlt_tiny,
     configs/pretrain_exp21.py's model with DropPath and BERT dropout at
     0.1, B = 150, one seeded state made twice) against two single steps
     from step 0 and from step 3: losses, parameters, BatchNorm statistics,
     AdamW moments, step and generator equal in bits, #10-#15 launched
     exactly twice a single step's count; ms per step of both by events;
 10b. the fused_attn_train route (kernels #6/#7 forward, #8 backward):
     fba_train_kernels holds the fused attention half's forward (out), its
     statistics form (out; LN mean and 1/std, each head's row max and
     1/denominator) and its backward in the recompute and the statistics
     form (dx, dK, dV and the six parameter gradients, each form fed its own
     forward's statistics) to their plain versions in bf16 (every output
     within 2e-2 as in phase 3; the dropped sample's dx equal to its dy) at
     the four stage shapes at B = 4 and B = 150, a ragged shape (N off
     the row tile, M off 16, head dim 32), stage 1 at 224 input (M = 177)
     and a two-head shape whose first 128-row tile spans a dropped and a
     kept sample (the forward's row scale taken row by row), with a
     DropPath scale holding a zero; at B = 150 both backward forms bit-equal
     over two calls, each
     kernel's time beside its plain version's (the backward's device time
     too), its bound and the default route's attention half on the same
     inputs by events and device time (cuBLAS Q and projection, #10/#11;
     no single library call computes the fused half). Then, per backward
     form, phase 9's six steps with fused_attn_train on (the fused forward
     and backward 8 times a step,
     #10/#11 never, LN-MLP 8 and MLM CE once a step, no serving kernel;
     falling loss), every block of a step (output, input, K/V and parameter
     gradients) vs the plain route, ms/step, peak memory and a profile;
     then one step on 4 samples on each route (default, both fused forms)
     against the same weights in fp32 on the CPU (losses, and per-tensor
     gradient cosines; the card's MLM loss through the kernels, the CPU's
     through the chunked plain decode), beside the CPU's own bf16 gap;
 10c. the training paths new in the port's later slices, each phase's
     seconds printed: train_glue holds the PyTorch glue of the new paths at
     the stage shapes (B = 4, bf16): Swin's window attention on its
     training route against the same module's serving route on kernel F
     and on F's plain version (the 256 stages, 224's padded 28x28 grid and
     a 10x6 grid in windows of 4, shifted and not), and linear SR's K/V
     input against a written-out plain version with 177, 192 and 192 rows
     at 64/32/16 (floored pool windows, not an adaptive 7x7); v2_route
     takes a v2 step with fused_attn_train set (#10/#11 once per block, the
     fused half never: it is v1's route); pvlt_v2_tiny and pvlt_swin_tiny
     (at 256) pre-train as phase 9 (6 steps at B = 150: v2's #10/#11 and
     Swin's #12/#13 8 times a step, the MLM CE kernels once, nothing else;
     falling loss, BatchNorm statistics moved), every block of a step vs
     plain, ms/step and a profile, and a 4-sample step vs the CPU fp32
     step; pvlt_v2_linear_tiny serves three bundles (C and D 8 launches a
     forward, A 2: stage 4 only), its blocks vs plain with their K/V rows,
     ITM logits vs the CPU fp32 model, pairs/s and a profile, then trains
     as v2; a v1 step with drop_rate = attn_drop_rate = 0.1 launches no
     block kernel (the JAX package's routes) and its loss falls; remat
     takes one step with and one without torch.utils.checkpoint per block
     from one generator seed (pvlt_tiny at B = 150 on the default route
     with drop_rate 0.1 and on fused_attn_stats, then pvlt_large at B =
     150): every loss within 1e-3, every gradient within 1e-3 of its
     tensor's largest magnitude or twice a repeat without remat's own gap
     (the card's step is not bit-reproducible), the generators in the same
     state after, the forward
     kernels launched twice, the peak memory lower, ms/step of each; and
     pvlt_small, pvlt_medium, pvlt_large, pvlt_v2_small and pvlt_swin_small
     (at 256, kernel E on every block) each serve one bundle, the ITM
     head's input of 4 rows within 3e-2 of the CPU fp32 model, the logits
     beside it;
 11. the command line: ``mvlt_tpu_torch.cli.main`` with
     configs/pretrain_exp21.py on synthetic data (B = 150) for 2 epochs with
     the VL eval in epoch 1, ``--resume last`` for epoch 2, then one CLS
     fine-tune epoch (configs/finetune_exp48.py) from that checkpoint, in
     build/chip_smoke_cli (removed after): logs, checkpoints, finite losses
     and eval statistics, every kernel launched, the MLM CE kernels once per
     pre-training step; one epoch at --batch-size 96 (two steps) at
     ``--steps-per-dispatch`` 1 and 2, each step's losses equal in bits and
     the log lines equal but for time and LR; then one more epoch, apart
     from those timed runs, under ``--profile-dir``, whose trace names the
     training kernels;
 12. the downstream command lines (cli_eval) on a small Fashion-Gen tree
     written under build/ and a .pth of seeded weights:
     ``--eval-retrieval-itr`` and ``-tir``, each with and without
     ``--parity-heads``, and ``--eval-recognition``, each returning the
     metrics of the same reader and scorer run directly (kernels A and B
     launched, no training kernel), the recognition artifact, ``--viz``,
     and one pre-training epoch on the tree's reader (the readers decode
     with Pillow; the phase fails where it is not installed); the train
     reader through the native host library (the C++ tokenizer, every image
     equal to native_crop_resize and not to PIL's) and its items/s with
     use_native_image_ops on and off;
 13. data parallelism at world 1 (ddp_world1): phase 11's first run (2
     pre-training epochs of configs/pretrain_exp21.py, synthetic, B = 150,
     the VL eval on the sharded path) under ``python -m
     torch.distributed.run --nproc_per_node=1`` on NCCL, its launches equal
     to that run's without a process group, its rank-0 checkpoint loaded
     strictly by ``load_eval_model``; in the rank, a DDP step against the unwrapped
     step from the same state and batch (DDP_TOL, the largest gap printed);
 14. two ranks on the one card over gloo (ddp_two_ranks; NCCL refuses two
     ranks on one device): a B = 75 step each against the B = 150 step
     (losses and BatchNorm statistics within DDP_TOL, gradients within
     DDP_TOL or the step's own noise under a reordering of its rows and,
     formed in bf16, the ranks' bf16 roundings), ZeRO-1's AdamW on the same
     gradients (within ZERO_TOL,
     the moments split), one call of two steps (scan_steps=2) equal in bits
     to two single DDP steps on each rank and within the same bounds of one
     process's call, retrieval over 3 bundles and recognition over 10
     items sharded over the ranks with the one-process metrics, the
     two-rank step's ms (gloo through host copies) beside the one-process
     step's;
 15. the tensor-parallel modes of #12/#13 (tp_kernels: a rank's slice of
     the hidden, H / 2 and H / 4, at the four stage shapes at B = 150 and a
     ragged one) and of #14/#15 (V / 2 at R = 3,072, labels in both halves
     and ignored rows), summed over the slices in fp32 in this process and
     held to the unsharded kernel and the plain version within 2e-2, one
     rank's launch timed beside the unsharded launch;
 16. tensor parallelism on two gloo ranks of one model group on the one
     card (tp_two_ranks: tp = 2, dp = 1, pvlt_tiny split by
     parallel/tensor.py:shard_model, the whole B = 150 batch): the step at
     each parity against this process's (losses, consolidated gradients
     under ddp_two_ranks' bound, BatchNorm statistics), the launches a rank
     (#10/#11 and #12/#13's tensor-parallel modes once per block, #14/#15's
     once a step, nothing else), the consolidated checkpoint restored in one
     process, equal masks on both ranks with DropPath and dropout on, the
     split model's VL eval against this process's on the same route, the
     step's ms over gloo;
 17. tp_families: the same two gloo ranks at B = 150 split pvlt_v2_tiny,
     pvlt_v2_linear_tiny and pvlt_swin_tiny, pvlt_tiny with every dropout
     at 0.1 and pvlt_swin_tiny under --remat (TP_FAMILY_CASES), each step
     against this process's from the same weights and mask seed: losses,
     consolidated gradients under tp_two_ranks' bound, parameters equal to
     AdamW's step on the consolidated gradients, BatchNorm statistics, the
     generator in the one-process state (the split masks drew what one
     process draws), every rank's digests equal, exact launches a rank;
 18. sp_two_ranks: the same two gloo ranks as one sequence-parallel model
     group (create_model(..., sp_group=), each stage planned_split names
     split into bands of half its grid rows and 64 text rows; Swin's stages
     1-3, by whole window rows): each primitive of parallel/sequence.py at
     stage 1 against the whole tensor's rows within SP_PRIMITIVE_TOL (split
     and gather, the K/V gather and its reduce-scatter, the halo exchange,
     linear SR's pool, a dropout mask's rows, Swin's shifted-window roll,
     the reduce-scatter of a row-parallel product's partials, each
     backward), pvlt_tiny, pvlt_v2_tiny, pvlt_v2_linear_tiny and
     pvlt_swin_tiny scoring a B = 101 bundle on their bands (A and B, A, C
     and D, or F and #12 on Swin's split stages and E on the whole one:
     sp_serving_launches a forward a rank) within SLICE_TOL of this
     process's whole forward (Swin's on the same route), a B = 150 step of v1 on both routes, of v2
     and of Swin, and of v1 and Swin with their weights split over the same
     two ranks (SP x TP: the consolidated tensors, #10-#15's TP modes,
     SPTP_STEPS' launches) against this process's under tp_families'
     bounds with SP_STEPS' launches a rank; kernel A on each band beside A
     on the whole grid; kernel F on a band's windows against its plain
     version.

``--cards 4`` (a machine with four cards; each phase under
``python -m torch.distributed.run --nproc_per_node=4``, one rank a card,
NCCL, a process-group or subprocess timeout failing a hang): the build,
then nccl_ddp (the pre-training command line at world 4, B = 150 a rank,
two epochs; a DDP step on each rank's quarter of a B = 600 batch against
one process's B = 600 step on cuda:0 under ddp_two_ranks' bound, the same
step under ZeRO-1; a rank's ms a step beside one process's at B = 150) and
nccl_tp (dp 2 x tp 2: the command line at --tp-size 2 on v1, v2 and Swin;
a split step of each at B = 150 a data rank against one process's at B =
300; v2 under ZeRO-1 over the data group, its checkpoint resumed at tp = 1
without it) and nccl_sp (sp 4: pvlt_tiny and pvlt_swin_tiny serving a B = 101 bundle
and taking their B = 150 steps on bands of a quarter of the rows, Swin's
stages 1-2, and pvlt_tiny's step with its weights split over the same four
ranks; dp 2 x sp 2: v2's step at B = 150 a data rank against one process
at B = 300; sp_two_ranks' checks, a rank's ms beside one process's). It prints the cards' nvidia-smi lines
and the same last line, ``count`` the cards it used.

Then one line {"kernels": [...]}: per kernel the launches of its path's
run (the MLM CE kernels': the command line's; the tensor-parallel modes':
a rank's in tp_two_ranks' step; ``sp_launches``: a rank's over
sp_two_ranks' forwards and steps), the largest error of its
checks, its time and its plain version's summed over the four stage shapes
at the path's batch (one launch each; the MLM CE kernels at R = 3,072), the
bound, and the library call's time where there is one; the nvidia-smi
line; and last {"ok": true, "device": {...}}. Without a CUDA device it exits
non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import pathlib
import pickle
import shutil
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from mvlt_tpu_torch import cli
from mvlt_tpu_torch.config import (DataConfig, LossType, ModelConfig, OptimConfig,
                                   apply_overrides)
from mvlt_tpu_torch.data.fashion_gen import (FashionGenRecognition, FashionGenRetrieval,
                                             SyntheticFashionGen, batch_to_device, collate)
from mvlt_tpu_torch.data.tokenizer import WordPieceTokenizer
from mvlt_tpu_torch.eval import recognition
from mvlt_tpu_torch.eval.recognition import evaluate_recognition, make_cls_scorer
from mvlt_tpu_torch.eval.retrieval import evaluate_retrieval, make_itm_scorer, uint8_to_unit
from mvlt_tpu_torch.models.pvlt import Block, SwinBlock, create_model, kernel_operand
from mvlt_tpu_torch.models.registry import resolve_model_config
from mvlt_tpu_torch.models.swin import (SwinJointAttention, add_table, heads_of,
                                        relative_position_index, window_masks,
                                        window_partition, window_reverse)
from mvlt_tpu_torch.ops import _build
from mvlt_tpu_torch.ops.block_attention import (block_attention_bwd_reference,
                                                block_attention_reference,
                                                block_attention_train_bwd,
                                                block_attention_train_bwd_tp,
                                                block_attention_train_fwd,
                                                block_attention_train_fwd_tp,
                                                block_attention_train_reference,
                                                fused_block_attention,
                                                fused_block_attention_train)
from mvlt_tpu_torch.ops.block_fused import block_reference, fused_block
from mvlt_tpu_torch.ops.dwconv_mlp import dwconv_mlp_reference, fused_dwconv_mlp, scratch_elems
from mvlt_tpu_torch.ops.fused_mlp import (fused_ln_mlp, ln_mlp_bwd, ln_mlp_bwd_reference,
                                          ln_mlp_bwd_tp, ln_mlp_fwd, ln_mlp_fwd_tp,
                                          ln_mlp_reference)
from mvlt_tpu_torch.ops.kernel_math import gelu_grad, layer_norm_fp32, linear
from mvlt_tpu_torch.ops.mlm_ce import (mlm_ce_bwd, mlm_ce_bwd_tp, mlm_ce_fwd, mlm_ce_fwd_tp,
                                       mlm_nll_bwd_reference, mlm_nll_partial_reference,
                                       mlm_nll_reference)
from mvlt_tpu_torch.ops.pallas_attention import (attention_bwd, attention_fwd,
                                                 attention_reference,
                                                 attention_stats_bwd_reference,
                                                 attention_stats_reference, fused_attention)
from mvlt_tpu_torch.ops.sr_kv import (conv_splits, fused_ln_sr_kv, linear_reduce_kv_input,
                                      sr_kv_reference)
from mvlt_tpu_torch.ops.swin_attention import fused_swin_attention, swin_attention_reference
from mvlt_tpu_torch.ops.swin_band import fused_swin_block, swin_block_reference
from mvlt_tpu_torch.parallel.tensor import COL, ROW, shard_tensor
from mvlt_tpu_torch.train.engine import train_one_epoch
from mvlt_tpu_torch.train.state import create_train_state
from mvlt_tpu_torch.train.step import make_train_step
from mvlt_tpu_torch.utils.checkpoint import merge_state_dicts
from mvlt_tpu_torch.utils.profiling import device_memory_profile

SEED = 0
BATCH = 101                 # candidates of one retrieval bundle
SMOKE_BATCH = 4             # kernel-vs-plain checks
KERNEL_TOL = 2e-2           # bf16 kernel vs bf16 plain, relative to max|plain|
# bf16 card model vs fp32 CPU model, max|diff| / max|logit|. With
# seeded_state_dict's weights the plain bf16 model on the CPU is ~1% off the
# fp32 one. Near initialisation attention is close to uniform and each
# block's residual dominates its output, so a wiring fault inside a block
# (K/V or Q/proj swapped) moves these logits by only ~1%: this bound guards
# the model glue and the bf16 policy, and check_blocks holds each block.
SLICE_TOL = 3e-2

# pvlt_tiny at 256x256 input and 128 text tokens: per stage (h, w, dim,
# heads, sr, hidden); M = (h/sr)(w/sr) + 128 = 192 at every stage. The
# overlapping patch embeds of pvlt_v2_tiny give the same grids, so its
# stages have the same shapes.
STAGES = [
    (64, 64, 64, 1, 8, 512),
    (32, 32, 128, 2, 4, 1024),
    (16, 16, 320, 5, 2, 1280),
    (8, 8, 512, 8, 1, 2048),
]
TEXT = 128
RAGGED = (12, 12, 64, 1, 4, 512, 20)   # N = 164, M = 29: ragged row tile and K/V
RAGGED_HEADS = (12, 12, 128, 2, 4, 1024, 20)   # the same with two heads of 64
# h != w (a halo that wraps across grid rows shows), T not a multiple of 8,
# head dim 32: N = 247, M = 22
V2_RAGGED = (12, 20, 96, 3, 4, 384, 7)
TRAIN_BATCH = 150          # pre-training batch (configs/pretrain_exp21.py)
TRAIN_STEPS = 6
CPU_BATCH = 4              # card-vs-CPU step
# bf16 card step vs fp32 CPU step: |loss diff| / |CPU loss| per loss, and
# the smallest per-tensor gradient cosine (tensors with a gradient norm
# above 1e-6 of the largest). Measured on an H100 (seeded weights and
# batch): 2.1e-3 (ITM) and 0.99942 (a T2I conv), the CPU's own bf16 model
# 3.7e-4 and 0.99939; the bounds keep a margin of ~5x on the loss gap and
# ~10x on 1 - cosine.
STEP_LOSS_TOL = 1e-2
GRAD_COS_MIN = 0.995
# H100 SXM peaks (NVIDIA's data sheet): bf16 dense tensor cores, HBM
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
KERNELS = [
    {"name": "sr_kv", "route": "cuda", "source": "mvlt_tpu_torch/csrc/sr_kv.cu",
     "replaces": "mvlt_tpu/ops/sr_kv.py:129 (+ mvlt_tpu/ops/block_packed.py:418)"},
    {"name": "block_fused", "route": "cuda", "source": "mvlt_tpu_torch/csrc/block_fused.cu",
     "replaces": "mvlt_tpu/ops/block_fused.py:130 (+ mvlt_tpu/ops/block_packed.py:131)"},
    {"name": "attention_fwd", "route": "cuda", "source": "mvlt_tpu_torch/csrc/attention.cu",
     "replaces": "mvlt_tpu/ops/pallas_attention.py:184"},
    {"name": "attention_bwd", "route": "cuda", "source": "mvlt_tpu_torch/csrc/attention.cu",
     "replaces": "mvlt_tpu/ops/pallas_attention.py:118"},
    {"name": "ln_mlp_fwd", "route": "cuda", "source": "mvlt_tpu_torch/csrc/ln_mlp.cu",
     "replaces": "mvlt_tpu/ops/fused_mlp.py:380"},
    {"name": "ln_mlp_bwd", "route": "cuda", "source": "mvlt_tpu_torch/csrc/ln_mlp_bwd.cu",
     "replaces": "mvlt_tpu/ops/fused_mlp.py:214"},
    {"name": "mlm_ce_fwd", "route": "cuda", "source": "mvlt_tpu_torch/csrc/mlm_ce.cu",
     "replaces": "mvlt_tpu/ops/mlm_ce.py:187"},
    {"name": "mlm_ce_bwd", "route": "cuda", "source": "mvlt_tpu_torch/csrc/mlm_ce.cu",
     "replaces": "mvlt_tpu/ops/mlm_ce.py:249"},
    {"name": "block_attention", "route": "cuda",
     "source": "mvlt_tpu_torch/csrc/block_attention.cu",
     "replaces": "mvlt_tpu/ops/block_attention.py:754 (+ mvlt_tpu/ops/block_packed.py:269)"},
    {"name": "dwconv_mlp", "route": "cuda", "source": "mvlt_tpu_torch/csrc/dwconv_mlp.cu",
     "replaces": "mvlt_tpu/ops/dwconv_mlp.py:98 (+ mvlt_tpu/ops/dwconv_mlp.py:263)"},
    {"name": "swin_block", "route": "cuda", "source": "mvlt_tpu_torch/csrc/swin_block.cu",
     "replaces": "mvlt_tpu/ops/swin_band.py:269"},
    {"name": "swin_attention", "route": "cuda",
     "source": "mvlt_tpu_torch/csrc/swin_attention.cu",
     "replaces": "mvlt_tpu/ops/swin_attention.py:142"},
    {"name": "fba_train_fwd", "route": "cuda",
     "source": "mvlt_tpu_torch/csrc/block_attention_train.cu",
     "replaces": "mvlt_tpu/ops/block_attention.py:647"},
    {"name": "fba_train_fwd_stats", "route": "cuda",
     "source": "mvlt_tpu_torch/csrc/block_attention_train.cu",
     "replaces": "mvlt_tpu/ops/block_attention.py:692"},
    {"name": "fba_train_bwd", "route": "cuda",
     "source": "mvlt_tpu_torch/csrc/block_attention_train.cu",
     "replaces": "mvlt_tpu/ops/block_attention.py:544 (_bwd_kernel :136)"},
    {"name": "fba_train_bwd_stats", "route": "cuda",
     "source": "mvlt_tpu_torch/csrc/block_attention_train.cu",
     "replaces": "mvlt_tpu/ops/block_attention.py:544 (_bwd_kernel_stats :265)"},
    {"name": "ln_mlp_fwd_tp", "route": "cuda", "source": "mvlt_tpu_torch/csrc/ln_mlp.cu",
     "replaces": "mvlt_tpu/ops/fused_mlp.py:380 (its tensor-parallel mode)"},
    {"name": "ln_mlp_bwd_tp", "route": "cuda", "source": "mvlt_tpu_torch/csrc/ln_mlp_bwd.cu",
     "replaces": "mvlt_tpu/ops/fused_mlp.py:214 (its tensor-parallel mode)"},
    {"name": "mlm_ce_fwd_tp", "route": "cuda", "source": "mvlt_tpu_torch/csrc/mlm_ce.cu",
     "replaces": "mvlt_tpu/ops/mlm_ce.py:187 (its tensor-parallel mode)"},
    {"name": "mlm_ce_bwd_tp", "route": "cuda", "source": "mvlt_tpu_torch/csrc/mlm_ce.cu",
     "replaces": "mvlt_tpu/ops/mlm_ce.py:249 (its tensor-parallel mode)"},
    {"name": "fba_train_fwd_tp", "route": "cuda",
     "source": "mvlt_tpu_torch/csrc/block_attention_train.cu",
     "replaces": "mvlt_tpu/ops/block_attention.py:647 (its tensor-parallel mode)"},
    {"name": "fba_train_fwd_stats_tp", "route": "cuda",
     "source": "mvlt_tpu_torch/csrc/block_attention_train.cu",
     "replaces": "mvlt_tpu/ops/block_attention.py:692 (its tensor-parallel mode)"},
    {"name": "fba_train_bwd_tp", "route": "cuda",
     "source": "mvlt_tpu_torch/csrc/block_attention_train.cu",
     "replaces": "mvlt_tpu/ops/block_attention.py:544 (_bwd_kernel :136, its tensor-parallel "
                 "mode)"},
    {"name": "fba_train_bwd_stats_tp", "route": "cuda",
     "source": "mvlt_tpu_torch/csrc/block_attention_train.cu",
     "replaces": "mvlt_tpu/ops/block_attention.py:544 (_bwd_kernel_stats :265, its "
                 "tensor-parallel mode)"},
]
SERVING_WRAPPERS = {"sr_kv": fused_ln_sr_kv, "block_fused": fused_block}
# kernel A's chain runs #12's norm kernel and its own under SrKvRoute,
# kernel B's #10's and #12's kernels under BlockFusedRoute
V1_GROUPS = {"sr_kv": ("SrKvRoute",), "block_fused": ("BlockFusedRoute",)}
V2_SERVING_WRAPPERS = {"sr_kv": fused_ln_sr_kv, "block_attention": fused_block_attention,
                       "dwconv_mlp": fused_dwconv_mlp}
SWIN_WRAPPERS = {"swin_block": fused_swin_block, "swin_attention": fused_swin_attention}
TRAINING_WRAPPERS = {"attention_fwd": attention_fwd, "attention_bwd": attention_bwd,
                     "ln_mlp_fwd": ln_mlp_fwd, "ln_mlp_bwd": ln_mlp_bwd}
MLM_WRAPPERS = {"mlm_ce_fwd": mlm_ce_fwd, "mlm_ce_bwd": mlm_ce_bwd}   # once per step
# the fused_attn_train route: one wrapper each for the forward and the
# backward, in either form (the kernels line keeps the two forms apart)
FBA_WRAPPERS = {"fba_train_fwd": block_attention_train_fwd,
                "fba_train_bwd": block_attention_train_bwd}
FBA_ROUTE = {**FBA_WRAPPERS, "ln_mlp_fwd": ln_mlp_fwd, "ln_mlp_bwd": ln_mlp_bwd}
# the tensor-parallel modes of #6-#8 and #12-#15 (a rank's heads, slice of
# the hidden or of the vocabulary), each counted apart from its one-process
# launches; #6-#8's in either form (the kernels line keeps the forms apart)
TP_WRAPPERS = {"ln_mlp_fwd_tp": ln_mlp_fwd_tp, "ln_mlp_bwd_tp": ln_mlp_bwd_tp,
               "mlm_ce_fwd_tp": mlm_ce_fwd_tp, "mlm_ce_bwd_tp": mlm_ce_bwd_tp,
               "fba_train_fwd_tp": block_attention_train_fwd_tp,
               "fba_train_bwd_tp": block_attention_train_bwd_tp}
WRAPPERS = {**SERVING_WRAPPERS, **V2_SERVING_WRAPPERS, **SWIN_WRAPPERS, **TRAINING_WRAPPERS,
            **MLM_WRAPPERS, **FBA_WRAPPERS, **TP_WRAPPERS}


def new_stats() -> dict:
    """Per kernel of KERNELS, the fields of its entry in the kernels line,
    summed or maxed over the phases that run it."""
    return {k["name"]: {"launches": 0, "sp_launches": 0, "max_abs_err": 0.0, "ms": 0.0,
                        "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": None, "library_ms": None,
                        "bound_shares": {"bytes": 0.0, "operations": 0.0}}
            for k in KERNELS}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the
    operations over the bf16 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, warmup: int = 3, reps: int = 10) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def is_kernel(evt) -> bool:
    """A device-side event of a profile: not an operator's own row (which
    repeats the device time of the kernels it launched), and not a user
    annotation's span on the device timeline (the optimizer step's, which
    covers idle gaps where the device waits on the host)."""
    return (evt.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False))


def device_time_ms(fn, calls: int = 10) -> float | str:
    """Device time of one call: the kernels' time by torch.profiler over
    ``calls`` calls after one warm-up, per call ("not measured" where the
    profiler shows no device time)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(evt.self_device_time_total for evt in prof.key_averages() if is_kernel(evt))
    return total / 1e3 / calls if total else "not measured"


def phase_device() -> str:
    smi = nvidia_smi_line()
    nvcc = subprocess.run(["nvcc", "--version"], capture_output=True, text=True,
                          check=False).stdout.strip().splitlines()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc[-1] if nvcc else "not found",
         python=sys.version.split()[0])
    return smi


# the wgmma kernels, each of which must hold HGMMA instructions in its SASS
WGMMA_KERNELS = ("attn_fwd_hopper_kernel", "attn_bwd_hopper_kernel", "mlm_ce_fwd_kernel",
                 "mlm_ce_dlogits_kernel", "mlm_ce_gemm_kernel", "ln_mlp_bwd_hidden_kernel",
                 "ln_mlp_bwd_wgrad_kernel", "ln_mlp_bwd_dnorm_kernel", "swin_attn_hopper_kernel",
                 "ln_mlp_fwd_fused_kernel", "ln_mlp_fwd_hidden_kernel", "ln_mlp_fwd_out_kernel",
                 "fba_bwd_proj_kernel", "fba_bwd_wgrad_kernel", "swin_qkv_kernel",
                 "swin_proj_kernel", "sr_conv_gemm_kernel", "kv_proj_gemm_kernel")
# the chains of kernels A, B, C, D and E and of the fused attention forward
# run #10's, #12's, F's and their own product kernels under their route
# tags (csrc/common.cuh): (kernel, tag) pairs whose instantiation must be in
# the library, with HGMMA like every instantiation of a WGMMA_KERNELS entry
WGMMA_ROUTES = (("ln_mlp_fwd_hidden_kernel", "DwConvRoute"),
                ("ln_mlp_fwd_out_kernel", "DwConvRoute"),
                ("ln_mlp_fwd_fused_kernel", "SwinBlockRoute"),
                ("ln_mlp_fwd_hidden_kernel", "SwinBlockRoute"),
                ("ln_mlp_fwd_out_kernel", "SwinBlockRoute"),
                ("swin_attn_hopper_kernel", "SwinBlockRoute"),
                ("attn_fwd_hopper_kernel", "BlockFusedRoute"),
                ("ln_mlp_fwd_hidden_kernel", "BlockFusedRoute"),
                ("ln_mlp_fwd_out_kernel", "BlockFusedRoute"),
                ("ln_mlp_fwd_fused_kernel", "BlockFusedRoute"),
                ("attn_fwd_hopper_kernel", "FbaFwdRoute"),
                ("ln_mlp_fwd_hidden_kernel", "FbaFwdRoute"),
                ("ln_mlp_fwd_out_kernel", "FbaFwdRoute"),
                ("attn_fwd_hopper_kernel", "BlockAttentionRoute"),
                ("ln_mlp_fwd_hidden_kernel", "BlockAttentionRoute"),
                ("ln_mlp_fwd_out_kernel", "BlockAttentionRoute"),
                ("sr_conv_gemm_kernel", "SrKvRoute"),
                ("kv_proj_gemm_kernel", "SrKvRoute"))


def hgmma_counts(library: pathlib.Path) -> dict:
    """HGMMA instructions in the SASS of each kernel of the library whose
    name holds one of WGMMA_KERNELS (``cuobjdump -sass``), by mangled name:
    one entry per template instantiation."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, current = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :", 1)[1].strip()
            current = name if any(k in name for k in WGMMA_KERNELS) else None
            if current:
                counts[current] = 0
        elif current and "HGMMA" in ln:
            counts[current] += 1
    return counts


def phase_build() -> None:
    path, log, seconds = _build.build()
    _build.load_library()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    hgmma = hgmma_counts(path)
    ok = (all(any(k in name for name in hgmma) for k in WGMMA_KERNELS)
          and all(any(k in name and tag in name for name in hgmma) for k, tag in WGMMA_ROUTES)
          and all(n > 0 for n in hgmma.values()))
    from mvlt_tpu_torch.data import native

    start = time.perf_counter()   # the host library the readers and tokenizer use
    native_path = native.build()
    native.load_library()
    emit("build", library=str(path.relative_to(path.parents[2])),
         seconds=round(seconds, 2), ptxas=ptxas, hgmma=hgmma,
         native_library=str(native_path.relative_to(REPO)),
         native_seconds=round(time.perf_counter() - start, 2), ok=ok)
    if not ok:
        raise AssertionError(f"a wgmma kernel has no HGMMA in its SASS: {hgmma}")


def stage_params(gen, d: int, sr: int, hidden: int, device) -> dict:
    """Seeded random parameters of one block, fp32, torch layout. A matrix
    has std gain / sqrt(fan_in): gain 1.5 for Q and K/V, so the softmax is
    peaked (logits of std ~2) and not near-uniform, and gain 1 for the
    out-projection and the MLP, so the block's update is not small beside
    its residual. A wrong logit scale, mask or K/V row then shows in the
    output."""
    def rnd(*shape, std=1.0, mean=0.0):
        return (mean + std * torch.randn(*shape, generator=gen)).to(device)

    def mat(*shape, gain):
        return rnd(*shape, std=gain / (math.prod(shape[1:]) ** 0.5))

    p = {
        "ln1_weight": rnd(d, std=0.1, mean=1.0), "ln1_bias": rnd(d, std=0.1),
        "kv_weight": mat(2 * d, d, gain=1.5), "kv_bias": rnd(2 * d, std=0.05),
        "wq": mat(d, d, gain=1.5), "bq": rnd(d, std=0.05),
        "wp": mat(d, d, gain=1.0), "bp": rnd(d, std=0.05),
        "ln2_weight": rnd(d, std=0.1, mean=1.0), "ln2_bias": rnd(d, std=0.1),
        "w1": mat(hidden, d, gain=1.0), "b1": rnd(hidden, std=0.05),
        "w2": mat(d, hidden, gain=1.0), "b2": rnd(d, std=0.05),
        "sr_weight": None, "sr_bias": None, "srn_weight": None, "srn_bias": None,
    }
    if sr > 1:
        p.update(sr_weight=mat(d, d, sr, sr, gain=1.0), sr_bias=rnd(d, std=0.05),
                 srn_weight=rnd(d, std=0.1, mean=1.0), srn_bias=rnd(d, std=0.1))
    return p


def _kv_args(p):
    return (p["ln1_weight"], p["ln1_bias"], p["sr_weight"], p["sr_bias"],
            p["srn_weight"], p["srn_bias"], p["kv_weight"], p["kv_bias"])


def _block_args(p):
    return (p["ln1_weight"], p["ln1_bias"], p["wq"], p["bq"], p["wp"], p["bp"],
            p["ln2_weight"], p["ln2_bias"], p["w1"], p["b1"], p["w2"], p["b2"])


def _rel_err(got, want) -> tuple[float, float]:
    diff = (got.float() - want.float()).abs().max().item()
    return diff, diff / max(want.float().abs().max().item(), 1e-30)


def check_kernels(stats: dict, gen, label: str, shape: tuple, batch: int):
    """Both kernels against their plain versions on one shape's seeded
    inputs on the card, and A's output bit-equal over two calls; raises
    past KERNEL_TOL or on a repeat that differs. Returns the inputs and the
    plain K/V, for timing."""
    h, w, d, nh, sr, hid, t = shape
    p = stage_params(gen, d, sr, hid, torch.device("cuda"))
    x = torch.randn(batch, h * w + t, d, generator=gen).to("cuda", torch.bfloat16)
    kw_kv = dict(sr=sr, heads=nh, eps1=1e-6, eps_sr=1e-5)
    kw_b = dict(heads=nh, eps1=1e-6, eps2=1e-6)
    k_ref, v_ref = sr_kv_reference(x, (h, w), *_kv_args(p), **kw_kv)
    k, v = fused_ln_sr_kv(x, (h, w), *_kv_args(p), **kw_kv)
    k2, v2 = fused_ln_sr_kv(x, (h, w), *_kv_args(p), **kw_kv)
    out_ref = block_reference(x, k_ref, v_ref, *_block_args(p), **kw_b)
    out = fused_block(x, k_ref, v_ref, *_block_args(p), **kw_b)
    torch.cuda.synchronize()
    repeat = bool(torch.equal(k, k2) and torch.equal(v, v2))
    emit("kernel_repeat", kernel="sr_kv", shape=label, batch=batch, bit_equal=repeat)
    if not repeat:
        raise AssertionError(f"sr_kv differs between two calls at {label}, B = {batch}")
    errs = {"sr_kv": max(_rel_err(k, k_ref), _rel_err(v, v_ref), key=lambda e: e[1]),
            "block_fused": _rel_err(out, out_ref)}
    for name, (abs_err, rel) in errs.items():
        ok = bool(rel <= KERNEL_TOL and np.isfinite(rel))
        emit("kernel_check", kernel=name, shape=label, batch=batch,
             n=h * w + t, dim=d, heads=nh, sr=sr, m=k.shape[2],
             max_abs_err=abs_err, rel_err=rel, tol=KERNEL_TOL, ok=ok)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version at "
                                 f"{label}, B = {batch}: rel err {rel:.3e} > {KERNEL_TOL}")
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], abs_err)
    return p, x, k_ref, v_ref, kw_kv, kw_b


def serving_bounds(shape: tuple, batch: int) -> dict:
    """(ms, bound_by) of kernels A and B at one stage shape: the SR conv and
    K/V products, and the block's Q, logits, P.V, out-proj, fc1 and fc2;
    bytes: the stream read (and for B written) once, K/V written (A) or
    read (B) once, the bf16 weights read once."""
    h, w, d, _, sr, hid, t = shape
    n = h * w + t
    m = (h // sr) * (w // sr) + t if sr > 1 else n
    flops_a = 2 * batch * ((h * w * d * d if sr > 1 else 0) + m * d * 2 * d)
    bytes_a = 2 * (batch * n * d + 2 * batch * m * d + (sr * sr * d * d if sr > 1 else 0) + 2 * d * d)
    flops_b = 2 * batch * n * (2 * d * d + 2 * m * d + 2 * d * hid)
    bytes_b = 2 * (2 * batch * n * d + 2 * batch * m * d + 2 * d * d + 2 * d * hid)
    return {"sr_kv": bound(flops_a, bytes_a), "block_fused": bound(flops_b, bytes_b)}


def add_time(stats: dict, name: str, **fields) -> None:
    """Sum a kernel's per-shape times and bound into its stats entry; its
    bound_by is the kind (bytes or operations) with the larger share of
    the summed bound."""
    st = stats[name]
    for key in ("ms", "plain_ms", "bound_ms"):
        st[key] += fields[key]
    lib = fields.get("library_ms")
    st["library_ms"] = None if lib is None else (st["library_ms"] or 0.0) + lib
    st["bound_shares"][fields["bound_by"]] += fields["bound_ms"]
    st["bound_by"] = max(st["bound_shares"], key=st["bound_shares"].get)


def yardsticks(run, composition) -> dict:
    """A kernel's device time and a bf16 PyTorch composition of its work
    by CUDA events and by device time (the composition is a yardstick,
    never a path the port calls)."""
    return {"device_ms": device_time_ms(run), "composition_ms": cuda_time_ms(composition),
            "composition_device_ms": device_time_ms(composition)}


def sr_kv_composition(x, hw: tuple, p: dict, sr: int):
    """Kernel A's function as PyTorch calls in bf16: F.layer_norm, the SR
    conv (cuDNN's F.conv2d), F.layer_norm, torch.cat with the text rows and
    F.linear (cuBLAS) to [B, M, 2D]; a yardstick, never a path the port
    calls."""
    g1, be1, wsr, bsr, gsr, bsrn, wkv, bkv = (None if t is None else t.to(torch.bfloat16)
                                              for t in _kv_args(p))
    (h, w), d = hw, x.shape[-1]

    def run():
        normed = F.layer_norm(x, (d,), g1, be1, 1e-6)
        if sr == 1:
            return F.linear(normed, wkv, bkv)
        grid = normed[:, : h * w].reshape(x.shape[0], h, w, d).permute(0, 3, 1, 2)
        red = F.conv2d(grid, wsr, bsr, stride=sr).flatten(2).transpose(1, 2)
        red = F.layer_norm(red, (d,), gsr, bsrn, 1e-5)
        return F.linear(torch.cat([red, normed[:, h * w:]], dim=1), wkv, bkv)
    return run


def attention_half_composition(x, k, v, p: dict, heads: int):
    """Kernel C's function as PyTorch calls in bf16: F.layer_norm, F.linear
    (cuBLAS), F.scaled_dot_product_attention, the projection and the
    residual; a yardstick, never a path the port calls."""
    g1, be1, wq, bq, wp, bp = (t.to(torch.bfloat16) for t in _c_args(p))
    b, n, d = x.shape

    def run():
        q = F.linear(F.layer_norm(x, (d,), g1, be1, 1e-6), wq, bq)
        o = F.scaled_dot_product_attention(q.view(b, n, heads, d // heads).transpose(1, 2), k, v)
        return x + F.linear(o.transpose(1, 2).reshape(b, n, d), wp, bp)
    return run


def block_composition(x, k, v, p: dict, heads: int):
    """Kernel B's function as PyTorch calls in bf16: F.layer_norm, F.linear
    (cuBLAS), F.scaled_dot_product_attention, the projection and residual,
    the MLP (F.linear, erf F.gelu) and its residual; a yardstick, never a
    path the port calls."""
    g1, be1, wq, bq, wp, bp, g2, be2, w1, b1, w2, b2 = (t.to(torch.bfloat16)
                                                        for t in _block_args(p))
    b, n, d = x.shape

    def run():
        q = F.linear(F.layer_norm(x, (d,), g1, be1, 1e-6), wq, bq)
        o = F.scaled_dot_product_attention(q.view(b, n, heads, d // heads).transpose(1, 2), k, v)
        h = x + F.linear(o.transpose(1, 2).reshape(b, n, d), wp, bp)
        return h + F.linear(F.gelu(F.linear(F.layer_norm(h, (d,), g2, be2, 1e-6), w1, b1)),
                            w2, b2)
    return run


def phase_kernels(stats: dict) -> None:
    """Kernel vs plain on the card: errors at B = 4 (stage shapes, ragged,
    two heads, M = 177), then errors and times at B = 101 (stage shapes, the
    main path's)."""
    gen = torch.Generator().manual_seed(SEED)
    shapes = [(f"stage{i + 1}", (h, w, d, nh, sr, hid, TEXT))
              for i, (h, w, d, nh, sr, hid) in enumerate(STAGES)]
    traps = [("ragged", RAGGED), ("ragged_heads", RAGGED_HEADS), ("m177", TRAIN_M177),
             ("v2_ragged", V2_RAGGED)]
    for label, shape in shapes + traps:
        check_kernels(stats, gen, label, shape, SMOKE_BATCH)

    for label, shape in shapes:
        p, x, k, v, kw_kv, kw_b = check_kernels(stats, gen, label, shape, BATCH)
        h, w = shape[:2]
        # timed on operands cast once, as a Block caches them
        p = {name: kernel_operand(t, torch.bfloat16) for name, t in p.items()}
        times = {
            "sr_kv": (cuda_time_ms(lambda: fused_ln_sr_kv(x, (h, w), *_kv_args(p), **kw_kv)),
                      cuda_time_ms(lambda: sr_kv_reference(x, (h, w), *_kv_args(p), **kw_kv))),
            "block_fused": (cuda_time_ms(lambda: fused_block(x, k, v, *_block_args(p), **kw_b)),
                            cuda_time_ms(lambda: block_reference(x, k, v, *_block_args(p), **kw_b))),
        }
        bounds = serving_bounds(shape, BATCH)
        extra = {
            "sr_kv": yardsticks(lambda: fused_ln_sr_kv(x, (h, w), *_kv_args(p), **kw_kv),
                                sr_kv_composition(x, (h, w), p, kw_kv["sr"])),
            "block_fused": yardsticks(lambda: fused_block(x, k, v, *_block_args(p), **kw_b),
                                      block_composition(x, k, v, p, kw_b["heads"]))}
        for name, (ms, plain_ms) in times.items():
            bound_ms, bound_by = bounds[name]
            emit("kernel_time", kernel=name, shape=label, batch=BATCH, ms=ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=None, speedup=plain_ms / ms, **extra.get(name, {}))
            add_time(stats, name, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=None)
        del x, k, v, extra
        torch.cuda.empty_cache()


def phase_uint8() -> None:
    u = np.arange(256, dtype=np.uint8)
    got = uint8_to_unit(torch.from_numpy(u).cuda()).cpu().numpy()
    want = u.astype(np.float32) / np.float32(255)
    mismatches = int((got.view(np.uint32) != want.view(np.uint32)).sum())
    emit("uint8_div255", values=256, bit_mismatches=mismatches, ok=mismatches == 0)
    if mismatches:
        raise AssertionError(f"uint8/255 on the card differs from the host in "
                             f"{mismatches} of 256 values")


def seeded_state_dict(model, seed: int) -> dict:
    """Weights made with numpy from a seed, as the JAX package initialises
    them (trunc-normal 0.02 matrices, conv kernels and pos-embeds; v2's
    depthwise convs LeCun normal over their 9 taps, std 1/3; normal 0.02
    embedding tables, zero biases, unit LayerNorm and BatchNorm scales and
    running variances), with a 0.03 normal
    perturbation on every bias and LayerNorm affine so they carry signal.
    The matrices stay unperturbed: perturbing them too shrinks the logits
    until bf16 rounding alone moves them by 4-6% (see SLICE_TOL)."""
    gen = np.random.default_rng(seed)
    out = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if t.dim() == 1:
            base = (np.ones(shape) if name.endswith(("weight", "running_var"))
                    else np.zeros(shape))
            base = base + 0.03 * gen.standard_normal(shape)
        elif "text_embeddings." in name:
            base = 0.02 * gen.standard_normal(shape)
        elif name.endswith("dwconv.dwconv.weight"):
            base = 9 ** -0.5 / 0.87962566103423978 * np.clip(gen.standard_normal(shape), -2, 2)
        else:
            base = 0.02 * np.clip(gen.standard_normal(shape), -2.0, 2.0)
        out[name] = torch.from_numpy(base.astype(np.float32))
    return out


CAPTIONS = ["a red cotton t-shirt with a round neck and short sleeves",
            "slim-fit black denim jeans with a five-pocket styling",
            "white leather sneakers with a rubber sole and lace-up front",
            "a navy wool coat with notched lapels and a button closure",
            "gold-tone hoop earrings", "a floral silk midi dress"]


def synthetic_bundles(n: int, seed: int, size: int, text_len: int) -> list:
    """101-candidate bundles with FashionGenRetrieval's item schema: uint8
    NHWC images from the seed, token ids from the shipped WordPiece vocab."""
    tok = WordPieceTokenizer(str(pathlib.Path(__file__).resolve().parent
                                 / "preweights" / "bert-base-uncased-vocab.txt"))
    captions = CAPTIONS
    gen = np.random.default_rng(seed)
    bundles = []
    for q in range(n):
        caps = [captions[(q + j) % len(captions)] for j in range(BATCH)]
        bundles.append({
            "images_101": gen.integers(0, 256, (BATCH, size, size, 3), dtype=np.uint8),
            "ori_input_ids_101": np.asarray([tok.encode(c, text_len) for c in caps],
                                            np.int32),
            "info_list": [{"img_name": f"synthetic_{q}_{j}.jpg", "prod_caption": c}
                          for j, c in enumerate(caps)],
        })
    return bundles


def phase_slice(stats: dict, model_name: str = "pvlt_tiny", path: dict = SERVING_WRAPPERS,
                phase: str = "slice", size: int = 256, per_forward: dict | None = None,
                n_bundles: int = 3, record: bool = True):
    """``model_name``, built for and run at ``size``, scores ``n_bundles``
    bundles through the serving entry points, launching each kernel of
    ``path`` ``per_forward[name]`` times a forward (default once per block)
    and no other kernel; with ``record`` ``stats`` keeps this run's
    launches. Returns the model, the bundles and the weights."""
    cfg = ModelConfig(name=model_name, compute_dtype="bfloat16",
                      loss_type=LossType(itm=True, mlm=False, t2i=False, cls=False))
    model = create_model(cfg, device="cuda", input_size=size).eval()
    sd = seeded_state_dict(model, SEED)
    model.load_state_dict(sd, strict=True)
    bundles = synthetic_bundles(n_bundles, SEED + 1, size, cfg.num_text_tokens)
    blocks = sum(model.cfg.depths)
    per_forward = per_forward or dict.fromkeys(path, blocks)

    scorer = make_itm_scorer(model)
    scores = []

    def recording(images, ids):
        s = scorer(images, ids)
        scores.append(s)
        return s

    # only this path's launches count: not those of the kernel checks
    reset_launches()
    start = time.perf_counter()
    results = evaluate_retrieval(recording, bundles, is_main=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = read_launches()
    forwards = len(scores)
    s = torch.cat(scores).float().cpu()
    finite = bool(torch.isfinite(s).all())
    in_range = bool(((s > 0) & (s < 1)).all())
    emit(phase, model=cfg.name, compute_dtype=cfg.compute_dtype, input=size,
         text_tokens=cfg.num_text_tokens, bundles=len(bundles), forwards=forwards,
         pairs=int(s.numel()), seconds_host_inclusive=seconds, results=results,
         score_min=float(s.min()), score_max=float(s.max()), launches=launches,
         launches_expected={name: n * forwards for name, n in per_forward.items()},
         finite=finite, in_unit_interval=in_range)
    if results["num_queries"] != len(bundles) or s.numel() != BATCH * len(bundles):
        raise AssertionError(f"scored {s.numel()} pairs in {results['num_queries']} queries")
    if not (finite and in_range):
        raise AssertionError("ITM scores not all finite and inside (0, 1)")
    if any(launches[name] for name in WRAPPERS if name not in per_forward):
        raise AssertionError(f"{cfg.name} serving launched a kernel of another path: {launches}")
    for name, n in per_forward.items():
        count = launches[name]
        if record:
            stats[name]["launches"] = count
        if count != n * forwards:
            raise AssertionError(f"{name} launched {count} times in {forwards} "
                                 f"forwards, expected {n} per forward")
    return model, bundles, sd


def check_blocks(model, bundle) -> None:
    """Every block of one B = 101 forward against the kernels' plain versions
    on the block's own input and parameters, within KERNEL_TOL: the kernels
    at the main path's shapes and operands, with no bf16 drift carried from
    block to block."""
    seen = []
    hooks = [blk.register_forward_hook(lambda m, args, out: seen.append((m, args[0], args[1], out)))
             for blk in model.modules() if isinstance(blk, Block)]
    try:
        with torch.no_grad():
            model(uint8_to_unit(torch.from_numpy(bundle["images_101"]).cuda()),
                  torch.from_numpy(bundle["ori_input_ids_101"]).long().cuda())
    finally:
        for h in hooks:
            h.remove()
    errs = {"kv": [], "out": []}
    for blk, x, hw, out in seen:
        kv_kw, block_kw = blk.kernel_kwargs()
        kv_params, block_params = blk.kernel_params()
        with torch.no_grad():
            k_ref, v_ref = sr_kv_reference(x, hw, *kv_params, **kv_kw)
            want = block_reference(x, k_ref, v_ref, *block_params, **block_kw)
            # kernel A again on the block's input and cached operands, as the
            # forward ran it: K/V compared element by element, which sees a
            # layout or row fault that near-uniform attention would average out
            k, v = fused_ln_sr_kv(x, hw, *blk.kernel_operands(x.dtype)[0], **kv_kw)
        errs["kv"].append(max(_rel_err(k, k_ref)[1], _rel_err(v, v_ref)[1]))
        errs["out"].append(_rel_err(out, want)[1])
    worst = max(errs["kv"] + errs["out"])
    ok = len(errs["out"]) == sum(model.cfg.depths) and worst <= KERNEL_TOL
    emit("slice_blocks_vs_plain", batch=BATCH, blocks=len(errs["out"]),
         rel_err_kv=errs["kv"], rel_err_out=errs["out"], tol=KERNEL_TOL, ok=ok)
    if not ok:
        raise AssertionError(f"a block of the main path disagrees with its plain "
                             f"version: rel errs {errs} (tol {KERNEL_TOL})")


def itm_outputs(model, images, ids) -> tuple:
    """(ITM logits, the ITM head's input rows: the CLS row after its
    adapter), fp32 on the host, of one no-grad forward."""
    feats = []
    hook = model.itm_head.register_forward_pre_hook(lambda m, args: feats.append(args[0]))
    try:
        with torch.no_grad():
            logits = model(images, ids)["itm_logits"]
    finally:
        hook.remove()
    return logits.float().cpu(), feats[0].float().cpu()


def compare_cpu_fp32(model, bundle, sd, phase: str = "slice_vs_cpu_fp32", rows: int = 2,
                     hold: str = "logits") -> float:
    """ITM logits of ``rows`` pairs, and the ITM head's input rows, against
    the same weights in fp32 on the CPU (plain path), beside the plain
    path's own bf16 errors on the CPU; each error max |diff| / max |fp32|.
    ``hold`` names the one held to SLICE_TOL: the logits, or (``features``)
    the head's input, where the logits are too small for a bound relative to
    them (near zero by cancellation, bf16 rounding alone moves them by more)."""
    cfg = model.cfg
    images = uint8_to_unit(torch.from_numpy(bundle["images_101"][:rows]))
    ids = torch.from_numpy(bundle["ori_input_ids_101"][:rows]).long()
    cpu = {}
    for dtype in ("float32", "bfloat16"):
        ref = create_model(dataclasses.replace(cfg, compute_dtype=dtype), device="cpu",
                           input_size=model.input_size).eval()
        ref.load_state_dict(sd, strict=True)
        cpu[dtype] = itm_outputs(ref, images, ids)
    card = itm_outputs(model, images.cuda(), ids.cuda())

    def rel(got, want):
        return (got - want).abs().max().item() / want.abs().max().item()

    errs = {k: rel(card[i], cpu["float32"][i]) for i, k in enumerate(("logits", "features"))}
    ok = bool(errs[hold] <= SLICE_TOL)
    emit(phase, model=cfg.name, pairs=rows, logits_card=card[0].flatten().tolist(),
         logits_cpu=cpu["float32"][0].flatten().tolist(),
         max_abs_diff=(card[0] - cpu["float32"][0]).abs().max().item(), rel_err=errs["logits"],
         rel_err_features=errs["features"],
         rel_err_cpu_bf16_plain=rel(cpu["bfloat16"][0], cpu["float32"][0]),
         rel_err_features_cpu_bf16_plain=rel(cpu["bfloat16"][1], cpu["float32"][1]),
         held=hold, tol=SLICE_TOL, ok=ok)
    if not ok:
        raise AssertionError(f"ITM {hold} on the card differ from the CPU fp32 "
                             f"model by {errs[hold]:.3e} > {SLICE_TOL}")
    return errs["logits"]


def phase_throughput(model, bundles, groups: dict, prefix: str = "") -> None:
    """Scorer pairs/s at B = 101 on pre-staged device tensors (H2D excluded),
    and the device profile of three calls by kernel ``groups``."""
    scorer = make_itm_scorer(model)
    staged = [(torch.from_numpy(b["images_101"]).cuda(),
               torch.from_numpy(b["ori_input_ids_101"]).long().cuda()) for b in bundles]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    calls = iter(range(10 ** 9))
    ms = cuda_time_ms(lambda: scorer(*staged[next(calls) % len(staged)]), warmup=3, reps=15)
    emit(prefix + "throughput", model=model.cfg.name, batch=BATCH, ms_per_batch=ms,
         pairs_per_s=BATCH / (ms / 1e3), peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         method="CUDA events around each scorer call, 3 warm-up, median of 15, "
                "3 distinct pre-staged uint8 bundles")

    # where the device time goes: kernel time by name over 3 scorer calls
    profile_device(lambda: [scorer(images, ids) for images, ids in staged], len(staged),
                   groups, prefix + "profile")


def profile_device(run, calls: int, groups: dict, phase: str) -> None:
    """torch.profiler over ``run`` (``calls`` calls): device kernel time
    summed by name and by group (a group's kernels matched by name
    fragments), against the host wall time; idle share = 1 - device / wall."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    by_name: dict = {}
    for evt in prof.key_averages():
        if is_kernel(evt) and evt.self_device_time_total > 0:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + evt.self_device_time_total / 1e3
    device_ms = sum(by_name.values())
    by_group = dict.fromkeys(list(groups) + ["other"], 0.0)
    for name, t in by_name.items():
        key = next((g for g, frags in groups.items() if any(f in name for f in frags)), "other")
        by_group[key] += t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    emit(phase, calls=calls, wall_ms=wall_ms,
         device_ms=device_ms if device_ms else "not measured",
         device_idle_share=(1 - device_ms / wall_ms) if device_ms else "not measured",
         ms_by_group=by_group, top_kernels=[[n[:80], t] for n, t in top])


# ---- PVT-v2 serving -------------------------------------------------------

def v2_stage_params(gen, d: int, sr: int, hidden: int, device) -> dict:
    """stage_params plus the depthwise conv: taps of std 1 / sqrt(9) (its
    fan-in, gain 1), bias std 0.1 (at 0.05 a dropped conv bias would move
    the output by only ~1.5x the bound)."""
    p = stage_params(gen, d, sr, hidden, device)
    p["dw_weight"] = (9 ** -0.5 * torch.randn(hidden, 1, 3, 3, generator=gen)).to(device)
    p["dw_bias"] = (0.1 * torch.randn(hidden, generator=gen)).to(device)
    return p


def _c_args(p):
    return (p["ln1_weight"], p["ln1_bias"], p["wq"], p["bq"], p["wp"], p["bp"])


def _d_args(p):
    return (p["ln2_weight"], p["ln2_bias"], p["w1"], p["b1"], p["dw_weight"], p["dw_bias"],
            p["w2"], p["b2"])


def v2_bounds(shape: tuple, batch: int) -> dict:
    """(ms, bound_by) of kernels C and D at one stage shape. C: the Q,
    logits, P.V and out-proj products, 4.N.D^2 + 4.N.M.D flops per sample;
    the stream read and written, K/V read, Wq and Wp read. D: fc1 and fc2,
    4.N.D.hidden, and the conv, 18.h.w.hidden; the stream read and written,
    the bf16 weights read."""
    h, w, d, _, sr, hid, t = shape
    n = h * w + t
    m = (h // sr) * (w // sr) + t if sr > 1 else n
    flops_c = batch * (4 * n * d * d + 4 * n * m * d)
    bytes_c = 2 * (2 * batch * n * d + 2 * batch * m * d + 2 * d * d)
    flops_d = batch * (4 * n * d * hid + 18 * h * w * hid)
    bytes_d = 2 * (2 * batch * n * d + 2 * d * hid + 9 * hid)
    return {"block_attention": bound(flops_c, bytes_c), "dwconv_mlp": bound(flops_d, bytes_d)}


def dwconv_mlp_composition(x, hw: tuple, p: dict):
    """Kernel D's function as PyTorch calls in bf16: F.layer_norm, F.linear
    (cuBLAS), the depthwise F.conv2d (cuDNN) on the visual rows, the erf
    F.gelu, F.linear and the residual; a yardstick, never a path the port
    calls."""
    g, be, w1, b1, wdw, bdw, w2, b2 = (t.to(torch.bfloat16) for t in _d_args(p))
    (h, w), d = hw, x.shape[-1]

    def run():
        hid = F.linear(F.layer_norm(x, (d,), g, be, 1e-6), w1, b1)
        b, _, c = hid.shape
        grid = hid[:, : h * w].transpose(1, 2).reshape(b, c, h, w)
        vis = F.conv2d(grid, wdw, bdw, padding=1, groups=c).flatten(2).transpose(1, 2)
        return x + F.linear(F.gelu(torch.cat([vis, hid[:, h * w:]], dim=1)), w2, b2)
    return run


def check_v2_kernels(stats: dict, gen, label: str, shape: tuple, batch: int):
    """Kernels C and D against their plain versions on one shape's seeded
    inputs (C on the plain K/V); raises past KERNEL_TOL. Returns the inputs
    and the plain K/V, for timing."""
    h, w, d, nh, sr, hid, t = shape
    p = v2_stage_params(gen, d, sr, hid, torch.device("cuda"))
    x = torch.randn(batch, h * w + t, d, generator=gen).to("cuda", torch.bfloat16)
    k, v = sr_kv_reference(x, (h, w), *_kv_args(p), sr=sr, heads=nh, eps1=1e-6, eps_sr=1e-5)
    kw_c, kw_d = dict(heads=nh, eps=1e-6), dict(eps=1e-6)
    errs = {"block_attention": _rel_err(fused_block_attention(x, k, v, *_c_args(p), **kw_c),
                                        block_attention_reference(x, k, v, *_c_args(p), **kw_c)),
            "dwconv_mlp": _rel_err(fused_dwconv_mlp(x, (h, w), *_d_args(p), **kw_d),
                                   dwconv_mlp_reference(x, (h, w), *_d_args(p), **kw_d))}
    torch.cuda.synchronize()
    for name, (abs_err, rel) in errs.items():
        ok = bool(rel <= KERNEL_TOL and np.isfinite(rel))
        emit("kernel_check", kernel=name, shape=label, batch=batch, n=h * w + t, hw=[h, w],
             dim=d, heads=nh, m=k.shape[2], hidden=hid, max_abs_err=abs_err, rel_err=rel,
             tol=KERNEL_TOL, ok=ok)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version at "
                                 f"{label}, B = {batch}: rel err {rel:.3e} > {KERNEL_TOL}")
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], abs_err)
    return p, x, k, v, kw_c, kw_d


def phase_v2_kernels(stats: dict) -> None:
    """Kernels C and D vs plain on the card: errors at B = 4 (the
    pvlt_v2_tiny stage shapes + ragged), then errors and times at B = 101."""
    gen = torch.Generator().manual_seed(SEED + 5)
    shapes = [(f"v2_stage{i + 1}", (h, w, d, nh, sr, hid, TEXT))
              for i, (h, w, d, nh, sr, hid) in enumerate(STAGES)]
    for label, shape in shapes + [("v2_ragged", V2_RAGGED)]:
        check_v2_kernels(stats, gen, label, shape, SMOKE_BATCH)
    for label, shape in shapes:
        p, x, k, v, kw_c, kw_d = check_v2_kernels(stats, gen, label, shape, BATCH)
        hw = shape[:2]
        p = {name: kernel_operand(t, torch.bfloat16) for name, t in p.items()}
        times = {
            "block_attention": (
                cuda_time_ms(lambda: fused_block_attention(x, k, v, *_c_args(p), **kw_c)),
                cuda_time_ms(lambda: block_attention_reference(x, k, v, *_c_args(p), **kw_c))),
            "dwconv_mlp": (cuda_time_ms(lambda: fused_dwconv_mlp(x, hw, *_d_args(p), **kw_d)),
                           cuda_time_ms(lambda: dwconv_mlp_reference(x, hw, *_d_args(p), **kw_d))),
        }
        bounds = v2_bounds(shape, BATCH)
        extra = {
            "block_attention": yardsticks(
                lambda: fused_block_attention(x, k, v, *_c_args(p), **kw_c),
                attention_half_composition(x, k, v, p, kw_c["heads"])),
            "dwconv_mlp": yardsticks(lambda: fused_dwconv_mlp(x, hw, *_d_args(p), **kw_d),
                                     dwconv_mlp_composition(x, hw, p))}
        for name, (ms, plain_ms) in times.items():
            bound_ms, bound_by = bounds[name]
            emit("kernel_time", kernel=name, shape=label, batch=BATCH, ms=ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=None, speedup=plain_ms / ms, **extra.get(name, {}))
            add_time(stats, name, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=None)
        del x, k, v, extra
        torch.cuda.empty_cache()


def check_v2_blocks(model, bundle, phase: str = "v2_slice_blocks_vs_plain") -> None:
    """Every block of one B = 101 pvlt_v2_tiny forward against the plain
    versions on the block's own input and parameters, within KERNEL_TOL:
    K/V element by element and the attention half (kernels A and C run
    again on the block's input and cached operands, as the forward ran
    them), and the block's output. A linear-SR block (pvlt_v2_linear_tiny,
    stages 1-3) has no kernel A: its K/V come from Block.linear_sr_kv on the
    cast operands against the same glue on the fp32 parameters, with
    LINEAR_M rows."""
    seen = []
    hooks = [blk.register_forward_hook(lambda m, args, out: seen.append((m, args[0], args[1], out)))
             for blk in model.modules() if isinstance(blk, Block)]
    try:
        with torch.no_grad():
            model(uint8_to_unit(torch.from_numpy(bundle["images_101"]).cuda()),
                  torch.from_numpy(bundle["ori_input_ids_101"]).long().cuda())
    finally:
        for h in hooks:
            h.remove()
    errs = {"kv": [], "attn": [], "out": [], "kv_rows": []}
    for blk, x, hw, out in seen:
        (kv_p, attn_p, mlp_p), (kv_kw, attn_kw, mlp_kw) = blk.kernel_params(), blk.kernel_kwargs()
        kv_ops, attn_ops, _ = blk.kernel_operands(x.dtype)
        linear_sr = blk.attn.linear_sr
        with torch.no_grad():
            if linear_sr:
                k_ref, v_ref = blk.linear_sr_kv(x, hw, *kv_p)
                k, v = blk.linear_sr_kv(x, hw, *kv_ops)
            else:
                k_ref, v_ref = sr_kv_reference(x, hw, *kv_p, **kv_kw)
                k, v = fused_ln_sr_kv(x, hw, *kv_ops, **kv_kw)
            attn_ref = block_attention_reference(x, k_ref, v_ref, *attn_p, **attn_kw)
            want = dwconv_mlp_reference(attn_ref, hw, *mlp_p, **mlp_kw)
            attn = fused_block_attention(x, k, v, *attn_ops, **attn_kw)
        if linear_sr and k.shape[2] != LINEAR_M[hw[0]]:
            raise AssertionError(f"linear SR at a {hw} grid gave {k.shape[2]} K/V rows, "
                                 f"expected {LINEAR_M[hw[0]]}")
        errs["kv_rows"].append(k.shape[2])
        errs["kv"].append(max(_rel_err(k, k_ref)[1], _rel_err(v, v_ref)[1]))
        errs["attn"].append(_rel_err(attn, attn_ref)[1])
        errs["out"].append(_rel_err(out, want)[1])
    worst = max(errs["kv"] + errs["attn"] + errs["out"])
    ok = len(errs["out"]) == sum(model.cfg.depths) and worst <= KERNEL_TOL
    emit(phase, model=model.cfg.name, batch=BATCH, blocks=len(errs["out"]),
         kv_rows=errs["kv_rows"], rel_err_kv=errs["kv"], rel_err_attn=errs["attn"],
         rel_err_out=errs["out"], tol=KERNEL_TOL, ok=ok)
    if not ok:
        raise AssertionError(f"a block of the v2 path disagrees with its plain "
                             f"version: rel errs {errs} (tol {KERNEL_TOL})")


# ---- Swin serving ----------------------------------------------------------

# pvlt_swin_tiny at 224x224, stages 2-4 (the window path, kernel F): per
# stage (h, w, dim, heads); windows of 8 (stage 4: 7), head dim 64
SWIN224_F_STAGES = [(28, 28, 128, 2), (14, 14, 320, 5), (7, 7, 512, 8)]
# kernel E off the stage shapes: h != w, pool window 2, head dim 32, T = 7
SWIN_E_RAGGED = (16, 24, 96, 3, 384, 7)
# kernel F off them: a 10x6 grid padded to 12x8 (6 windows of 4x4), head dim 32
SWIN_F_RAGGED = (10, 6, 96, 3, 4, 7)


def swin_block_params(gen, d: int, heads: int, hidden: int, ws: int, device) -> tuple:
    """stage_params' block weights in fused_swin_block's order, the kv weight
    [2C, C] of gain 1.5, and the relative-position table at std 0.5: at the
    init's 0.02 a transposed (dy, dx) index would move the output by less
    than the bound."""
    p = stage_params(gen, d, 1, hidden, device)
    rel = (0.5 * torch.randn((2 * ws - 1) ** 2, heads, generator=gen)).to(device)
    return (rel, p["ln1_weight"], p["ln1_bias"], p["wq"], p["bq"], p["kv_weight"],
            p["kv_bias"], p["wp"], p["bp"], p["ln2_weight"], p["ln2_bias"], p["w1"], p["b1"],
            p["w2"], p["b2"])


def swin_e_bound(shape: tuple, batch: int) -> tuple[float, str]:
    """Kernel E at one stage shape: q, K, V and out-projection products
    (8.C^2 a row), logits and P.V (4.(ws^2 + T).C a row), fc1 and fc2
    (4.C.hidden a row); bytes: the stream read and written, text K/V read,
    the pooled rows written, the bf16 weights and the bias table read."""
    h, w, d, nh, hid, t, ws, pool = shape
    n = h * w
    flops = 2 * batch * n * (4 * d * d + 2 * (ws * ws + t) * d + 2 * d * hid)
    nbytes = (2 * (2 * batch * n * d + 2 * batch * t * d + batch * (n // pool ** 2) * d
                   + 4 * d * d + 2 * d * hid) + 4 * (2 * ws - 1) ** 2 * nh)
    return bound(flops, nbytes)


def swin_f_bound(nw: int, nh: int, ws2: int, t: int, hd: int, batch: int) -> tuple[float, str]:
    """Kernel F: q.K^T and P.V, 4.ws^2.(ws^2 + T).hd flops per (window,
    head); q, K, V read and the output written once, the text K/V once per
    sample, the fp32 table once."""
    flops = 4 * batch * nw * nh * ws2 * (ws2 + t) * hd
    nbytes = (2 * (4 * batch * nw * nh * ws2 * hd + 2 * batch * nh * t * hd)
              + 4 * nw * nh * ws2 * (ws2 + t))
    return bound(flops, nbytes)


def check_swin_block_kernel(stats, gen, label, shape, shift, batch):
    """Kernel E against its plain version on seeded inputs (the output and
    the pooled rows); raises past KERNEL_TOL. Returns its arguments."""
    h, w, d, nh, hid, t, ws, pool = shape
    dev = torch.device("cuda")
    x = torch.randn(batch, h * w, d, generator=gen).to(dev, torch.bfloat16)
    kt, vt = (torch.randn(batch, t, d, generator=gen).to(dev, torch.bfloat16) for _ in range(2))
    args = (x, kt, vt, *swin_block_params(gen, d, nh, hid, ws, dev))
    kw = dict(hw=(h, w), heads=nh, window=ws, shift=ws // 2 if shift else 0, pool=pool,
              eps1=1e-6, eps2=1e-6)
    out, pooled = fused_swin_block(*args, **kw, table=swin_table(args, kw))
    want_out, want_pooled = swin_block_reference(*args, **kw)
    torch.cuda.synchronize()
    errs = {"out": _rel_err(out, want_out), "pooled": _rel_err(pooled, want_pooled)}
    worst = max(e[1] for e in errs.values())
    ok = bool(worst <= KERNEL_TOL and np.isfinite(worst))
    emit("kernel_check", kernel="swin_block", shape=label, batch=batch, hw=[h, w], dim=d,
         heads=nh, hidden=hid, text=t, window=ws, shift=kw["shift"], pool=pool,
         rel_err={k: e[1] for k, e in errs.items()}, tol=KERNEL_TOL, ok=ok)
    if not ok:
        raise AssertionError(f"swin_block disagrees with its plain version at {label}, "
                             f"B = {batch}: {errs} (tol {KERNEL_TOL})")
    stats["swin_block"]["max_abs_err"] = max(stats["swin_block"]["max_abs_err"],
                                             max(e[0] for e in errs.values()))
    return args, kw


def swin_attention_inputs(gen, shape: tuple, shift: bool, batch: int) -> tuple:
    """Kernel F's inputs as the window path makes them on a grid: q, K and V
    rows of [B, h*w, C] cut into (padded, shifted) windows, text K/V, and the
    grid's table from a relative-position table of std 0.5."""
    h, w, d, nh, ws, t = shape
    dev = torch.device("cuda")
    s = ws // 2 if shift else 0
    win = lambda: heads_of(window_partition(
        torch.randn(batch, h * w, d, generator=gen).to(dev, torch.bfloat16), (h, w), ws, s),
        nh).contiguous()
    txt = lambda: torch.randn(batch, nh, t, d // nh, generator=gen).to(dev, torch.bfloat16)
    rel = (0.5 * torch.randn((2 * ws - 1) ** 2, nh, generator=gen)).to(dev)
    index = torch.from_numpy(relative_position_index(ws)).to(dev)
    mask = torch.from_numpy(window_masks(h, w, ws, s)).to(dev)
    return (win(), win(), win(), txt(), txt(), add_table(rel, index, mask, t)), (d // nh) ** -0.5


def check_swin_attention_kernel(stats, gen, label, shape, shift, batch):
    """Kernel F against its plain version; raises past KERNEL_TOL."""
    args, scale = swin_attention_inputs(gen, shape, shift, batch)
    got = fused_swin_attention(*args, scale=scale)
    want = swin_attention_reference(*args, scale=scale)
    torch.cuda.synchronize()
    abs_err, rel = _rel_err(got, want)
    ok = bool(rel <= KERNEL_TOL and np.isfinite(rel))
    b, nw, nh, ws2, hd = args[0].shape
    emit("kernel_check", kernel="swin_attention", shape=label, batch=batch, windows=nw,
         heads=nh, ws2=ws2, text=args[3].shape[2], head_dim=hd, shift=shift,
         max_abs_err=abs_err, rel_err=rel, tol=KERNEL_TOL, ok=ok)
    if not ok:
        raise AssertionError(f"swin_attention disagrees with its plain version at {label}, "
                             f"B = {batch}: rel err {rel:.3e} > {KERNEL_TOL}")
    stats["swin_attention"]["max_abs_err"] = max(stats["swin_attention"]["max_abs_err"],
                                                 abs_err)
    return args, scale


def sdpa_window(args: tuple, scale: float):
    """A call of F.scaled_dot_product_attention on [B.nW, heads, ws^2, hd]
    queries against the window's K/V concatenated with the text K/V, the
    table as a float attn_mask (a yardstick the port never calls)."""
    q, k, v, kt, vt, table = args
    b, nw, nh, ws2, hd = q.shape
    cat = lambda win, txt: torch.cat([win, txt[:, None].expand(b, nw, *txt.shape[1:])],
                                     dim=-2).reshape(b * nw, nh, -1, hd)
    qq, kk, vv = q.reshape(b * nw, nh, ws2, hd), cat(k, kt), cat(v, vt)
    mask = table[None].expand(b, *table.shape).reshape(b * nw, nh, ws2, -1).to(q.dtype)
    return lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask, scale=scale)


def swin_table(args: tuple, kw: dict) -> torch.Tensor:
    """Kernel E's additive table for its arguments (models/swin.py:add_table),
    made once as a SwinBlock caches it beside its operands
    (models/pvlt.py:CastOperands.kernel_table)."""
    dev, ws = args[3].device, kw["window"]
    index = torch.from_numpy(relative_position_index(ws)).to(dev)
    mask = torch.from_numpy(window_masks(*kw["hw"], ws, kw["shift"])).to(dev)
    return add_table(args[3], index, mask, args[1].shape[1]).contiguous()


def swin_block_composition(args: tuple, kw: dict):
    """Kernel E's function as the window path's own PyTorch ops in bf16:
    F.layer_norm, F.linear (cuBLAS), window_partition (roll and partition
    copies), F.scaled_dot_product_attention over [window K/V | text K/V]
    with the additive table as a float mask, window_reverse, the projection
    and residual, the MLP (F.linear, erf F.gelu) and the pooled LN1 rows
    (F.avg_pool2d); a yardstick, never a path the port calls."""
    bf = torch.bfloat16
    x, kt, vt, rel = args[:4]
    g1, be1, wq, bq, wkv, bkv, wp, bp, g2, be2, w1, b1, w2, b2 = (t.to(bf) for t in args[4:])
    (h, w), ws, s, nh, pool = kw["hw"], kw["window"], kw["shift"], kw["heads"], kw["pool"]
    b, _, c = x.shape
    t, hd, nw = kt.shape[1], c // nh, (h // ws) * (w // ws)
    mask = swin_table(args, kw).to(bf)
    mask = mask[None].expand(b, *mask.shape).reshape(b * nw, nh, ws * ws, -1)

    def run():
        ln = F.layer_norm(x, (c,), g1, be1, kw["eps1"])
        q, kv = F.linear(ln, wq, bq), F.linear(ln, wkv, bkv)
        def win(z, txt):   # window rows then the text rows, [B.nW, heads, ws^2 + T, hd]
            return torch.cat([heads_of(window_partition(z, (h, w), ws, s), nh),
                              heads_of(txt, nh)[:, None].expand(b, nw, nh, t, hd)],
                             dim=-2).reshape(b * nw, nh, -1, hd)
        qw = heads_of(window_partition(q, (h, w), ws, s), nh).reshape(b * nw, nh, ws * ws, hd)
        o = F.scaled_dot_product_attention(qw, win(kv[..., :c], kt), win(kv[..., c:], vt),
                                           attn_mask=mask, scale=hd ** -0.5)
        attn = window_reverse(o.reshape(b, nw, nh, ws * ws, hd).movedim(2, -2).flatten(-2),
                              (h, w), ws, s)
        res = x + F.linear(attn, wp, bp)
        hid = F.gelu(F.linear(F.layer_norm(res, (c,), g2, be2, kw["eps2"]), w1, b1))
        pooled = F.avg_pool2d(ln.transpose(1, 2).reshape(b, c, h, w), pool)
        return res + F.linear(hid, w2, b2), pooled.flatten(2).transpose(1, 2)
    return run


def swin_kernel_shapes() -> tuple[list, list]:
    """(kernel E's shapes, kernel F's shapes) as (label, shape) pairs, the
    stage shapes first and a ragged one last: E at the four pvlt_swin_tiny
    stages at 256 (h, w, dim, heads, hidden, T, window, pool); F at the three
    window-path stages at 224 (grids 28 and 14 padded to 32 and 16, 7x7
    windows at stage 4) as (h, w, dim, heads, window, T)."""
    e_shapes = [(f"swin_stage{i + 1}", (h, w, d, nh, hid, TEXT, 8, max(1, h // 8)))
                for i, (h, w, d, nh, _, hid) in enumerate(STAGES)]
    h, w, d, nh, hid, t = SWIN_E_RAGGED
    f_shapes = [(f"swin224_stage{i + 2}", (h_, w_, d_, nh_, min(8, h_), TEXT))
                for i, (h_, w_, d_, nh_) in enumerate(SWIN224_F_STAGES)]
    return (e_shapes + [("swin_ragged", (h, w, d, nh, hid, t, 8, h // 8))],
            f_shapes + [("swin_window_ragged", SWIN_F_RAGGED)])


def check_swin_kernels(stats: dict, gen, batch: int) -> None:
    """Kernels E and F against their plain versions at every shape of
    ``swin_kernel_shapes``, unshifted and shifted."""
    e_shapes, f_shapes = swin_kernel_shapes()
    for shift in (False, True):
        for label, shape in e_shapes:
            check_swin_block_kernel(stats, gen, label, shape, shift, batch)
        for label, shape in f_shapes:
            check_swin_attention_kernel(stats, gen, label, shape, shift, batch)


def phase_swin_kernels(stats: dict) -> None:
    """Kernels E and F against their plain versions at B = 4 at every shape
    of ``swin_kernel_shapes``, unshifted and shifted; then the stage shapes
    at B = 101, where each kernel is timed beside its plain version, its
    bound and, for F, SDPA. Times summed over the unshifted stage shapes."""
    gen = torch.Generator().manual_seed(SEED + 13)
    check_swin_kernels(stats, gen, SMOKE_BATCH)
    e_shapes, f_shapes = (shapes[:-1] for shapes in swin_kernel_shapes())
    for shift in (False, True):
        for label, shape in e_shapes:
            args, kw = check_swin_block_kernel(stats, gen, label, shape, shift, BATCH)
            ops = tuple(kernel_operand(t, torch.bfloat16) if i > 3 else t
                        for i, t in enumerate(args))
            table = swin_table(ops, kw)
            kernel = lambda: fused_swin_block(*ops, **kw, table=table)
            composition = swin_block_composition(ops, kw)
            ms = cuda_time_ms(kernel)
            plain_ms = cuda_time_ms(lambda: swin_block_reference(*ops, **kw))
            bound_ms, bound_by = swin_e_bound(shape, BATCH)
            emit("kernel_time", kernel="swin_block", shape=label, shift=kw["shift"], batch=BATCH,
                 ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=None, speedup=plain_ms / ms, device_ms=device_time_ms(kernel),
                 composition_ms=cuda_time_ms(composition),
                 composition_device_ms=device_time_ms(composition))
            if not shift:
                add_time(stats, "swin_block", ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None)
            del args, ops, kernel, composition, table
        for label, shape in f_shapes:
            args, scale = check_swin_attention_kernel(stats, gen, label, shape, shift, BATCH)
            kernel = lambda: fused_swin_attention(*args, scale=scale)
            sdpa = sdpa_window(args, scale)
            ms, library_ms = cuda_time_ms(kernel), cuda_time_ms(sdpa)
            plain_ms = cuda_time_ms(lambda: swin_attention_reference(*args, scale=scale))
            bound_ms, bound_by = swin_f_bound(*args[0].shape[1:4], args[3].shape[2],
                                              args[0].shape[4], BATCH)
            emit("kernel_time", kernel="swin_attention", shape=label, shift=shift, batch=BATCH,
                 ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=library_ms, speedup=plain_ms / ms,
                 device_ms=device_time_ms(kernel), library_device_ms=device_time_ms(sdpa))
            if not shift:
                add_time(stats, "swin_attention", ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms)
            del args, kernel, sdpa
        torch.cuda.empty_cache()


def _ln_mlp_plain(x, gamma, beta, w1, b1, w2, b2, row_scale, eps):
    """fused_ln_mlp's signature over the plain forward (no DropPath)."""
    ones = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    return ln_mlp_reference(x, gamma, beta, w1, b1, w2, b2, ones, eps)


def check_swin_blocks(model, bundle, phase: str) -> None:
    """Every Swin block of one B = 101 forward against the plain versions on
    the block's own input and parameters, within KERNEL_TOL: a block on
    kernel E's route (both streams' outputs, and the pooled LN1 rows of
    kernel E run again on the block's input), or on the window route (its
    output, kernel F and the LN-MLP replaced by their plain versions)."""
    seen = []
    hooks = [blk.register_forward_hook(lambda m, args, out: seen.append((m, args[0], args[1], out)))
             for blk in model.modules() if isinstance(blk, SwinBlock)]
    try:
        with torch.no_grad():
            model(uint8_to_unit(torch.from_numpy(bundle["images_101"]).cuda()),
                  torch.from_numpy(bundle["ori_input_ids_101"]).long().cuda())
    finally:
        for h in hooks:
            h.remove()
    errs = {"route": [], "out": [], "pooled": []}
    for blk, x, hw, out in seen:
        with torch.no_grad():
            if isinstance(x, tuple):
                want = blk.band_forward(*x, hw, block=lambda *a, table, **k:
                                        swin_block_reference(*a, **k))
                _, k_t, v_t = blk.text_qkv(x[1])
                args = (x[0], k_t, v_t, blk.attn.relative_position_bias_table,
                        *blk.kernel_operands(x[0].dtype)[0])
                pooled = fused_swin_block(*args, **blk.kernel_kwargs(hw),
                                          table=blk.attn.add_table(hw, k_t.shape[1]))[1]
                pooled_ref = swin_block_reference(*args, **blk.kernel_kwargs(hw))[1]
                errs["route"].append("E")
                errs["out"].append(max(_rel_err(out[0], want[0])[1], _rel_err(out[1], want[1])[1]))
                errs["pooled"].append(_rel_err(pooled, pooled_ref)[1])
            else:
                want = blk.window_forward(x, hw, attention=swin_attention_reference,
                                          ln_mlp=_ln_mlp_plain)
                errs["route"].append("F")
                errs["out"].append(_rel_err(out, want)[1])
    worst = max(errs["out"] + errs["pooled"])
    ok = len(errs["out"]) == sum(model.cfg.depths) and worst <= KERNEL_TOL
    emit(phase, batch=BATCH, input=model.input_size, blocks=len(errs["out"]),
         route=errs["route"], rel_err_out=errs["out"], rel_err_pooled=errs["pooled"],
         tol=KERNEL_TOL, ok=ok)
    if not ok:
        raise AssertionError(f"a block of the Swin path disagrees with its plain "
                             f"version: rel errs {errs} (tol {KERNEL_TOL})")


def swin_init_gap(model, bundle, sd) -> None:
    """A measurement, not a check: the ITM logits with create_model's own
    initialisation (torch.manual_seed(SEED)) on the card in bf16 and on the
    CPU in bf16 (plain path), each against the CPU fp32 model, to tell a
    card fault from the bf16 rounding of near-uniform logits; the model gets
    ``sd`` back afterwards."""
    images = uint8_to_unit(torch.from_numpy(bundle["images_101"][:2]))
    ids = torch.from_numpy(bundle["ori_input_ids_101"][:2]).long()
    torch.manual_seed(SEED)
    init = create_model(model.cfg, device="cpu", input_size=model.input_size).state_dict()
    logits = {}
    for dtype in ("float32", "bfloat16"):
        cpu = create_model(dataclasses.replace(model.cfg, compute_dtype=dtype), device="cpu",
                           input_size=model.input_size).eval()
        cpu.load_state_dict(init, strict=True)
        with torch.no_grad():
            logits[dtype] = cpu(images, ids)["itm_logits"].float()
    model.load_state_dict(init, strict=True)
    with torch.no_grad():
        card = model(images.cuda(), ids.cuda())["itm_logits"].float().cpu()
    model.load_state_dict(sd, strict=True)
    want = logits["float32"]
    scale = want.abs().max().item()
    emit("swin_init_gap", pairs=2, logits_cpu_fp32=want.flatten().tolist(),
         logits_card=card.flatten().tolist(), logits_cpu_bf16=logits["bfloat16"].flatten().tolist(),
         rel_err_card=(card - want).abs().max().item() / scale,
         rel_err_cpu_bf16=(logits["bfloat16"] - want).abs().max().item() / scale,
         rel_err_card_vs_cpu_bf16=(card - logits["bfloat16"]).abs().max().item() / scale)


# kernel E's chain runs F's and #12's kernels under its own route tag
# (csrc/common.cuh: SwinBlockRoute); its group comes first, so their device
# time there is E's
SWIN_GROUPS = {"swin_block": ("SwinBlockRoute", "swin_qkv_kernel", "swin_proj_kernel",
                              "swin_pool_kernel"),
               "swin_attention": ("swin_attn_hopper_kernel",), "ln_mlp_fwd": ("ln_mlp_fwd",)}
# kernel C's chain runs #10's and #12's kernels under BlockAttentionRoute,
# kernel D's #12's kernels under DwConvRoute
V2_GROUPS = {"sr_kv": ("SrKvRoute",), "block_attention": ("BlockAttentionRoute",),
             "dwconv_mlp": ("DwConvRoute", "dwconv_")}


def phase_swin256_window(model, bundle, sd, e_logits_err: float) -> None:
    """The window route (kernel F and the LN-MLP forward) of pvlt_swin_tiny
    at 256, which serves a stage's bands under sequence parallelism,
    against the CPU fp32 model (compare_cpu_fp32, the ITM logits within
    SLICE_TOL) on the bundle and weights of swin_slice_vs_cpu_fp32: with
    models/swin.py:swin_band_stage patched off on the stages sp 2 splits
    (1-3), as sp_serving_reference does, and on every stage; E's figure of
    the same bundle beside them. Over the bound, every block of that route
    is held to its plain version at 256's shapes (check_swin_blocks) before
    the phase fails."""
    from mvlt_tpu_torch.models import pvlt
    from mvlt_tpu_torch.parallel import sequence

    split = planned_split(model.cfg, SP_SIZE)
    bands = {g for g, on in zip(sequence.stage_grids(model.cfg, 256), split) if on}
    gate = pvlt.swin_band_stage
    forms = {"sp2_stages": lambda ws, hw: tuple(hw) not in bands and gate(ws, hw),
             "every_stage": lambda ws, hw: False}
    errs, failed = {}, []
    for form, off in forms.items():
        with mock.patch.object(pvlt, "swin_band_stage", off):
            try:
                errs[form] = compare_cpu_fp32(model, bundle, sd,
                                              f"swin256_window_{form}_vs_cpu_fp32")
            except AssertionError as e:
                failed.append(form)
                errs[form] = str(e)
                check_swin_blocks(model, bundle, f"swin256_window_{form}_blocks_vs_plain")
    emit("swin256_window_vs_cpu_fp32", model=model.cfg.name, input=256,
         window_stages={"sp2_stages": [i + 1 for i, on in enumerate(split) if on],
                        "every_stage": [1, 2, 3, 4]},
         rel_err_logits=errs, rel_err_logits_e_route=e_logits_err, tol=SLICE_TOL,
         ok=not failed)
    if failed:
        raise AssertionError(f"Swin's window route at 256 differs from the CPU fp32 model past "
                             f"{SLICE_TOL}: {errs}")


def phase_swin(stats: dict) -> None:
    """Swin serving: kernels E and F vs plain; pvlt_swin_tiny at 224 (stage 1
    on kernel E, stages 2-4 on F and the LN-MLP forward) through
    evaluate_retrieval, its blocks, its logits vs the CPU fp32 model, pairs/s
    and a profile; then the same at 256 (every stage on E), whose launches
    of E are the ones kept (the training path's, run later, keep the LN-MLP
    forward's)."""
    phase_swin_kernels(stats)
    for size, per_forward, prefix in (
            (224, {"swin_block": 2, "swin_attention": 6, "ln_mlp_fwd": 6}, "swin224_"),
            (256, {"swin_block": 8}, "swin_")):
        model, bundles, sd = phase_slice(stats, "pvlt_swin_tiny", SWIN_WRAPPERS,
                                         prefix + "slice", size, per_forward)
        check_swin_blocks(model, bundles[0], prefix + "slice_blocks_vs_plain")
        e_err = compare_cpu_fp32(model, bundles[0], sd, prefix + "slice_vs_cpu_fp32")
        if size == 256:
            swin_init_gap(model, bundles[0], sd)
            phase_swin256_window(model, bundles[0], sd, e_err)
        phase_throughput(model, bundles, SWIN_GROUPS, prefix)
        del model
        torch.cuda.empty_cache()


# ---- recognition (M-CR / S-CR) at the protocol's batch ----------------------

REC_BATCH = 500            # the recognition protocol's batch (main_vl.py:374-385)
REC_RAGGED = 28            # the valid split's last batch: 35,528 items = 71 x 500 + 28
REC_ITEMS = REC_BATCH + REC_RAGGED
CLS_HEADS = LossType(itm=False, mlm=False, t2i=False, cls=True)   # configs/finetune_exp48.py


def emit_recognition_time(name: str, label: str, batch: int, run, plain,
                          bound_ms: float, bound_by: str, **extra) -> None:
    """One kernel's time at a recognition batch by CUDA events and by device
    time, beside its plain version's and its bound (not summed into the
    kernels line, whose times are the B = 101 rows')."""
    ms = cuda_time_ms(run)
    plain_ms = cuda_time_ms(plain)
    emit("kernel_time", kernel=name, shape=label, batch=batch, ms=ms, plain_ms=plain_ms,
         bound_ms=bound_ms, bound_by=bound_by, library_ms=None, speedup=plain_ms / ms,
         device_ms=device_time_ms(run), **extra)


def phase_recognition_kernels(stats: dict) -> None:
    """Kernels A and B at v1's stage 1, C and D at v2's and E at Swin's
    (256) against their plain versions in bf16 at the recognition batch of
    500 and the ragged 28, where each scratch is largest (D's H1 and G 2.16
    GB each at B = 500), A bit-equal over two calls at each; each kernel's
    time by events and by device time beside its plain version's."""
    gen = torch.Generator().manual_seed(SEED + 21)
    h, w, d, nh, sr, hid = STAGES[0]
    shape, hw = (h, w, d, nh, sr, hid, TEXT), (h, w)
    e_label, e_shape = swin_kernel_shapes()[0][0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for batch in (REC_BATCH, REC_RAGGED):
        p, x, k, v, kw_kv, kw_b = check_kernels(stats, gen, "stage1", shape, batch)
        p = {name: kernel_operand(t, torch.bfloat16) for name, t in p.items()}
        bounds = serving_bounds(shape, batch)
        emit_recognition_time(
            "sr_kv", "stage1", batch, lambda: fused_ln_sr_kv(x, hw, *_kv_args(p), **kw_kv),
            lambda: sr_kv_reference(x, hw, *_kv_args(p), **kw_kv), *bounds["sr_kv"],
            conv_splits=conv_splits(batch, (h // sr) * (w // sr), d, sr, sms))
        emit_recognition_time(
            "block_fused", "stage1", batch, lambda: fused_block(x, k, v, *_block_args(p), **kw_b),
            lambda: block_reference(x, k, v, *_block_args(p), **kw_b), *bounds["block_fused"])
        del x, k, v
        p, x, k, v, kw_c, kw_d = check_v2_kernels(stats, gen, "v2_stage1", shape, batch)
        p = {name: kernel_operand(t, torch.bfloat16) for name, t in p.items()}
        bounds = v2_bounds(shape, batch)
        emit_recognition_time(
            "block_attention", "v2_stage1", batch,
            lambda: fused_block_attention(x, k, v, *_c_args(p), **kw_c),
            lambda: block_attention_reference(x, k, v, *_c_args(p), **kw_c),
            *bounds["block_attention"])
        emit_recognition_time(
            "dwconv_mlp", "v2_stage1", batch, lambda: fused_dwconv_mlp(x, hw, *_d_args(p), **kw_d),
            lambda: dwconv_mlp_reference(x, hw, *_d_args(p), **kw_d), *bounds["dwconv_mlp"],
            scratch_gb=2 * scratch_elems(x.shape[0] * x.shape[1], d, hid) / 1e9)
        del x, k, v
        args, kw = check_swin_block_kernel(stats, gen, e_label, e_shape, False, batch)
        ops = tuple(kernel_operand(t, torch.bfloat16) if i > 3 else t for i, t in enumerate(args))
        table = swin_table(ops, kw)
        emit_recognition_time("swin_block", e_label, batch,
                              lambda: fused_swin_block(*ops, **kw, table=table),
                              lambda: swin_block_reference(*ops, **kw), *swin_e_bound(e_shape, batch))
        del args, ops, table
        torch.cuda.empty_cache()


class RecognitionItems:
    """``n`` in-memory items with FashionGenRecognition's schema, each a
    function of (seed, index): a uint8 NHWC image, clean ids of a caption of
    the shipped vocab, super and sub labels, and a name."""

    def __init__(self, n: int, seed: int, size: int, text_len: int):
        tok = WordPieceTokenizer(str(REPO / "preweights" / "bert-base-uncased-vocab.txt"))
        self.ids = [np.asarray(tok.encode(c, text_len), np.int32) for c in CAPTIONS]
        self.n, self.seed, self.size = n, seed, size

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> dict:
        gen = np.random.default_rng((self.seed, i))
        return {"images": gen.integers(0, 256, (self.size, self.size, 3), dtype=np.uint8),
                "ori_input_ids": self.ids[i % len(self.ids)],
                "sup_cls_labels": np.int32(gen.integers(0, 48)),
                "sub_cls_labels": np.int32(gen.integers(0, 122)),
                "info_list": f"synthetic_{i}.jpg"}


def cls_logits_vs_cpu(model, sd, images, ids, card: tuple) -> None:
    """The card's sup/sub logits of a few rows against the same weights in
    fp32 on the CPU (plain path), beside the plain path's own bf16 error on
    the CPU; relative to the largest CPU logit of each head."""
    cpu = {}
    for dtype in ("float32", "bfloat16"):
        m = create_model(dataclasses.replace(model.cfg, compute_dtype=dtype), device="cpu").eval()
        m.load_state_dict(sd, strict=True)
        cpu[dtype] = recognition.cls_logits(m, torch.device("cpu"), images, ids)
    errs, errs_cpu_bf16 = [], []
    for got, want, plain_bf16 in zip(card, cpu["float32"], cpu["bfloat16"]):
        scale = want.abs().max().item()
        errs.append((got - want).abs().max().item() / scale)
        errs_cpu_bf16.append((plain_bf16 - want).abs().max().item() / scale)
    ok = max(errs) <= SLICE_TOL
    emit("recognition_vs_cpu_fp32", rows=len(ids), rel_err_sup_sub=errs,
         rel_err_cpu_bf16_plain=errs_cpu_bf16, tol=SLICE_TOL, ok=ok)
    if not ok:
        raise AssertionError(f"CLS logits on the card differ from the CPU fp32 model by "
                             f"{errs} > {SLICE_TOL}")


def phase_recognition() -> None:
    """M-CR / S-CR recognition as the CLI runs it on the card: pvlt_tiny with
    the fine-tune heads (cls only, bf16, 256x256, 128 tokens, seeded
    weights) scores 528 in-memory items through
    evaluate_recognition(make_cls_scorer(model)) over the CLI's loader at
    B = 500, the last batch ragged: kernels A and B 8 launches per forward
    and no other kernel, 528 predictions in the artifact, the first four
    rows' logits of the B = 500 call vs the CPU fp32 model; then images/s at
    B = 500 on pre-staged uint8 device tensors, peak memory and a profile."""
    cfg = ModelConfig(name="pvlt_tiny", compute_dtype="bfloat16", loss_type=CLS_HEADS)
    model = create_model(cfg, device="cuda").eval()
    sd = seeded_state_dict(model, SEED)
    model.load_state_dict(sd, strict=True)
    items = RecognitionItems(REC_ITEMS, SEED + 3, 256, cfg.num_text_tokens)
    out = REPO / "build" / "chip_smoke_recognition"
    shutil.rmtree(out, ignore_errors=True)
    calls, real = [], recognition.cls_logits

    def recording(model, device, images, ids):
        logits = real(model, device, images, ids)
        calls.append((len(ids), images[:4], ids[:4], tuple(t[:4].cpu() for t in logits)))
        return logits

    try:
        reset_launches()
        start = time.perf_counter()
        with mock.patch.object(recognition, "cls_logits", recording):
            results = evaluate_recognition(make_cls_scorer(model),
                                           cli._simple_loader(items, REC_BATCH),
                                           artifact_dir=str(out))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = read_launches()
        with open(out / "recognition_predictions.json") as f:
            artifact = json.load(f)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    batches = [c[0] for c in calls]
    per_forward = {"sr_kv": 8, "block_fused": 8}
    ok = (batches == [REC_BATCH, REC_RAGGED]
          and len(artifact["sup_preds"]) == len(artifact["sub_preds"]) == REC_ITEMS
          and len(artifact["names"]) == REC_ITEMS
          and all(launches[name] == n * len(calls) for name, n in per_forward.items())
          and not any(launches[name] for name in WRAPPERS if name not in per_forward))
    emit("recognition", model=cfg.name, heads="cls", compute_dtype=cfg.compute_dtype, input=256,
         text_tokens=cfg.num_text_tokens, items=REC_ITEMS, batches=batches,
         seconds_host_inclusive=seconds, results=results, launches=launches,
         launches_expected={name: n * len(calls) for name, n in per_forward.items()},
         predictions=len(artifact["sup_preds"]), ok=ok)
    if not ok:
        raise AssertionError(f"recognition failed its checks: batches {batches}, "
                             f"launches {launches}, {len(artifact['sup_preds'])} predictions")
    _, images, ids, card = calls[0]
    cls_logits_vs_cpu(model, sd, images, ids, card)

    scorer = make_cls_scorer(model)
    staged = []
    for first in (0, REC_RAGGED):
        batch = collate([items[first + i] for i in range(REC_BATCH)])
        staged.append((torch.from_numpy(batch["images"]).cuda(),
                       torch.from_numpy(batch["ori_input_ids"]).long().cuda()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    turns = iter(range(10 ** 9))
    ms = cuda_time_ms(lambda: scorer(*staged[next(turns) % 2]), warmup=3, reps=10)
    snapshot = REPO / "build" / "chip_smoke_memory.pickle"
    device_memory_profile(str(snapshot))
    with open(snapshot, "rb") as f:
        segments = len(pickle.load(f)["segments"])
    snapshot.unlink()
    if not segments:
        raise AssertionError("the device memory snapshot holds no segment")
    emit("recognition_throughput", model=cfg.name, batch=REC_BATCH, ms_per_batch=ms,
         images_per_s=REC_BATCH / (ms / 1e3),
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         memory_snapshot_segments=segments,
         method="CUDA events around each scorer call (uint8 /255 on the card, forward, "
                "argmax), 3 warm-up, median of 10, 2 distinct pre-staged uint8 batches")
    profile_device(lambda: [scorer(*s) for s in staged], len(staged), V1_GROUPS,
                   "recognition_profile")
    del model, staged
    torch.cuda.empty_cache()


# ---- the training path -------------------------------------------------

TRAIN_RAGGED = (6, 10, 96, 3, 2, 384, 7)   # N = 67, M = 22, head dim 32
TRAIN_M177 = (56, 56, 64, 1, 8, 512, TEXT)  # stage 1 at 224 input: N = 3,264, M = 177
TRAIN_M272 = (48, 48, 64, 2, 4, 512, TEXT)  # N = 2,432, M = 272 (two K/V groups), head dim 32
# N = 67, M = 22, two heads of 64; its first 128-row tile spans sample 0
# (scale 0) and sample 1 (kept), FBA_TWO_SAMPLE_SCALES
TRAIN_TWO_SAMPLES = (6, 10, 128, 2, 2, 512, 7)
FBA_TWO_SAMPLE_SCALES = (0.0, 1 / 0.9, 1 / 0.9, 0.5)


def train_kernel_inputs(gen, shape: tuple, batch: int) -> dict:
    """Seeded inputs of the four training kernels at one shape, in the
    model's layouts: q and dO as [B, H, N, hd] views of [B, N, D], K and V
    as views of the [B, M, 2D] projection; LN-MLP weights with std
    gain / sqrt(fan_in) (phase 3's), a DropPath scale with one dropped
    sample."""
    h, w, d, nh, sr, hid, t = shape
    n = h * w + t
    m = (h // sr) * (w // sr) + t if sr > 1 else n
    hd = d // nh
    dev = torch.device("cuda")
    bf = lambda *s, std=1.0: (std * torch.randn(*s, generator=gen)).to(dev, torch.bfloat16)
    kv = bf(batch, m, 2, nh, hd).permute(2, 0, 3, 1, 4)
    p = stage_params(gen, d, sr, hid, dev)
    s = ((torch.rand(batch, generator=gen) < 0.9).float() / 0.9).to(dev)
    s[0] = 0.0
    return {"q": bf(batch, n, nh, hd, std=1.5).transpose(1, 2), "k": kv[0], "v": kv[1],
            "do": bf(batch, n, nh, hd).transpose(1, 2), "scale": hd ** -0.5,
            "x": bf(batch, n, d), "dy": bf(batch, n, d),
            "mlp": (p["ln2_weight"], p["ln2_bias"], p["w1"], p["b1"], p["w2"], p["b2"]),
            "s": s}


def _attn_args(a):
    return a["q"], a["k"], a["v"]


def _bwd_args(a, o_lse):
    return (*_attn_args(a), *o_lse, a["do"], a["scale"])


def _mlp_fwd_args(a):
    return (a["x"], *a["mlp"], a["s"], 1e-6)


def _mlp_bwd_args(a):
    g, b, w1, b1, w2, _ = a["mlp"]
    return (a["x"], g, b, w1, b1, w2, a["s"], 1e-6, a["dy"])


def check_train_kernels(stats: dict, gen, label: str, shape: tuple, batch: int) -> dict:
    """The four training kernels against their plain versions on one
    shape's seeded inputs; every output within KERNEL_TOL."""
    a = train_kernel_inputs(gen, shape, batch)
    o_lse = attention_stats_reference(*_attn_args(a), a["scale"])   # the backward's o, lse
    outs = {
        "attention_fwd": (("o", "lse"), attention_fwd(*_attn_args(a), a["scale"]), o_lse),
        "attention_bwd": (("dq", "dk", "dv"), attention_bwd(*_bwd_args(a, o_lse)),
                          attention_stats_bwd_reference(*_bwd_args(a, o_lse))),
        "ln_mlp_fwd": (("y",), (ln_mlp_fwd(*_mlp_fwd_args(a)),),
                       (ln_mlp_reference(*_mlp_fwd_args(a)),)),
        "ln_mlp_bwd": (("dx", "dgamma", "dbeta", "dW1", "db1", "dW2", "db2"),
                       ln_mlp_bwd(*_mlp_bwd_args(a)), ln_mlp_bwd_reference(*_mlp_bwd_args(a))),
    }
    torch.cuda.synchronize()
    h, w, d, nh, sr, hid, t = shape
    for name, (keys, got, want) in outs.items():
        errs = {k: _rel_err(g, w_) for k, g, w_ in zip(keys, got, want)}
        worst = max(e[1] for e in errs.values())
        ok = bool(worst <= KERNEL_TOL and np.isfinite(worst))
        emit("kernel_check", kernel=name, shape=label, batch=batch, n=h * w + t, dim=d,
             heads=nh, m=a["k"].shape[2], hidden=hid,
             rel_err={k: e[1] for k, e in errs.items()}, tol=KERNEL_TOL, ok=ok)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version at {label}, "
                                 f"B = {batch}: {errs} (tol {KERNEL_TOL})")
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"],
                                         max(e[0] for e in errs.values()))
    if batch == TRAIN_BATCH:
        again = ln_mlp_bwd(*_mlp_bwd_args(a))
        torch.cuda.synchronize()
        equal = all(torch.equal(x, y) for x, y in zip(outs["ln_mlp_bwd"][1], again))
        emit("kernel_check", kernel="ln_mlp_bwd", shape=label, batch=batch,
             check="two calls bit-equal", ok=equal)
        if not equal:
            raise AssertionError(f"two ln_mlp_bwd calls on the same inputs differ at {label}")
    return a


def ln_mlp_fwd_composition(a: dict):
    """The LN-MLP forward as PyTorch calls in bf16: F.layer_norm, F.linear
    (cuBLAS), the erf F.gelu, F.linear and the scaled residual; a yardstick
    for #12 (PERF.md section 6), never a path the port calls."""
    bf = torch.bfloat16
    g, be, w1, b1, w2, b2 = (t.to(bf) for t in a["mlp"])
    x, s = a["x"], a["s"].to(bf)[:, None, None]
    d = x.shape[-1]
    return lambda: x + F.linear(F.gelu(F.linear(F.layer_norm(x, (d,), g, be, 1e-6), w1, b1)),
                                w2, b2) * s


def ln_mlp_bwd_composition(a: dict):
    """The LN-MLP backward as the five products in bf16 torch.matmul (cuBLAS)
    and PyTorch's elementwise LN and GELU work in fp32: a yardstick for
    #13 (PERF.md section 5), never a path the port calls."""
    g, be, w1, b1, w2, _ = a["mlp"]
    x, dy, s = a["x"], a["dy"], a["s"]
    w1b, w2b = w1.to(torch.bfloat16), w2.to(torch.bfloat16)
    d, hid = x.shape[-1], w1.shape[0]

    def run():
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        rstd = torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + 1e-6)
        nhat = (xf - mean) * rstd
        n = (nhat * g + be).to(torch.bfloat16)
        dys = dy.float() * s[:, None, None]
        dysb = dys.to(torch.bfloat16)
        h1 = (n @ w1b.t()).float() + b1
        gl = F.gelu(h1).to(torch.bfloat16)
        dh1 = (dysb @ w2b).float() * gelu_grad(h1)
        dh1b = dh1.to(torch.bfloat16)
        dw2 = dysb.reshape(-1, d).t() @ gl.reshape(-1, hid)
        dw1 = dh1b.reshape(-1, hid).t() @ n.reshape(-1, d)
        dn = (dh1b @ w1b).float()
        dng = dn * g
        dx = dy.float() + (dng - dng.mean(-1, keepdim=True)
                           - nhat * (dng * nhat).mean(-1, keepdim=True)) * rstd
        return (dx.to(torch.bfloat16), (dn * nhat).sum((0, 1)), dn.sum((0, 1)), dw1,
                dh1.sum((0, 1)), dw2, dys.sum((0, 1)))
    return run


def train_bounds(shape: tuple, batch: int) -> dict:
    """(ms, bound_by) of the four training kernels at one stage shape. Forward
    attention: 4.B.H.N.M.hd flops (q.K^T and P.V), q read and o written, K/V
    read; backward: 10.B.H.N.M.hd (P recomputed, dV, dP, dQ, dK), q and dO
    read and dq written, K/V read and dK/dV written. LN-MLP forward:
    4.rows.D.H, the stream read and written and the bf16 weights read;
    backward: 10.rows.D.H (hidden recomputed, dW2, dG, dW1, dLN), x and dy
    read and dx written, the weights read and their fp32 gradients written."""
    h, w, d, nh, sr, hid, t = shape
    n = h * w + t
    m = (h // sr) * (w // sr) + t if sr > 1 else n
    q_elems, kv_elems, rows = batch * n * d, batch * m * d, batch * n
    return {
        "attention_fwd": bound(4 * q_elems * m, 2 * (2 * q_elems + 2 * kv_elems)),
        "attention_bwd": bound(10 * q_elems * m, 2 * (3 * q_elems + 4 * kv_elems)),
        "ln_mlp_fwd": bound(4 * rows * d * hid, 2 * 2 * rows * d + 2 * 2 * d * hid),
        "ln_mlp_bwd": bound(10 * rows * d * hid,
                            2 * 3 * rows * d + 2 * 2 * d * hid + 4 * 2 * d * hid),
    }


def sdpa_times(a: dict) -> tuple[float, float, float]:
    """F.scaled_dot_product_attention on the same tensors: forward, backward
    alone (on a kept graph) and forward + backward, in ms."""
    q, k, v = (t.detach().requires_grad_() for t in _attn_args(a))
    fwd = lambda: F.scaled_dot_product_attention(q, k, v, scale=a["scale"])
    o = fwd()
    bwd = lambda: torch.autograd.grad(o, (q, k, v), a["do"], retain_graph=True)
    both = lambda: torch.autograd.grad(fwd(), (q, k, v), a["do"])
    return cuda_time_ms(fwd), cuda_time_ms(bwd), cuda_time_ms(both)


def phase_train_kernels(stats: dict) -> None:
    """Training kernels vs plain: errors at B = 4 (stage shapes + ragged),
    then errors and times at B = 150 (the stage shapes of the step)."""
    gen = torch.Generator().manual_seed(SEED + 7)
    shapes = [(f"stage{i + 1}", (h, w, d, nh, sr, hid, TEXT))
              for i, (h, w, d, nh, sr, hid) in enumerate(STAGES)]
    extra = [("ragged", TRAIN_RAGGED), ("m177", TRAIN_M177), ("m272", TRAIN_M272)]
    for label, shape in shapes + extra:
        check_train_kernels(stats, gen, label, shape, SMOKE_BATCH)
    for label, shape in shapes:
        a = check_train_kernels(stats, gen, label, shape, TRAIN_BATCH)
        sdpa_fwd, sdpa_bwd, sdpa_both = sdpa_times(a)
        o_lse = attention_fwd(*_attn_args(a), a["scale"])
        times = {
            "attention_fwd": (lambda: attention_fwd(*_attn_args(a), a["scale"]),
                              lambda: attention_stats_reference(*_attn_args(a), a["scale"]),
                              sdpa_fwd),
            "attention_bwd": (lambda: attention_bwd(*_bwd_args(a, o_lse)),
                              lambda: attention_stats_bwd_reference(*_bwd_args(a, o_lse)),
                              sdpa_bwd),
            "ln_mlp_fwd": (lambda: ln_mlp_fwd(*_mlp_fwd_args(a)),
                           lambda: ln_mlp_reference(*_mlp_fwd_args(a)), None),
            "ln_mlp_bwd": (lambda: ln_mlp_bwd(*_mlp_bwd_args(a)),
                           lambda: ln_mlp_bwd_reference(*_mlp_bwd_args(a)), None),
        }
        bounds = train_bounds(shape, TRAIN_BATCH)
        for name, (kernel, plain, library_ms) in times.items():
            ms, plain_ms = cuda_time_ms(kernel), cuda_time_ms(plain)
            bound_ms, bound_by = bounds[name]
            compositions = {"ln_mlp_fwd": ln_mlp_fwd_composition,
                            "ln_mlp_bwd": ln_mlp_bwd_composition}
            extra = ({"sdpa_fwd_bwd_ms": sdpa_both} if name == "attention_bwd" else
                     {"device_ms": device_time_ms(kernel),
                      "composition_ms": cuda_time_ms(compositions[name](a)),
                      "composition_device_ms": device_time_ms(compositions[name](a))}
                     if name in compositions else {})
            emit("kernel_time", kernel=name, shape=label, batch=TRAIN_BATCH, ms=ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 library_ms=library_ms, speedup=plain_ms / ms, **extra)
            add_time(stats, name, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=library_ms)
        del a, times, o_lse
        torch.cuda.empty_cache()


def train_config() -> ModelConfig:
    """configs/pretrain_exp21.py: pvlt_tiny, ITM + MLM + T2I, DropPath 0.1,
    BERT dropout 0.1, bf16, the MLM loss through the MLM CE kernels (the
    default, mlm_ce_kernel=True)."""
    return ModelConfig(name="pvlt_tiny", compute_dtype="bfloat16", drop_path_rate=0.1)


def train_batch(seed: int, size: int) -> dict:
    """A host batch of the synthetic pre-training set (256x256, 128 tokens)."""
    data = SyntheticFashionGen(DataConfig(), size=size, seed=seed)
    return collate([data[i] for i in range(size)])


def phase_train_slice(stats: dict, cfg: ModelConfig | None = None, phase: str = "train_slice",
                      route: dict = TRAINING_WRAPPERS, record: dict | None = None):
    """pvlt_tiny takes TRAIN_STEPS pre-training steps at B = 150 through
    train_one_epoch(make_train_step(...)) on one repeated batch, each block
    kernel of ``route`` launched once per block and step, each MLM CE kernel
    once per step, nothing else; ``stats[record[name]]`` keeps the launches
    of ``route``'s wrapper ``name`` (default: under its own name). Returns
    the state, the config, the weights and the device batch."""
    cfg = cfg or train_config()
    record = {name: name for name in route} if record is None else record
    model = create_model(cfg)
    sd = seeded_state_dict(model, SEED)
    model.load_state_dict(sd, strict=True)
    batch = batch_to_device(train_batch(SEED, TRAIN_BATCH), "cuda")
    state = create_train_state(model, OptimConfig(warmup_epochs=0), TRAIN_BATCH,
                               TRAIN_STEPS, seed=SEED)
    step = make_train_step(cfg)
    seen = []

    def recording(state, batch):
        state, losses = step(state, batch)
        seen.append(losses)
        return state, losses

    stats_before = {k: v.clone() for k, v in model.named_buffers()}
    reset_launches()
    start = time.perf_counter()
    state, _ = train_one_epoch(recording, state, [batch] * TRAIN_STEPS,
                                      lr_schedule=state.lr_schedule, is_main=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = read_launches()
    losses = [{k: float(v) for k, v in ls.items()} for ls in seen]
    totals = [ls["total_loss"] for ls in losses]
    finite = all(np.isfinite(v) for ls in losses for v in ls.values())
    falling = totals[4] < totals[0] and totals[5] < totals[1]
    bn_moved = any(not torch.equal(v, stats_before[k]) for k, v in model.named_buffers())
    blocks = sum(cfg.depths)
    expected = {**{name: blocks * TRAIN_STEPS for name in route},
                **{name: TRAIN_STEPS for name in MLM_WRAPPERS}}
    emit(phase, model=cfg.name, compute_dtype=cfg.compute_dtype, batch=TRAIN_BATCH,
         fused_attn_train=cfg.fused_attn_train, fused_attn_stats=cfg.fused_attn_stats,
         drop_rate=cfg.drop_rate, attn_drop_rate=cfg.attn_drop_rate, steps=TRAIN_STEPS, seconds_host_inclusive=seconds, losses=losses,
         launches=launches, launches_expected=expected, finite=finite,
         loss_falling=falling, bn_stats_changed=bn_moved)
    if not finite:
        raise AssertionError(f"a training loss is not finite: {losses}")
    if any(launches[name] for name in WRAPPERS if name not in expected) or any(
            launches[name] != count for name, count in expected.items()):
        raise AssertionError(f"training launches {launches}, expected {expected} and "
                             f"no serving kernel")
    if not falling:
        raise AssertionError(f"total loss did not fall over {TRAIN_STEPS} steps: {totals}")
    if not bn_moved:
        raise AssertionError("the T2I BatchNorm statistics did not change")
    for name, key in record.items():
        stats[key]["launches"] = launches[name]
    return state, cfg, sd, batch


def plain_ln_mlp(x, gamma, beta, w1, b1, w2, b2, row_scale, eps):
    """ln_mlp_reference with fused_ln_mlp's signature (row_scale None: ones)."""
    if row_scale is None:
        row_scale = torch.ones(x.shape[0], device=x.device)
    return ln_mlp_reference(x, gamma, beta, w1, b1, w2, b2, row_scale, eps)


def plain_block_attention(x, k, v, *params, heads, eps, save_stats):
    """block_attention_train_reference with fused_block_attention_train's
    signature, differentiable by autograd (the statistics form is a
    backward choice: the plain route has none)."""
    return block_attention_train_reference(x, k, v, *params, heads=heads, eps=eps)


def check_train_blocks(state, cfg, batch, phase: str = "train_blocks_vs_plain") -> None:
    """Every block of one B = 150 training step: its output, and the
    gradients of its input and parameters for the upstream gradient the
    step gave it, against the plain versions on the block's own input and
    DropPath draws, within KERNEL_TOL; on the fused_attn_train route also
    the gradients of the block's K and V (the fused call's dK, dV). A v2
    block's kernels are #10/#11 (its DWConv MLP is PyTorch on both sides),
    a Swin block's #12/#13 (its window attention is PyTorch on both)."""
    model = state.model
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    seen = {}

    def pre(blk, args):
        seen[blk] = {"x": args[0].detach(), "hw": args[1], "rng": args[2].get_state()}

    def post(blk, args, out):
        seen[blk]["out"] = out.detach()
        out.register_hook(lambda g: seen[blk].__setitem__("dy", g))

    blocks = [blk for blk in model.modules() if isinstance(blk, (Block, SwinBlock))]
    hooks = [h for blk in blocks for h in (blk.register_forward_pre_hook(pre),
                                           blk.register_forward_hook(post))]
    try:
        make_train_step(cfg)(state, batch)
    finally:
        for h in hooks:
            h.remove()
    model.load_state_dict(saved)     # the weights the step's forward saw
    gen = torch.Generator(device=state.device)
    errs = {"out": [], "grad": [], "kv_grad": []}

    def kv_recorder(fn, store):
        """fn with the gradients of its K and V kept in ``store``."""
        def run(x, k, v, *args, **kwargs):
            k.register_hook(lambda g: store.__setitem__("dk", g))
            v.register_hook(lambda g: store.__setitem__("dv", g))
            return fn(x, k, v, *args, **kwargs)
        return run

    for blk in blocks:
        e = seen[blk]
        params = list(blk.parameters())
        results = []
        for attention, ln_mlp, fba in ((fused_attention, fused_ln_mlp,
                                        fused_block_attention_train),
                                       (attention_reference, plain_ln_mlp,
                                        plain_block_attention)):
            gen.set_state(e["rng"])
            x = e["x"].clone().requires_grad_()
            kv = {}
            if isinstance(blk, SwinBlock):
                out = blk.train_forward(x, e["hw"], gen, ln_mlp=ln_mlp)
            else:
                out = blk.train_forward(x, e["hw"], gen, attention=attention, ln_mlp=ln_mlp,
                                        block_attention=kv_recorder(fba, kv))
            grads = torch.autograd.grad(out, [x] + params, e["dy"])
            results.append((out.detach(), grads, kv))
        (out_k, grads_k, kv_k), (out_p, grads_p, kv_p) = results
        errs["out"].append(max(_rel_err(e["out"], out_p)[1], _rel_err(out_k, out_p)[1]))
        errs["grad"].append(max(_rel_err(g, w)[1] for g, w in zip(grads_k, grads_p)))
        if cfg.fused_attn_train:
            errs["kv_grad"].append(max(_rel_err(kv_k[n], kv_p[n])[1] for n in ("dk", "dv")))
    worst = max(errs["out"] + errs["grad"] + errs["kv_grad"])
    ok = (len(errs["out"]) == sum(cfg.depths) and worst <= KERNEL_TOL
          and len(errs["kv_grad"]) == (len(blocks) if cfg.fused_attn_train else 0))
    emit(phase, batch=TRAIN_BATCH, blocks=len(errs["out"]), rel_err_out=errs["out"],
         rel_err_grads=errs["grad"], rel_err_kv_grads=errs["kv_grad"], tol=KERNEL_TOL, ok=ok)
    if not ok:
        raise AssertionError(f"a block of the training step disagrees with its plain "
                             f"version: {errs} (tol {KERNEL_TOL})")


def compare_train_cpu(cfg, sd, card_routes: dict) -> None:
    """One step on CPU_BATCH samples, DropPath and dropout off, from the same
    weights: the card in bf16 on each route of ``card_routes`` (phase name
    -> the fused_attn_train and fused_attn_stats flags) against the CPU in
    fp32 (losses, per-tensor gradient cosines), beside the CPU bf16 model's
    own gap to fp32. The CPU takes the default route (the same function)."""
    cfg = dataclasses.replace(cfg, drop_path_rate=0.0, bert_dropout=0.0)
    batch = train_batch(SEED + 3, CPU_BATCH)
    runs = {}
    cards = [(phase, "cuda", "bfloat16", flags) for phase, flags in card_routes.items()]
    for label, device, dtype, flags in cards + [("cpu_fp32", "cpu", "float32", (False, False)),
                                                ("cpu_bf16", "cpu", "bfloat16", (False, False))]:
        run_cfg = dataclasses.replace(cfg, compute_dtype=dtype, fused_attn_train=flags[0],
                                      fused_attn_stats=flags[1])
        model = create_model(run_cfg, device=device)
        model.load_state_dict(sd, strict=True)
        state = create_train_state(model, OptimConfig(warmup_epochs=0), CPU_BATCH, 1)
        _, losses = make_train_step(run_cfg)(state, batch)
        runs[label] = ({k: float(v) for k, v in losses.items()},
                       {n: p.grad.float().cpu() for n, p in model.named_parameters()
                        if p.grad is not None})
    want_l, want_g = runs["cpu_fp32"]
    top = max(g.norm().item() for g in want_g.values())

    def gap(label):
        got_l, got_g = runs[label]
        loss_err = {k: abs(got_l[k] - v) / max(abs(v), 1e-12) for k, v in want_l.items() if v}
        cos = {n: torch.nn.functional.cosine_similarity(got_g[n].flatten(), w.flatten(),
                                                        dim=0).item()
               for n, w in want_g.items() if w.norm().item() > 1e-6 * top}
        worst = min(cos, key=cos.get)
        return loss_err, cos[worst], worst

    cpu_loss, cpu_cos, cpu_worst = gap("cpu_bf16")
    for phase, flags in card_routes.items():
        card_loss, card_cos, card_worst = gap(phase)   # MLM: kernels vs chunked plain
        ok = max(card_loss.values()) <= STEP_LOSS_TOL and card_cos >= GRAD_COS_MIN
        emit(phase, batch=CPU_BATCH, fused_attn_train=flags[0], fused_attn_stats=flags[1],
             mlm_card="mlm_ce kernels", mlm_cpu="chunked plain decode",
             losses_card=runs[phase][0], losses_cpu=want_l, rel_err_losses=card_loss,
             min_grad_cosine=card_cos, min_cosine_tensor=card_worst,
             rel_err_losses_cpu_bf16=cpu_loss, min_grad_cosine_cpu_bf16=cpu_cos,
             min_cosine_tensor_cpu_bf16=cpu_worst, loss_tol=STEP_LOSS_TOL,
             cosine_min=GRAD_COS_MIN, ok=ok)
        if not ok:
            raise AssertionError(f"the card's step ({phase}) differs from the CPU fp32 step: "
                                 f"losses {card_loss}, smallest gradient cosine {card_cos} "
                                 f"({card_worst})")


# a kernel books to the first group with a fragment of its name: the fused
# attention forward's chain (#10's and #12's kernels under FbaFwdRoute) first
TRAIN_GROUPS = {"fba_train_fwd": ("FbaFwdRoute",),
                "attention_fwd": ("attn_fwd_hopper_kernel",),
                "attention_bwd": ("attn_bwd_hopper_kernel", "attn_bwd_slot_sum_kernel"),
                "fba_train_bwd": ("fba_bwd_",),
                "ln_mlp_fwd": ("ln_mlp_fwd_",),
                "ln_mlp_bwd": ("ln_mlp_bwd_",),
                "mlm_ce_fwd": ("mlm_ce_fwd_kernel", "mlm_ce_merge_kernel"),
                "mlm_ce_bwd": ("mlm_ce_dlogits_kernel", "mlm_ce_gemm_kernel",
                               "mlm_ce_slot_sum_kernel")}


# the fused_attn_train route: its backward runs the attention core on
# #10/#11's kernels untagged, whose device time is the backward's there
# (the forward's tagged #10 books to the forward, the first group)
FBA_GROUPS = {"fba_train_fwd": TRAIN_GROUPS["fba_train_fwd"],
              "fba_train_bwd": ("fba_bwd_", "attn_fwd_hopper_kernel", "attn_bwd_hopper_kernel",
                                "attn_bwd_slot_sum_kernel"),
              **{k: v for k, v in TRAIN_GROUPS.items() if k not in ("fba_train_fwd",
                                                                     "fba_train_bwd")}}


def phase_train_throughput(state, cfg, prefix: str = "", groups: dict = TRAIN_GROUPS) -> None:
    """ms per step and samples/s at B = 150 on two pre-staged device batches,
    peak memory, and the device profile of three steps (device time summed
    by ``groups``)."""
    step = make_train_step(cfg)
    staged = [batch_to_device(train_batch(SEED + i, TRAIN_BATCH), "cuda") for i in (1, 2)]
    calls = iter(range(10 ** 9))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_time_ms(lambda: step(state, staged[next(calls) % 2]), warmup=3, reps=10)
    emit(prefix + "train_throughput", model=cfg.name, fused_attn_train=cfg.fused_attn_train,
         fused_attn_stats=cfg.fused_attn_stats, batch=TRAIN_BATCH, ms_per_step=ms,
         samples_per_s=TRAIN_BATCH / (ms / 1e3),
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         method="CUDA events around each step call (forward, backward, AdamW), 3 warm-up, "
                "median of 10, 2 distinct pre-staged batches")
    profile_device(lambda: [step(state, staged[i % 2]) for i in range(3)], 3, groups,
                   prefix + "train_profile")


# ---- multi-step dispatch (make_train_step(scan_steps=k)) -----------------

SCAN_K = 2
# the training kernels of a step on the default route: a dispatch of k
# steps launches each exactly k times a single step's count
SCAN_WRAPPERS = (*TRAINING_WRAPPERS, *MLM_WRAPPERS)


def state_gaps(a, b) -> dict:
    """The largest |a - b| of two train states' parameters, buffers (the
    BatchNorm statistics) and AdamW moments, and whether their steps and
    generators agree; every number 0.0 where the states are equal in bits."""
    def gap(x, y):
        return float((x.double() - y.double()).abs().max()) if x.numel() else 0.0

    sa, sb = a.model.state_dict(), b.model.state_dict()
    params = {n for n, _ in a.model.named_parameters()}
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    return {
        "params": max(gap(sa[n], sb[n]) for n in sa if n in params),
        "buffers": max(gap(sa[n], sb[n]) for n in sa if n not in params),
        "moments": max(gap(oa[i][k], ob[i][k]) for i in oa for k in oa[i]
                       if torch.is_tensor(oa[i][k])),
        "equal": (all(torch.equal(sa[n], sb[n]) for n in sa) and sorted(oa) == sorted(ob)
                  and all(torch.equal(torch.as_tensor(oa[i][k]), torch.as_tensor(ob[i][k]))
                          for i in oa for k in oa[i])
                  and a.step == b.step
                  and torch.equal(a.generator.get_state(), b.generator.get_state())),
    }


def phase_scan_steps(stats: dict) -> None:
    """make_train_step(scan_steps=2) on the card: pvlt_tiny with
    configs/pretrain_exp21.py's model (bf16, DropPath 0.1, BERT dropout 0.1,
    the MLM CE kernels) at B = 150, one seeded state made twice. From step 0
    one takes two single steps on batches b0 and b1 and the other one call
    on them stacked [2, 150, ...]; both then take a single step on b0, and
    from step 3 (odd: masked images first) two single steps on b1, b0
    against one call. After each pair the stacked losses, every parameter,
    every buffer (the BatchNorm statistics), every AdamW moment, the step
    and the generator's state are equal in bits (the largest gaps printed;
    the step is bit-reproducible since F14); the call launches each
    training kernel (#10-#15) exactly twice a single step's count and no
    other kernel. Then ms per step of both by CUDA events around two
    single steps and around one call (a measurement, no claim)."""
    from mvlt_tpu_torch.config import load_config_file

    cfg = load_config_file(str(REPO / "configs" / "pretrain_exp21.py")).model
    b0, b1 = (batch_to_device(train_batch(SEED + i, TRAIN_BATCH), "cuda") for i in (3, 4))

    def fresh():
        model = create_model(cfg)
        model.load_state_dict(seeded_state_dict(model, SEED), strict=True)
        return create_train_state(model, OptimConfig(warmup_epochs=0), TRAIN_BATCH,
                                  TRAIN_STEPS, seed=SEED)

    single, scan = make_train_step(cfg), make_train_step(cfg, scan_steps=SCAN_K)
    singles, dispatched = fresh(), fresh()
    pairs, launches = {}, {}
    for label, (x, y) in (("even", (b0, b1)), ("odd", (b1, b0))):
        start = singles.step
        reset_launches()
        singles, l0 = single(singles, x)
        torch.cuda.synchronize()
        one = read_launches()
        singles, l1 = single(singles, y)
        reset_launches()
        dispatched, losses = scan(dispatched, {k: torch.stack([x[k], y[k]]) for k in x})
        torch.cuda.synchronize()
        launches[label] = read_launches()
        want = {k: torch.stack([l0[k], l1[k]]) for k in l0}
        gaps = state_gaps(singles, dispatched)
        pairs[label] = {
            "start_step": start, "losses": {k: v.tolist() for k, v in losses.items()},
            "loss_gap": max(float((losses[k].double() - want[k].double()).abs().max())
                            for k in want),
            "losses_equal": sorted(losses) == sorted(want)
            and all(torch.equal(losses[k], want[k]) for k in want),
            **gaps,
            "launches_twice_single": all(one[n] > 0 and launches[label][n] == SCAN_K * one[n]
                                         for n in SCAN_WRAPPERS)
            and not any(launches[label][n] for n in WRAPPERS if n not in SCAN_WRAPPERS),
            "single_step_launches": {n: one[n] for n in SCAN_WRAPPERS}}
        if label == "even":   # both to an odd step
            singles, _ = single(singles, x)
            dispatched, _ = single(dispatched, x)
    stacked = {k: torch.stack([b0[k], b1[k]]) for k in b0}
    times = {"single": [], "scan": []}
    for form in ("single", "scan", "scan", "single"):
        run = ((lambda: (single(singles, b0), single(singles, b1))) if form == "single"
               else (lambda: scan(dispatched, stacked)))
        times[form].append(cuda_time_ms(run, warmup=1, reps=3) / SCAN_K)
    ok = all(p["losses_equal"] and p["equal"] and p["launches_twice_single"]
             and p["start_step"] % 2 == (label == "odd") for label, p in pairs.items())
    emit("scan_steps", model=cfg.name, config="configs/pretrain_exp21.py", batch=TRAIN_BATCH,
         k=SCAN_K, drop_path_rate=cfg.drop_path_rate, bert_dropout=cfg.bert_dropout,
         pairs=pairs, launches=launches, ms_per_step_single=times["single"],
         ms_per_step_scan=times["scan"],
         ms_method="CUDA events around two single steps and around one call of two steps, "
                   "1 warm-up, median of 3, turns single, scan, scan, single; per step",
         nvidia_smi=nvidia_smi_line(), ok=ok)
    if not ok:
        raise AssertionError(f"scan_steps={SCAN_K} differs from {SCAN_K} single steps: "
                             f"{pairs}")
    del singles, dispatched, b0, b1, stacked
    torch.cuda.empty_cache()


# ---- the fused_attn_train route ------------------------------------------

FBA_GRADS = ("dx", "dk", "dv", "dgamma", "dbeta", "dWq", "dbq", "dWp", "dbp")
FBA_FORMS = {"fba_recompute": (True, False), "fba_stats": (True, True)}


def fba_inputs(gen, shape: tuple, batch: int, scales: tuple | None = None) -> dict:
    """Seeded inputs of the fused attention half at one shape: the stream and
    its upstream gradient at unit scale, K and V as the model's contiguous
    [B, H, M, hd] copies, phase 3's parameters (Q at gain 1.5 / sqrt(D), so
    the softmax is peaked, the out-projection at gain 1) with Wq and Wp in
    bf16 as the autograd Function rounds them, a DropPath scale with one
    dropped sample (or ``scales``, one a sample)."""
    h, w, d, nh, sr, hid, t = shape
    n = h * w + t
    m = (h // sr) * (w // sr) + t if sr > 1 else n
    dev = torch.device("cuda")
    bf = lambda *s: torch.randn(*s, generator=gen).to(dev, torch.bfloat16)
    kv = bf(batch, m, 2, nh, d // nh).permute(2, 0, 3, 1, 4)
    p = stage_params(gen, d, sr, hid, dev)
    s = ((torch.rand(batch, generator=gen) < 0.9).float() / 0.9).to(dev)
    s[0] = 0.0
    if scales is not None:
        s = torch.tensor(scales, dtype=torch.float32, device=dev)
    master = (p["ln1_weight"], p["ln1_bias"], p["wq"], p["bq"], p["wp"], p["bp"])
    cast = (p["ln1_weight"], p["ln1_bias"], p["wq"].to(torch.bfloat16), p["bq"],
            p["wp"].to(torch.bfloat16), p["bp"])
    return {"x": bf(batch, n, d), "dy": bf(batch, n, d), "k": kv[0].contiguous(),
            "v": kv[1].contiguous(), "params": cast, "master": master, "s": s,
            "kw": dict(heads=nh, eps=1e-6)}


def _fba_fwd_args(a):
    return (a["x"], a["k"], a["v"], *a["params"], a["s"])


def _fba_bwd_args(a):
    g, be, wq, bq, wp, _ = a["params"]
    return (a["x"], a["k"], a["v"], g, be, wq, bq, wp, a["s"], a["dy"])


def check_fba_kernels(stats: dict, gen, label: str, shape: tuple, batch: int,
                      scales: tuple | None = None) -> dict:
    """The fused attention half's kernels against their plain versions on
    one shape's seeded inputs: the forward (out), the forward with
    statistics (out; LN mean, 1/std, row max and 1/denominator, each
    against its own largest value), and the backward in both forms (all nine
    gradients, each form fed its own forward's statistics), every one within
    KERNEL_TOL; the dropped sample's dx equal to its dy and its dK, dV zero.
    Returns the inputs and both statistics, for timing."""
    a = fba_inputs(gen, shape, batch, scales)
    kw = a["kw"]
    out = block_attention_train_fwd(*_fba_fwd_args(a), **kw)
    out_s, st = block_attention_train_fwd(*_fba_fwd_args(a), save_stats=True, **kw)
    out_ref = block_attention_train_reference(*_fba_fwd_args(a), **kw)
    _, st_ref = block_attention_train_reference(*_fba_fwd_args(a), save_stats=True, **kw)
    grads = block_attention_train_bwd(*_fba_bwd_args(a), **kw)
    grads_s = block_attention_train_bwd(*_fba_bwd_args(a), stats=st, **kw)
    want = block_attention_bwd_reference(*_fba_bwd_args(a), **kw)
    want_s = block_attention_bwd_reference(*_fba_bwd_args(a), stats=st_ref, **kw)
    torch.cuda.synchronize()
    cols = {"stats_mean": slice(0, 1), "stats_rstd": slice(1, 2), "stats_max": slice(2, None, 2),
            "stats_inv": slice(3, None, 2)}
    errs = {
        "fba_train_fwd": {"out": _rel_err(out, out_ref)},
        "fba_train_fwd_stats": {"out": _rel_err(out_s, out_ref),
                                **{k: _rel_err(st[..., c], st_ref[..., c])
                                   for k, c in cols.items()}},
        "fba_train_bwd": {k: _rel_err(g, w) for k, g, w in zip(FBA_GRADS, grads, want)},
        "fba_train_bwd_stats": {k: _rel_err(g, w) for k, g, w in zip(FBA_GRADS, grads_s, want_s)},
    }
    dropped = all(torch.equal(g[0][0], a["dy"][0]) and not g[1][0].any() and not g[2][0].any()
                  for g in (grads, grads_s))
    h, w, d, nh, sr, hid, t = shape
    for name, e in errs.items():
        worst = max(v[1] for v in e.values())
        ok = bool(worst <= KERNEL_TOL and np.isfinite(worst)) and (
            dropped or not name.startswith("fba_train_bwd"))
        emit("kernel_check", kernel=name, shape=label, batch=batch, n=h * w + t, dim=d,
             heads=nh, m=a["k"].shape[2], rel_err={k: v[1] for k, v in e.items()},
             dropped_sample_passes_dy=dropped, tol=KERNEL_TOL, ok=ok)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version at {label}, "
                                 f"B = {batch}: {e} (tol {KERNEL_TOL}; dropped sample "
                                 f"passes dy: {dropped})")
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"],
                                         max(v[0] for v in e.values()))
    if batch == TRAIN_BATCH:
        for name, got, form in (("fba_train_bwd", grads, None),
                                ("fba_train_bwd_stats", grads_s, st)):
            again = block_attention_train_bwd(*_fba_bwd_args(a), stats=form, **kw)
            torch.cuda.synchronize()
            equal = all(torch.equal(x, y) for x, y in zip(got, again))
            emit("kernel_check", kernel=name, shape=label, batch=batch,
                 check="two calls bit-equal", ok=equal)
            if not equal:
                raise AssertionError(f"two {name} calls on the same inputs differ at {label}")
    return {**a, "stats": st, "stats_ref": st_ref}


def fba_bounds(shape: tuple, batch: int) -> dict:
    """(ms, bound_by) of the fused attention half at one stage shape. Forward:
    4.B.N.(D^2 + M.D) flops (Q, out-projection, q.K^T, P.V); x read, out
    written, K/V and the bf16 Wq, Wp read (the statistics written too).
    Backward, the least work: 10.B.N.D^2 + 12.B.N.M.D (Q and dO recomputed,
    dWq, dWp, dLN1; logits, P.V, dP, dQ, dK, dV); x and dy read, dx written,
    K/V read and dK/dV written, the bf16 weights read and their fp32
    gradients written (the statistics read)."""
    h, w, d, nh, sr, hid, t = shape
    n = h * w + t
    m = (h // sr) * (w // sr) + t if sr > 1 else n
    rows, kv, st = batch * n, batch * m * d, 4 * batch * n * (2 + 2 * nh)
    fwd_bytes = 2 * (2 * rows * d + 2 * kv + 2 * d * d)
    bwd_bytes = 2 * (3 * rows * d + 4 * kv + 2 * d * d) + 4 * (2 * d * d + 4 * d)
    fwd_flops = 4 * rows * (d * d + m * d)
    bwd_flops = 10 * rows * d * d + 12 * rows * m * d
    return {"fba_train_fwd": bound(fwd_flops, fwd_bytes),
            "fba_train_fwd_stats": bound(fwd_flops, fwd_bytes + st),
            "fba_train_bwd": bound(bwd_flops, bwd_bytes),
            "fba_train_bwd_stats": bound(bwd_flops, bwd_bytes + st)}


def default_route_times(a: dict) -> dict:
    """The default route's attention half on the same inputs, the yardstick
    of the fused one: LN1, the cuBLAS Q and out-projections and the port's
    attention kernels (#10/#11) with the DropPath scale, on fp32 master
    parameters; forward, and backward alone (on a kept graph) to x, K, V and
    every parameter, in ms by CUDA events and by torch.profiler device
    time."""
    x, k, v = (a[n].detach().requires_grad_() for n in ("x", "k", "v"))
    g, be, wq, bq, wp, bp = (t.detach().requires_grad_() for t in a["master"])
    b, n, d = x.shape
    heads = a["kw"]["heads"]
    hd = d // heads
    s = a["s"].to(torch.bfloat16)[:, None, None]

    def fwd():
        q = linear(layer_norm_fp32(x, g, be, 1e-6), wq, bq).reshape(b, n, heads, hd)
        o = fused_attention(q.transpose(1, 2), k, v, hd ** -0.5).transpose(1, 2)
        return x + linear(o.reshape(b, n, d), wp, bp) * s

    out = fwd()
    bwd = lambda: torch.autograd.grad(out, (x, k, v, g, be, wq, bq, wp, bp), a["dy"],
                                      retain_graph=True)
    return {"route_fwd_ms": cuda_time_ms(fwd), "route_fwd_device_ms": device_time_ms(fwd),
            "route_bwd_ms": cuda_time_ms(bwd), "route_bwd_device_ms": device_time_ms(bwd)}


def check_fba_traps(stats: dict, gen) -> None:
    """check_fba_kernels at B = 4 on the stage shapes and on the shapes that
    catch each trap of the chains."""
    shapes = [(f"stage{i + 1}", (h, w, d, nh, sr, hid, TEXT))
              for i, (h, w, d, nh, sr, hid) in enumerate(STAGES)]
    for label, shape in shapes + [("ragged", TRAIN_RAGGED), ("m177", TRAIN_M177)]:
        check_fba_kernels(stats, gen, label, shape, SMOKE_BATCH)
    check_fba_kernels(stats, gen, "two_samples", TRAIN_TWO_SAMPLES, SMOKE_BATCH,
                      FBA_TWO_SAMPLE_SCALES)


def phase_fba_train_kernels(stats: dict) -> None:
    """The fused attention half's kernels vs plain: errors at B = 4 (the four
    stage shapes, a ragged one: N off the row tile, M off 16, head dim 32;
    M = 177; two heads with a 128-row tile across a dropped and a kept
    sample), then errors and times at B = 150 (the stage shapes of the
    step), beside the default route's attention half on the same inputs."""
    gen = torch.Generator().manual_seed(SEED + 17)
    check_fba_traps(stats, gen)
    shapes = [(f"stage{i + 1}", (h, w, d, nh, sr, hid, TEXT))
              for i, (h, w, d, nh, sr, hid) in enumerate(STAGES)]
    for label, shape in shapes:
        a = check_fba_kernels(stats, gen, label, shape, TRAIN_BATCH)
        kw, st, st_ref = a["kw"], a["stats"], a["stats_ref"]
        route = default_route_times(a)
        route_fwd = {k: v for k, v in route.items() if k.startswith("route_fwd")}
        route_bwd = {k: v for k, v in route.items() if k.startswith("route_bwd")}
        times = {
            "fba_train_fwd": (lambda: block_attention_train_fwd(*_fba_fwd_args(a), **kw),
                              lambda: block_attention_train_reference(*_fba_fwd_args(a), **kw),
                              route_fwd),
            "fba_train_fwd_stats": (
                lambda: block_attention_train_fwd(*_fba_fwd_args(a), save_stats=True, **kw),
                lambda: block_attention_train_reference(*_fba_fwd_args(a), save_stats=True, **kw),
                route_fwd),
            "fba_train_bwd": (lambda: block_attention_train_bwd(*_fba_bwd_args(a), **kw),
                              lambda: block_attention_bwd_reference(*_fba_bwd_args(a), **kw),
                              route_bwd),
            "fba_train_bwd_stats": (
                lambda: block_attention_train_bwd(*_fba_bwd_args(a), stats=st, **kw),
                lambda: block_attention_bwd_reference(*_fba_bwd_args(a), stats=st_ref, **kw),
                route_bwd),
        }
        bounds = fba_bounds(shape, TRAIN_BATCH)
        for name, (kernel, plain, yardstick) in times.items():
            ms, plain_ms = cuda_time_ms(kernel), cuda_time_ms(plain)
            bound_ms, bound_by = bounds[name]
            extra = ({"device_ms": device_time_ms(kernel)} if name.startswith("fba_train_bwd")
                     else {})
            emit("kernel_time", kernel=name, shape=label, batch=TRAIN_BATCH, ms=ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                 speedup=plain_ms / ms, **yardstick, **extra)
            add_time(stats, name, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=None)
        del a, times
        torch.cuda.empty_cache()


def phase_fba_train(stats: dict) -> None:
    """The fused_attn_train route in each backward form: TRAIN_STEPS steps
    of the pre-training configuration at B = 150 (the fused forward and
    backward 8 times a step, #10/#11 never, the LN-MLP kernels 8 times, the
    MLM CE kernels once, no serving kernel; finite and falling losses),
    every block of a step vs the plain route, and the step's throughput and
    profile."""
    for prefix, (fused, with_stats) in FBA_FORMS.items():
        cfg = dataclasses.replace(train_config(), fused_attn_train=fused,
                                  fused_attn_stats=with_stats)
        suffix = "_stats" if with_stats else ""
        state, cfg, _, batch = phase_train_slice(
            stats, cfg, prefix + "_train_slice", FBA_ROUTE,
            {name: name + suffix for name in FBA_WRAPPERS})
        check_train_blocks(state, cfg, batch, prefix + "_train_blocks_vs_plain")
        phase_train_throughput(state, cfg, prefix + "_", FBA_GROUPS)
        del state, batch
        torch.cuda.empty_cache()


# ---- the MLM cross entropy and the pre-training CLI ------------------------

REPO = pathlib.Path(__file__).resolve().parent
MLM_ROWS = 3072            # the gather plan's capacity at B = 150 x 128 tokens, frac 0.16
MLM_WIDTH, VOCAB = 768, 30522


def mlm_inputs(gen, rows: int, frac: float, vocab: int = VOCAB, bias_mean: float = 0.0,
               last: int = 0) -> tuple:
    """Seeded operands of the MLM CE kernels on the card: bf16 rows, the bf16
    table with std 3 / sqrt(H) (logits of std ~3, a peaked softmax), an fp32
    bias around ``bias_mean``, labels with ``frac`` of the rows labeled (among
    the last ``last`` columns of the vocabulary where ``last`` is set), and
    the per-row gradient the mean loss gives (1 / labeled count)."""
    dev = torch.device("cuda")
    x = torch.randn(rows, MLM_WIDTH, generator=gen).to(dev, torch.bfloat16)
    table = (3.0 / MLM_WIDTH ** 0.5 * torch.randn(vocab, MLM_WIDTH, generator=gen)).to(
        dev, torch.bfloat16)
    bias = (bias_mean + 0.1 * torch.randn(vocab, generator=gen)).to(dev)
    labels = torch.where(torch.rand(rows, generator=gen) < frac,
                         torch.randint(vocab - last if last else 0, vocab, (rows,),
                                       generator=gen), -1).to(dev)
    g = torch.full((rows,), 1.0 / max(int((labels >= 0).sum()), 1), device=dev)
    return x, table, bias, labels, g


def mlm_bounds(rows: int) -> dict:
    """(ms, bound_by) of the two MLM CE kernels. Forward: 2.R.V.H flops;
    rows, table, bias and labels read, nll and lse written. Backward: the
    least work, one logits recompute, dx and dE (6.R.V.H); rows, table,
    bias, labels, lse and g read, fp32 dx, dE and db written."""
    r, h, v = rows, MLM_WIDTH, VOCAB
    operands = 2 * r * h + 2 * v * h + 4 * v + 4 * r
    return {"mlm_ce_fwd": bound(2 * r * v * h, operands + 2 * 4 * r),
            "mlm_ce_bwd": bound(6 * r * v * h, operands + 2 * 4 * r + 4 * (r * h + v * h + v))}


def library_ce_calls(x, table, bias, labels) -> tuple:
    """The library yardstick the port never calls: the cuBLAS bf16 logits,
    then F.cross_entropy(ignore_index=-1) summed, as one autograd graph:
    calls of its forward, its backward alone (on a kept graph) and both."""
    xr, tr, br = (t.detach().requires_grad_() for t in (x, table.float(), bias))
    fwd = lambda: F.cross_entropy((xr @ tr.to(torch.bfloat16).t()).float() + br, labels,
                                  ignore_index=-1, reduction="sum")
    loss = fwd()
    bwd = lambda: torch.autograd.grad(loss, (xr, tr, br), retain_graph=True)
    both = lambda: torch.autograd.grad(fwd(), (xr, tr, br))
    return fwd, bwd, both


# the MLM CE checks: (label, rows, labeled share, mlm_inputs' keywords).
# "ragged_vocab": V = 4,099 (its last 128-column tile holds 3 columns, 125
# padded), every logit far below 0 (bias -10) and the labels among the last
# 70 columns, so that a padded column counted in the sum, or a dropped last
# tile, shows.
MLM_CHECKS = (("path", MLM_ROWS, 0.15, {}), ("ragged", 1000, 0.3, {}),
              ("ragged_vocab", 1000, 0.3, {"vocab": 4099, "bias_mean": -10.0, "last": 70}),
              ("all_ignored", 512, 0.0, {}))


def phase_mlm_kernels(stats: dict) -> None:
    """The MLM CE kernels against their plain versions in bf16 (nll, lse and
    the three gradients, each within KERNEL_TOL) at the path's R = 3,072
    rows with ~15% labeled, at a ragged R = 1,000, on a ragged vocabulary
    with logits below 0, and with every row ignored (exact zeros); at R =
    3,072 two calls of each bit-equal, and their times beside the plain
    versions', the bounds and the library call's (CUDA events and
    torch.profiler device time)."""
    gen = torch.Generator().manual_seed(SEED + 11)
    for label, rows, frac, kw in MLM_CHECKS:
        x, table, bias, labels, g = mlm_inputs(gen, rows, frac, **kw)
        nll, lse = mlm_ce_fwd(x, table, bias, labels)
        want_nll, want_lse = mlm_nll_reference(x, table, bias, labels)
        grads = mlm_ce_bwd(x, table, bias, labels, want_lse, g)
        want = mlm_nll_bwd_reference(x, table, bias, labels, want_lse, g)
        torch.cuda.synchronize()
        errs = {"mlm_ce_fwd": {"nll": _rel_err(nll, want_nll), "lse": _rel_err(lse, want_lse)},
                "mlm_ce_bwd": {k: _rel_err(a, b) for k, a, b in
                               zip(("d_rows", "d_table", "d_bias"), grads, want)}}
        if frac == 0.0:
            nonzero = int(torch.count_nonzero(nll)) + sum(int(torch.count_nonzero(t))
                                                           for t in grads)
            ok = nonzero == 0
            emit("kernel_check", kernel="mlm_ce", shape=label, rows=rows, labeled=0,
                 nonzero_outputs=nonzero, ok=ok)
            if not ok:
                raise AssertionError(f"MLM CE with every row ignored left {nonzero} non-zeros")
            continue
        for name, e in errs.items():
            worst = max(v[1] for v in e.values())
            ok = bool(worst <= KERNEL_TOL and np.isfinite(worst))
            emit("kernel_check", kernel=name, shape=label, rows=rows, width=MLM_WIDTH,
                 vocab=table.shape[0], labeled=int((labels >= 0).sum()),
                 rel_err={k: v[1] for k, v in e.items()}, tol=KERNEL_TOL, ok=ok)
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain version at {label}: "
                                     f"{e} (tol {KERNEL_TOL})")
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"],
                                             max(v[0] for v in e.values()))
        if label != "path":
            continue
        again = (mlm_ce_fwd(x, table, bias, labels),
                 mlm_ce_bwd(x, table, bias, labels, want_lse, g))
        torch.cuda.synchronize()
        for name, first, second in zip(MLM_WRAPPERS, ((nll, lse), grads), again):
            equal = all(torch.equal(a, b) for a, b in zip(first, second))
            emit("kernel_check", kernel=name, shape=label, rows=rows,
                 check="two calls bit-equal", ok=equal)
            if not equal:
                raise AssertionError(f"two {name} calls on the same inputs differ")
        del again
        lib_fwd, lib_bwd, lib_both = library_ce_calls(x, table, bias, labels)
        times = {"mlm_ce_fwd": (lambda: mlm_ce_fwd(x, table, bias, labels),
                                lambda: mlm_nll_reference(x, table, bias, labels), lib_fwd),
                 "mlm_ce_bwd": (lambda: mlm_ce_bwd(x, table, bias, labels, lse, g),
                                lambda: mlm_nll_bwd_reference(x, table, bias, labels, lse, g),
                                lib_bwd)}
        bounds = mlm_bounds(rows)
        for name, (kernel, plain, library) in times.items():
            ms, plain_ms = cuda_time_ms(kernel), cuda_time_ms(plain)
            library_ms = cuda_time_ms(library)
            bound_ms, bound_by = bounds[name]
            device = {"device_ms": device_time_ms(kernel),
                      "library_device_ms": device_time_ms(library),
                      **({"library_fwd_bwd_ms": cuda_time_ms(lib_both)}
                         if name == "mlm_ce_bwd" else {})}
            emit("kernel_time", kernel=name, shape=label, rows=rows, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                 speedup=plain_ms / ms, **device)
            add_time(stats, name, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=library_ms)
        del times, lib_fwd, lib_bwd, lib_both
    torch.cuda.empty_cache()


def _train_log(run: pathlib.Path) -> list:
    with open(run / "train_log.jsonl") as f:
        return [json.loads(line) for line in f]


# the training kernels of the default route, as a trace names their launches
TRACE_KERNELS = {"attention_fwd": ("attn_fwd_hopper_kernel",),
                 "attention_bwd": ("attn_bwd_hopper_kernel",),
                 "ln_mlp_fwd": ("ln_mlp_fwd_",), "ln_mlp_bwd": ("ln_mlp_bwd_",),
                 "mlm_ce_fwd": ("mlm_ce_fwd_kernel",), "mlm_ce_bwd": ("mlm_ce_dlogits_kernel",)}


# the launches of phase_cli's first run (2 pre-training epochs), which
# ddp_world1 repeats under torchrun
CLI_PRETRAIN_LAUNCHES: dict = {}


CLI_DISPATCH_BATCH = 96   # two steps an epoch over the synthetic set's 192 draws


def cli_dispatch_pair(out: pathlib.Path) -> dict:
    """One pre-training epoch of configs/pretrain_exp21.py on synthetic data
    at --batch-size 96 (two steps) through ``cli.main`` at
    --steps-per-dispatch 1 and 2, each step's losses recorded from the
    step the CLI builds: at k = 2 one call returns both steps' rows, equal
    in bits to the k = 1 run's, and the epochs' train_log.jsonl lines equal
    but for the time and the LR (logged once a call, with its last
    step's); the launches of the two runs equal."""
    from mvlt_tpu_torch.train import step as step_module

    build = step_module.make_train_step
    runs = {}
    for k in (1, 2):
        rows = []

        def recording(*args, **kwargs):
            fn = build(*args, **kwargs)

            def run(state, batch):
                state, losses = fn(state, batch)
                rows.append(losses)
                return state, losses
            return run

        run_dir = out / f"dispatch{k}"
        reset_launches()
        start = time.perf_counter()
        with mock.patch.object(step_module, "make_train_step", recording):
            cli.main(["--config", str(REPO / "configs" / "pretrain_exp21.py"),
                      "--synthetic-data", "--batch-size", str(CLI_DISPATCH_BATCH),
                      "--epochs", "1", "--steps-per-dispatch", str(k),
                      "--output-dir", str(run_dir)])
        torch.cuda.synchronize()
        per_step = [{name: v.reshape(-1)[i].item() for name, v in losses.items()}
                    for losses in rows for i in range(k)]
        (line,) = _train_log(run_dir)
        runs[k] = {"calls": len(rows), "losses": per_step, "line": line,
                   "launches": read_launches(), "seconds": time.perf_counter() - start}
    drop = ("time", "lr")
    one, two = runs[1], runs[2]
    ok = (one["calls"] == 2 and two["calls"] == 1 and len(two["losses"]) == 2
          and two["losses"] == one["losses"]
          and {k: v for k, v in two["line"].items() if k not in drop}
          == {k: v for k, v in one["line"].items() if k not in drop}
          and two["launches"] == one["launches"]
          and all(one["launches"][n] for n in SCAN_WRAPPERS))
    return {"batch": CLI_DISPATCH_BATCH, "k1": one, "k2": two, "ok": ok}


def phase_cli(stats: dict) -> None:
    """The pre-training entry point on the card, as a user runs it:
    ``mvlt_tpu_torch.cli.main`` with configs/pretrain_exp21.py on synthetic
    data (B = 150, one step per epoch over 64 items x 3 repeats) for 2
    epochs, the VL eval in epoch 1; then ``--resume last`` for epoch 2;
    then one CLS fine-tune epoch (configs/finetune_exp48.py) from that
    checkpoint. Checks the logs, the checkpoints, finite losses and eval
    statistics, and that every kernel of the path launched (the MLM CE
    kernels once per pre-training step). Then one more pre-training epoch
    under ``--profile-dir``, apart from the three timed runs, whose trace
    must name the training kernels' launches."""
    out = REPO / "build" / "chip_smoke_cli"
    shutil.rmtree(out, ignore_errors=True)
    pre, ft = out / "pretrain", out / "finetune"
    base = ["--config", str(REPO / "configs" / "pretrain_exp21.py"), "--synthetic-data",
            "--output-dir", str(pre)]
    runs = [("pretrain", base + ["--epochs", "2"]),
            ("resume", base + ["--epochs", "3", "--resume", "last"]),
            ("finetune", ["--config", str(REPO / "configs" / "finetune_exp48.py"),
                          "--synthetic-data", "--output-dir", str(ft), "--epochs", "1",
                          "--finetune", str(pre)])]
    try:
        seconds, by_run = {}, {}
        for label, argv in runs:
            reset_launches()
            start = time.perf_counter()
            cli.main(argv)
            torch.cuda.synchronize()
            seconds[label] = time.perf_counter() - start
            by_run[label] = read_launches()
        launches = {k: sum(run[k] for run in by_run.values()) for k in WRAPPERS}
        CLI_PRETRAIN_LAUNCHES.update(by_run["pretrain"])
        dispatch = cli_dispatch_pair(out)
        start = time.perf_counter()
        cli.main(["--config", str(REPO / "configs" / "pretrain_exp21.py"), "--synthetic-data",
                  "--output-dir", str(out / "profiled"), "--epochs", "1",
                  "--profile-dir", str(out / "profile")])
        torch.cuda.synchronize()
        profiled_seconds = time.perf_counter() - start
        pre_log, ft_log = _train_log(pre), _train_log(ft)
        steps = int(torch.load(pre / "checkpoint" / "last" / "state.pt", map_location="cpu",
                               weights_only=True)["step"])
        with open(pre / "checkpoint" / "last.json") as f:
            last_epoch = json.load(f)["epoch"]
        traces = os.listdir(out / "profile")
        with open(out / "profile" / traces[0]) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    finally:
        shutil.rmtree(out, ignore_errors=True)
    # the profiled epoch's trace names the training kernels' launches
    traced = {group: any(frag in name for name in names for frag in frags)
              for group, frags in TRACE_KERNELS.items()}
    evals = [{k: v for k, v in line.items() if k.startswith("eval_")}
             for line in pre_log + ft_log]
    finite = all(np.isfinite(v) for line in pre_log + ft_log for v in line.values())
    ok = ([line["epoch"] for line in pre_log] == [0, 1, 2] and len(ft_log) == 1
          and not evals[0] and all(evals[1:]) and finite and steps == 3 and last_epoch == 2
          and launches["mlm_ce_fwd"] == launches["mlm_ce_bwd"] == steps
          and all(launches[name] for name in
                  (*SERVING_WRAPPERS, *TRAINING_WRAPPERS, *MLM_WRAPPERS))
          and not any(launches[name] for name in V2_SERVING_WRAPPERS if name != "sr_kv")
          and not any(launches[name] for name in FBA_WRAPPERS)
          and len(traces) == 1 and all(traced.values()) and dispatch["ok"])
    emit("cli", config="configs/pretrain_exp21.py", batch=TRAIN_BATCH, epochs_run=[0, 1, 2],
         steps_per_dispatch=dispatch,
         profile_traces=len(traces), profile_kernels=traced,
         profiled_epoch_seconds=profiled_seconds,
         resumed_at_epoch=2, pretrain_steps=steps, finetune_steps=1, seconds=seconds,
         losses={f"epoch{line['epoch']}": line["total_loss"] for line in pre_log},
         finetune_loss=ft_log[0]["total_loss"], eval_stats=[e for e in evals if e],
         launches=launches, finite=finite, ok=ok)
    if not ok:
        raise AssertionError(f"the CLI path failed its checks: logs {pre_log} {ft_log}, "
                             f"steps {steps}, launches {launches}")
    for name in MLM_WRAPPERS:
        stats[name]["launches"] = launches[name]


def write_fashion_gen_tree(root: pathlib.Path) -> None:
    """A small Fashion-Gen tree in the reference's layout (as
    tests/test_cli_downstream.py's): 64 train and 10 valid products (a
    coloured block on white, PNG), their pickled info dicts, and 2 retrieval
    queries of 4 candidates each way."""
    from PIL import Image

    rng = np.random.default_rng(SEED + 7)
    for split, n in (("train", 64), ("valid", 10)):
        (root / f"extracted_{split}_images").mkdir(parents=True)
        (root / f"full_{split}_info_PAI").mkdir()
        for i in range(n):
            name = f"prod{i:04d}_img.png"
            path = root / f"extracted_{split}_images" / name
            arr = np.full((40, 44, 3), 255, np.uint8)
            arr[6:34, 5 + i % 4:38] = rng.integers(0, 220, (28, 33 - i % 4, 3), np.uint8)
            Image.fromarray(arr).save(path)
            info = {"product_id": i, "img_name": name, "super_cls_id": int(rng.integers(0, 48)),
                    "sub_cls_id": int(rng.integers(0, 122)),
                    "captions": f"item {i} {CAPTIONS[i % len(CAPTIONS)]}"}
            with open(root / f"full_{split}_info_PAI" / f"prod{i:04d}_info.pkl", "wb") as f:
                pickle.dump(info, f)
    for step, direction in ((1, "ITR"), (3, "TIR")):
        (root / f"retrieve_{direction}").mkdir()
        for q in range(2):
            bundle = {c: {"img_name": f"prod{(q + step * c) % 10:04d}_img.png",
                          "captions": f"item {q + c} {CAPTIONS[(q + c) % len(CAPTIONS)]}"}
                      for c in range(4)}
            with open(root / f"retrieve_{direction}" / f"q{q:04d}.pkl", "wb") as f:
                pickle.dump(bundle, f)


def direct_eval(argv: list, tree: str, sd: dict) -> dict:
    """The metrics of an eval command line computed without its dispatch:
    the model of its config with the heads the mode needs, ``sd`` merged in
    by name, and the mode's reader, scorer and protocol called directly."""
    args = cli.get_args_parser().parse_args(argv)
    cfg = cli.build_run_config(args)
    if args.eval_recognition:
        cfg = apply_overrides(cfg, {"loss_type": {"cls": 1}})
    elif not args.parity_heads:
        cfg = apply_overrides(cfg, {"loss_type": {"itm": 1, "mlm": 0, "t2i": 0, "cls": 0}})
    model = create_model(cfg.model, device="cuda")
    model.load_state_dict(merge_state_dicts(model.state_dict(), sd)[0])
    model.eval()
    if args.eval_recognition:
        return evaluate_recognition(make_cls_scorer(model), cli._simple_loader(
            FashionGenRecognition(tree, cfg.data), REC_BATCH), is_main=False)
    direction = "itr" if args.eval_retrieval_itr else "tir"
    return evaluate_retrieval(make_itm_scorer(model), cli._simple_loader(
        FashionGenRetrieval(tree, cfg.data, direction), 1), is_main=False)


READER_ITEMS = 64   # the tree's train split


def native_reader_check(tree: pathlib.Path) -> dict:
    """The train reader of the tree at 256 (DataConfig's defaults,
    use_native_image_ops on) reads through the native host library: its
    tokenizer is the C++ one, and every item's image equals
    native_crop_resize of the decoded file, not PIL's crop-resize (within
    1.5/255 of it). Then the reader's items/s over the split with the key
    on and off, in turns (on, off, off, on), one host thread: a measurement
    of the host, no claim."""
    from mvlt_tpu_torch.data import native
    from mvlt_tpu_torch.data.fashion_gen import FashionGenPretrain
    from mvlt_tpu_torch.data.image_ops import decode_rgb, load_image

    cfg = DataConfig()
    reader = FashionGenPretrain(str(tree), "train", cfg, seed=SEED)
    equal_native = differs_pil = 0
    pil_gap = 0.0
    for i in range(len(reader)):
        image = reader[i]["images"]
        equal_native += np.array_equal(image, native.native_crop_resize(
            decode_rgb(reader.images[i]), cfg.input_size))
        plain = load_image(reader.images[i], cfg.input_size)
        differs_pil += not np.array_equal(image, plain)
        pil_gap = max(pil_gap, float(np.abs(image - plain).max()))
    rates = {"on": [], "off": []}
    for key in ("on", "off", "off", "on"):
        timed_reader = FashionGenPretrain(str(tree), "train", dataclasses.replace(
            cfg, use_native_image_ops=key == "on"), seed=SEED)
        start = time.perf_counter()
        for i in range(len(timed_reader)):
            timed_reader[i]
        rates[key].append(len(timed_reader) / (time.perf_counter() - start))
    ok = (isinstance(reader.tokenizer, native.NativeTokenizer) and len(reader) == READER_ITEMS
          and equal_native == differs_pil == READER_ITEMS and pil_gap < 1.5 / 255)
    return {"library": str(native.library_path().relative_to(REPO)),
            "tokenizer": type(reader.tokenizer).__name__, "items": len(reader),
            "images_equal_native": equal_native, "images_differ_from_pil": differs_pil,
            "max_gap_to_pil": pil_gap, "items_per_s_native_on": rates["on"],
            "items_per_s_native_off": rates["off"], "input_size": cfg.input_size,
            "rate_method": "one host thread, __getitem__ over the 64 train items of the tree "
                           "(40x44 PNGs), turns on, off, off, on",
            "nvidia_smi": nvidia_smi_line(), "ok": ok}


def phase_cli_eval(stats: dict | None = None) -> None:
    """The downstream entry points on the card, as a user runs them, on a
    small Fashion-Gen tree under build/ and a reference-style .pth of seeded
    weights (every head): ``--eval-retrieval-itr`` and ``-tir`` with and
    without ``--parity-heads`` (configs/pretrain_exp21.py) and
    ``--eval-recognition`` (configs/finetune_exp48.py), each returning the
    metrics of the same reader and scorer run directly, kernels A and B
    launched and no training kernel; the recognition artifact; ``--viz``;
    one pre-training epoch on the tree's reader. The readers decode, crop
    and resize with Pillow, so the phase fails where it is not installed."""
    import PIL

    out = REPO / "build" / "chip_smoke_cli_eval"
    shutil.rmtree(out, ignore_errors=True)
    tree = out / "fashion_gen"
    write_fashion_gen_tree(tree)
    every = LossType(itm=True, mlm=True, t2i=True, cls=True)
    sd = seeded_state_dict(create_model(ModelConfig(name="pvlt_tiny", loss_type=every),
                                        device="cpu"), SEED)
    pth = out / "checkpoint_seeded.pth"
    torch.save({"model": sd, "epoch": 0}, pth)
    pretrain, finetune = (str(REPO / "configs" / c) for c in ("pretrain_exp21.py",
                                                              "finetune_exp48.py"))
    base = ["--data-path", str(tree), "--resume", str(pth), "--output-dir", str(out / "eval")]
    modes = {"itr": ["--config", pretrain, "--eval-retrieval-itr"],
             "tir": ["--config", pretrain, "--eval-retrieval-tir"],
             "itr_parity_heads": ["--config", pretrain, "--eval-retrieval-itr", "--parity-heads"],
             "tir_parity_heads": ["--config", pretrain, "--eval-retrieval-tir", "--parity-heads"],
             "recognition": ["--config", finetune, "--eval-recognition"]}
    try:
        reset_launches()
        got = {mode: cli.main(flags + base) for mode, flags in modes.items()}
        torch.cuda.synchronize()
        launches = read_launches()
        with open(out / "eval" / "visualization" / "recognition_predictions.json") as f:
            predictions = len(json.load(f)["sup_preds"])
        want = {mode: direct_eval(flags + base, str(tree), sd) for mode, flags in modes.items()}
        cli.main(["--config", pretrain, "--data-path", str(tree), "--finetune", str(pth),
                  "--viz", "--viz-samples", "4", "--output-dir", str(out / "viz")])
        viz = sorted(sorted(os.listdir(out / "viz" / "visualization" / d))
                     for d in os.listdir(out / "viz" / "visualization"))
        reset_launches()
        cli.main(["--config", pretrain, "--data-path", str(tree), "--epochs", "1",
                  "--output-dir", str(out / "pretrain")])
        torch.cuda.synchronize()
        train_launches = read_launches()
        (train_line,) = _train_log(out / "pretrain")
        native_reader = native_reader_check(tree)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    files = ["masked.png", "original.png", "predictions.txt", "reconstruction.png"]
    ok = (all(got[m] == want[m] for m in modes) and predictions == 10
          and all(got[m]["num_queries"] == 2 for m in modes if m != "recognition")
          and launches["sr_kv"] > 0 and launches["block_fused"] > 0
          and not any(launches[name] for name in WRAPPERS if name not in SERVING_WRAPPERS)
          and viz == [files] * 4
          and np.isfinite(train_line["total_loss"]) and "eval_quality_score" in train_line
          and all(train_launches[name] for name in (*TRAINING_WRAPPERS, *MLM_WRAPPERS))
          and native_reader["ok"])
    emit("cli_eval", pillow=PIL.__version__, native_reader=native_reader,
         results=got, direct_results_equal={
        m: got[m] == want[m] for m in modes}, recognition_predictions=predictions,
        launches=launches, viz_samples=viz, pretrain_on_reader=train_line,
        pretrain_launches=train_launches, ok=ok)
    if not ok:
        raise AssertionError(f"the downstream CLI failed its checks: native reader "
                             f"{native_reader['images_equal_native']} of {READER_ITEMS} "
                             f"images native ({native_reader['tokenizer']}), "
                             f"{got} vs {want}, launches {launches}, viz {viz}, {train_line}")


# ---- v2, linear-SR and Swin training, dropout, --remat, deeper models -------

# the block kernels of a training step, once per block and step: v2 and
# linear SR #10/#11 (the DWConv MLP in PyTorch), Swin #12/#13 (the window
# attention in PyTorch); the MLM CE kernels once per step as everywhere
V2_TRAIN_ROUTE = {"attention_fwd": attention_fwd, "attention_bwd": attention_bwd}
SWIN_TRAIN_ROUTE = {"ln_mlp_fwd": ln_mlp_fwd, "ln_mlp_bwd": ln_mlp_bwd}
# linear SR's K/V rows at the 256x256 stages that reduce (grid side -> M):
# floored pool windows of 9, 4 and 2 give 7x7, 8x8 and 8x8 cells, + 128 text
LINEAR_M = {64: 177, 32: 192, 16: 192}
# the window attention's training route against kernel F and its plain
# version: the pvlt_swin_tiny stages at 256 and 224 (a padded 28x28 grid),
# and F's ragged grid in windows of 4: (h, w, dim, heads, window)
SWIN_TRAIN_ATTN_SHAPES = [(64, 64, 64, 1, 8), (32, 32, 128, 2, 8), (16, 16, 320, 5, 8),
                          (8, 8, 512, 8, 8), (28, 28, 128, 2, 8), (10, 6, 96, 3, 4)]
# remat against no remat, one step from one generator seed: each loss, and
# each gradient relative to its tensor's largest magnitude
REMAT_TOL = 1e-3
# tensors held instead to twice what a repeat of the step without remat
# moves them by, where that is more than REMAT_TOL: none since the
# pos-embed resize became two fixed products (models/pvlt.py:resize_pos_embed)
REMAT_REPEAT_GAP: tuple = ()
# the wrappers a remat step launches twice (forward, then the recompute)
REMAT_RECOMPUTED = ("attention_fwd", "ln_mlp_fwd", "fba_train_fwd")
DEEPER = ("pvlt_small", "pvlt_medium", "pvlt_large", "pvlt_v2_small", "pvlt_swin_small")


def timed(name: str, fn, *args):
    """fn(*args), and a line with the seconds it took."""
    start = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    emit("phase_seconds", name=name, seconds=time.perf_counter() - start)
    return out


def swin_train_attention(gen, d: int, heads: int, ws: int, shift: bool):
    """A SwinJointAttention on the card in fp32 master parameters, Q and K/V
    of gain 1.5 / sqrt(D), the projection 1 / sqrt(D), biases 0.03, the
    relative-position table at std 0.5 (swin_block_params' scales)."""
    attn = SwinJointAttention(d, heads, ws, shift, True, ws)
    with torch.no_grad():
        for lin, gain in ((attn.q, 1.5), (attn.kv, 1.5), (attn.proj, 1.0)):
            lin.weight.copy_(gain * d ** -0.5 * torch.randn(lin.weight.shape, generator=gen))
            lin.bias.copy_(0.03 * torch.randn(lin.bias.shape, generator=gen))
        attn.relative_position_bias_table.normal_(0.0, 0.5, generator=gen)
    return attn.cuda()


def linear_kv_input_plain(normed, grid: int, w, b, g, be):
    """linear_reduce_kv_input written out in fp32 for a square grid: each
    pooled cell the mean of its floored window, the 1x1 conv as a product,
    LN, exact GELU, the text rows appended."""
    bsz, _, d = normed.shape
    win = grid // min(7, grid)
    cells = grid // win
    vis = normed[:, : grid * grid].float().reshape(bsz, grid, grid, d)[:, : cells * win,
                                                                       : cells * win]
    mean = vis.reshape(bsz, cells, win, cells, win, d).mean((2, 4)).reshape(bsz, -1, d)
    red = mean @ w.reshape(d, d).float().t() + b.float()
    red = F.gelu(F.layer_norm(red, (d,), g.float(), be.float(), 1e-5))
    return torch.cat([red, normed[:, grid * grid:].float()], dim=1)


def phase_train_glue(stats: dict) -> None:
    """The PyTorch glue new on the training paths, at the stage shapes, B =
    4, bf16: Swin's window attention on its training route (einsum,
    differentiable) against the same module's serving route on kernel F and
    on F's plain version, unshifted and shifted (every output within
    KERNEL_TOL); linear SR's K/V input against linear_kv_input_plain, with
    LINEAR_M rows at 64/32/16."""
    gen = torch.Generator().manual_seed(SEED + 23)
    errs = []
    for h, w, d, nh, window in SWIN_TRAIN_ATTN_SHAPES:
        for shift in (False, True):
            ws = min(window, h, w)
            attn = swin_train_attention(gen, d, nh, ws, shift)
            x = torch.randn(SMOKE_BATCH, h * w + TEXT, d, generator=gen).cuda().to(torch.bfloat16)
            train = attn.train()(x, (h, w), TEXT)
            with torch.no_grad():
                kernel = attn.eval()(x, (h, w), TEXT)
                plain = attn(x, (h, w), TEXT, attention=swin_attention_reference)
            err = max(_rel_err(train, plain)[1], _rel_err(kernel, plain)[1])
            errs.append([f"{h}x{w}/{ws}", shift, _rel_err(train, plain)[1],
                         _rel_err(kernel, plain)[1]])
            stats["swin_attention"]["max_abs_err"] = max(stats["swin_attention"]["max_abs_err"],
                                                         _rel_err(kernel, plain)[0])
            if err > KERNEL_TOL:
                raise AssertionError(f"Swin window attention at {h}x{w}, window {ws}, shift "
                                     f"{shift}: training route vs plain, kernel F vs plain "
                                     f"{errs[-1][2:]} (tol {KERNEL_TOL})")
    lin = []
    for grid, d in ((64, 64), (32, 128), (16, 320)):
        normed = torch.randn(SMOKE_BATCH, grid * grid + TEXT, d, generator=gen)
        w = torch.randn(d, d, 1, 1, generator=gen) * d ** -0.5
        b, be = (0.03 * torch.randn(d, generator=gen) for _ in range(2))
        g = 1 + 0.03 * torch.randn(d, generator=gen)
        normed, w, b, g, be = (t.cuda() for t in (normed.to(torch.bfloat16), w, b, g, be))
        got = linear_reduce_kv_input(normed, (grid, grid), w, b, g, be, 1e-5)
        want = linear_kv_input_plain(normed, grid, w, b, g, be)
        if got.shape[1] != LINEAR_M[grid] or want.shape[1] != LINEAR_M[grid]:
            raise AssertionError(f"linear SR at {grid}x{grid}: {got.shape[1]} K/V rows, plain "
                                 f"{want.shape[1]}, expected {LINEAR_M[grid]}")
        lin.append([grid, got.shape[1], _rel_err(got, want)[1]])
        if lin[-1][2] > KERNEL_TOL:
            raise AssertionError(f"linear SR's K/V input at {grid}x{grid} is {lin[-1][2]} off "
                                 f"its plain version (tol {KERNEL_TOL})")
    emit("train_glue", batch=SMOKE_BATCH,
         swin_window_attention=[["grid/window", "shift", "train_vs_plain", "kernel_vs_plain"]]
         + errs, linear_kv_input=[["grid", "rows", "rel_err"]] + lin, tol=KERNEL_TOL, ok=True)


def phase_v2_route(stats: dict) -> None:
    """A v2 step with fused_attn_train and fused_attn_stats set: the fused
    attention half is v1's route (mvlt_tpu/models/pvlt.py:861-866), so
    #10/#11 launch once per block and the fused wrappers never."""
    cfg = dataclasses.replace(train_config(), name="pvlt_v2_tiny", fused_attn_train=True,
                              fused_attn_stats=True)
    model = create_model(cfg)
    model.load_state_dict(seeded_state_dict(model, SEED), strict=True)
    state = create_train_state(model, OptimConfig(warmup_epochs=0), CPU_BATCH, 1, seed=SEED)
    batch = batch_to_device(train_batch(SEED, CPU_BATCH), "cuda")
    reset_launches()
    _, losses = make_train_step(cfg)(state, batch)
    launches = read_launches()
    blocks = sum(model.cfg.depths)
    want = {"attention_fwd": blocks, "attention_bwd": blocks, "fba_train_fwd": 0,
            "fba_train_bwd": 0, "mlm_ce_fwd": 1, "mlm_ce_bwd": 1}
    ok = all(launches[k] == n for k, n in want.items()) and all(
        np.isfinite(float(v)) for v in losses.values())
    emit("v2_route", model=cfg.name, batch=CPU_BATCH, fused_attn_train=True, launches=launches,
         launches_expected=want, ok=ok)
    if not ok:
        raise AssertionError(f"a v2 step with fused_attn_train launched {launches}, "
                             f"expected {want}")


def phase_family_train(stats: dict, name: str, route: dict, prefix: str) -> None:
    """``name`` pre-trains as pvlt_tiny does in phase 9 (configs/pretrain_exp21.py's
    objective, B = 150, bf16, TRAIN_STEPS steps; ``route``'s kernels once
    per block and step, the MLM CE kernels once per step, nothing else;
    falling loss, BatchNorm statistics moved), every block of a step vs
    plain, ms/step with a profile, and a 4-sample step vs the CPU fp32 step.
    The kernels line keeps phase 9's launches."""
    cfg = dataclasses.replace(train_config(), name=name)
    state, cfg, sd, batch = phase_train_slice(stats, cfg, prefix + "train_slice", route, {})
    check_train_blocks(state, cfg, batch, prefix + "train_blocks_vs_plain")
    phase_train_throughput(state, cfg, prefix)
    del state, batch
    torch.cuda.empty_cache()
    compare_train_cpu(cfg, sd, {prefix + "train_vs_cpu_fp32": (False, False)})


def phase_linear(stats: dict) -> None:
    """pvlt_v2_linear_tiny: serving (kernels C and D once per block, kernel A
    only at stage 4, where sr = 1; the linear SR front end in PyTorch with
    LINEAR_M K/V rows), its blocks vs plain, ITM logits vs the CPU fp32
    model, pairs/s and a profile; then its training as phase_family_train."""
    per_forward = {"sr_kv": 2, "block_attention": 8, "dwconv_mlp": 8}
    model, bundles, sd = phase_slice(stats, "pvlt_v2_linear_tiny", V2_SERVING_WRAPPERS,
                                     "linear_slice", per_forward=per_forward, record=False)
    check_v2_blocks(model, bundles[0], "linear_slice_blocks_vs_plain")
    compare_cpu_fp32(model, bundles[0], sd, "linear_slice_vs_cpu_fp32")
    phase_throughput(model, bundles, V2_GROUPS, "linear_")
    del model
    torch.cuda.empty_cache()
    phase_family_train(stats, "pvlt_v2_linear_tiny", V2_TRAIN_ROUTE, "linear_")


def phase_dropout(stats: dict) -> None:
    """A v1 pre-training step with drop_rate = attn_drop_rate = 0.1: no
    block kernel (the JAX routing: no LN-MLP kernel with drop_rate, no
    attention kernel with attn_drop_rate in training mode, no fused half),
    the MLM CE kernels once per step; finite, falling losses; ms/step."""
    cfg = dataclasses.replace(train_config(), drop_rate=0.1, attn_drop_rate=0.1)
    state, cfg, _, _ = phase_train_slice(stats, cfg, "dropout_train_slice", {}, {})
    phase_train_throughput(state, cfg, "dropout_")
    del state
    torch.cuda.empty_cache()


def remat_pair(cfg: ModelConfig, batch: dict, phase: str, expected: dict) -> None:
    """One step of ``cfg`` without remat, again without it, and with it,
    each from the same weights and generator seed on ``batch``: every loss
    within REMAT_TOL, every gradient within REMAT_TOL of its tensor's
    largest magnitude (a tensor of REMAT_REPEAT_GAP: or twice the two runs
    without remat's own gap on it), the pos-embeds' gradients bit-equal
    over the two runs without remat, the generators in the same state
    after, the forward wrappers of REMAT_RECOMPUTED launched twice as often
    with remat, and the peak memory lower with it; then ms/step of each."""
    sd = None
    runs = {}
    for label, remat in (("plain", False), ("again", False), ("remat", True)):
        run_cfg = dataclasses.replace(cfg, remat=remat)
        model = create_model(run_cfg)
        sd = sd or seeded_state_dict(model, SEED)
        model.load_state_dict(sd, strict=True)
        state = create_train_state(model, OptimConfig(warmup_epochs=0), TRAIN_BATCH, 1,
                                   seed=SEED)
        step = make_train_step(run_cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        _, losses = step(state, batch)
        torch.cuda.synchronize()
        runs[label] = {
            "losses": {k: float(v) for k, v in losses.items()},
            "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()
                      if p.grad is not None},
            "rng": state.generator.get_state().cpu(), "launches": read_launches(),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "ms_per_step": (cuda_time_ms(lambda: step(state, batch), warmup=1, reps=3)
                            if label != "again" else None)}
        del model, state, step
        torch.cuda.empty_cache()
    plain, again, remat = runs["plain"], runs["again"], runs["remat"]
    loss_err = max(abs(remat["losses"][k] - v) / max(abs(v), 1e-12)
                   for k, v in plain["losses"].items() if v)

    def gaps(run):
        return {n: (run["grads"][n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
                for n, g in plain["grads"].items()}

    grad_err, floor = gaps(remat), gaps(again)
    bad = {n: (e, floor[n]) for n, e in grad_err.items()
           if e > (max(REMAT_TOL, 2 * floor[n]) if n in REMAT_REPEAT_GAP else REMAT_TOL)}
    pos_repeat_equal = all(torch.equal(again["grads"][n], g) for n, g in plain["grads"].items()
                           if "pos_embed" in n)
    repeat_gaps = {n: e for n, e in sorted(floor.items(), key=lambda kv: -kv[1]) if e}
    worst = max(grad_err, key=grad_err.get)
    above = sorted((n for n, e in grad_err.items() if e > REMAT_TOL), key=grad_err.get)[-5:]
    want = {k: n * (2 if k in REMAT_RECOMPUTED else 1) for k, n in expected.items()}
    launches_ok = all(plain["launches"][k] == expected.get(k, 0)
                      and remat["launches"][k] == want.get(k, 0) for k in WRAPPERS)
    rng_equal = torch.equal(plain["rng"], remat["rng"])
    ok = (loss_err <= REMAT_TOL and not bad and rng_equal and launches_ok and pos_repeat_equal
          and sorted(plain["grads"]) == sorted(remat["grads"])
          and remat["peak_gib"] < plain["peak_gib"])
    emit(phase, model=cfg.name, batch=TRAIN_BATCH, drop_path_rate=cfg.drop_path_rate,
         bert_dropout=cfg.bert_dropout, drop_rate=cfg.drop_rate,
         fused_attn_train=cfg.fused_attn_train, fused_attn_stats=cfg.fused_attn_stats,
         losses=plain["losses"], rel_err_losses=loss_err, rel_err_grads=grad_err[worst],
         worst_tensor=worst, worst_tensor_floor=floor[worst],
         above_tol={n: [grad_err[n], floor[n]] for n in above},
         rel_err_grads_repeat=max(floor.values()), repeat_gaps=dict(list(repeat_gaps.items())[:8]),
         pos_embed_grads_repeat_bit_equal=pos_repeat_equal, failing=bad,
         generator_equal=rng_equal,
         launches=plain["launches"], launches_remat=remat["launches"],
         launches_expected=expected, launches_remat_expected=want,
         peak_gib=plain["peak_gib"], peak_gib_remat=remat["peak_gib"],
         ms_per_step=plain["ms_per_step"], ms_per_step_remat=remat["ms_per_step"],
         method="first step's peak by torch.cuda.max_memory_allocated; ms by CUDA events, "
                "1 warm-up, median of 3 further steps", tol=REMAT_TOL, ok=ok)
    if not ok:
        raise AssertionError(f"{phase}: remat vs not: losses {loss_err}, gradients {bad} "
                             f"(tensor: error, repeat's gap), generator equal {rng_equal}, "
                             f"launches {launches_ok}, pos-embeds' repeat bit-equal "
                             f"{pos_repeat_equal}, peaks {plain['peak_gib']} / "
                             f"{remat['peak_gib']} GiB (tol {REMAT_TOL})")


def phase_remat(stats: dict) -> None:
    """remat_pair for pvlt_tiny at B = 150 on the default route with
    DropPath, BERT dropout and drop_rate 0.1 (#10/#11 launched, the MLP
    glue), and on fused_attn_stats with DropPath and BERT dropout (the
    fused half takes no drop_rate)."""
    batch = batch_to_device(train_batch(SEED, TRAIN_BATCH), "cuda")
    base = train_config()
    blocks = sum(base.depths)
    mlm = {"mlm_ce_fwd": 1, "mlm_ce_bwd": 1}
    remat_pair(dataclasses.replace(base, drop_rate=0.1), batch, "remat_default",
               {"attention_fwd": blocks, "attention_bwd": blocks, **mlm})
    remat_pair(dataclasses.replace(base, fused_attn_train=True, fused_attn_stats=True), batch,
               "remat_fused_attn_stats",
               {"fba_train_fwd": blocks, "fba_train_bwd": blocks, "ln_mlp_fwd": blocks,
                "ln_mlp_bwd": blocks, **mlm})


def phase_remat_large(stats: dict) -> None:
    """remat_pair for pvlt_large (depths 3/8/27/3) at B = 150 with
    configs/pretrain_exp21.py's regularisers, the case remat exists for
    (mvlt_tpu/models/pvlt.py:1196-1199)."""
    batch = batch_to_device(train_batch(SEED, TRAIN_BATCH), "cuda")
    cfg = dataclasses.replace(train_config(), name="pvlt_large")
    blocks = sum((3, 8, 27, 3))
    remat_pair(cfg, batch, "remat_pvlt_large",
               {"attention_fwd": blocks, "attention_bwd": blocks, "ln_mlp_fwd": blocks,
                "ln_mlp_bwd": blocks, "mlm_ce_fwd": 1, "mlm_ce_bwd": 1})


def phase_registry(stats: dict) -> None:
    """Each deeper model of the registry serves one B = 101 bundle through
    evaluate_retrieval (v1: A and B, v2: A, C and D, once per block; Swin at
    256: E on every block), with the ITM head's input of 4 rows within
    SLICE_TOL of the same weights in fp32 on the CPU and the ITM logits
    beside it: pvlt_small's seeded logits are ~0.05, and the CPU's own bf16
    plain path puts them 13% off fp32 (relative to the largest), so no bf16
    model could hold them to SLICE_TOL."""
    paths = {"v1": SERVING_WRAPPERS, "v2": V2_SERVING_WRAPPERS, "swin": {"swin_block":
                                                                         fused_swin_block}}
    for name in DEEPER:
        variant = resolve_model_config(ModelConfig(name=name)).variant
        model, bundles, sd = phase_slice(stats, name, paths[variant], f"registry_{name}",
                                         n_bundles=1, record=False)
        compare_cpu_fp32(model, bundles[0], sd, f"registry_{name}_vs_cpu_fp32", rows=4,
                         hold="features")
        del model
        torch.cuda.empty_cache()

# ---- data parallelism (mvlt_tpu_torch/parallel/) ---------------------------

DDP_DIR = REPO / "build" / "chip_smoke_ddp"
DDP_TOL = 1e-3      # a DDP step's losses, gradients and BatchNorm statistics, relative
                    # to each tensor's largest magnitude, unless the step's own noise is more:
# the one-process step on the same rows in another order (the batch's
# halves swapped) moves gradients too: the T2I head's BatchNorms couple
# every row, and bf16 roundings of their outputs cascade into the
# backbone's gradients; a gradient may differ by SWAP_FACTOR times the
# largest such move over all tensors. A tensor's own move does not bound
# it: the ranks' B = 75 shapes round otherwise than B = 150 does, and move
# tensors that neither the swap nor the rows dealt to the ranks alternately
# (printed beside each of the largest ratios) move as much. A fault of the
# gradients alone, such as the cross-rank sums' backward unreduced, lands
# thousands of times over this bound (chip_faults.py:bn_grad_unreduced)
SWAP_FACTOR = 2.0
# a gradient that autograd forms in bf16 (every element bf16-valued in the
# one-process step) carries each rank's rounding of its partial and the
# one-process rounding of the total: up to BF16_SPACING of each magnitude
BF16_SPACING = 2.0 ** -8
FIRST_BN = ("t2i_head.reduction1.1.", "t2i_head.reduction2.1.", "t2i_head.reduction3.1.")
ZERO_TOL = 1e-6     # ZeRO-1's parameters after AdamW against the plain AdamW's


def moment_bytes(optimizer) -> int:
    """The bytes of an optimizer's AdamW moments on this rank."""
    return sum(t.numel() * t.element_size() for st in optimizer.state.values()
               for k, t in st.items() if k in ("exp_avg", "exp_avg_sq"))


def zero1_parts(params, data: int) -> dict:
    """The fp32 AdamW moments of ``params`` (a rank's, its tensor-parallel
    shards marked) under ZeRO-1 by element over ``data`` ranks: the bytes
    of those that split (parallel/sharding.py:zero1_dim), of those every
    rank keeps whole, and what a rank must hold: sharded / data + whole."""
    from mvlt_tpu_torch.parallel.sharding import zero1_dim

    params = [p for p in params if p.requires_grad]
    sharded = sum(8 * p.numel() for p in params if zero1_dim(p, data) is not None)
    whole = sum(8 * p.numel() for p in params if zero1_dim(p, data) is None)
    return {"sharded_bytes": sharded, "replicated_bytes": whole,
            "rank_bytes": sharded // data + whole}
DDP_BUNDLES = 3
DDP_ITEMS = 10
PRETRAIN_CONFIG = REPO / "configs" / "pretrain_exp21.py"


_SEEDED: dict = {}


def seeded_weights(model) -> dict:
    """seeded_state_dict(model, SEED), made once in a process per set of
    tensor names and shapes."""
    key = tuple((n, tuple(t.shape)) for n, t in model.state_dict().items())
    if key not in _SEEDED:
        _SEEDED[key] = seeded_state_dict(model, SEED)
    return _SEEDED[key]


def ddp_config() -> ModelConfig:
    """pvlt_tiny at full width with configs/pretrain_exp21.py's heads and
    routes, DropPath and dropout off: the comparisons' config."""
    return ModelConfig(name="pvlt_tiny", compute_dtype="bfloat16", drop_path_rate=0.0,
                       bert_dropout=0.0)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_ranks(role: str, world: int, spec: dict, timeout: float,
                torchrun: bool = False) -> list:
    """Run ``chip_smoke.py --ddp-rank <role>`` as ``world`` ranks (through
    torch.distributed.run, or with the torchrun environment set here, all on
    cuda:0); each writes its results to DDP_DIR/<role>_<rank>.json. Raises
    RuntimeError with the ranks' output if one fails, TimeoutExpired if the
    timeout passes."""
    DDP_DIR.mkdir(parents=True, exist_ok=True)
    spec_path = DDP_DIR / f"{role}.json"
    spec_path.write_text(json.dumps(spec))
    port = free_port()
    rank_cmd = [str(REPO / "chip_smoke.py"), "--ddp-rank", role, str(spec_path)]
    if torchrun:
        cmds = [[sys.executable, "-m", "torch.distributed.run", f"--nproc_per_node={world}",
                 "--master_addr=127.0.0.1", f"--master_port={port}", *rank_cmd]]
        envs = [dict(os.environ)]
    else:
        cmds = [[sys.executable, *rank_cmd] for _ in range(world)]
        envs = [{**os.environ, "RANK": str(r), "WORLD_SIZE": str(world), "LOCAL_RANK": str(r),
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)} for r in range(world)]
    procs = [subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd, env in zip(cmds, envs)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):   # a crash, not a failed check
        raise RuntimeError(f"{role}: a rank failed: " + " | ".join(
            f"rc {p.returncode}: {o[-1500:]} {e[-2500:]}" for p, (o, e) in zip(procs, outs)))
    return [json.loads((DDP_DIR / f"{role}_{r}.json").read_text()) for r in range(world)]


def grads_of(model) -> dict:
    return {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()
            if p.grad is not None}


def rel_gaps(got: dict, want: dict) -> dict:
    """Per tensor, the largest gap between two dicts of tensors relative to
    the ``want`` tensor's largest magnitude."""
    assert sorted(got) == sorted(want), (sorted(set(got) ^ set(want)))[:5]
    return {n: float((got[n].double() - w.double()).abs().max())
            / max(float(w.double().abs().max()), 1e-30) for n, w in want.items()}


def max_rel_gap(got: dict, want: dict) -> tuple[float, str]:
    """The largest of ``rel_gaps`` and the tensor's name."""
    gaps = rel_gaps(got, want)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def top_gaps(gaps: dict, want: dict, k: int = 12) -> list:
    """The ``k`` largest gaps: [name, gap, largest magnitude, elements]."""
    return [[n, gaps[n], float(want[n].abs().max()), want[n].numel()]
            for n in sorted(gaps, key=gaps.get, reverse=True)[:k]]


def loss_gap(got: dict, want: dict) -> float:
    return max(abs(got[k] - v) / max(abs(v), 1e-12) for k, v in want.items() if v)


def ddp_world1_rank(spec: dict) -> None:
    """The rank of ``ddp_world1`` (torchrun, one process, NCCL): the CLI's
    epoch with the launch counts, the rank-0 checkpoint loaded by
    ``load_eval_model`` and with strict names, then one DDP step against
    the unwrapped step from the same weights, generator and batch."""
    from mvlt_tpu_torch.parallel import mesh
    from mvlt_tpu_torch.parallel.sharding import wrap_model
    from mvlt_tpu_torch.utils.checkpoint import STATE_FILE

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launches()
    start = time.perf_counter()
    cli.main(spec["argv"])
    torch.cuda.synchronize()
    cli_seconds = time.perf_counter() - start
    launches = read_launches()
    backend, world = torch.distributed.get_backend(), mesh.world_size()
    device = torch.device("cuda", torch.cuda.current_device())
    saved = torch.load(pathlib.Path(spec["run"]) / "checkpoint" / "last" / STATE_FILE,
                       map_location="cpu", weights_only=True)["model"]
    run_cfg = cli.build_run_config(cli.get_args_parser().parse_args(
        spec["argv"] + ["--resume", spec["run"]]))
    eval_model = cli.load_eval_model(run_cfg, device)
    eval_model.load_state_dict(saved, strict=True)
    strict_names = (sorted(saved) == sorted(eval_model.state_dict())
                    and not any(k.startswith("module.") for k in saved))
    del eval_model

    cfg = ddp_config()
    batch = batch_to_device(train_batch(SEED, TRAIN_BATCH), device)
    runs = {}
    for label in ("plain", "ddp"):
        model = create_model(cfg, device=device)
        model.load_state_dict(seeded_weights(model), strict=True)
        ddp = wrap_model(model, device) if label == "ddp" else None
        state = create_train_state(model, OptimConfig(warmup_epochs=0), TRAIN_BATCH, 1,
                                   seed=SEED, ddp=ddp)
        _, losses = make_train_step(cfg)(state, batch)
        runs[label] = ({k: float(v) for k, v in losses.items()}, grads_of(model))
        del model, state, ddp
    gap, worst = max_rel_gap(runs["ddp"][1], runs["plain"][1])
    (pathlib.Path(spec["out"]) / "world1_0.json").write_text(json.dumps({
        "launches": launches, "backend": backend, "world": world, "cli_seconds": cli_seconds,
        "strict_names": strict_names, "checkpoint_tensors": len(saved),
        "step_grad_gap": gap, "step_grad_gap_tensor": worst,
        "step_loss_gap": loss_gap(runs["ddp"][0], runs["plain"][0]),
        "losses": runs["ddp"][0]}))
    mesh.destroy()


def phase_ddp_world1(stats: dict) -> None:
    """Data parallelism at world 1 through the user's entry point:
    ``python -m torch.distributed.run --nproc_per_node=1`` running
    ``mvlt_tpu_torch.cli.main`` with configs/pretrain_exp21.py on synthetic
    data (B = 150, 2 epochs of one step, the VL eval on the sharded path in
    epoch 1) on NCCL, the first run of phase ``cli`` again: finite losses
    and eval statistics, a rank-0 checkpoint with the reference's names
    that ``load_eval_model`` loads strictly, and every wrapper launched as
    often as in that run without a process group. Then, in the rank, one
    DDP step against the unwrapped step from the same state and batch: each
    loss and gradient within DDP_TOL of its tensor's largest magnitude (the
    largest gap printed)."""
    out = DDP_DIR / "world1"
    shutil.rmtree(out, ignore_errors=True)
    # phase_cli's first run: its launches without a process group
    argv = ["--config", str(PRETRAIN_CONFIG), "--synthetic-data", "--epochs", "2"]
    try:
        if not CLI_PRETRAIN_LAUNCHES:   # the phase run on its own
            reset_launches()
            cli.main(argv + ["--output-dir", str(out / "plain")])
            torch.cuda.synchronize()
            CLI_PRETRAIN_LAUNCHES.update(read_launches())
        plain = dict(CLI_PRETRAIN_LAUNCHES)
        torch.cuda.empty_cache()
        run = out / "ddp"
        start = time.perf_counter()
        (res,) = spawn_ranks("world1", 1, {"argv": argv + ["--output-dir", str(run)],
                                           "run": str(run), "out": str(DDP_DIR)},
                             timeout=600, torchrun=True)
        seconds = time.perf_counter() - start
        log = _train_log(run)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    finite = all(np.isfinite(v) for line in log for v in line.values())
    evals = {k: v for k, v in log[-1].items() if k.startswith("eval_")}
    ok = (res["backend"] == "nccl" and res["world"] == 1 and len(log) == 2 and finite
          and bool(evals) and res["strict_names"] and res["launches"] == plain
          and all(plain[k] for k in (*TRAINING_WRAPPERS, *MLM_WRAPPERS))
          and res["step_grad_gap"] <= DDP_TOL and res["step_loss_gap"] <= DDP_TOL)
    emit("ddp_world1", config="configs/pretrain_exp21.py", batch=TRAIN_BATCH,
         backend=res["backend"], world=res["world"], launches=res["launches"],
         launches_without_process_group=plain, strict_names=res["strict_names"],
         checkpoint_tensors=res["checkpoint_tensors"], losses=log, eval_stats=evals,
         step_grad_gap=res["step_grad_gap"], step_grad_gap_tensor=res["step_grad_gap_tensor"],
         step_loss_gap=res["step_loss_gap"], tol=DDP_TOL, cli_seconds=res["cli_seconds"],
         seconds=seconds, ok=ok)
    if not ok:
        raise AssertionError(f"ddp_world1 failed its checks: {res}, log {log}, "
                             f"launches without a process group {plain}")


def eval_models(device) -> tuple:
    """(ITM-only model for retrieval, CLS-only model for recognition),
    pvlt_tiny in bf16 with seeded weights, in eval mode."""
    models = []
    for heads in (LossType(itm=True, mlm=False, t2i=False, cls=False), CLS_HEADS):
        model = create_model(ModelConfig(name="pvlt_tiny", compute_dtype="bfloat16",
                                         loss_type=heads), device=device)
        model.load_state_dict(seeded_weights(model), strict=True)
        models.append(model.eval())
    return tuple(models)


def ddp_evals(device, artifact_dir: pathlib.Path, shard_of=None) -> dict:
    """Retrieval over DDP_BUNDLES bundles and recognition over DDP_ITEMS
    items (batch 500: one ragged batch), sharded with ``shard_of(n)``; the
    metrics, and the recognition artifact's labels and predictions (None on
    a rank other than 0, which writes none)."""
    itm, cls_model = eval_models(device)
    bundles = synthetic_bundles(DDP_BUNDLES, SEED + 5, 256, 128)
    items = RecognitionItems(DDP_ITEMS, SEED + 6, 256, 128)
    shard = shard_of(len(bundles)) if shard_of else None
    retrieval = evaluate_retrieval(make_itm_scorer(itm), cli._simple_loader(bundles, 1, shard),
                                   is_main=False, shard=shard)
    shard = shard_of(len(items)) if shard_of else None
    main = shard is None or shard.rank == 0
    rec = evaluate_recognition(make_cls_scorer(cls_model),
                               cli._simple_loader(items, REC_BATCH, shard), is_main=main,
                               shard=shard, artifact_dir=str(artifact_dir))
    preds = None
    if main:
        with open(artifact_dir / "recognition_predictions.json") as f:
            art = json.load(f)
        preds = {k: art[k] for k in ("sup_labels", "sup_preds", "sub_labels", "sub_preds")}
    return {"retrieval": retrieval, "recognition": rec, "recognition_predictions": preds}


def ddp_two_ranks_rank(spec: dict) -> None:
    """A rank of ``ddp_two_ranks`` (gloo, both ranks on cuda:0): one DDP
    step at B = 75 (its rows of the B = 150 batch); the same step with the
    rows dealt to the ranks alternately (what regrouping the rows alone
    moves); the same step under ZeRO-1 through
    ``create_train_state(zero1=True)`` and ``make_train_step``, its state
    consolidated and saved by ``CheckpointManager``; the step's time; and
    the sharded evals."""
    from torch.distributed.algorithms.ddp_comm_hooks import default_hooks

    from mvlt_tpu_torch.parallel import mesh
    from mvlt_tpu_torch.parallel.sharding import EvalShard, wrap_model
    from mvlt_tpu_torch.utils.checkpoint import STATE_FILE, CheckpointManager

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = mesh.maybe_init_distributed(device="cuda:0", backend="gloo")
    rank, world = mesh.rank(), mesh.world_size()
    cfg = ddp_config()
    host = dict(np.load(spec["batch"]))
    share = TRAIN_BATCH // world

    def rows_of(rows):
        return batch_to_device({k: v[rows] for k, v in host.items()}, device)

    def ddp_state(zero1=False):
        """A DDP model from the seeded weights and its state at step 0."""
        net = create_model(cfg, device=device)
        net.load_state_dict(seeded_weights(net), strict=True)
        wrap = wrap_model(net, device)
        return net, wrap, create_train_state(net, OptimConfig(warmup_epochs=0), TRAIN_BATCH,
                                             1, seed=SEED + rank, ddp=wrap, zero1=zero1)

    batch = rows_of(slice(rank * share, (rank + 1) * share))
    model, ddp, state = ddp_state()
    names = {id(p): n for n, p in model.named_parameters()}
    partial_max = {}

    def recording_hook(group, bucket):
        """DDP's all-reduce, after noting each gradient's largest magnitude
        on this rank before the reduction."""
        for p, g in zip(bucket.parameters(), bucket.gradients()):
            partial_max[names[id(p)]] = g.detach().abs().max()
        return default_hooks.allreduce_hook(group, bucket)

    ddp.register_comm_hook(None, recording_hook)
    step = make_train_step(cfg)
    reset_launches()
    _, losses = step(state, batch)
    torch.cuda.synchronize()
    launches = read_launches()
    partials = {n: float(v) for n, v in partial_max.items()}   # this step's (the timing reruns)
    grads = grads_of(model)
    after = {n: p.detach().clone() for n, p in model.named_parameters()}
    buffers = {n: b.detach().float().cpu() for n, b in model.named_buffers()}
    sums = torch.tensor([float(losses[k]) for k in sorted(losses)], dtype=torch.float64,
                        device=device)
    torch.distributed.all_reduce(sums)
    mean_losses = dict(zip(sorted(losses), (sums / world).tolist()))
    checksum = torch.tensor([sum(float(g.double().sum()) for g in grads.values())],
                            dtype=torch.float64, device=device)
    both = torch.zeros(world, dtype=torch.float64, device=device)
    both[rank] = checksum[0]
    torch.distributed.all_reduce(both)

    net, wrap, probe = ddp_state()
    step(probe, rows_of(slice(rank, None, world)))
    dealt_grads = grads_of(net)
    del net, wrap, probe

    # the same step under ZeRO-1, through the port's state and step, then
    # its AdamW state consolidated on rank 0 and saved as the CLI saves it
    net, wrap, zstate = ddp_state(zero1=True)
    step(zstate, batch)
    torch.cuda.synchronize()
    zero_gap = max(float((p - after[n]).abs().max()) for n, p in net.named_parameters())
    zero_bytes = moment_bytes(zstate.optimizer)
    zero_parts = zero1_parts(net.parameters(), world)
    full_bytes = 2 * sum(p.numel() * p.element_size() for p in net.parameters()
                         if p.requires_grad)
    ckpt_dir = pathlib.Path(spec["out"]) / "zero1_run"
    CheckpointManager(str(ckpt_dir)).save_epoch(zstate, 0, 1)
    saved_gap = saved_names = None
    if rank == 0:   # the consolidated moments against the plain AdamW's
        saved = torch.load(ckpt_dir / "checkpoint" / "last" / STATE_FILE, map_location="cpu",
                           weights_only=True)
        plain_moments = state.optimizer.state_dict()["state"]
        saved_moments = saved["optimizer"]["state"]
        saved_names = (sorted(saved["model"]) == sorted(model.state_dict())
                       and sorted(saved_moments) == sorted(plain_moments))
        saved_gap = max(float((saved_moments[i][k].float().cpu() - v.float().cpu()).abs().max())
                        for i, st in plain_moments.items()
                        for k, v in st.items() if k in ("exp_avg", "exp_avg_sq"))
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del net, wrap, zstate

    # one call of two steps (scan_steps=2) on this rank's rows twice, against
    # two single DDP steps (in bits) here and one process's call in the phase
    net, wrap, sstate = ddp_state()
    _, scan_losses = make_train_step(cfg, scan_steps=2)(
        sstate, {k: torch.stack([v, v]) for k, v in batch.items()})
    scan_grads = grads_of(net)   # the second step's
    scan_buffers = {n: b.detach().float().cpu() for n, b in net.named_buffers()}
    net2, wrap2, twice = ddp_state()
    _, first = step(twice, batch)
    _, second = step(twice, batch)
    scan_gaps = state_gaps(twice, sstate)
    scan_equal = scan_gaps["equal"] and all(
        torch.equal(scan_losses[k], torch.stack([first[k], second[k]])) for k in first)
    scan_sums = torch.stack([scan_losses[k].double() for k in sorted(scan_losses)])
    torch.distributed.all_reduce(scan_sums)
    scan_mean_losses = dict(zip(sorted(scan_losses), (scan_sums / world).tolist()))
    del net, wrap, sstate, net2, wrap2, twice

    ms = cuda_time_ms(lambda: step(state, batch), warmup=1, reps=3)
    del state, model
    torch.cuda.empty_cache()
    evals = ddp_evals(device, pathlib.Path(spec["out"]) / f"rank{rank}", EvalShard.of_this_rank)
    out = pathlib.Path(spec["out"])
    if rank == 0:
        torch.save({"grads": grads, "buffers": buffers, "dealt_grads": dealt_grads,
                    "scan_grads": scan_grads, "scan_buffers": scan_buffers},
                   out / "two_ranks_tensors.pt")
    (out / f"two_ranks_{rank}.json").write_text(json.dumps({
        "world": world, "backend": torch.distributed.get_backend(), "launches": launches,
        "losses": {k: float(v) for k, v in losses.items()}, "mean_losses": mean_losses,
        "grad_checksums": both.tolist(), "zero1_param_gap": zero_gap,
        "zero1_moment_bytes": zero_bytes, "zero1_parts": zero_parts,
        "full_moment_bytes": full_bytes,
        "zero1_saved_moment_gap": saved_gap, "zero1_saved_names": saved_names,
        "partial_max": partials, "ms_per_step": ms, "scan_mean_losses": scan_mean_losses,
        "scan_equal_singles": scan_equal, "scan_single_gaps": scan_gaps, **evals}))
    mesh.destroy()


def phase_ddp_two_ranks(stats: dict) -> None:
    """Two ranks on the one card over gloo (NCCL refuses two ranks on one
    device), pvlt_tiny at full width with the pre-training heads, DropPath
    and dropout off, host masks, seeded weights: one step at B = 75 a rank
    against this process's step at B = 150. Each loss within DDP_TOL; each
    gradient within DDP_TOL of its tensor's largest magnitude or, where
    more, within the step's own noise: SWAP_FACTOR times the largest move
    of any gradient when this process takes the same step on the rows in
    another order (the batch's halves swapped), to which a gradient
    autograd forms in bf16 (bf16-valued in the one-process step) adds
    BF16_SPACING of the largest rank partial (read by a comm hook before
    the reduction) plus the total's largest magnitude (each rank rounds its
    partial to bf16 before DDP adds them, where one process rounds the
    total once). The largest ratios print each tensor's own moves, under
    the swap and with the rows dealt to the ranks alternately, and the
    worst gap over a bound from a tensor's own moves is printed. The
    BatchNorm running statistics within DDP_TOL (the backbone-reading ones
    printed apart).
    Every training wrapper launched as in the one-process step. The same
    two-rank step under ZeRO-1 through the port's state and step (the
    parameters within ZERO_TOL of the plain two-rank step's, each rank
    holding exactly half of every moment ZeRO-1 splits by element and the
    whole of the others (zero1_parts), the state consolidated and saved
    by CheckpointManager with the moments of the plain step), and retrieval
    over DDP_BUNDLES bundles and recognition over DDP_ITEMS items sharded
    over the ranks, whose metrics (and rank 0's recognition artifact's
    predictions) equal this process's. The two-rank step's ms beside the
    one-process step's: gloo through host copies, not a speed of NCCL
    DDP."""
    cfg = ddp_config()
    DDP_DIR.mkdir(parents=True, exist_ok=True)
    host = train_batch(SEED, TRAIN_BATCH)
    arrays = {k: v for k, v in host.items() if isinstance(v, np.ndarray)}
    np.savez(DDP_DIR / "batch.npz", **arrays)
    model = create_model(cfg)
    model.load_state_dict(seeded_weights(model), strict=True)
    state = create_train_state(model, OptimConfig(warmup_epochs=0), TRAIN_BATCH, 1, seed=SEED)
    step = make_train_step(cfg)
    batch = batch_to_device(arrays, "cuda")
    reset_launches()
    _, losses = step(state, batch)
    torch.cuda.synchronize()
    launches = read_launches()
    want_losses = {k: float(v) for k, v in losses.items()}
    want_grads = grads_of(model)
    want_buffers = {n: b.detach().float().cpu() for n, b in model.named_buffers()}
    one_ms = cuda_time_ms(lambda: step(state, batch), warmup=1, reps=3)
    del state, model
    # one call of two steps on the batch twice (scan_steps=2), as the ranks take it
    model = create_model(cfg)
    model.load_state_dict(seeded_weights(model), strict=True)
    state = create_train_state(model, OptimConfig(warmup_epochs=0), TRAIN_BATCH, 1, seed=SEED)
    _, scan_losses = make_train_step(cfg, scan_steps=2)(
        state, {k: torch.stack([v, v]) for k, v in batch.items()})
    want_scan_losses = {k: v.tolist() for k, v in scan_losses.items()}
    want_scan_grads = grads_of(model)
    want_scan_buffers = {n: b.detach().float().cpu() for n, b in model.named_buffers()}
    del state, model
    # the same step on the batch with its halves swapped: what the order of
    # the rows alone moves each tensor by
    half = TRAIN_BATCH // 2
    swapped = {k: torch.cat([v[half:], v[:half]]) for k, v in batch.items()}
    model = create_model(cfg)
    model.load_state_dict(seeded_weights(model), strict=True)
    state = create_train_state(model, OptimConfig(warmup_epochs=0), TRAIN_BATCH, 1, seed=SEED)
    step(state, swapped)
    swap_grads = rel_gaps(grads_of(model), want_grads)
    swap_buffers = rel_gaps({n: b.detach().float().cpu() for n, b in model.named_buffers()},
                            want_buffers)
    del state, model, batch, swapped
    torch.cuda.empty_cache()
    want_evals = ddp_evals(torch.device("cuda"), DDP_DIR / "one_process")
    torch.cuda.empty_cache()
    start = time.perf_counter()
    try:
        ranks = spawn_ranks("two_ranks", 2, {"batch": str(DDP_DIR / "batch.npz"),
                                             "out": str(DDP_DIR)}, timeout=600)
        got = torch.load(DDP_DIR / "two_ranks_tensors.pt", weights_only=True)
    finally:
        shutil.rmtree(DDP_DIR, ignore_errors=True)
    seconds = time.perf_counter() - start
    # each gradient against its bound: DDP_TOL of its largest magnitude, or
    # the step's reordering noise, plus for a gradient formed in bf16 the
    # roundings of the ranks' partials and of the one-process total
    grad_gaps = rel_gaps(got["grads"], want_grads)
    swap_max = max(swap_grads.values())
    dealt = rel_gaps(got["dealt_grads"], got["grads"])
    own = {n: g / max(DDP_TOL, SWAP_FACTOR * max(swap_grads[n], dealt[n]))
           for n, g in grad_gaps.items()}
    own_worst = max(own, key=own.get)
    bf16_formed = {n for n, w in want_grads.items()
                   if torch.equal(w.to(torch.bfloat16).float(), w)}
    bounds = {}
    for n, w in want_grads.items():
        big = float(w.abs().max())
        rel = max(DDP_TOL, SWAP_FACTOR * swap_max)
        if n in bf16_formed:   # the roundings add to the reordering's noise
            partial = max(r["partial_max"][n] for r in ranks)
            rel += BF16_SPACING * (partial + big) / max(big, 1e-30)
        bounds[n] = rel
    ratios = {n: grad_gaps[n] / bounds[n] for n in grad_gaps}
    worst_ratio = max(ratios, key=ratios.get)
    bn_gaps = rel_gaps(got["buffers"], want_buffers)
    first_bn = {n: g for n, g in bn_gaps.items() if n.startswith(FIRST_BN)}
    chained_bn = {n: g for n, g in bn_gaps.items() if n not in first_bn}
    l_gap = loss_gap(ranks[0]["mean_losses"], want_losses)
    # the dispatched pair: each step's losses, the second step's gradients
    # under the first step's bounds, the BatchNorm statistics after both
    scan_l_gap = max(loss_gap({k: v[i] for k, v in ranks[0]["scan_mean_losses"].items()},
                              {k: v[i] for k, v in want_scan_losses.items()}) for i in (0, 1))
    scan_grad_gaps = rel_gaps(got["scan_grads"], want_scan_grads)
    scan_ratios = {n: scan_grad_gaps[n] / bounds[n] for n in scan_grad_gaps}
    scan_worst = max(scan_ratios, key=scan_ratios.get)
    scan_bn_gap = max(rel_gaps(got["scan_buffers"], want_scan_buffers).values())
    checks = {
        "backend_gloo_world_2": all(r["backend"] == "gloo" and r["world"] == 2 for r in ranks),
        "grads_equal_on_both_ranks": len(set(ranks[0]["grad_checksums"])) == 1,
        "losses": l_gap <= DDP_TOL, "grads": ratios[worst_ratio] <= 1.0,
        "batchnorms": len(first_bn) == 6 and max(bn_gaps.values()) <= DDP_TOL,
        "launches": all(r["launches"] == launches for r in ranks)
        and all(launches[k] for k in (*TRAINING_WRAPPERS, *MLM_WRAPPERS)),
        "zero1_params": all(r["zero1_param_gap"] <= ZERO_TOL for r in ranks),
        "zero1_saved": ranks[0]["zero1_saved_names"] is True
        and ranks[0]["zero1_saved_moment_gap"] <= ZERO_TOL,
        "zero1_moments_split": all(r["zero1_moment_bytes"] == r["zero1_parts"]["rank_bytes"]
                                   for r in ranks),
        "scan_equal_two_single_steps": all(r["scan_equal_singles"] for r in ranks),
        "scan_vs_one_process": scan_l_gap <= DDP_TOL and scan_ratios[scan_worst] <= 1.0
        and scan_bn_gap <= DDP_TOL,
        "retrieval_equal": all(r["retrieval"] == want_evals["retrieval"] for r in ranks)
        and want_evals["retrieval"]["num_queries"] == DDP_BUNDLES,
        "recognition_equal": all(r["recognition"] == want_evals["recognition"] for r in ranks)
        and ranks[0]["recognition_predictions"] == want_evals["recognition_predictions"]
        and len(want_evals["recognition_predictions"]["sup_preds"]) == DDP_ITEMS,
    }
    diag = {"top_grad_gaps": [g + [bounds[g[0]], swap_grads[g[0]]]
                              for g in top_gaps(grad_gaps, want_grads)],
            "top_grad_ratios": [[n, ratios[n], grad_gaps[n], bounds[n], swap_grads[n], dealt[n]]
                                for n in sorted(ratios, key=ratios.get, reverse=True)[:8]],
            "worst_gap_over_own_moves": [own_worst, own[own_worst]],
            "grads_over_half_bound": sum(r > 0.5 for r in ratios.values()),
            "grads_bf16_formed": len(bf16_formed), "grads_total": len(want_grads),
            "grads_above_tol": sum(g > DDP_TOL for g in grad_gaps.values()),
            "first_batchnorm_gaps": first_bn,
            "top_chained_bn_gaps": [g + [swap_buffers[g[0]]]
                                    for g in top_gaps(chained_bn, want_buffers, 6)],
            "swap_grad_gap_max": max(swap_grads.values()),
            "dealt_grad_gap_max": max(dealt.values()),
            "swap_bn_gap_max": max(swap_buffers.values())}
    ok = all(checks.values())
    emit("ddp_two_ranks", model="pvlt_tiny", batch_per_rank=TRAIN_BATCH // 2,
         global_batch=TRAIN_BATCH, checks=checks, rel_err_losses=l_gap,
         rel_err_grads=grad_gaps[max(grad_gaps, key=grad_gaps.get)],
         worst_grad_tensor=max(grad_gaps, key=grad_gaps.get),
         worst_grad_over_bound=[worst_ratio, ratios[worst_ratio]],
         rel_err_first_batchnorms=max(first_bn.values()),
         rel_err_chained_batchnorms=max(chained_bn.values()), tol=DDP_TOL,
         swap_factor=SWAP_FACTOR, bf16_spacing=BF16_SPACING,
         rank_losses=[r["losses"] for r in ranks], losses_one_process=want_losses,
         launches=[r["launches"] for r in ranks], launches_one_process=launches,
         zero1_param_gap=[r["zero1_param_gap"] for r in ranks], zero_tol=ZERO_TOL,
         zero1_moment_bytes=[r["zero1_moment_bytes"] for r in ranks],
         zero1_saved_moment_gap=ranks[0]["zero1_saved_moment_gap"],
         zero1_parts=ranks[0]["zero1_parts"], full_moment_bytes=ranks[0]["full_moment_bytes"],
         retrieval=ranks[0]["retrieval"], recognition=ranks[0]["recognition"],
         ms_per_step_two_ranks=[r["ms_per_step"] for r in ranks], ms_per_step_one_process=one_ms,
         scan_rel_err_losses=scan_l_gap, scan_worst_grad_over_bound=[
             scan_worst, scan_ratios[scan_worst]], scan_rel_err_batchnorms=scan_bn_gap,
         scan_single_gaps=[r["scan_single_gaps"] for r in ranks],
         ms_note="two ranks over gloo on one card: gradients all-reduced through host copies, "
                 "not a speed of NCCL DDP; CUDA events, 1 warm-up, median of 3 steps",
         seconds=seconds, **diag, ok=ok)
    if not ok:
        raise AssertionError(f"ddp_two_ranks failed {[k for k, v in checks.items() if not v]}: "
                             f"losses {l_gap}, gradient over its bound {worst_ratio} "
                             f"{ratios[worst_ratio]}, BatchNorms {max(bn_gaps.values())}, "
                             f"retrieval "
                             f"{[r['retrieval'] for r in ranks]} vs {want_evals['retrieval']}")


# ---- tensor parallelism ---------------------------------------------------

TP_SIZES = (2, 4)
TP_MLM_ROWS = MLM_ROWS
TP_EVAL_ITEMS = (32, 12)   # the VL eval's batches: one full, one ragged
# the launches of one tensor-parallel step a rank: #10/#11 and the LN-MLP
# kernels' tensor-parallel modes once per block, the MLM CE kernels' once
TP_STEP_LAUNCHES = {"attention_fwd": 8, "attention_bwd": 8, "ln_mlp_fwd_tp": 8,
                    "ln_mlp_bwd_tp": 8, "mlm_ce_fwd_tp": 1, "mlm_ce_bwd_tp": 1}
# on the fused_attn_train route: #6-#8's tensor-parallel modes on the four
# blocks whose heads split over two ranks (stages 2 and 4), the unsharded
# launch on the other four (stages 1 and 3: 1 and 5 heads)
TP_FBA_LAUNCHES = {"fba_train_fwd": 4, "fba_train_bwd": 4, "fba_train_fwd_tp": 4,
                   "fba_train_bwd_tp": 4, "ln_mlp_fwd_tp": 8, "ln_mlp_bwd_tp": 8,
                   "mlm_ce_fwd_tp": 1, "mlm_ce_bwd_tp": 1}
# tp_two_ranks' other routes: (config overrides on ddp_config, a split
# step's launches a rank); through the logits the MLM loss is PyTorch's
# matmul and the vocabulary-parallel cross entropy, no MLM CE kernel
TP_ROUTES = {
    "fused": ({"fused_attn_train": True}, TP_FBA_LAUNCHES),
    "fused_stats": ({"fused_attn_train": True, "fused_attn_stats": True}, TP_FBA_LAUNCHES),
    "mlm_logits": ({"mlm_loss_chunk": 0},
                   {k: v for k, v in TP_STEP_LAUNCHES.items() if "mlm" not in k}),
}


def tp_hidden_slices(mlp: tuple, rank: int, tp: int) -> tuple:
    """(W1, b1, W2) of rank ``rank``'s slice of the hidden."""
    _, _, w1, b1, w2, _ = mlp
    return shard_tensor(w1, ROW, rank, tp), shard_tensor(b1, ROW, rank, tp), \
        shard_tensor(w2, COL, rank, tp)


def tp_mlp_sums(a: dict, tp: int) -> tuple:
    """#12's and #13's tensor-parallel modes on each of ``tp`` slices of the
    hidden, summed in fp32 in this process as the model group sums them,
    with b2, x and dy added once: (y,), (dx, dgamma, dbeta, dW1, db1, dW2,
    db2), and every slice's db2 (each must be the whole one)."""
    g, be, _, _, _, b2 = a["mlp"]
    x, s, dy = a["x"], a["s"], a["dy"]
    parts, grads = [], []
    for r in range(tp):
        w1, b1, w2 = tp_hidden_slices(a["mlp"], r, tp)
        parts.append(ln_mlp_fwd_tp(x, g, be, w1, b1, w2, s, 1e-6))
        grads.append(ln_mlp_bwd_tp(x, g, be, w1, b1, w2, s, 1e-6, dy))
    y = (x.float() + sum(parts) + s[:, None, None] * b2).to(x.dtype)
    dx = (dy.float() + sum(o[0] for o in grads)).to(x.dtype)
    whole = (dx, sum(o[1] for o in grads), sum(o[2] for o in grads),
             torch.cat([o[3] for o in grads]), torch.cat([o[4] for o in grads]),
             torch.cat([o[5] for o in grads], dim=1), grads[0][6])
    return (y,), whole, [o[6] for o in grads]


def tp_bounds(shape: tuple, batch: int, tp: int) -> dict:
    """(ms, bound_by) of one rank's launch of #12's and #13's
    tensor-parallel modes: the products on H / tp of the hidden, the stream
    (and dy) read in bf16, the fp32 partial written, the slice's bf16
    weights read and (backward) its fp32 gradients written."""
    h, w, d, _, _, hid, t = shape
    rows, hl = batch * (h * w + t), hid // tp
    return {"ln_mlp_fwd_tp": bound(4 * rows * d * hl, 2 * rows * d + 4 * rows * d + 2 * 2 * d * hl),
            "ln_mlp_bwd_tp": bound(10 * rows * d * hl, 2 * 2 * rows * d + 4 * rows * d
                                   + 2 * 2 * d * hl + 4 * 2 * d * hl)}


def tp_mlm_bounds(rows: int, vocab: int) -> dict:
    """(ms, bound_by) of one rank's launch of #14's and #15's
    tensor-parallel modes on ``vocab`` rows of the table (mlm_bounds' work
    on the rank's share)."""
    r, h, v = rows, MLM_WIDTH, vocab
    operands = 2 * r * h + 2 * v * h + 4 * v + 4 * r
    return {"mlm_ce_fwd_tp": bound(2 * r * v * h, operands + 2 * 4 * r),
            "mlm_ce_bwd_tp": bound(6 * r * v * h,
                                   operands + 2 * 4 * r + 4 * (r * h + v * h + v))}


def check_tp_errors(stats: dict, name: str, label: str, keys: tuple, got, unsharded,
                    plain, **fields) -> None:
    """A tensor-parallel mode's summed outputs against the unsharded kernel's
    and the plain version's, each within KERNEL_TOL."""
    errs = {f"{against}_{k}": _rel_err(g, w_) for against, want in
            (("kernel", unsharded), ("plain", plain)) for k, g, w_ in zip(keys, got, want)}
    worst = max(e[1] for e in errs.values())
    ok = bool(worst <= KERNEL_TOL and np.isfinite(worst))
    emit("kernel_check", kernel=name, shape=label, rel_err={k: e[1] for k, e in errs.items()},
         tol=KERNEL_TOL, ok=ok, **fields)
    if not ok:
        raise AssertionError(f"{name} (summed over the ranks) disagrees at {label}: {errs} "
                             f"(tol {KERNEL_TOL})")
    stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"],
                                     max(e[0] for e in errs.values()))


def tp_time(stats: dict, name: str, label: str, kernel, unsharded, plain, bound_pair,
            **fields) -> None:
    """One rank's launch of a tensor-parallel mode by CUDA events, beside the
    unsharded kernel's launch and the mode's plain version on the same
    slice; summed into its kernels-line entry."""
    ms, unsharded_ms, plain_ms = cuda_time_ms(kernel), cuda_time_ms(unsharded), cuda_time_ms(plain)
    bound_ms, bound_by = bound_pair
    emit("kernel_time", kernel=name, shape=label, ms=ms, unsharded_ms=unsharded_ms,
         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
         device_ms=device_time_ms(kernel), **fields)
    add_time(stats, name, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
             library_ms=None)


# #6-#8's tensor-parallel modes: the pvlt_tiny stages whose heads split
# (stages 2 and 4 at tp 2, stage 4 at tp 4) and a ragged shape of four
# heads of 32 (N = 67, M = 22)
FBA_TP_RAGGED = (6, 10, 128, 4, 2, 512, 7)


def fba_tp_slices(a: dict, rank: int, tp: int) -> tuple:
    """(K, V, Wq, bq, Wp) of rank ``rank``'s heads: K and V its heads, Wq
    and bq their rows, Wp their columns."""
    _, _, wq, bq, wp, _ = a["params"]
    hr = a["kw"]["heads"] // tp
    heads = slice(rank * hr, (rank + 1) * hr)
    return (a["k"][:, heads].contiguous(), a["v"][:, heads].contiguous(),
            shard_tensor(wq, ROW, rank, tp), shard_tensor(bq, ROW, rank, tp),
            shard_tensor(wp, COL, rank, tp))


def fba_tp_sums(a: dict, tp: int, with_stats: bool) -> tuple:
    """#6 (#7 ``with_stats``) and #8's tensor-parallel modes on each of
    ``tp`` slices of the heads, summed in fp32 in this process as the
    model group sums them, with s bp, x and dy added once: (out,), the nine
    gradients of the whole (each slice's stats feeding its backward), and
    every slice's dbp (each must be the whole one)."""
    g, be, _, _, _, bp = a["params"]
    x, s, dy = a["x"], a["s"], a["dy"]
    hr = a["kw"]["heads"] // tp
    parts, grads = [], []
    for r in range(tp):
        k, v, wq, bq, wp = fba_tp_slices(a, r, tp)
        res = block_attention_train_fwd_tp(x, k, v, g, be, wq, bq, wp, s, heads=hr, eps=1e-6,
                                           save_stats=with_stats)
        part, st = res if with_stats else (res, None)
        parts.append(part)
        grads.append(block_attention_train_bwd_tp(x, k, v, g, be, wq, bq, wp, s, dy, heads=hr,
                                                  eps=1e-6, stats=st))
    out = (x.float() + sum(parts) + s[:, None, None] * bp).to(x.dtype)
    dx = (dy.float() + sum(o[0] for o in grads)).to(x.dtype)
    whole = (dx, torch.cat([o[1] for o in grads], 1), torch.cat([o[2] for o in grads], 1),
             sum(o[3] for o in grads), sum(o[4] for o in grads),
             torch.cat([o[5] for o in grads]), torch.cat([o[6] for o in grads]),
             torch.cat([o[7] for o in grads], 1), grads[0][8])
    return (out,), whole, [o[8] for o in grads]


def fba_tp_bounds(shape: tuple, batch: int, tp: int) -> dict:
    """(ms, bound_by) of one rank's launch of #6-#8's tensor-parallel modes
    on H / tp heads, dh = D / tp wide: fba_bounds' work on the rank's
    heads (the products and K/V of dh columns), x (and dy) read in bf16,
    the fp32 partial out (dx) written, the slice's bf16 Wq and Wp read and
    (backward) their fp32 gradients and dgamma, dbeta, dbq, dbp written."""
    h, w, d, nh, sr, hid, t = shape
    n = h * w + t
    m = (h // sr) * (w // sr) + t if sr > 1 else n
    dh = d // tp
    rows, kv, st = batch * n, batch * m * dh, 4 * batch * n * (2 + 2 * nh // tp)
    fwd_bytes = 2 * rows * d + 4 * rows * d + 2 * 2 * kv + 2 * 2 * d * dh
    bwd_bytes = (2 * 2 * rows * d + 4 * rows * d + 2 * 4 * kv + 2 * 2 * d * dh
                 + 4 * (2 * d * dh + dh + 3 * d))
    fwd_flops = 4 * rows * (d * dh + m * dh)
    bwd_flops = 10 * rows * d * dh + 12 * rows * m * dh
    return {"fba_train_fwd_tp": bound(fwd_flops, fwd_bytes),
            "fba_train_fwd_stats_tp": bound(fwd_flops, fwd_bytes + st),
            "fba_train_bwd_tp": bound(bwd_flops, bwd_bytes),
            "fba_train_bwd_stats_tp": bound(bwd_flops, bwd_bytes + st)}


def check_fba_tp(stats: dict, gen, label: str, shape: tuple, batch: int,
                 time_tp: int = 0) -> None:
    """#6/#7/#8's tensor-parallel modes at every tp of TP_SIZES that divides
    the shape's heads, in both forms, summed over the slices and held to
    the unsharded kernel of the same form and to the plain version within
    KERNEL_TOL; #8's dbp whole on every slice. At ``time_tp`` one rank's
    launch of each is timed beside the unsharded launch and its plain
    version on the same slice."""
    a = fba_inputs(gen, shape, batch)
    kw = a["kw"]
    for with_stats in (False, True):
        sfx = "_stats" if with_stats else ""
        res_k = block_attention_train_fwd(*_fba_fwd_args(a), save_stats=True, **kw)
        res_p = block_attention_train_reference(*_fba_fwd_args(a), save_stats=True, **kw)
        fwd_k, fwd_p = (res_k[0],), (res_p[0],)
        bwd_k = block_attention_train_bwd(*_fba_bwd_args(a), stats=res_k[1] if with_stats
                                          else None, **kw)
        bwd_p = block_attention_bwd_reference(*_fba_bwd_args(a), stats=res_p[1] if with_stats
                                              else None, **kw)
        for tp in TP_SIZES:
            if kw["heads"] % tp:
                continue
            out, grads, dbps = fba_tp_sums(a, tp, with_stats)
            torch.cuda.synchronize()
            fields = dict(batch=batch, tp=tp, heads=kw["heads"], heads_per_rank=kw["heads"] // tp)
            check_tp_errors(stats, f"fba_train_fwd{sfx}_tp", label, ("out",), out, fwd_k, fwd_p,
                            **fields)
            check_tp_errors(stats, f"fba_train_bwd{sfx}_tp", label, FBA_GRADS, grads, bwd_k,
                            bwd_p, **fields)
            if not all(torch.equal(d, dbps[0]) for d in dbps):
                raise AssertionError(f"#8's tensor-parallel dbp differs between slices at {label}")
            del out, grads, dbps
        del res_k, res_p, bwd_k, bwd_p
    if time_tp:
        g, be, *_ = a["params"]
        x, s, dy = a["x"], a["s"], a["dy"]
        k, v, wq, bq, wp = fba_tp_slices(a, 0, time_tp)
        hr = kw["heads"] // time_tp
        _, st = block_attention_train_fwd_tp(x, k, v, g, be, wq, bq, wp, s, heads=hr, eps=1e-6,
                                             save_stats=True)
        _, st_ref = block_attention_train_reference(x, k, v, g, be, wq, bq, wp, None, s,
                                                    heads=hr, eps=1e-6, save_stats=True,
                                                    partial=True)
        _, st_whole = block_attention_train_fwd(*_fba_fwd_args(a), save_stats=True, **kw)
        bounds = fba_tp_bounds(shape, batch, time_tp)
        for with_stats in (False, True):
            sfx = "_stats" if with_stats else ""
            tp_time(stats, f"fba_train_fwd{sfx}_tp", label,
                    lambda: block_attention_train_fwd_tp(x, k, v, g, be, wq, bq, wp, s,
                                                         heads=hr, eps=1e-6,
                                                         save_stats=with_stats),
                    lambda: block_attention_train_fwd(*_fba_fwd_args(a), save_stats=with_stats,
                                                      **kw),
                    lambda: block_attention_train_reference(x, k, v, g, be, wq, bq, wp, None, s,
                                                            heads=hr, eps=1e-6,
                                                            save_stats=with_stats, partial=True),
                    bounds[f"fba_train_fwd{sfx}_tp"], batch=batch, tp=time_tp)
            tp_time(stats, f"fba_train_bwd{sfx}_tp", label,
                    lambda: block_attention_train_bwd_tp(x, k, v, g, be, wq, bq, wp, s, dy,
                                                         heads=hr, eps=1e-6,
                                                         stats=st if with_stats else None),
                    lambda: block_attention_train_bwd(*_fba_bwd_args(a), stats=st_whole
                                                      if with_stats else None, **kw),
                    lambda: block_attention_bwd_reference(x, k, v, g, be, wq, bq, wp, s, dy,
                                                          heads=hr, eps=1e-6,
                                                          stats=st_ref if with_stats else None,
                                                          partial=True),
                    bounds[f"fba_train_bwd{sfx}_tp"], batch=batch, tp=time_tp)
    del a
    torch.cuda.empty_cache()


def phase_fba_tp_kernels(stats: dict) -> None:
    """check_fba_tp on the pvlt_tiny stages whose heads split over 2 or 4
    ranks (B = 150, one rank's launch at tp 2 timed) and on FBA_TP_RAGGED
    (B = 4)."""
    gen = torch.Generator().manual_seed(SEED + 24)
    for i, (h, w, d, nh, sr, hid) in enumerate(STAGES):
        if nh % 2 == 0:
            check_fba_tp(stats, gen, f"stage{i + 1}", (h, w, d, nh, sr, hid, TEXT), TRAIN_BATCH,
                         time_tp=2)
    check_fba_tp(stats, gen, "ragged", FBA_TP_RAGGED, SMOKE_BATCH)


def phase_tp_kernels(stats: dict) -> None:
    """The tensor-parallel modes of #12/#13 at H / 2 and H / 4 (pvlt_tiny's
    stage shapes at B = 150 and a ragged shape at B = 4) and of #14/#15 at
    V / 2 (R = 3,072, labels in both halves and ignored rows), each summed
    over the slices in fp32 in this process and held to the unsharded
    kernel and to the plain version within KERNEL_TOL; #13's db2 whole on
    every slice. At tp = 2 one rank's launch is timed beside the unsharded
    launch and the mode's plain version. Then #6-#8's modes on a rank's
    heads (phase_fba_tp_kernels)."""
    gen = torch.Generator().manual_seed(SEED + 23)
    shapes = [(f"stage{i + 1}", (h, w, d, nh, sr, hid, TEXT), TRAIN_BATCH)
              for i, (h, w, d, nh, sr, hid) in enumerate(STAGES)]
    for label, shape, batch in shapes + [("ragged", TRAIN_RAGGED, SMOKE_BATCH)]:
        a = train_kernel_inputs(gen, shape, batch)
        fwd_k, bwd_k = (ln_mlp_fwd(*_mlp_fwd_args(a)),), ln_mlp_bwd(*_mlp_bwd_args(a))
        fwd_p, bwd_p = (ln_mlp_reference(*_mlp_fwd_args(a)),), ln_mlp_bwd_reference(
            *_mlp_bwd_args(a))
        for tp in TP_SIZES:
            y, grads, db2s = tp_mlp_sums(a, tp)
            torch.cuda.synchronize()
            fields = dict(batch=batch, tp=tp, hidden=shape[5], hidden_per_rank=shape[5] // tp)
            check_tp_errors(stats, "ln_mlp_fwd_tp", label, ("y",), y, fwd_k, fwd_p, **fields)
            check_tp_errors(stats, "ln_mlp_bwd_tp", label,
                            ("dx", "dgamma", "dbeta", "dW1", "db1", "dW2", "db2"), grads, bwd_k,
                            bwd_p, **fields)
            if not all(torch.equal(d, db2s[0]) for d in db2s):
                raise AssertionError(f"#13's tensor-parallel db2 differs between slices at {label}")
            del y, grads, db2s
        if batch == TRAIN_BATCH:
            g, be, _, _, _, _ = a["mlp"]
            w1, b1, w2 = tp_hidden_slices(a["mlp"], 0, 2)
            x, s, dy = a["x"], a["s"], a["dy"]
            bounds = tp_bounds(shape, batch, 2)
            tp_time(stats, "ln_mlp_fwd_tp", label,
                    lambda: ln_mlp_fwd_tp(x, g, be, w1, b1, w2, s, 1e-6),
                    lambda: ln_mlp_fwd(*_mlp_fwd_args(a)),
                    lambda: ln_mlp_reference(x, g, be, w1, b1, w2, None, s, 1e-6, partial=True),
                    bounds["ln_mlp_fwd_tp"], batch=batch, tp=2)
            tp_time(stats, "ln_mlp_bwd_tp", label,
                    lambda: ln_mlp_bwd_tp(x, g, be, w1, b1, w2, s, 1e-6, dy),
                    lambda: ln_mlp_bwd(*_mlp_bwd_args(a)),
                    lambda: ln_mlp_bwd_reference(x, g, be, w1, b1, w2, s, 1e-6, dy,
                                                 passthrough=False),
                    bounds["ln_mlp_bwd_tp"], batch=batch, tp=2)
        del a, fwd_k, bwd_k, fwd_p, bwd_p
        torch.cuda.empty_cache()

    x, table, bias, labels, g = mlm_inputs(gen, TP_MLM_ROWS, 0.15)
    half = VOCAB // 2
    starts = (0, half)
    if not all(bool(((labels >= s0) & (labels < s0 + half)).any()) for s0 in starts) \
            or not bool((labels < 0).any()):
        raise AssertionError("the MLM CE check's labels miss a half of the vocabulary")
    parts = [mlm_ce_fwd_tp(x, table[s0:s0 + half], bias[s0:s0 + half], labels, s0)
             for s0 in starts]
    lse = torch.logsumexp(torch.stack([p[0] for p in parts]), 0)
    nll = torch.where(labels >= 0, lse - sum(p[1] for p in parts), 0.0)
    grads = [mlm_ce_bwd_tp(x, table[s0:s0 + half], bias[s0:s0 + half], labels, lse, g, s0)
             for s0 in starts]
    summed = (sum(o[0] for o in grads), torch.cat([o[1] for o in grads]),
              torch.cat([o[2] for o in grads]))
    want_k, want_p = mlm_ce_fwd(x, table, bias, labels), mlm_nll_reference(x, table, bias, labels)
    torch.cuda.synchronize()
    fields = dict(rows=TP_MLM_ROWS, tp=2, vocab=VOCAB, vocab_per_rank=half,
                  labeled=int((labels >= 0).sum()))
    check_tp_errors(stats, "mlm_ce_fwd_tp", "path", ("nll", "lse"), (nll, lse), want_k, want_p,
                    **fields)
    check_tp_errors(stats, "mlm_ce_bwd_tp", "path", ("d_rows", "d_table", "d_bias"), summed,
                    mlm_ce_bwd(x, table, bias, labels, want_k[1], g),
                    mlm_nll_bwd_reference(x, table, bias, labels, want_p[1], g), **fields)
    bounds = tp_mlm_bounds(TP_MLM_ROWS, half)
    t0, b0 = table[:half].contiguous(), bias[:half].contiguous()
    tp_time(stats, "mlm_ce_fwd_tp", "path", lambda: mlm_ce_fwd_tp(x, t0, b0, labels, 0),
            lambda: mlm_ce_fwd(x, table, bias, labels),
            lambda: mlm_nll_partial_reference(x, t0, b0, labels, 0), bounds["mlm_ce_fwd_tp"],
            **fields)
    tp_time(stats, "mlm_ce_bwd_tp", "path", lambda: mlm_ce_bwd_tp(x, t0, b0, labels, lse, g, 0),
            lambda: mlm_ce_bwd(x, table, bias, labels, want_k[1], g),
            lambda: mlm_nll_bwd_reference(x, t0, b0, labels, lse, g, 0),
            bounds["mlm_ce_bwd_tp"], **fields)
    del x, table, bias, labels, g, parts, grads, summed
    torch.cuda.empty_cache()
    phase_fba_tp_kernels(stats)


def tp_eval_batches() -> list:
    """The VL eval's host batches of the tensor-parallel phase (synthetic
    pre-training items: clean and masked images, masked text, ITM labels)."""
    data = SyntheticFashionGen(DataConfig(), size=sum(TP_EVAL_ITEMS), seed=SEED + 29)
    items = [data[i] for i in range(len(data))]
    return [collate(items[:TP_EVAL_ITEMS[0]]), collate(items[TP_EVAL_ITEMS[0]:])]


def training_route_forward(self, x, hw, generator=None):
    """Block.forward on the training route whatever the mode (#10 and the
    one-process LN-MLP kernel): the route a split block takes in eval mode,
    for the one-process comparison."""
    return self.train_forward(x, hw, generator)


def tensors_digest(tensors: dict) -> str:
    """sha256 of the names and bytes of ``tensors`` in name order: equal
    on two ranks only where every tensor is equal bit for bit."""
    h = hashlib.sha256()
    for n in sorted(tensors):
        h.update(n.encode())
        h.update(tensors[n].contiguous().numpy().tobytes())
    return h.hexdigest()


def tp_two_ranks_rank(spec: dict) -> None:
    """A rank of ``tp_two_ranks`` (gloo, both ranks on cuda:0, tp = 2, dp =
    1): the step of pvlt_tiny split over the two ranks from the whole
    seeded weights at each parity on the whole B = 150 batch, its launches,
    its consolidated gradients, parameters and BatchNorm statistics, a
    checkpoint of the step-0 state, its time, a digest of each set of
    consolidated tensors (every rank's own, for ``ranks_equal``); step 0 on
    each route of TP_ROUTES (its launches, losses, consolidated tensors and
    digests); one step at configs/pretrain_exp21.py's DropPath and BERT
    dropout from this rank's seed; the VL eval of the split model."""
    from mvlt_tpu_torch.eval.vl_eval import evaluate_vl, make_vl_eval_fn
    from mvlt_tpu_torch.parallel import mesh
    from mvlt_tpu_torch.parallel.tensor import consolidate, shard_model
    from mvlt_tpu_torch.utils.checkpoint import CheckpointManager

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = mesh.maybe_init_distributed(device="cuda:0", backend="gloo")
    mesh.init_model_parallel(2)
    group, rank = mesh.model_group(), mesh.rank()
    batch = batch_to_device(dict(np.load(spec["batch"])), device)
    out = pathlib.Path(spec["out"])

    def split(cfg, step: int = 0):
        model = create_model(cfg, device=device)
        model.load_state_dict(seeded_weights(model), strict=True)   # whole, then the shard
        shard_model(model, group)
        state = create_train_state(model, OptimConfig(warmup_epochs=0), TRAIN_BATCH, 1,
                                   seed=mesh.rank_seed(SEED), model_group=group)
        state.step = step
        return model, state

    def whole(tensors: dict, cfg) -> dict:
        return {n: t.detach().float().cpu() for n, t in consolidate(tensors, group, cfg).items()}

    cfg = ddp_config()
    res, tensors = {"world": mesh.world_size(), "backend": torch.distributed.get_backend(),
                    "ranks": [mesh.data_rank(), mesh.model_rank()]}, {}
    for parity in (0, 1):
        model, state = split(cfg, parity)
        step = make_train_step(cfg)
        reset_launches()
        _, losses = step(state, batch)
        torch.cuda.synchronize()
        res[f"launches{parity}"] = read_launches()
        res[f"losses{parity}"] = {k: float(v) for k, v in losses.items()}
        tensors[f"grads{parity}"] = whole({n: p.grad for n, p in model.named_parameters()},
                                          model.cfg)
        if parity == 0:
            tensors["params"] = whole(dict(model.named_parameters()), model.cfg)
            tensors["buffers"] = {n: b.detach().float().cpu() for n, b in model.named_buffers()}
            CheckpointManager(str(out / "tp_run")).save_epoch(state, 0, 1)
            res["ms_per_step"] = cuda_time_ms(lambda: step(state, batch), warmup=1, reps=3)
        del model, state
        torch.cuda.empty_cache()
    for route, (overrides, _) in TP_ROUTES.items():
        route_cfg = dataclasses.replace(cfg, **overrides)
        model, state = split(route_cfg)
        reset_launches()
        _, losses = make_train_step(route_cfg)(state, batch)
        torch.cuda.synchronize()
        res[f"launches_{route}"] = read_launches()
        res[f"losses_{route}"] = {k: float(v) for k, v in losses.items()}
        tensors[f"route_{route}"] = consolidated(model, group)
        del model, state
        torch.cuda.empty_cache()
    # the masks: both ranks of the model group must draw the same
    drop_cfg = train_config()
    model, state = split(drop_cfg)
    _, losses = make_train_step(drop_cfg)(state, batch)
    res["dropout_losses"] = {k: float(v) for k, v in losses.items()}
    res["dropout_generator"] = state.generator.get_state().tolist()
    del model, state
    torch.cuda.empty_cache()
    model, _ = split(cfg)
    res["vl_eval"] = evaluate_vl(make_vl_eval_fn(model.eval(), cfg), tp_eval_batches(),
                                 is_main=False)
    res["digests"] = {k: tensors_digest(v) if not k.startswith("route_") else
                      {part: tensors_digest(t) for part, t in v.items()}
                      for k, v in tensors.items()}
    if rank == 0:
        torch.save(tensors, out / "tp_tensors.pt")
    (out / f"tp_two_ranks_{rank}.json").write_text(json.dumps(res))
    mesh.destroy()


def phase_tp_two_ranks(stats: dict) -> None:
    """Tensor parallelism on two gloo ranks on the one card (tp = 2, dp = 1;
    NCCL refuses two ranks on one device), pvlt_tiny at full width with
    configs/pretrain_exp21.py's heads, DropPath and dropout off, host masks,
    seeded weights, the whole B = 150 batch on each rank: one step at each
    parity against this process's step on the same weights and batch. The
    losses within DDP_TOL; each consolidated gradient within the bound of
    ddp_two_ranks (max(DDP_TOL, SWAP_FACTOR x the largest move of any
    gradient when this process takes the step on the batch's halves
    swapped), plus, for a gradient formed in bf16, BF16_SPACING of twice its
    largest magnitude: each side rounds it once); the BatchNorm statistics
    within DDP_TOL; both ranks' losses and VL eval equal, and their
    consolidated gradients (both parities), parameters after the step and
    BatchNorm statistics equal bit for bit (each rank's digest of its own:
    a replicated tensor that drifts on one rank shows). Per
    rank #10/#11 and the LN-MLP kernels' tensor-parallel modes launched once
    per block, the MLM CE kernels' once, nothing else. The consolidated
    checkpoint restores strictly in one process with the run's parameters.
    With pretrain_exp21's DropPath and BERT dropout on, both ranks draw the
    same masks (equal losses and generator states). The split model's VL
    eval against this process's on the same route (the blocks' training
    route; accuracies within one flip, losses within DDP_TOL), and beside
    the serving route's. The two-rank step's ms beside the one-process
    step's: gloo through host copies, not a speed of tensor parallelism.
    Then step 0 on each route of TP_ROUTES (the fused_attn_train route in
    both backward forms, #6-#8's tensor-parallel modes where the heads
    split; the MLM loss through the logits) against this process's step on
    the same route (compare_split_step: each gradient within the bound
    measured by that route's own swap of the batch's halves, the
    parameters within ZERO_TOL of AdamW's step on the consolidated
    gradients, the BatchNorm statistics, the losses within DDP_TOL), with
    exactly TP_ROUTES' launches a rank."""
    from mvlt_tpu_torch.eval.vl_eval import evaluate_vl, make_vl_eval_fn
    from mvlt_tpu_torch.utils.checkpoint import STATE_FILE, CheckpointManager

    cfg = ddp_config()
    DDP_DIR.mkdir(parents=True, exist_ok=True)
    arrays = {k: v for k, v in train_batch(SEED, TRAIN_BATCH).items() if isinstance(v, np.ndarray)}
    np.savez(DDP_DIR / "batch.npz", **arrays)
    batch = batch_to_device(arrays, "cuda")
    step = make_train_step(cfg)

    def one_process(b, parity: int = 0):
        model = create_model(cfg)
        model.load_state_dict(seeded_weights(model), strict=True)
        state = create_train_state(model, OptimConfig(warmup_epochs=0), TRAIN_BATCH, 1, seed=SEED)
        state.step = parity
        _, losses = step(state, b)
        return model, state, {k: float(v) for k, v in losses.items()}

    want = {}
    for parity in (0, 1):
        model, state, losses = one_process(batch, parity)
        want[parity] = (losses, grads_of(model))
        if parity == 0:
            want_params = {n: p.detach().float().cpu() for n, p in model.named_parameters()}
            want_buffers = {n: b.detach().float().cpu() for n, b in model.named_buffers()}
            one_ms = cuda_time_ms(lambda: step(state, batch), warmup=1, reps=3)
        del model, state
    half = TRAIN_BATCH // 2
    model, state, _ = one_process({k: torch.cat([v[half:], v[:half]]) for k, v in batch.items()})
    swap = rel_gaps(grads_of(model), want[0][1])
    del model, state
    swapped = {k: torch.cat([v[half:], v[:half]]) for k, v in batch.items()}
    want_routes, swap_routes = {}, {}
    for route, (overrides, _) in TP_ROUTES.items():
        route_cfg = dataclasses.replace(cfg, **overrides)
        want_routes[route] = one_process_step(route_cfg, batch, TRAIN_BATCH)
        swap_routes[route] = rel_gaps(one_process_step(route_cfg, swapped, TRAIN_BATCH)["grads"],
                                      want_routes[route]["grads"])
    del swapped
    model = create_model(cfg)
    model.load_state_dict(seeded_weights(model), strict=True)
    model.eval()
    with mock.patch.object(Block, "forward", training_route_forward):
        want_vl = evaluate_vl(make_vl_eval_fn(model, cfg), tp_eval_batches(), is_main=False)
    serving_vl = evaluate_vl(make_vl_eval_fn(model, cfg), tp_eval_batches(), is_main=False)
    del model, batch
    torch.cuda.empty_cache()
    start = time.perf_counter()
    try:
        ranks = spawn_ranks("tp_two_ranks", 2, {"batch": str(DDP_DIR / "batch.npz"),
                                                "out": str(DDP_DIR)}, timeout=600)
        got = torch.load(DDP_DIR / "tp_tensors.pt", weights_only=True)
        saved = torch.load(DDP_DIR / "tp_run" / "checkpoint" / "last" / STATE_FILE,
                           map_location="cpu", weights_only=True)
        reloaded = create_model(cfg)
        restored_state = create_train_state(reloaded, OptimConfig(warmup_epochs=0), TRAIN_BATCH, 1)
        CheckpointManager(str(DDP_DIR / "tp_run")).restore(restored_state, "last")
        restored = {n: p.detach().float().cpu() for n, p in reloaded.named_parameters()}
        del reloaded, restored_state
    finally:
        shutil.rmtree(DDP_DIR, ignore_errors=True)
    seconds = time.perf_counter() - start
    swap_max = max(swap.values())
    bf16_formed = {n for n, w in want[0][1].items() if torch.equal(w.to(torch.bfloat16).float(), w)}
    bounds = {n: max(DDP_TOL, SWAP_FACTOR * swap_max)
              + (2 * BF16_SPACING if n in bf16_formed else 0.0) for n in want[0][1]}
    ratios, gaps = {}, {}
    for parity in (0, 1):
        gaps[parity] = rel_gaps(got[f"grads{parity}"], want[parity][1])
        ratios[parity] = {n: g / bounds[n] for n, g in gaps[parity].items()}
    worst = {p: max(r, key=r.get) for p, r in ratios.items()}
    bn_gap = max(rel_gaps(got["buffers"], want_buffers).values())
    l_gaps = {p: loss_gap(ranks[0][f"losses{p}"], want[p][0]) for p in (0, 1)}
    expected = {name: TP_STEP_LAUNCHES.get(name, 0) for name in WRAPPERS}
    labels = [b["mlm_labels"] for b in tp_eval_batches()]
    counts = {"mlm_acc": sum(int((lb >= 0).sum()) for lb in labels),
              "itm_acc": sum(TP_EVAL_ITEMS)}
    vl = ranks[0]["vl_eval"]
    vl_gaps = {k: (abs(vl[k] - v) * counts[k] if k in counts
                   else abs(vl[k] - v) / max(abs(v), 1e-12)) for k, v in want_vl.items()}
    checks = {
        "backend_gloo_world_2": all(r["backend"] == "gloo" and r["world"] == 2 for r in ranks),
        "model_ranks": [r["ranks"] for r in ranks] == [[0, 0], [0, 1]],
        "losses": max(l_gaps.values()) <= DDP_TOL,
        "grads": max(ratios[p][worst[p]] for p in (0, 1)) <= 1.0,
        "batchnorms": bn_gap <= DDP_TOL,
        "ranks_equal": all(ranks[0][k] == ranks[1][k]
                           for k in ("losses0", "losses1", "vl_eval", "digests")),
        "launches": all(r[f"launches{p}"] == expected for r in ranks for p in (0, 1)),
        "checkpoint_tp1": sorted(saved["model"]) == sorted({**want_params, **want_buffers})
        and all(torch.equal(restored[n], got["params"][n]) for n in restored),
        "same_masks": ranks[0]["dropout_losses"] == ranks[1]["dropout_losses"]
        and ranks[0]["dropout_generator"] == ranks[1]["dropout_generator"],
        "vl_eval": all(vl_gaps[k] <= (1.0 if k in counts else DDP_TOL) for k in vl_gaps),
    }
    routes = {}
    for route, (_, launches) in TP_ROUTES.items():
        cmp = compare_split_step(got[f"route_{route}"], want_routes[route], swap_routes[route])
        r_gap = loss_gap(ranks[0][f"losses_{route}"], want_routes[route]["losses"])
        expected_r = {name: launches.get(name, 0) for name in WRAPPERS}
        route_checks = {"losses": r_gap <= DDP_TOL, "grads": cmp["grad_ratio"][1] <= 1.0,
                        "params": cmp["param_gap"][1] <= ZERO_TOL,
                        "batchnorms": cmp["bn_gap"] <= DDP_TOL,
                        "launches": all(r[f"launches_{route}"] == expected_r for r in ranks),
                        "ranks_equal": all(ranks[0][f"losses_{route}"] == r[f"losses_{route}"]
                                           and ranks[0]["digests"][f"route_{route}"]
                                           == r["digests"][f"route_{route}"] for r in ranks)}
        routes[route] = {"checks": route_checks, "rel_err_losses": r_gap,
                         "launches": ranks[0][f"launches_{route}"], **cmp}
        checks[f"route_{route}"] = all(route_checks.values())
    stats_launches = ranks[0]["launches0"]
    for name in TP_WRAPPERS:
        stats[name]["launches"] = stats_launches[name]
    for form, route in (("", "fused"), ("_stats", "fused_stats")):
        for half in ("fwd", "bwd"):
            stats[f"fba_train_{half}{form}_tp"]["launches"] = \
                ranks[0][f"launches_{route}"][f"fba_train_{half}_tp"]
    ok = all(checks.values())
    emit("tp_two_ranks", model="pvlt_tiny", tp=2, dp=1, batch=TRAIN_BATCH, checks=checks,
         rel_err_losses=l_gaps, worst_grad_over_bound={p: [worst[p], ratios[p][worst[p]]]
                                                      for p in (0, 1)},
         rel_err_grads_max={p: max(gaps[p].values()) for p in (0, 1)},
         top_grad_ratios={p: [[n, ratios[p][n], gaps[p][n], bounds[n]]
                              for n in sorted(ratios[p], key=ratios[p].get, reverse=True)[:6]]
                          for p in (0, 1)},
         grads_over_half_bound={p: sum(r > 0.5 for r in ratios[p].values()) for p in (0, 1)},
         swap_grad_gap_max=swap_max, rel_err_batchnorms=bn_gap, tol=DDP_TOL,
         param_gap_one_process=max(rel_gaps(got["params"], want_params).values()),
         launches=ranks[0]["launches0"], launches_expected=expected,
         losses=ranks[0]["losses0"], losses_one_process=want[0][0],
         dropout_losses=[r["dropout_losses"] for r in ranks],
         vl_eval=vl, vl_eval_one_process_training_route=want_vl,
         vl_eval_one_process_serving_route=serving_vl, vl_gaps=vl_gaps, vl_counts=counts,
         ms_per_step_two_ranks=[r["ms_per_step"] for r in ranks], ms_per_step_one_process=one_ms,
         ms_note="two ranks over gloo on one card: every partial sum through host copies, not "
                 "a speed of tensor parallelism; CUDA events, 1 warm-up, median of 3 steps",
         routes=routes, seconds=seconds, ok=ok)
    if not ok:
        raise AssertionError(f"tp_two_ranks failed {[k for k, v in checks.items() if not v]}: "
                             f"losses {l_gaps}, gradients {[(worst[p], ratios[p][worst[p]]) for p in (0, 1)]}, "
                             f"BatchNorms {bn_gap}, VL eval {vl_gaps}")


# ---- tensor parallelism of the other backbones and training options -------

# the pre-training batch: at B = 32 a bf16 gradient formed from fewer rows
# moved up to 1.12 times the bound of tp_two_ranks (v2 and linear v2, one
# call on the H100), three bf16 spacings of its largest magnitude
TP_FAMILY_BATCH = TRAIN_BATCH
TP_FAMILY_LAUNCHES = {      # the launches of one split step a rank, by family
    "attention": {"attention_fwd": 8, "attention_bwd": 8, "mlm_ce_fwd_tp": 1,
                  "mlm_ce_bwd_tp": 1},
    "ln_mlp": {"ln_mlp_fwd_tp": 8, "ln_mlp_bwd_tp": 8, "mlm_ce_fwd_tp": 1, "mlm_ce_bwd_tp": 1},
    "glue": {"mlm_ce_fwd_tp": 1, "mlm_ce_bwd_tp": 1},
    "ln_mlp_remat": {"ln_mlp_fwd_tp": 16, "ln_mlp_bwd_tp": 8, "mlm_ce_fwd_tp": 1,
                     "mlm_ce_bwd_tp": 1},
}
DROPOUT_ON = dict(drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.1, bert_dropout=0.1)
# case: (registry model, config overrides on ddp_config, launches a rank):
# the v2 and linear-SR v2 attention on #10/#11 and their DWConv MLP in glue
# on the rank's channels; Swin's window attention in glue on the rank's
# heads and table columns, its MLP on #12/#13's tensor-parallel modes; v1
# with every dropout on (no block kernel: the glue on the rank's heads and
# hidden, each split mask the rank's slice of the one-process mask); Swin
# under --remat (the forward's kernels and collectives repeated)
TP_FAMILY_CASES = {
    "v2": ("pvlt_v2_tiny", {}, "attention"),
    "linear": ("pvlt_v2_linear_tiny", {}, "attention"),
    "swin": ("pvlt_swin_tiny", {}, "ln_mlp"),
    "dropout": ("pvlt_tiny", DROPOUT_ON, "glue"),
    "remat": ("pvlt_swin_tiny", {"remat": True}, "ln_mlp_remat"),
}


def tp_case_config(case: str, dropout: bool = True) -> ModelConfig:
    """The case's config at full width (bf16, 256x256, the pre-training
    heads); ``dropout`` False: its rates at 0 (the reordering probe)."""
    name, overrides, _ = TP_FAMILY_CASES[case]
    cfg = dataclasses.replace(ddp_config(), name=name, **overrides)
    if not dropout:
        cfg = dataclasses.replace(cfg, **dict.fromkeys(DROPOUT_ON, 0.0))
    return cfg


def split_train_state(cfg: ModelConfig, device, global_batch: int, model_group, zero1=False):
    """A model of ``cfg`` from the seeded whole weights, split over
    ``model_group``, under DDP over the data group where it has several
    ranks, and its state at step 0 (the mask seed of this data rank)."""
    from mvlt_tpu_torch.parallel import mesh
    from mvlt_tpu_torch.parallel.sharding import wrap_model
    from mvlt_tpu_torch.parallel.tensor import shard_model

    model = create_model(cfg, device=device)
    model.load_state_dict(seeded_weights(model), strict=True)
    shard_model(model, model_group)
    ddp = wrap_model(model, device, mesh.data_group()) if mesh.data_size() > 1 else None
    state = create_train_state(model, OptimConfig(warmup_epochs=0), global_batch, 1,
                               seed=mesh.rank_seed(SEED), ddp=ddp, zero1=zero1,
                               model_group=model_group)
    return model, state


def consolidated(model, group) -> dict:
    """(gradients, parameters, buffers) of a split model, whole, fp32 on the
    host."""
    from mvlt_tpu_torch.parallel.tensor import consolidate

    def whole(tensors):
        return {n: t.detach().to("cpu", torch.float32, copy=True)
                for n, t in consolidate(tensors, group, model.cfg).items()}

    return {"grads": whole({n: p.grad for n, p in model.named_parameters()}),
            "params": whole(dict(model.named_parameters())),
            "buffers": {n: b.detach().to("cpu", torch.float32, copy=True)
                        for n, b in model.named_buffers()}}


def tp_families_rank(spec: dict) -> None:
    """A rank of ``tp_families`` (gloo, both ranks on cuda:0, tp = 2, dp =
    1): one step of each case of TP_FAMILY_CASES on the whole batch of
    spec (TP_FAMILY_BATCH), its launches, losses, generator state after,
    and its consolidated gradients, parameters and BatchNorm statistics
    (rank 0 writes them) with each rank's digest of its own."""
    from mvlt_tpu_torch.parallel import mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = mesh.maybe_init_distributed(device="cuda:0", backend="gloo", timeout_s=300)
    mesh.init_model_parallel(2)
    group, rank = mesh.model_group(), mesh.rank()
    batch = batch_to_device(dict(np.load(spec["batch"])), device)
    out = pathlib.Path(spec["out"])
    res, tensors = {"world": mesh.world_size(), "backend": torch.distributed.get_backend()}, {}
    for case in TP_FAMILY_CASES:
        cfg = tp_case_config(case)
        model, state = split_train_state(cfg, device, TP_FAMILY_BATCH, group)
        reset_launches()
        _, losses = make_train_step(cfg)(state, batch)
        torch.cuda.synchronize()
        tensors[case] = consolidated(model, group)
        res[case] = {"launches": read_launches(),
                     "losses": {k: float(v) for k, v in losses.items()},
                     "generator": state.generator.get_state().tolist(),
                     "digests": {k: tensors_digest(v) for k, v in tensors[case].items()}}
        del model, state
        torch.cuda.empty_cache()
    if rank == 0:
        torch.save(tensors, out / "tp_families_tensors.pt")
    (out / f"tp_families_{rank}.json").write_text(json.dumps(res))
    mesh.destroy()


def adamw_first_step(before: dict, grads: dict, lr: float) -> dict:
    """AdamW's first step (OptimConfig's betas and eps, its weight decay on
    the tensors of more than one dimension) from the weights ``before`` on
    ``grads``, on the host in fp32: what a split step's consolidated
    parameters must be, given its consolidated gradients."""
    cfg = OptimConfig()
    params = {n: before[n].clone().requires_grad_(True) for n in grads}
    for n, p in params.items():
        p.grad = grads[n].clone()
    groups = [{"params": [p for p in params.values() if p.dim() > 1],
               "weight_decay": cfg.weight_decay},
              {"params": [p for p in params.values() if p.dim() <= 1], "weight_decay": 0.0}]
    torch.optim.AdamW(groups, lr=lr, betas=cfg.betas, eps=cfg.eps).step()
    return {n: p.detach() for n, p in params.items()}


def param_gap(got: torch.Tensor, want: torch.Tensor, before: torch.Tensor) -> float:
    """A parameter after the step against ``adamw_first_step``'s, relative
    to the update's largest magnitude, less two fp32 spacings of the
    tensor's largest magnitude (the card's and the host's roundings)."""
    slack = 2.0 ** -22 * float(want.abs().max())
    gap = max(float((got - want).abs().max()) - slack, 0.0)
    return gap / max(float((want - before).abs().max()), 1e-30)


def step_bounds(want_grads: dict, swap: dict) -> dict:
    """Each gradient's bound: max(DDP_TOL, SWAP_FACTOR x the largest move of
    any gradient when one process takes the step on its rows reordered),
    plus twice BF16_SPACING where the gradient is formed in bf16 (each side
    rounds it once)."""
    swap_max = max(swap.values())
    bf16_formed = {n for n, w in want_grads.items()
                   if torch.equal(w.to(torch.bfloat16).float(), w)}
    return {n: max(DDP_TOL, SWAP_FACTOR * swap_max)
            + (2 * BF16_SPACING if n in bf16_formed else 0.0) for n in want_grads}


def one_process_step(cfg: ModelConfig, batch: dict, global_batch: int) -> dict:
    """This process's step of ``cfg`` from the seeded weights (mask seed
    SEED): its losses, gradients, buffers after, generator state after, the
    seeded weights and the step's LR."""
    model = create_model(cfg)
    weights = seeded_weights(model)
    model.load_state_dict(weights, strict=True)
    state = create_train_state(model, OptimConfig(warmup_epochs=0), global_batch, 1, seed=SEED)
    _, losses = make_train_step(cfg)(state, batch)
    res = {"losses": {k: float(v) for k, v in losses.items()}, "grads": grads_of(model),
           "buffers": {n: b.detach().float().cpu() for n, b in model.named_buffers()},
           "generator": state.generator.get_state().tolist(), "weights": weights,
           "lr": state.lr_schedule(0)}
    del model, state
    torch.cuda.empty_cache()
    return res


def compare_split_step(got: dict, want: dict, swap: dict) -> dict:
    """A consolidated split step against this process's: each gradient over
    its bound (step_bounds); each parameter's gap to AdamW's first step on
    the consolidated gradients from the whole weights (param_gap, within
    ZERO_TOL: the split optimizer step consolidates to the whole one; the
    gradients are held to one process by their bound, and AdamW's first
    step, about +-lr whatever a gradient's size, would hide their gaps);
    the BatchNorm statistics' gap."""
    grads, before = want["grads"], want["weights"]
    bounds = step_bounds(grads, swap)
    g_gaps = rel_gaps(got["grads"], grads)
    g_ratio = {n: g / bounds[n] for n, g in g_gaps.items()}
    adamw = adamw_first_step(before, got["grads"], want["lr"])
    p_gaps = {n: param_gap(got["params"][n], adamw[n], before[n]) for n in grads}
    worst_g, worst_p = max(g_ratio, key=g_ratio.get), max(p_gaps, key=p_gaps.get)
    return {"grad_ratio": [worst_g, g_ratio[worst_g]], "param_gap": [worst_p, p_gaps[worst_p]],
            "rel_err_grads_max": max(g_gaps.values()),
            "bn_gap": max(rel_gaps(got["buffers"], want["buffers"]).values()),
            "swap_grad_gap_max": max(swap.values()),
            "top_grad_ratios": [[n, g_ratio[n], g_gaps[n], bounds[n]]
                                for n in sorted(g_ratio, key=g_ratio.get, reverse=True)[:4]]}


def phase_tp_families(stats: dict) -> None:
    """Tensor parallelism of the v2, linear-SR v2 and Swin backbones, of
    dropout and of --remat, on two gloo ranks of one model group on the one
    card (tp = 2, dp = 1; NCCL refuses two ranks on one device), each at
    full width (256x256, 128 tokens, bf16, the pre-training heads, seeded
    weights) on the whole TP_FAMILY_BATCH batch: one step of each case of
    TP_FAMILY_CASES against this process's step from the same weights and
    mask seed. Per case: the losses within DDP_TOL; each consolidated
    gradient within tp_two_ranks' bound (step_bounds, from the case's own
    step on the batch's halves swapped, with its dropout off since masks
    follow positions); each parameter after AdamW within its gradient's
    gradients from the whole weights within ZERO_TOL (param_gap); the BatchNorm
    statistics within DDP_TOL; both ranks' losses, generator states and
    digests of their consolidated tensors equal; the generator in the
    one-process step's state after (the split masks drew what one process
    draws); the launches a rank exactly TP_FAMILY_LAUNCHES' (and no other
    wrapper's)."""
    DDP_DIR.mkdir(parents=True, exist_ok=True)
    arrays = {k: v for k, v in train_batch(SEED + 31, TP_FAMILY_BATCH).items()
              if isinstance(v, np.ndarray)}
    np.savez(DDP_DIR / "tp_families_batch.npz", **arrays)
    batch = batch_to_device(arrays, "cuda")
    half = TP_FAMILY_BATCH // 2
    swapped = {k: torch.cat([v[half:], v[:half]]) for k, v in batch.items()}
    want, swaps = {}, {}
    for case in TP_FAMILY_CASES:
        want[case] = one_process_step(tp_case_config(case), batch, TP_FAMILY_BATCH)
        base = tp_case_config(case, dropout=False)
        unswapped = (one_process_step(base, batch, TP_FAMILY_BATCH)["grads"]
                     if base != tp_case_config(case) else want[case]["grads"])
        swaps[case] = rel_gaps(one_process_step(base, swapped, TP_FAMILY_BATCH)["grads"],
                               unswapped)
    del batch, swapped
    torch.cuda.empty_cache()
    start = time.perf_counter()
    try:
        ranks = spawn_ranks("tp_families", 2, {"batch": str(DDP_DIR / "tp_families_batch.npz"),
                                               "out": str(DDP_DIR)}, timeout=600)
        got = torch.load(DDP_DIR / "tp_families_tensors.pt", weights_only=True)
    finally:
        shutil.rmtree(DDP_DIR, ignore_errors=True)
    seconds = time.perf_counter() - start
    failed, results = [], {}
    for case, (name, _, kind) in TP_FAMILY_CASES.items():
        cmp = compare_split_step(got[case], want[case], swaps[case])
        expected = {w: TP_FAMILY_LAUNCHES[kind].get(w, 0) for w in WRAPPERS}
        l_gap = loss_gap(ranks[0][case]["losses"], want[case]["losses"])
        checks = {
            "backend_gloo_world_2": all(r["backend"] == "gloo" and r["world"] == 2
                                        for r in ranks),
            "losses": l_gap <= DDP_TOL, "grads": cmp["grad_ratio"][1] <= 1.0,
            "params": cmp["param_gap"][1] <= ZERO_TOL, "batchnorms": cmp["bn_gap"] <= DDP_TOL,
            "ranks_equal": all(ranks[0][case][k] == ranks[1][case][k]
                               for k in ("losses", "generator", "digests")),
            "same_masks_as_one_process": ranks[0][case]["generator"] == want[case]["generator"],
            "launches": all(r[case]["launches"] == expected for r in ranks),
        }
        results[case] = {"model": name, "checks": checks, "rel_err_losses": l_gap,
                         "launches": ranks[0][case]["launches"], **cmp}
        failed += [f"{case}:{k}" for k, v in checks.items() if not v]
    ok = not failed
    emit("tp_families", tp=2, dp=1, batch=TP_FAMILY_BATCH, tol=DDP_TOL, cases=results,
         launches_expected={c: TP_FAMILY_LAUNCHES[k] for c, (_, _, k) in TP_FAMILY_CASES.items()},
         seconds=seconds, ok=ok)
    if not ok:
        raise AssertionError(f"tp_families failed {failed}: "
                             + "; ".join(f"{c} grads {r['grad_ratio']} params {r['param_gap']} "
                                         f"losses {r['rel_err_losses']} BN {r['bn_gap']}"
                                         for c, r in results.items()))


# ---- sequence parallelism (parallel/sequence.py) ---------------------------

SP_SIZE = 2
# a serving forward's launches a rank, by model: every block on its band
# (Swin's: sp_serving_launches, by the stages that split)
SP_SERVING = {
    "pvlt_tiny": {"sr_kv": 8, "block_fused": 8},
    "pvlt_v2_tiny": {"sr_kv": 8, "block_attention": 8, "dwconv_mlp": 8},
    "pvlt_v2_linear_tiny": {"sr_kv": 2, "block_attention": 8, "dwconv_mlp": 8},
    "pvlt_swin_tiny": None,
}
# case: (registry model, config overrides on ddp_config, a step's launches a rank)
SP_STEPS = {
    "v1": ("pvlt_tiny", {}, {"attention_fwd": 8, "attention_bwd": 8, "ln_mlp_fwd": 8,
                             "ln_mlp_bwd": 8, "mlm_ce_fwd": 1, "mlm_ce_bwd": 1}),
    "v1_fused": ("pvlt_tiny", {"fused_attn_train": True},
                 {"fba_train_fwd": 8, "fba_train_bwd": 8, "ln_mlp_fwd": 8, "ln_mlp_bwd": 8,
                  "mlm_ce_fwd": 1, "mlm_ce_bwd": 1}),
    "v2": ("pvlt_v2_tiny", {}, {"attention_fwd": 8, "attention_bwd": 8, "mlm_ce_fwd": 1,
                                "mlm_ce_bwd": 1}),
    "swin": ("pvlt_swin_tiny", {}, {"ln_mlp_fwd": 8, "ln_mlp_bwd": 8, "mlm_ce_fwd": 1,
                                    "mlm_ce_bwd": 1}),
}
# sequence parallelism with the weights split over the same model group
# (shard_model): SP_STEPS' cases, each with its launches a rank of a step
# by the model group's size (pvlt_tiny's vocabulary of 30,522 rows splits
# over 2 ranks, not over 4)
SPTP_STEPS = {
    "v1": {2: TP_STEP_LAUNCHES,
           4: {**{k: v for k, v in TP_STEP_LAUNCHES.items() if "mlm" not in k},
               "mlm_ce_fwd": 1, "mlm_ce_bwd": 1}},
    "v1_fused": {2: TP_FBA_LAUNCHES},
    "swin": {2: TP_FAMILY_LAUNCHES["ln_mlp"]},
}
# the primitives move or add values without rounding (fp32 buffers, a sum
# of one value and zeros); linear SR's pool adds in another order
SP_PRIMITIVE_TOL = 1e-6
SP_PRIMITIVE_BATCH = 8


def sp_serving_config(name: str) -> ModelConfig:
    return ModelConfig(name=name, compute_dtype="bfloat16",
                       loss_type=LossType(itm=True, mlm=False, t2i=False, cls=False))


def sp_step_config(case: str) -> ModelConfig:
    name, overrides, _ = SP_STEPS[case]
    return dataclasses.replace(ddp_config(), name=name, **overrides)


def planned_split(cfg: ModelConfig, n: int) -> list:
    """The stages parallel/sequence.py:row_plan splits at 256 over n ranks."""
    from mvlt_tpu_torch.models.registry import resolve_model_config
    from mvlt_tpu_torch.parallel import sequence

    cfg = resolve_model_config(cfg)
    return [sequence.row_plan(h, w, cfg.num_text_tokens, sequence.stage_unit(cfg, i, (h, w)),
                              n, 0).split
            for i, (h, w) in enumerate(sequence.stage_grids(cfg, 256))]


def sp_serving_launches(name: str, split: list) -> dict:
    """A serving forward's launches a rank: SP_SERVING's; Swin's split
    stages (two blocks each) on the window path, F and #12 a block, the
    others whole on kernel E (every stage at 256 admits it)."""
    if name != "pvlt_swin_tiny":
        return SP_SERVING[name]
    k = sum(split)
    return {"swin_attention": 2 * k, "ln_mlp_fwd": 2 * k, "swin_block": 2 * (len(split) - k)}


def sp_bundle(device) -> tuple:
    """One B = 101 bundle (synthetic_bundles'), its images divided by 255 on
    ``device`` as make_itm_scorer divides them."""
    bundle = synthetic_bundles(1, SEED + 1, 256, TEXT)[0]
    images = uint8_to_unit(torch.from_numpy(bundle["images_101"]).to(device))
    return images, torch.from_numpy(bundle["ori_input_ids_101"]).long().to(device)


def sp_primitives(device, group) -> dict:
    """Each primitive of parallel/sequence.py on this rank at stage 1 of
    pvlt_tiny at 256 (a 64x64 grid, 128 text rows, B = 8), against what it
    must give, taken from the whole tensor (the same on every rank): {check:
    its largest gap relative to the expected tensor's largest magnitude}."""
    from mvlt_tpu_torch.models.bert_embeddings import dropout
    from mvlt_tpu_torch.ops.sr_kv import linear_pool_shape
    from mvlt_tpu_torch.parallel import sequence

    n, rank = torch.distributed.get_world_size(group), torch.distributed.get_rank(group)
    h = w = 64
    b, d, heads, sr = SP_PRIMITIVE_BATCH, 64, 1, 8
    plan = sequence.row_plan(h, w, TEXT, sr, n, rank, group)
    gen = torch.Generator(device=device).manual_seed(SEED + 61)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=device)   # noqa: E731
    gaps = {}

    def gap(name, got, want):
        gaps[name] = float((got.detach().double() - want.double()).abs().max()) / max(
            float(want.double().abs().max()), 1e-30)

    mv = plan.hb * w
    z = rnd(b, h * w + TEXT, d).requires_grad_(True)
    zb = sequence.split_rows(z, plan)
    gap("split_rows", zb, sequence.take(z, plan, mv))
    back = sequence.gather_rows(zb, plan)
    gap("gather_rows", back, z)
    r = rnd(*z.shape)
    (back * r).sum().backward()
    gap("split_gather_backward", z.grad, r)       # whole on every rank
    m_vis = sequence.kv_visual_rows(plan, sr)
    kv = rnd(2, b, heads, (h // sr) * (w // sr) + TEXT, d // heads)
    local = sequence.take(kv, plan, m_vis, -2).requires_grad_(True)
    got = sequence.gather_kv(local, plan, m_vis)
    gap("gather_kv", got, kv)
    r = rnd(*kv.shape)
    (got * r).sum().backward()                    # every rank's queries: the same r
    gap("gather_kv_backward", local.grad, n * sequence.take(r, plan, m_vis, -2))
    x = rnd(b, h * w + TEXT, d)
    xb = sequence.take(x, plan, mv).requires_grad_(True)
    ext = sequence.exchange_halo(xb, plan)
    gap("exchange_halo", ext, sequence.halo_band(x, plan))
    r = rnd(*x.shape)
    (ext * sequence.halo_band(r, plan)).sum().backward()
    count = torch.ones(h * w + TEXT, device=device)   # the ranks holding each row
    for q in range(1, n):
        count[q * plan.hb * w - w:q * plan.hb * w + w] += 1
    gap("exchange_halo_backward", xb.grad, sequence.take(r * count[None, :, None], plan, mv))
    win, out = linear_pool_shape((h, w))
    grid = x[:, :h * w].reshape(b, h, w, d)
    pooled = sequence.linear_pool(grid[:, rank * plan.hb:(rank + 1) * plan.hb], plan, win, out)
    want = F.avg_pool2d(grid.permute(0, 3, 1, 2), win, win).permute(0, 2, 3, 1)
    gap("linear_pool", pooled, want)
    state = gen.get_state()
    ones = torch.ones(b, h * w + TEXT, d, device=device)
    whole = dropout(ones, 0.1, gen)
    gen.set_state(state)
    rows = dropout(sequence.take(ones, plan, mv), 0.1, gen, rows=(1, plan))
    gap("dropout_rows", rows, sequence.take(whole, plan, mv))
    # Swin's shifted windows at stage 1 (windows of 8, s = 4): the band of
    # the grid rolled by -s rows, its backward the gradient rolled back
    s, grid = 4, rnd(b, h * w, d)
    gb = grid[:, rank * mv:(rank + 1) * mv].clone().requires_grad_(True)
    rolled = sequence.roll_rows(gb, plan, -s)

    def roll(t, k):
        return torch.roll(t.reshape(b, h, w, d), k, 1).reshape(b, h * w, d)[
            :, rank * mv:(rank + 1) * mv]

    gap("roll_rows", rolled, roll(grid, -s))
    r = rnd(b, h * w, d)
    (rolled * r[:, rank * mv:(rank + 1) * mv]).sum().backward()
    gap("roll_rows_backward", gb.grad, roll(r, s))
    # a row-parallel product's partials (the same on every rank here)
    # reduce-scattered to the band, the backward all-gathering
    part = rnd(b, h * w + TEXT, d).requires_grad_(True)
    scattered = sequence.scatter_rows(part, plan)
    gap("scatter_rows", scattered, n * sequence.take(part.detach(), plan, mv))
    r = rnd(*part.shape)
    (scattered * sequence.take(r, plan, mv)).sum().backward()
    gap("scatter_rows_backward", part.grad, r)
    return gaps


def host_copy(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", torch.float32, copy=True)


def sp_rank_cases(spec: dict, device, group) -> tuple:
    """This rank's runs of the sequence-parallel cases of ``spec`` (a model
    group made by mesh.init_model_parallel): each serving model's ITM
    forward on the bundle through make_itm_scorer (launches, logits, the
    ITM head's input, ms a forward) and each step case on this data rank's
    rows (launches, losses, digests; the whole gradients, parameters and
    BatchNorm statistics in ``tensors``; ms a step), and each case of
    spec["sptp_steps"] with the weights split over the group as well
    (results under "sptp", consolidated tensors under "sptp_<case>").
    Returns (results, tensors)."""
    from mvlt_tpu_torch.parallel import mesh
    from mvlt_tpu_torch.parallel.sharding import wrap_model
    from mvlt_tpu_torch.parallel.tensor import shard_model

    res, tensors = {"serving": {}, "steps": {}}, {}
    if spec["serving"]:
        images, ids = sp_bundle(device)
    for name in spec["serving"]:
        model = create_model(sp_serving_config(name), device=device, sp_group=group).eval()
        model.load_state_dict(seeded_weights(model), strict=True)
        scorer = make_itm_scorer(model)
        reset_launches()
        scores = scorer(images, ids)
        torch.cuda.synchronize()
        launches = read_launches()
        logits, feats = itm_outputs(model, images, ids)
        tensors[f"serving_{name}"] = {"logits": logits, "feats": feats, "scores": scores.cpu()}
        res["serving"][name] = {"launches": launches, "split": list(model.sp_split),
                                "ms": cuda_time_ms(lambda: scorer(images, ids), warmup=1, reps=3)
                                if spec["time"] else None,
                                "digest": tensors_digest(tensors[f"serving_{name}"])}
        del model
        torch.cuda.empty_cache()
    steps = ([(case, False) for case in spec["steps"]]
             + [(case, True) for case in spec.get("sptp_steps", ())])
    host = dict(np.load(spec["batch"])) if steps else {}
    res["sptp"] = {}
    for case, sptp in steps:
        cfg = sp_step_config(case)
        share = host["images"].shape[0] // mesh.data_size()
        lo = mesh.data_rank() * share
        batch = batch_to_device({k: v[lo:lo + share] for k, v in host.items()}, device)
        model = create_model(cfg, device=device, sp_group=group)
        model.load_state_dict(seeded_weights(model), strict=True)
        if sptp:     # the weights split over the model group too
            shard_model(model, group)
        ddp = wrap_model(model, device, mesh.data_group()) if mesh.data_size() > 1 else None
        state = create_train_state(model, OptimConfig(warmup_epochs=0), share * mesh.data_size(),
                                   1, seed=mesh.rank_seed(SEED), ddp=ddp,
                                   model_group=group if sptp else None)
        step = make_train_step(cfg)
        reset_launches()
        _, losses = step(state, batch)
        torch.cuda.synchronize()
        launches = read_launches()
        key = f"sptp_{case}" if sptp else case
        tensors[key] = (consolidated(model, group) if sptp else
                        {"grads": {n: host_copy(p.grad) for n, p in model.named_parameters()},
                         "params": {n: host_copy(p) for n, p in model.named_parameters()},
                         "buffers": {n: host_copy(b) for n, b in model.named_buffers()}})
        sums = torch.tensor([float(losses[k]) for k in sorted(losses)], dtype=torch.float64,
                            device=device)
        if mesh.data_size() > 1:
            torch.distributed.all_reduce(sums, group=mesh.data_group())
        res["sptp" if sptp else "steps"][case] = {
            "launches": launches, "split": list(model.sp_split),
            "mean_losses": dict(zip(sorted(losses), (sums / mesh.data_size()).tolist())),
            "digests": {k: tensors_digest(v) for k, v in tensors[key].items()},
            "ms": cuda_time_ms(lambda: step(state, batch), warmup=1, reps=3)
            if spec["time"] else None}
        del model, state, ddp
        torch.cuda.empty_cache()
    return res, tensors


def sp_two_ranks_rank(spec: dict) -> None:
    """A rank of ``sp_two_ranks`` (gloo, both ranks on cuda:0, one model
    group of two): the primitives, then ``sp_rank_cases``; rank 0 writes
    the tensors."""
    from mvlt_tpu_torch.parallel import mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = mesh.maybe_init_distributed(device="cuda:0", backend="gloo", timeout_s=300)
    mesh.init_model_parallel(SP_SIZE)
    group, rank = mesh.model_group(), mesh.rank()
    out = pathlib.Path(spec["out"])
    res = {"world": mesh.world_size(), "backend": torch.distributed.get_backend(),
           "primitives": sp_primitives(device, group)}
    cases, tensors = sp_rank_cases(spec, device, group)
    res.update(cases)
    if rank == 0:
        torch.save(tensors, out / "sp_tensors.pt")
    (out / f"sp_two_ranks_{rank}.json").write_text(json.dumps(res))
    mesh.destroy()


def sp_serving_reference(names, device, sp: int = SP_SIZE) -> dict:
    """This process's whole forward of each model on the bundle from the
    same weights: {name: (logits, ITM head input, ms a forward, None)}.
    Swin's bands serve a split stage on the window path (F and #12), as the
    JAX package's gate keeps its band kernel off under sp_mesh: its
    reference takes that path on the stages planned_split splits over
    ``sp`` ranks and E on the others, as the bands do, and the last entry
    holds (logits, ITM head input) of its forward on E at every stage."""
    from unittest import mock

    from mvlt_tpu_torch.models import pvlt
    from mvlt_tpu_torch.parallel import sequence

    images, ids = sp_bundle(device)
    out = {}
    for name in names:
        model = create_model(sp_serving_config(name), device=device).eval()
        model.load_state_dict(seeded_weights(model), strict=True)
        scorer = make_itm_scorer(model)
        logits, feats = itm_outputs(model, images, ids)
        ms = cuda_time_ms(lambda: scorer(images, ids), warmup=1, reps=3)
        e_route = None
        if name == "pvlt_swin_tiny":
            split = planned_split(model.cfg, sp)
            bands = {g for g, on in zip(sequence.stage_grids(model.cfg, 256), split) if on}
            gate = pvlt.swin_band_stage
            e_route = (logits, feats)
            with mock.patch.object(pvlt, "swin_band_stage",
                                   lambda ws, hw: tuple(hw) not in bands and gate(ws, hw)):
                logits, feats = itm_outputs(model, images, ids)
        out[name] = (logits, feats, ms, e_route)
        del model
        torch.cuda.empty_cache()
    return out


def sp_step_references(cases, batch: dict, global_b: int) -> tuple:
    """This process's step of each case on ``batch`` and the gradients'
    moves when the batch's halves swap (the bound's input), and the ms of a
    step at TRAIN_BATCH: ({case: one_process_step}, {case: swap gaps},
    {case: ms})."""
    half = global_b // 2
    swapped = {k: torch.cat([v[half:], v[:half]]) for k, v in batch.items()}
    one = {k: v[:TRAIN_BATCH] for k, v in batch.items()}
    want, swaps, ms = {}, {}, {}
    for case in cases:
        cfg = sp_step_config(case)
        want[case] = one_process_step(cfg, batch, global_b)
        swaps[case] = rel_gaps(one_process_step(cfg, swapped, global_b)["grads"],
                               want[case]["grads"])
        model = create_model(cfg)
        model.load_state_dict(seeded_weights(model), strict=True)
        state = create_train_state(model, OptimConfig(warmup_epochs=0), TRAIN_BATCH, 1, seed=SEED)
        step = make_train_step(cfg)
        ms[case] = cuda_time_ms(lambda: step(state, one), warmup=1, reps=3)
        del model, state
        torch.cuda.empty_cache()
    return want, swaps, ms


def cyclic_moves(cfg: ModelConfig, batch: dict, global_b: int, parts: int,
                 want_grads: dict) -> dict:
    """Each gradient's largest move when this process takes the step on the
    batch cut into ``parts`` equal parts in each other cyclic order (rolled
    by 1 .. parts - 1 parts), against its step on the batch as it is: the
    rounding spread of a sum of ``parts`` partials taken in another order.
    At parts = 2 the swap of the halves that the bounds take."""
    share = global_b // parts
    moves = {}
    for k in range(1, parts):
        rolled = {key: torch.cat([v[k * share:], v[:k * share]]) for key, v in batch.items()}
        for n, g in rel_gaps(one_process_step(cfg, rolled, global_b)["grads"],
                             want_grads).items():
            moves[n] = max(moves.get(n, 0.0), g)
    return moves


def sp_compare(ranks: list, got: dict, serving: dict, want: dict, swaps: dict,
               sp: int = SP_SIZE, sptp_swaps: dict | None = None) -> tuple:
    """The ranks' results against this process's: per serving model the
    ITM head's input and logits (gap relative to the largest, within
    SLICE_TOL) and a rank's launches (sp_serving_launches a forward,
    nothing else); per step case, and per case with the weights split over
    the model group too (its consolidated tensors), compare_split_step's
    gradients, parameters and BatchNorm statistics, the losses within
    DDP_TOL and a rank's launches (SP_STEPS', SPTP_STEPS'); every model
    splitting the stages planned_split names over ``sp`` ranks, at least
    one; every rank of a model group the same digests. Returns (results,
    failed checks). ``sptp_swaps``: the moves that bound the
    cases with split weights, by case, in place of ``swaps`` (cyclic_moves
    over the model group's size)."""
    results, failed = {}, []
    for name in serving:
        logits, feats, ms, e_route = serving[name]
        mine = got[f"serving_{name}"]
        g_feats = _rel_err(mine["feats"], feats)[1]
        g_logits = _rel_err(mine["logits"], logits)[1]
        vs_e = None if e_route is None else {   # information: the route differs
            "rel_err_itm_input": _rel_err(mine["feats"], e_route[1])[1],
            "rel_err_itm_logits": _rel_err(mine["logits"], e_route[0])[1],
            "one_process_window_vs_e_itm_logits": _rel_err(logits, e_route[0])[1]}
        split = planned_split(sp_serving_config(name), sp)
        expected = {w: sp_serving_launches(name, split).get(w, 0) for w in WRAPPERS}
        checks = {"feats": g_feats <= SLICE_TOL, "logits": g_logits <= SLICE_TOL,
                  "launches": all(r["serving"][name]["launches"] == expected for r in ranks),
                  "stages_split_as_planned": any(split) and all(
                      r["serving"][name]["split"] == split for r in ranks),
                  "ranks_equal": len({r["serving"][name]["digest"] for r in ranks}) == 1}
        results[name] = {"checks": checks, "rel_err_itm_input": g_feats,
                         "rel_err_itm_logits": g_logits, "tol": SLICE_TOL,
                         "vs_one_process_on_kernel_e": vs_e,
                         "launches": ranks[0]["serving"][name]["launches"],
                         "ms_forward_rank": [r["serving"][name]["ms"] for r in ranks],
                         "ms_forward_one_process": ms}
        failed += [f"{name}:{k}" for k, v in checks.items() if not v]
    runs = [(case, "steps", case, SP_STEPS[case][2]) for case in want
            if case in ranks[0]["steps"]]
    runs += [(case, "sptp", f"sptp_{case}", SPTP_STEPS[case][sp]) for case in want
             if case in ranks[0]["sptp"]]
    for case, part, key, launches in runs:
        swap = (sptp_swaps or {}).get(case, swaps[case]) if part == "sptp" else swaps[case]
        cmp = compare_split_step(got[key], want[case], swap)
        l_gap = loss_gap(ranks[0][part][case]["mean_losses"], want[case]["losses"])
        expected = {w: launches.get(w, 0) for w in WRAPPERS}
        split = planned_split(sp_step_config(case), sp)
        checks = {"losses": l_gap <= DDP_TOL, "grads": cmp["grad_ratio"][1] <= 1.0,
                  "params": cmp["param_gap"][1] <= ZERO_TOL, "batchnorms": cmp["bn_gap"] <= DDP_TOL,
                  "launches": all(r[part][case]["launches"] == expected for r in ranks),
                  "stages_split_as_planned": any(split) and all(
                      r[part][case]["split"] == split for r in ranks),
                  "ranks_equal": len({json.dumps(r[part][case]["digests"], sort_keys=True)
                                      for r in ranks}) == 1}
        results[key] = {"checks": checks, "rel_err_losses": l_gap,
                        "launches": ranks[0][part][case]["launches"],
                        "ms_step_rank": [r[part][case]["ms"] for r in ranks], **cmp}
        failed += [f"{key}:{k}" for k, v in checks.items() if not v]
    return results, failed


def sp_record_launches(stats: dict, rank0: dict) -> None:
    """Each kernel's launches a rank over the phase's forwards and steps."""
    for part in ("serving", "steps", "sptp"):
        for run in rank0[part].values():
            for name, n in run["launches"].items():
                stats[name]["sp_launches"] += n


def kernel_a_band_gap(device) -> dict:
    """Kernel A on each rank's band of stage 1 (B = 101, a 64x64 grid, 128
    text rows) against the rows of A on the whole grid: its split
    contraction takes other ranges on the shorter grid, so the rows may
    differ by a bf16 rounding."""
    from mvlt_tpu_torch.parallel import sequence

    gen = torch.Generator().manual_seed(SEED + 67)
    h, w, d, heads, sr, hidden = STAGES[0]
    p = stage_params(gen, d, sr, hidden, device)
    args = [t if t is None or t.dim() == 1 else t.to(torch.bfloat16) for t in _kv_args(p)]
    x = torch.randn(BATCH, h * w + TEXT, d, generator=gen).to(device, torch.bfloat16)
    kw = dict(sr=sr, heads=heads, eps1=1e-6, eps_sr=1e-5)
    whole = torch.stack(fused_ln_sr_kv(x, (h, w), *args, **kw))
    gaps, equal = [], True
    for r in range(SP_SIZE):
        plan = sequence.row_plan(h, w, TEXT, sr, SP_SIZE, r)
        band = torch.stack(fused_ln_sr_kv(sequence.take(x, plan, plan.hb * w).contiguous(),
                                          plan.hw, *args, **kw))
        want = sequence.take(whole, plan, sequence.kv_visual_rows(plan, sr), -2)
        gaps.append(_rel_err(band, want))
        equal = equal and torch.equal(band, want)
    return {"max_abs": max(g[0] for g in gaps), "rel": max(g[1] for g in gaps),
            "bit_equal": equal, "splits_whole": conv_splits(BATCH, (h // sr) * (w // sr), d, sr,
                                                            _build.sm_count(0)),
            "splits_band": conv_splits(BATCH, (h // sr // SP_SIZE) * (w // sr), d, sr,
                                       _build.sm_count(0))}


def kernel_f_band_gap(stats: dict) -> dict:
    """Kernel F on rank 1's windows of Swin's stage 1 at 256 (B = 101, a
    band of 32 of 64 grid rows, windows of 8, shifted: the whole grid's
    table sliced to the band's window rows, as SwinJointAttention takes
    it) against its plain version; raises past KERNEL_TOL."""
    from mvlt_tpu_torch.parallel import sequence

    gen = torch.Generator().manual_seed(SEED + 69)
    h = w = 64
    d, nh, ws, s = 64, 1, 8, 4
    plan = sequence.row_plan(h, w, TEXT, ws, SP_SIZE, 1)
    args, scale = swin_attention_inputs(gen, (plan.hb, w, d, nh, ws, TEXT), True, BATCH)
    rel = (0.5 * torch.randn((2 * ws - 1) ** 2, nh, generator=gen)).to("cuda")
    index = torch.from_numpy(relative_position_index(ws)).to("cuda")
    mask = torch.from_numpy(window_masks(h, w, ws, s)[sequence.band_windows(plan, ws)]).to("cuda")
    args = (*args[:5], add_table(rel, index, mask, TEXT))
    got = fused_swin_attention(*args, scale=scale)
    want = swin_attention_reference(*args, scale=scale)
    torch.cuda.synchronize()
    abs_err, rel_err = _rel_err(got, want)
    ok = bool(rel_err <= KERNEL_TOL and np.isfinite(rel_err))
    stats["swin_attention"]["max_abs_err"] = max(stats["swin_attention"]["max_abs_err"], abs_err)
    if not ok:
        raise AssertionError(f"kernel F on a band disagrees with its plain version: rel err "
                             f"{rel_err:.3e} > {KERNEL_TOL}")
    return {"windows": args[0].shape[1], "max_abs_err": abs_err, "rel_err": rel_err,
            "tol": KERNEL_TOL}


def phase_sp_two_ranks(stats: dict, serving: tuple = tuple(SP_SERVING),
                       steps: tuple = tuple(SP_STEPS), sptp_steps: tuple = tuple(SPTP_STEPS),
                       phase: str = "sp_two_ranks") -> None:
    """Sequence parallelism on two gloo ranks of one model group on the one
    card (NCCL refuses two ranks on one device), each model at full width
    (256x256, 128 tokens, bf16, seeded weights), every stage split into
    bands of half its grid rows and 64 text rows. Per rank: each primitive
    of parallel/sequence.py at stage 1 against the whole tensor's rows
    within SP_PRIMITIVE_TOL (split and gather and their backward, the K/V
    gather and its reduce-scatter, the halo exchange and its backward,
    linear SR's pool, a dropout mask of the rows, Swin's shifted-window
    roll and the reduce-scatter of a row-parallel product's partials, each
    backward); pvlt_tiny, pvlt_v2_tiny, pvlt_v2_linear_tiny and
    pvlt_swin_tiny score one B = 101 bundle through make_itm_scorer on
    their bands (A and B, or A, C and D, or on Swin's split stages 1-3 F
    and #12 a block and on stage 4, whole, E: sp_serving_launches a
    forward a rank and no other kernel), the ITM head's input and logits
    within SLICE_TOL of this process's whole forward (Swin's on the route
    its bands take, sp_serving_reference; its gap to E's route beside
    it); one B = 150 step of v1 on both routes, of v2 and of Swin against
    this process's
    (compare_split_step: the losses within DDP_TOL, each gradient within
    ddp_two_ranks' bound, the parameters within ZERO_TOL of AdamW's step on
    the gradients, the BatchNorm statistics), SP_STEPS' launches a step a
    rank; then v1's and Swin's step with the weights split over the same
    two ranks (sequence and tensor parallelism on one model group; the
    consolidated tensors held the same way, SPTP_STEPS' launches of
    #10-#15's modes); both ranks' digests equal. Kernel A's band rows
    beside its whole grid's (information); kernel F on a band's windows
    against its plain version. The ranks are not timed: over gloo every
    gather goes through host copies (nccl_sp times a rank)."""
    DDP_DIR.mkdir(parents=True, exist_ok=True)
    arrays = {k: v for k, v in train_batch(SEED + 51, TRAIN_BATCH).items()
              if isinstance(v, np.ndarray)}
    np.savez(DDP_DIR / "sp_batch.npz", **arrays)
    batch = batch_to_device(arrays, "cuda")
    names = serving
    serving = sp_serving_reference(names, "cuda")
    want, swaps, one_ms = sp_step_references([c for c in SP_STEPS if c in steps + sptp_steps],
                                             batch, TRAIN_BATCH)
    band = kernel_a_band_gap("cuda")
    band_f = kernel_f_band_gap(stats)
    del batch
    torch.cuda.empty_cache()
    start = time.perf_counter()
    try:
        ranks = spawn_ranks("sp_two_ranks", SP_SIZE,
                            {"batch": str(DDP_DIR / "sp_batch.npz"), "out": str(DDP_DIR),
                             "serving": list(names), "steps": list(steps),
                             "sptp_steps": list(sptp_steps), "time": False}, timeout=900)
        got = torch.load(DDP_DIR / "sp_tensors.pt", weights_only=True)
    finally:
        shutil.rmtree(DDP_DIR, ignore_errors=True)
    seconds = time.perf_counter() - start
    results, failed = sp_compare(ranks, got, serving, want, swaps)
    for key, r in results.items():
        if key.removeprefix("sptp_") in one_ms:
            r["ms_step_one_process"] = one_ms[key.removeprefix("sptp_")]
    primitives = {k: max(r["primitives"][k] for r in ranks) for k in ranks[0]["primitives"]}
    common = {"backend_gloo_world_2": all(r["backend"] == "gloo" and r["world"] == SP_SIZE
                                          for r in ranks),
              "primitives": all(v <= SP_PRIMITIVE_TOL for v in primitives.values())}
    failed += [k for k, v in common.items() if not v]
    sp_record_launches(stats, ranks[0])
    ok = not failed
    emit(phase, sp=SP_SIZE, dp=1, batch_serving=BATCH, batch_step=TRAIN_BATCH,
         checks=common, primitives_rel_err=primitives, primitive_tol=SP_PRIMITIVE_TOL,
         primitive_over_tol={k: v / SP_PRIMITIVE_TOL for k, v in primitives.items()},
         cases=results, kernel_a_band_vs_whole=band, kernel_f_band_vs_plain=band_f, tol=DDP_TOL,
         ms_note="the ranks are not timed: over gloo every gather goes through host copies "
                 "(nccl_sp times them); one process: CUDA events, 1 warm-up, median of 3",
         seconds=seconds, ok=ok)
    if not ok:
        raise AssertionError(f"{phase} failed {failed}: primitives {primitives}; " + "; ".join(
            f"{c} {r.get('grad_ratio')} {r.get('param_gap')} {r.get('rel_err_itm_input')}"
            for c, r in results.items()))


def phase_sp_swin(stats: dict) -> None:
    """sp_two_ranks on Swin alone: its bundle on the bands and its step, the
    primitives (chip_faults.py's Swin faults)."""
    phase_sp_two_ranks(stats, ("pvlt_swin_tiny",), ("swin",), (), "sp_swin")


def phase_sp_tp(stats: dict) -> None:
    """sp_two_ranks' steps with the weights split over the model group too,
    alone, and the primitives (chip_faults.py's sequence x tensor
    parallelism faults)."""
    phase_sp_two_ranks(stats, (), (), tuple(SPTP_STEPS), "sp_tp")


# ---- data and tensor parallelism over NCCL across four cards (--cards 4) ----

NCCL_CARDS = 4
NCCL_TIMEOUT_S = 300        # a process-group call that waits longer fails the run
NCCL_TP = 2
# family: its launches a rank of a split step (dp 2 x tp 2)
NCCL_FAMILIES = {"pvlt_tiny": TP_STEP_LAUNCHES, "pvlt_v2_tiny": TP_FAMILY_LAUNCHES["attention"],
                 "pvlt_swin_tiny": TP_FAMILY_LAUNCHES["ln_mlp"]}
# nccl_tp's split steps on another route (no command line): label ->
# (registry model, config overrides on ddp_config, a rank's launches)
NCCL_TP_ROUTES = {"pvlt_tiny_fused": ("pvlt_tiny", {"fused_attn_train": True}, TP_FBA_LAUNCHES)}


def nccl_tp_case(label: str) -> tuple:
    """(config, a split step's launches a rank) of a label of nccl_tp."""
    name, overrides, launches = NCCL_TP_ROUTES.get(label, (label, {}, None))
    return (dataclasses.replace(ddp_config(), name=name, **overrides),
            NCCL_FAMILIES[label] if launches is None else launches)


def nccl_ddp_rank(spec: dict) -> None:
    """A rank of ``nccl_ddp`` (torchrun, one rank a card, NCCL): the
    pre-training command line at world 4 with its launches, then one DDP
    step at B = 150 on this rank's quarter of the B = 600 batch (each
    gradient's largest magnitude on this rank noted before the
    reduction), the same step under ZeRO-1; then the step's time under DDP
    (no comm hook) and of the rank's own model without DDP, every rank at
    once."""
    from torch.distributed.algorithms.ddp_comm_hooks import default_hooks

    from mvlt_tpu_torch.parallel import mesh
    from mvlt_tpu_torch.parallel.sharding import wrap_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh.maybe_init_distributed(timeout_s=NCCL_TIMEOUT_S)   # the command line joins it
    reset_launches()
    start = time.perf_counter()
    cli.main(spec["argv"])
    torch.cuda.synchronize()
    cli_seconds, cli_launches = time.perf_counter() - start, read_launches()
    rank, world, device = mesh.rank(), mesh.world_size(), mesh.comm_device()
    cfg = ddp_config()
    host = dict(np.load(spec["batch"]))
    share = host["images"].shape[0] // world
    batch = batch_to_device({k: v[rank * share:(rank + 1) * share] for k, v in host.items()},
                            device)
    res = {"backend": torch.distributed.get_backend(), "world": world, "device": str(device),
           "card": torch.cuda.get_device_name(device), "cli_launches": cli_launches,
           "cli_seconds": cli_seconds}
    step = make_train_step(cfg)
    after = {}
    for zero1 in (False, True):
        model = create_model(cfg, device=device)
        model.load_state_dict(seeded_weights(model), strict=True)
        ddp = wrap_model(model, device)
        names = {id(p): n for n, p in model.named_parameters()}
        partial_max = {}

        def recording_hook(group, bucket):
            for p, g in zip(bucket.parameters(), bucket.gradients()):
                partial_max[names[id(p)]] = g.detach().abs().max()
            return default_hooks.allreduce_hook(group, bucket)

        ddp.register_comm_hook(None, recording_hook)
        state = create_train_state(model, OptimConfig(warmup_epochs=0), share * world, 1,
                                   seed=SEED + rank, ddp=ddp, zero1=zero1)
        reset_launches()
        _, losses = step(state, batch)
        torch.cuda.synchronize()
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        if not zero1:
            res["launches"] = read_launches()
            res["partial_max"] = {n: float(v) for n, v in partial_max.items()}
            grads = grads_of(model)
            sums = torch.tensor([float(losses[k]) for k in sorted(losses)], dtype=torch.float64,
                                device=device)
            torch.distributed.all_reduce(sums)
            res["mean_losses"] = dict(zip(sorted(losses), (sums / world).tolist()))
            res["grad_digest"] = tensors_digest(grads)
            if rank == 0:
                torch.save({"grads": grads,
                            "buffers": {n: b.detach().float().cpu()
                                        for n, b in model.named_buffers()}},
                           pathlib.Path(spec["out"]) / "nccl_ddp_tensors.pt")
            after = params
        else:
            res["zero1_param_gap"] = max(float((p - after[n]).abs().max())
                                         for n, p in params.items())
            res["zero1_moment_bytes"] = moment_bytes(state.optimizer)
            res["zero1_parts"] = zero1_parts(model.parameters(), world)
            res["full_moment_bytes"] = 2 * sum(p.numel() * p.element_size()
                                               for p in model.parameters())
        del model, ddp, state
        torch.cuda.empty_cache()
    # the step's time as the command line trains (no comm hook), and each
    # rank's own model without DDP at the same time: weak scaling on the
    # host the ranks share
    for label in ("alone", "ddp"):
        model = create_model(cfg, device=device)
        model.load_state_dict(seeded_weights(model), strict=True)
        ddp = wrap_model(model, device) if label == "ddp" else None
        state = create_train_state(model, OptimConfig(warmup_epochs=0), share * world, 1,
                                   seed=SEED + rank, ddp=ddp)
        res[f"ms_{label}"] = cuda_time_ms(lambda: step(state, batch), warmup=2, reps=5)
        del model, ddp, state
        torch.cuda.empty_cache()
        torch.distributed.barrier()
    (pathlib.Path(spec["out"]) / f"nccl_ddp_{rank}.json").write_text(json.dumps(res))
    mesh.destroy()


def phase_nccl_ddp(stats: dict) -> None:
    """Data parallelism over NCCL across four cards, one rank a card,
    through the user's entry point: ``python -m torch.distributed.run
    --nproc_per_node=4 chip_smoke.py --ddp-rank nccl_ddp`` runs
    ``mvlt_tpu_torch.cli.main`` with configs/pretrain_exp21.py on synthetic
    data (B = 150 a rank, 2 epochs of one step, the VL eval in epoch 1):
    NCCL at world 4, finite losses and eval statistics, every rank's
    training kernels launched once per block a step. Then, in the ranks,
    one DDP step (pvlt_tiny, the pre-training heads, DropPath and dropout
    off, seeded weights) on each rank's quarter of a B = 600 batch against
    this process's step at B = 600 on cuda:0: the losses within DDP_TOL,
    every gradient within ddp_two_ranks' bound (DDP_TOL or the step's own
    reordering noise, plus for a gradient formed in bf16 the ranks' and
    the one-process bf16 roundings), the BatchNorm statistics within
    DDP_TOL, every rank's gradients equal; the same step under ZeRO-1 (the
    parameters within ZERO_TOL of the DDP step's; each rank's moments
    exactly a quarter of those ZeRO-1 splits by element plus the whole of
    the others, both parts printed). The DDP step's ms a rank at B = 150 and its samples/s at world
    4 beside each rank's own model without DDP, timed at once on the host
    the ranks share: the weak-scaling efficiency (this process's step at B
    = 150 on cuda:0 printed beside)."""
    cfg = ddp_config()
    global_b = TRAIN_BATCH * NCCL_CARDS
    DDP_DIR.mkdir(parents=True, exist_ok=True)
    arrays = {k: v for k, v in train_batch(SEED + 37, global_b).items()
              if isinstance(v, np.ndarray)}
    np.savez(DDP_DIR / "nccl_batch.npz", **arrays)
    batch = batch_to_device(arrays, "cuda")
    want = one_process_step(cfg, batch, global_b)
    half = global_b // 2
    swapped = one_process_step(cfg, {k: torch.cat([v[half:], v[:half]])
                                     for k, v in batch.items()}, global_b)
    swap = rel_gaps(swapped["grads"], want["grads"])
    del batch, swapped
    one = batch_to_device({k: v[:TRAIN_BATCH] for k, v in arrays.items()}, "cuda")
    model = create_model(cfg)
    model.load_state_dict(seeded_weights(model), strict=True)
    state = create_train_state(model, OptimConfig(warmup_epochs=0), TRAIN_BATCH, 1, seed=SEED)
    step = make_train_step(cfg)
    one_ms = cuda_time_ms(lambda: step(state, one), warmup=1, reps=3)
    del model, state, one
    torch.cuda.empty_cache()
    run = DDP_DIR / "nccl_ddp_run"
    argv = ["--config", str(PRETRAIN_CONFIG), "--synthetic-data", "--epochs", "2",
            "--output-dir", str(run)]
    start = time.perf_counter()
    try:
        ranks = spawn_ranks("nccl_ddp", NCCL_CARDS,
                            {"argv": argv, "batch": str(DDP_DIR / "nccl_batch.npz"),
                             "out": str(DDP_DIR)}, timeout=900, torchrun=True)
        got = torch.load(DDP_DIR / "nccl_ddp_tensors.pt", weights_only=True)
        log = _train_log(run)
    finally:
        shutil.rmtree(DDP_DIR, ignore_errors=True)
    seconds = time.perf_counter() - start
    grads = want["grads"]
    gaps = rel_gaps(got["grads"], grads)
    swap_max = max(swap.values())
    bf16_formed = {n for n, w in grads.items() if torch.equal(w.to(torch.bfloat16).float(), w)}
    bounds = {}
    for n, w in grads.items():
        big = float(w.abs().max())
        bounds[n] = max(DDP_TOL, SWAP_FACTOR * swap_max)
        if n in bf16_formed:   # each rank's rounding of its partial, and the total's
            partial = max(r["partial_max"][n] for r in ranks)
            bounds[n] += BF16_SPACING * (NCCL_CARDS * partial + big) / max(big, 1e-30)
    ratios = {n: gaps[n] / bounds[n] for n in gaps}
    worst = max(ratios, key=ratios.get)
    bn_gap = max(rel_gaps(got["buffers"], want["buffers"]).values())
    l_gap = loss_gap(ranks[0]["mean_losses"], want["losses"])
    steps = len(log)
    cli_expected = {"attention_fwd": 8 * steps, "attention_bwd": 8 * steps,
                    "ln_mlp_fwd": 8 * steps, "ln_mlp_bwd": 8 * steps, "mlm_ce_fwd": steps,
                    "mlm_ce_bwd": steps}
    rank_ms, alone_ms = [r["ms_ddp"] for r in ranks], [r["ms_alone"] for r in ranks]
    world1_ms = statistics.median(alone_ms)
    checks = {
        "backend_nccl_world_4": all(r["backend"] == "nccl" and r["world"] == NCCL_CARDS
                                    for r in ranks),
        "one_card_a_rank": len({r["device"] for r in ranks}) == NCCL_CARDS,
        "cli_epochs": steps == 2 and all(np.isfinite(v) for ln in log for v in ln.values())
        and any(k.startswith("eval_") for k in log[-1]),
        "cli_launches": all(all(r["cli_launches"][k] == v for k, v in cli_expected.items())
                            for r in ranks),
        "losses": l_gap <= DDP_TOL, "grads": ratios[worst] <= 1.0,
        "batchnorms": bn_gap <= DDP_TOL,
        "ranks_equal": len({r["grad_digest"] for r in ranks}) == 1,
        "launches": all(r["launches"] == ranks[0]["launches"] for r in ranks)
        and ranks[0]["launches"]["attention_fwd"] == 8,
        "zero1_params": all(r["zero1_param_gap"] <= ZERO_TOL for r in ranks),
        "zero1_moments_split": all(r["zero1_moment_bytes"] == r["zero1_parts"]["rank_bytes"]
                                   for r in ranks),
    }
    ok = all(checks.values())
    emit("nccl_ddp", model="pvlt_tiny", world=NCCL_CARDS, batch_per_rank=TRAIN_BATCH,
         global_batch=global_b, checks=checks, rel_err_losses=l_gap,
         worst_grad_over_bound=[worst, ratios[worst]], rel_err_grads_max=max(gaps.values()),
         top_grad_ratios=[[n, ratios[n], gaps[n], bounds[n], swap[n]]
                          for n in sorted(ratios, key=ratios.get, reverse=True)[:6]],
         swap_grad_gap_max=swap_max, rel_err_batchnorms=bn_gap, tol=DDP_TOL,
         zero1_param_gap=[r["zero1_param_gap"] for r in ranks], zero_tol=ZERO_TOL,
         zero1_moment_bytes=[r["zero1_moment_bytes"] for r in ranks],
         zero1_sharded_bytes=ranks[0]["zero1_parts"]["sharded_bytes"],
         zero1_replicated_bytes=ranks[0]["zero1_parts"]["replicated_bytes"],
         zero1_rank_bytes_expected=ranks[0]["zero1_parts"]["rank_bytes"],
         full_moment_bytes=ranks[0]["full_moment_bytes"],
         cards=[r["card"] for r in ranks], cli_log=log, cli_launches=ranks[0]["cli_launches"],
         cli_seconds=[r["cli_seconds"] for r in ranks],
         ms_per_step_world4=rank_ms, ms_per_step_alone=alone_ms,
         ms_per_step_one_process_cuda0=one_ms,
         samples_per_s_world4=NCCL_CARDS * TRAIN_BATCH / max(rank_ms) * 1e3,
         samples_per_s_world1=TRAIN_BATCH / world1_ms * 1e3,
         weak_scaling_efficiency=world1_ms / max(rank_ms),
         ms_note="CUDA events around a step, 2 warm-up, median of 5, every rank at once: "
                 "world 4, each rank's DDP step at B = 150 with its NCCL all-reduces (the "
                 "slowest rank sets the rate); world 1, each rank's own model without DDP (the "
                 "median); one_process_cuda0: this process before the ranks (1 warm-up, "
                 "median of 3)",
         seconds=seconds, ok=ok)
    if not ok:
        raise AssertionError(f"nccl_ddp failed {[k for k, v in checks.items() if not v]}: "
                             f"losses {l_gap}, gradient over its bound {worst} {ratios[worst]}, "
                             f"BatchNorms {bn_gap}")


def nccl_tp_rank(spec: dict) -> None:
    """A rank of ``nccl_tp`` (torchrun, one rank a card, NCCL, dp 2 x tp
    2): per family of the spec, the pre-training command line at
    --tp-size 2 (one epoch with its VL eval) and one split step at B = 150
    on this data rank's half of the B = 300 batch (consolidated gradients,
    parameters and BatchNorm statistics, rank 0 writes them; each rank's
    digest of its own; the step's time), the command line for the
    families of NCCL_FAMILIES only; with ``zero1``, v2's split step
    without and with ZeRO-1 over the data group (each rank's moment bytes
    and their expected parts), the ZeRO-1 state saved by CheckpointManager
    (rank 0 compares its moments with the plain step's consolidated ones),
    then restored here under ZeRO-1 and gathered whole again (rank 0
    compares them and the parameters with the file's)."""
    from mvlt_tpu_torch.parallel import mesh
    from mvlt_tpu_torch.parallel.tensor import consolidate
    from mvlt_tpu_torch.utils.checkpoint import (STATE_FILE, CheckpointManager, _moment_names,
                                                 whole_state)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = mesh.maybe_init_distributed(timeout_s=NCCL_TIMEOUT_S)
    out = pathlib.Path(spec["out"])
    rank = mesh.rank()
    res = {"backend": torch.distributed.get_backend(), "world": mesh.world_size(),
           "device": str(device)}
    host = dict(np.load(spec["batch"]))
    tensors = {}
    for name in spec["families"]:
        if spec["cli"] and name in NCCL_FAMILIES:
            run = out / f"nccl_tp_{name}"
            reset_launches()
            cli.main(["--config", str(PRETRAIN_CONFIG), "--synthetic-data", "--epochs", "1",
                      "--model", name, "--tp-size", str(NCCL_TP), "--output-dir", str(run)])
            torch.cuda.synchronize()
            torch.distributed.barrier()       # rank 0 has written the log
            res[f"cli_{name}"] = {"launches": read_launches(),
                                  "log": _train_log(run) if rank == 0 else None}
        mesh.init_model_parallel(NCCL_TP)
        res["ranks"] = [mesh.data_rank(), mesh.model_rank()]
        share = host["images"].shape[0] // mesh.data_size()
        lo = mesh.data_rank() * share
        batch = batch_to_device({k: v[lo:lo + share] for k, v in host.items()}, device)
        cfg, _ = nccl_tp_case(name)
        model, state = split_train_state(cfg, device, share * mesh.data_size(),
                                         mesh.model_group())
        step = make_train_step(cfg)
        reset_launches()
        _, losses = step(state, batch)
        torch.cuda.synchronize()
        launches = read_launches()
        tensors[name] = consolidated(model, mesh.model_group())
        sums = torch.tensor([float(losses[k]) for k in sorted(losses)], dtype=torch.float64,
                            device=device)
        torch.distributed.all_reduce(sums, group=mesh.data_group())
        res[name] = {"launches": launches,
                     "mean_losses": dict(zip(sorted(losses), (sums / mesh.data_size()).tolist())),
                     "digests": {k: tensors_digest(v) for k, v in tensors[name].items()},
                     "ms_per_step": cuda_time_ms(lambda: step(state, batch), warmup=1, reps=3)}
        del model, state
        torch.cuda.empty_cache()
    if spec["zero1"]:
        mesh.init_model_parallel(NCCL_TP)
        share = host["images"].shape[0] // mesh.data_size()
        lo = mesh.data_rank() * share
        batch = batch_to_device({k: v[lo:lo + share] for k, v in host.items()}, device)
        cfg = dataclasses.replace(ddp_config(), name="pvlt_v2_tiny")
        for zero1 in (False, True):
            model, state = split_train_state(cfg, device, share * mesh.data_size(),
                                             mesh.model_group(), zero1=zero1)
            make_train_step(cfg)(state, batch)
            torch.cuda.synchronize()
            if zero1:
                res["zero1_moment_bytes"] = moment_bytes(state.optimizer)
                res["zero1_parts"] = zero1_parts(model.parameters(), mesh.data_size())
                CheckpointManager(str(out / "nccl_tp_zero1")).save_epoch(state, 0, 1)
                res["zero1_params_digest"] = tensors_digest(
                    consolidated(model, mesh.model_group())["params"])
            else:   # the plain step's moments and parameters, whole, by name
                order = _moment_names(state)
                by_name = {n: state.optimizer.state[p] for n, p in model.named_parameters()}
                moments = {k: consolidate({n: by_name[n][k] for n in order},
                                          mesh.model_group(), cfg)
                           for k in ("exp_avg", "exp_avg_sq")}
                plain_params = consolidated(model, mesh.model_group())["params"]
                buffer_names = [n for n, _ in model.named_buffers()]
            del model, state
            torch.cuda.empty_cache()
        # the round trip: the checkpoint restored under ZeRO-1 at dp 2 x tp 2
        model, state = split_train_state(cfg, device, share * mesh.data_size(),
                                         mesh.model_group(), zero1=True)
        state, _ = CheckpointManager(str(out / "nccl_tp_zero1")).restore(state, "last")
        res["zero1_restored_moment_bytes"] = moment_bytes(state.optimizer)
        state.optimizer.consolidate_state_dict()
        back_model, back_optim = whole_state(state)
        del model, state
        torch.cuda.empty_cache()
        if rank == 0:
            saved = torch.load(out / "nccl_tp_zero1" / "checkpoint" / "last" / STATE_FILE,
                               map_location="cpu", weights_only=True)
            res["zero1_round_trip"] = (
                all(torch.equal(back_model[n].cpu(), t) for n, t in saved["model"].items())
                and sorted(back_optim["state"]) == sorted(saved["optimizer"]["state"])
                and all(torch.equal(back_optim["state"][i][k].cpu(), st[k])
                        for i, st in saved["optimizer"]["state"].items()
                        for k in ("exp_avg", "exp_avg_sq")))
            saved_m = saved["optimizer"]["state"]
            res["zero1_saved_moment_gap"] = max(
                float((saved_m[i][k].float().cpu() - moments[k][n].float().cpu()).abs().max())
                for i, n in enumerate(order) for k in moments)
            res["zero1_saved_param_gap"] = max(
                float((saved["model"][n].float().cpu() - v).abs().max())
                for n, v in plain_params.items())
            res["zero1_saved_names"] = (sorted(saved_m) == list(range(len(order)))
                                        and sorted(saved["model"])
                                        == sorted([*plain_params, *buffer_names]))
    if rank == 0:
        torch.save(tensors, out / "nccl_tp_tensors.pt")
    (out / f"nccl_tp_{rank}.json").write_text(json.dumps(res))
    mesh.destroy()


def phase_nccl_tp(stats: dict, families=(*NCCL_FAMILIES, *NCCL_TP_ROUTES),
                  run_cli: bool = True, zero1: bool = True) -> None:
    """Tensor parallelism over NCCL across four cards as dp 2 x tp 2 (model
    groups of cards 0-1 and 2-3), through ``python -m
    torch.distributed.run --nproc_per_node=4 chip_smoke.py --ddp-rank
    nccl_tp``: for v1, v2 and Swin at 256 (``families``), the pre-training
    command line at --tp-size 2 for one epoch (finite losses, the VL eval,
    the layout) and one split step at B = 150 a data rank against this
    process's step at B = 300 on cuda:0: the losses (the data ranks' mean)
    within DDP_TOL, each consolidated gradient within tp_two_ranks' bound
    and each parameter within ZERO_TOL of AdamW's step on the consolidated
    gradients (param_gap), the
    BatchNorm statistics within DDP_TOL, the digests of every rank's
    consolidated tensors equal, a rank's launches of #10-#15 as
    TP_FAMILY_LAUNCHES, a rank's ms a step beside this process's at B =
    150; v1's split step also on the fused_attn_train route (#6-#8's
    tensor-parallel modes, NCCL_TP_ROUTES), without a command line. With
    ``zero1``: v2's split step under ZeRO-1 over the data group, its
    consolidated checkpoint's moments and parameters within ZERO_TOL of the
    plain split step's, each rank's moments exactly half of its shard's
    moments that split by element plus the others (zero1_parts), the
    checkpoint restored by the ranks under ZeRO-1 and gathered whole again
    equal to the file, and resumed here at tp = 1 without ZeRO-1 to those
    parameters (the ranks' digest) and moments (the file's, exactly)."""
    from mvlt_tpu_torch.utils.checkpoint import STATE_FILE, CheckpointManager

    global_b = TRAIN_BATCH * (NCCL_CARDS // NCCL_TP)
    DDP_DIR.mkdir(parents=True, exist_ok=True)
    arrays = {k: v for k, v in train_batch(SEED + 41, global_b).items()
              if isinstance(v, np.ndarray)}
    np.savez(DDP_DIR / "nccl_tp_batch.npz", **arrays)
    batch = batch_to_device(arrays, "cuda")
    one = batch_to_device({k: v[:TRAIN_BATCH] for k, v in arrays.items()}, "cuda")
    half = global_b // 2
    want, swaps, one_ms = {}, {}, {}
    for name in families:
        cfg, _ = nccl_tp_case(name)
        want[name] = one_process_step(cfg, batch, global_b)
        swaps[name] = rel_gaps(one_process_step(cfg, {k: torch.cat([v[half:], v[:half]])
                                                      for k, v in batch.items()}, global_b)["grads"],
                               want[name]["grads"])
        model = create_model(cfg)
        model.load_state_dict(seeded_weights(model), strict=True)
        state = create_train_state(model, OptimConfig(warmup_epochs=0), TRAIN_BATCH, 1,
                                   seed=SEED)
        step = make_train_step(cfg)
        one_ms[name] = cuda_time_ms(lambda: step(state, one), warmup=1, reps=3)
        del model, state
        torch.cuda.empty_cache()
    del batch, one
    torch.cuda.empty_cache()
    start = time.perf_counter()
    restored_ok = None
    try:
        ranks = spawn_ranks("nccl_tp", NCCL_CARDS,
                            {"batch": str(DDP_DIR / "nccl_tp_batch.npz"), "out": str(DDP_DIR),
                             "families": list(families), "cli": run_cli, "zero1": zero1},
                            timeout=1200, torchrun=True)
        got = torch.load(DDP_DIR / "nccl_tp_tensors.pt", weights_only=True)
        if zero1:   # the ZeRO-1 checkpoint at tp = 1 without ZeRO-1, in this process
            ckpt = DDP_DIR / "nccl_tp_zero1"
            saved = torch.load(ckpt / "checkpoint" / "last" / STATE_FILE, map_location="cpu",
                               weights_only=True)
            model = create_model(dataclasses.replace(ddp_config(), name="pvlt_v2_tiny"))
            state = create_train_state(model, OptimConfig(warmup_epochs=0), global_b, 1)
            state, _ = CheckpointManager(str(ckpt)).restore(state, "last")
            params = {n: p.detach().float().cpu() for n, p in model.named_parameters()}
            moments = state.optimizer.state_dict()["state"]
            restored_ok = (tensors_digest(params) == ranks[0]["zero1_params_digest"]
                           and all(torch.equal(moments[i][k].cpu(), st[k])
                                   for i, st in saved["optimizer"]["state"].items()
                                   for k in ("exp_avg", "exp_avg_sq")))
            del model, state
    finally:
        shutil.rmtree(DDP_DIR, ignore_errors=True)
    seconds = time.perf_counter() - start
    failed, results = [], {}
    for name in families:
        expected = {w: nccl_tp_case(name)[1].get(w, 0) for w in WRAPPERS}
        cmp = compare_split_step(got[name], want[name], swaps[name])
        l_gap = loss_gap(ranks[0][name]["mean_losses"], want[name]["losses"])
        checks = {"losses": l_gap <= DDP_TOL, "grads": cmp["grad_ratio"][1] <= 1.0,
                  "params": cmp["param_gap"][1] <= ZERO_TOL, "batchnorms": cmp["bn_gap"] <= DDP_TOL,
                  "ranks_equal": len({json.dumps(r[name]["digests"], sort_keys=True)
                                      for r in ranks}) == 1,
                  "launches": all(r[name]["launches"] == expected for r in ranks)}
        if run_cli and name in NCCL_FAMILIES:
            log = ranks[0][f"cli_{name}"]["log"]
            checks["cli_epoch"] = (len(log) == 1 and any(k.startswith("eval_") for k in log[0])
                                   and all(np.isfinite(v) for v in log[0].values()))
        results[name] = {"checks": checks, "rel_err_losses": l_gap,
                         "ms_per_step_rank": [r[name]["ms_per_step"] for r in ranks],
                         "ms_per_step_one_process_b150": one_ms[name],
                         "launches": ranks[0][name]["launches"], **cmp}
        if run_cli and name in NCCL_FAMILIES:
            results[name]["cli_log"] = ranks[0][f"cli_{name}"]["log"]
        failed += [f"{name}:{k}" for k, v in checks.items() if not v]
    common = {"backend_nccl_world_4": all(r["backend"] == "nccl" and r["world"] == NCCL_CARDS
                                          for r in ranks),
              "one_card_a_rank": len({r["device"] for r in ranks}) == NCCL_CARDS}
    if families:
        common["layout"] = [r["ranks"] for r in ranks] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    if zero1:
        common["zero1_saved"] = (ranks[0]["zero1_saved_names"] is True
                                 and ranks[0]["zero1_saved_moment_gap"] <= ZERO_TOL
                                 and ranks[0]["zero1_saved_param_gap"] <= ZERO_TOL)
        common["zero1_resumed_tp1"] = bool(restored_ok)
        common["zero1_moments_split"] = all(
            r["zero1_moment_bytes"] == r["zero1_parts"]["rank_bytes"]
            == r["zero1_restored_moment_bytes"] for r in ranks)
        common["zero1_round_trip_dp2_tp2"] = ranks[0]["zero1_round_trip"] is True
    failed += [k for k, v in common.items() if not v]
    ok = not failed
    emit("nccl_tp", dp=NCCL_CARDS // NCCL_TP, tp=NCCL_TP, batch_per_data_rank=TRAIN_BATCH,
         global_batch=global_b, checks=common, families=results, tol=DDP_TOL,
         zero1_saved_moment_gap=ranks[0].get("zero1_saved_moment_gap"),
         zero1_saved_param_gap=ranks[0].get("zero1_saved_param_gap"),
         zero1_moment_bytes=[r.get("zero1_moment_bytes") for r in ranks], zero_tol=ZERO_TOL,
         zero1_parts=[r.get("zero1_parts") for r in ranks],
         ms_note="CUDA events around a step, 1 warm-up, median of 3; a rank: B = 150 on its "
                 "half of the model, with its NCCL sums; one process: B = 150, the whole model",
         seconds=seconds, ok=ok)
    if not ok:
        raise AssertionError(f"nccl_tp failed {failed}: " + "; ".join(
            f"{n} grads {r['grad_ratio']} params {r['param_gap']} losses "
            f"{r['rel_err_losses']} BN {r['bn_gap']}" for n, r in results.items()))


def phase_nccl_tp_step(stats: dict) -> None:
    """nccl_tp's split step of v1 alone (no command line, no ZeRO-1)."""
    phase_nccl_tp(stats, families=("pvlt_tiny",), run_cli=False, zero1=False)


def phase_nccl_tp_zero1(stats: dict) -> None:
    """nccl_tp's ZeRO-1 checkpoint alone."""
    phase_nccl_tp(stats, families=(), run_cli=False, zero1=True)


NCCL_SP_CASES = {    # label: (model group size, serving models, step cases, the step
    # cases with the weights split over the model group too, global batch)
    "sp4": (NCCL_CARDS, ("pvlt_tiny", "pvlt_swin_tiny"), ("v1", "swin"), ("v1",), TRAIN_BATCH),
    "dp2_sp2": (2, (), ("v2",), (), 2 * TRAIN_BATCH),
}


def nccl_sp_rank(spec: dict) -> None:
    """A rank of ``nccl_sp`` (torchrun, one rank a card, NCCL): for each case
    of NCCL_SP_CASES, its model groups made, ``sp_rank_cases`` on them;
    rank 0 writes the tensors."""
    from mvlt_tpu_torch.parallel import mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = mesh.maybe_init_distributed(timeout_s=NCCL_TIMEOUT_S)
    out = pathlib.Path(spec["out"])
    res = {"backend": torch.distributed.get_backend(), "world": mesh.world_size(),
           "device": str(device)}
    tensors = {}
    for label, (sp, serving, steps, sptp_steps, _) in NCCL_SP_CASES.items():
        mesh.init_model_parallel(sp)
        case_spec = {"serving": serving, "steps": steps, "sptp_steps": sptp_steps,
                     "batch": spec[f"batch_{label}"], "time": True}
        r, t = sp_rank_cases(case_spec, device, mesh.model_group())
        res[label] = {**r, "ranks": [mesh.data_rank(), mesh.model_rank()]}
        tensors[label] = t
    if mesh.rank() == 0:
        torch.save(tensors, out / "nccl_sp_tensors.pt")
    (out / f"nccl_sp_{mesh.rank()}.json").write_text(json.dumps(res))
    mesh.destroy()


def phase_nccl_sp(stats: dict) -> None:
    """Sequence parallelism over NCCL across four cards, through ``python -m
    torch.distributed.run --nproc_per_node=4 chip_smoke.py --ddp-rank
    nccl_sp``: sp 4 (one model group of the four cards, bands of a quarter
    of each stage's grid rows and 32 text rows; Swin's stages 1-2 split,
    3-4 whole) serving pvlt_tiny's and pvlt_swin_tiny's B = 101 bundle and
    taking their B = 150 steps, then pvlt_tiny's step with its weights split
    over the same four ranks (sequence and tensor parallelism on one model
    group); then dp 2 x sp 2 taking v2's step,
    B = 150 a data rank against this process's at B = 300. Each against
    this process with sp_two_ranks' bounds and launches (sp_compare); every
    rank the same digests; a rank's ms a forward and a step beside this
    process's (information)."""
    DDP_DIR.mkdir(parents=True, exist_ok=True)
    spec = {"out": str(DDP_DIR)}
    serving, want, swaps, one_ms, cyclic = {}, {}, {}, {}, {}
    for label, (_, names, steps, _, global_b) in NCCL_SP_CASES.items():
        arrays = {k: v for k, v in train_batch(SEED + 71, global_b).items()
                  if isinstance(v, np.ndarray)}
        spec[f"batch_{label}"] = str(DDP_DIR / f"nccl_sp_{label}.npz")
        np.savez(spec[f"batch_{label}"], **arrays)
        batch = batch_to_device(arrays, "cuda")
        serving[label] = sp_serving_reference(names, "cuda", NCCL_SP_CASES[label][0])
        want[label], swaps[label], one_ms[label] = sp_step_references(steps, batch, global_b)
        sp = NCCL_SP_CASES[label][0]
        if sp > 2:   # the split weights' partials are summed over sp ranks: sp-way moves
            cyclic[label] = {case: cyclic_moves(sp_step_config(case), batch, global_b, sp,
                                                want[label][case]["grads"])
                             for case in NCCL_SP_CASES[label][3]}
        del batch
        torch.cuda.empty_cache()
    start = time.perf_counter()
    try:
        ranks = spawn_ranks("nccl_sp", NCCL_CARDS, spec, timeout=900, torchrun=True)
        got = torch.load(DDP_DIR / "nccl_sp_tensors.pt", weights_only=True)
    finally:
        shutil.rmtree(DDP_DIR, ignore_errors=True)
    seconds = time.perf_counter() - start
    failed, results, bounds = [], {}, {}
    for label, (sp, *_) in NCCL_SP_CASES.items():
        res, bad = sp_compare([r[label] for r in ranks], got[label], serving[label], want[label],
                              swaps[label], sp, cyclic.get(label))
        for case, moves in cyclic.get(label, {}).items():
            two = step_bounds(want[label][case]["grads"], swaps[label][case])
            many = step_bounds(want[label][case]["grads"], moves)
            gaps = rel_gaps(got[label][f"sptp_{case}"]["grads"], want[label][case]["grads"])
            worst = max(gaps, key=lambda n: gaps[n] / many[n])
            bounds[f"{label}/sptp_{case}"] = {
                "two_way_bound_max": max(two.values()), f"{sp}_way_bound_max": max(many.values()),
                "two_way_move_max": max(swaps[label][case].values()),
                f"{sp}_way_move_max": max(moves.values()),
                "worst": [worst, gaps[worst], gaps[worst] / two[worst],
                          gaps[worst] / many[worst]],
                "top": [[n, gaps[n], two[n], many[n], gaps[n] / many[n]]
                        for n in sorted(gaps, key=lambda n: gaps[n] / many[n],
                                        reverse=True)[:6]]}
        for key, r in res.items():
            if key.removeprefix("sptp_") in one_ms[label]:
                r["ms_step_one_process_b150"] = one_ms[label][key.removeprefix("sptp_")]
        results[label] = res
        failed += [f"{label}:{k}" for k in bad]
    common = {"backend_nccl_world_4": all(r["backend"] == "nccl" and r["world"] == NCCL_CARDS
                                          for r in ranks),
              "one_card_a_rank": len({r["device"] for r in ranks}) == NCCL_CARDS,
              "layout_sp4": [r["sp4"]["ranks"] for r in ranks] == [[0, q] for q in range(4)],
              "layout_dp2_sp2": [r["dp2_sp2"]["ranks"] for r in ranks]
              == [[0, 0], [0, 1], [1, 0], [1, 1]]}
    failed += [k for k, v in common.items() if not v]
    ok = not failed
    emit("nccl_sp", checks=common, cases=results, tol=DDP_TOL, serving_tol=SLICE_TOL,
         sptp_bounds=bounds,
         bounds_note="the split weights' cases at sp 4 take the bound of the four-way cyclic "
                     "moves of one process's step (cyclic_moves); each gradient's gap over the "
                     "two-way and the four-way bound, [name, gap, two-way, four-way, ratio]",
         ms_note="CUDA events, 1 warm-up, median of 3; a rank: its band of every stage with "
                 "its NCCL gathers; one process: the whole model, B = 101 a forward, B = 150 "
                 "a step",
         seconds=seconds, ok=ok)
    if not ok:
        raise AssertionError(f"nccl_sp failed {failed}: " + "; ".join(
            f"{lb}/{c} {r.get('grad_ratio')} {r.get('param_gap')} {r.get('rel_err_itm_input')}"
            for lb, res in results.items() for c, r in res.items()))


def main_cards(cards: int) -> int:
    """``--cards 4``: the build, then data and tensor parallelism over NCCL
    across the cards (nccl_ddp, nccl_tp), each rank on its own card."""
    if cards != NCCL_CARDS:
        raise ValueError(f"--cards {cards}: the multi-card mode takes {NCCL_CARDS} cards")
    if torch.cuda.device_count() < cards:
        raise RuntimeError(f"--cards {cards}: torch sees {torch.cuda.device_count()} CUDA "
                           f"devices")
    smi = phase_device()
    emit("cards", nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines())
    phase_build()
    stats = new_stats()
    timed("nccl_ddp", phase_nccl_ddp, stats)
    timed("nccl_tp", phase_nccl_tp, stats)
    timed("nccl_sp", phase_nccl_sp, stats)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cards}}), flush=True)
    return 0


DDP_ROLES = {"world1": ddp_world1_rank, "two_ranks": ddp_two_ranks_rank,
             "tp_two_ranks": tp_two_ranks_rank, "tp_families": tp_families_rank,
             "nccl_ddp": nccl_ddp_rank, "nccl_tp": nccl_tp_rank,
             "sp_two_ranks": sp_two_ranks_rank, "nccl_sp": nccl_sp_rank}



def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--ddp-rank":   # a rank of a ddp_* phase
        DDP_ROLES[sys.argv[2]](json.loads(pathlib.Path(sys.argv[3]).read_text()))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 2
    if len(sys.argv) > 2 and sys.argv[1] == "--cards":
        return main_cards(int(sys.argv[2]))
    smi = phase_device()
    phase_build()
    stats = new_stats()
    phase_kernels(stats)
    phase_uint8()
    model, bundles, sd = phase_slice(stats)
    check_blocks(model, bundles[0])
    compare_cpu_fp32(model, bundles[0], sd)
    phase_throughput(model, bundles, V1_GROUPS)
    del model
    phase_v2_kernels(stats)
    model, bundles, sd = phase_slice(stats, "pvlt_v2_tiny", V2_SERVING_WRAPPERS, "v2_slice")
    check_v2_blocks(model, bundles[0])
    compare_cpu_fp32(model, bundles[0], sd, "v2_slice_vs_cpu_fp32")
    phase_throughput(model, bundles, V2_GROUPS, "v2_")
    del model
    torch.cuda.empty_cache()
    phase_swin(stats)
    phase_recognition_kernels(stats)
    phase_recognition()
    phase_train_kernels(stats)
    phase_mlm_kernels(stats)
    state, cfg, sd, batch = phase_train_slice(stats)
    check_train_blocks(state, cfg, batch)
    phase_train_throughput(state, cfg)
    del state, batch
    torch.cuda.empty_cache()
    timed("scan_steps", phase_scan_steps, stats)
    phase_fba_train_kernels(stats)
    phase_fba_train(stats)
    compare_train_cpu(cfg, sd, {"train_vs_cpu_fp32": (False, False),
                                **{p + "_train_vs_cpu_fp32": f for p, f in FBA_FORMS.items()}})
    timed("train_glue", phase_train_glue, stats)
    timed("v2_route", phase_v2_route, stats)
    timed("v2_train", phase_family_train, stats, "pvlt_v2_tiny", V2_TRAIN_ROUTE, "v2_")
    timed("swin_train", phase_family_train, stats, "pvlt_swin_tiny", SWIN_TRAIN_ROUTE, "swin_")
    timed("linear", phase_linear, stats)
    timed("dropout", phase_dropout, stats)
    timed("remat", phase_remat, stats)
    timed("remat_large", phase_remat_large, stats)
    timed("registry", phase_registry, stats)
    phase_cli(stats)
    phase_cli_eval()
    timed("ddp_world1", phase_ddp_world1, stats)
    timed("ddp_two_ranks", phase_ddp_two_ranks, stats)
    timed("tp_kernels", phase_tp_kernels, stats)
    timed("tp_two_ranks", phase_tp_two_ranks, stats)
    timed("tp_families", phase_tp_families, stats)
    timed("sp_two_ranks", phase_sp_two_ranks, stats)
    print(json.dumps({"kernels": [
        {**k, **{key: v for key, v in stats[k["name"]].items() if key != "bound_shares"}}
        for k in KERNELS]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
