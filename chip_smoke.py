#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU: retrieval serving
(pvlt_tiny, pvlt_v2_tiny and pvlt_swin_tiny), the pre-training step, and
pre-training through the command line.

    python3 chip_smoke.py

run from the root of a checkout, on a machine with a CUDA card, the CUDA
toolkit (nvcc) and PyTorch built for CUDA; JAX is not needed. Phases, one
JSON line each; a failed phase raises and the script exits non-zero:

  1. device: card name and power limit (nvidia-smi), torch/CUDA/nvcc versions;
     TF32 off (matmul and cuDNN) for the fp32 comparisons;
  2. build: nvcc compiles mvlt_tpu_torch/csrc/*.cu for sm_90a; ptxas's
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
 11. the command line: ``mvlt_tpu_torch.cli.main`` with
     configs/pretrain_exp21.py on synthetic data (B = 150) for 2 epochs with
     the VL eval in epoch 1, ``--resume last`` for epoch 2, then one CLS
     fine-tune epoch (configs/finetune_exp48.py) from that checkpoint, in
     build/chip_smoke_cli (removed after): logs, checkpoints, finite losses
     and eval statistics, every kernel launched, the MLM CE kernels once per
     pre-training step.

Then one line {"kernels": [...]}: per kernel the launches of its path's
run (the MLM CE kernels': the command line's), the largest error of its
checks, its time and its plain version's summed over the four stage shapes
at the path's batch (one launch each; the MLM CE kernels at R = 3,072), the
bound, and the library call's time where there is one; the nvidia-smi
line; and last {"ok": true, "device": {...}}. Without a CUDA device it exits
non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from mvlt_tpu_torch import cli
from mvlt_tpu_torch.config import DataConfig, LossType, ModelConfig, OptimConfig
from mvlt_tpu_torch.data.fashion_gen import SyntheticFashionGen, batch_to_device, collate
from mvlt_tpu_torch.data.tokenizer import WordPieceTokenizer
from mvlt_tpu_torch.eval.retrieval import evaluate_retrieval, make_itm_scorer, uint8_to_unit
from mvlt_tpu_torch.models.pvlt import Block, SwinBlock, create_model, kernel_operand
from mvlt_tpu_torch.models.swin import (add_table, heads_of, relative_position_index,
                                        window_masks, window_partition, window_reverse)
from mvlt_tpu_torch.ops import _build
from mvlt_tpu_torch.ops.block_attention import (block_attention_bwd_reference,
                                                block_attention_reference,
                                                block_attention_train_bwd,
                                                block_attention_train_fwd,
                                                block_attention_train_reference,
                                                fused_block_attention,
                                                fused_block_attention_train)
from mvlt_tpu_torch.ops.block_fused import block_reference, fused_block
from mvlt_tpu_torch.ops.dwconv_mlp import dwconv_mlp_reference, fused_dwconv_mlp
from mvlt_tpu_torch.ops.fused_mlp import (fused_ln_mlp, ln_mlp_bwd, ln_mlp_bwd_reference,
                                          ln_mlp_fwd, ln_mlp_reference)
from mvlt_tpu_torch.ops.kernel_math import gelu_grad, layer_norm_fp32, linear
from mvlt_tpu_torch.ops.mlm_ce import (mlm_ce_bwd, mlm_ce_fwd, mlm_nll_bwd_reference,
                                       mlm_nll_reference)
from mvlt_tpu_torch.ops.pallas_attention import (attention_bwd, attention_fwd,
                                                 attention_reference,
                                                 attention_stats_bwd_reference,
                                                 attention_stats_reference, fused_attention)
from mvlt_tpu_torch.ops.sr_kv import fused_ln_sr_kv, sr_kv_reference
from mvlt_tpu_torch.ops.swin_attention import fused_swin_attention, swin_attention_reference
from mvlt_tpu_torch.ops.swin_band import fused_swin_block, swin_block_reference
from mvlt_tpu_torch.train.engine import train_one_epoch
from mvlt_tpu_torch.train.state import create_train_state
from mvlt_tpu_torch.train.step import make_train_step

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
WRAPPERS = {**SERVING_WRAPPERS, **V2_SERVING_WRAPPERS, **SWIN_WRAPPERS, **TRAINING_WRAPPERS,
            **MLM_WRAPPERS, **FBA_WRAPPERS}


def new_stats() -> dict:
    """Per kernel of KERNELS, the fields of its entry in the kernels line,
    summed or maxed over the phases that run it."""
    return {k["name"]: {"launches": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                        "bound_ms": 0.0, "bound_by": None, "library_ms": None,
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
    emit("build", library=str(path.relative_to(path.parents[2])),
         seconds=round(seconds, 2), ptxas=ptxas, hgmma=hgmma, ok=ok)
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


def synthetic_bundles(n: int, seed: int, size: int, text_len: int) -> list:
    """101-candidate bundles with FashionGenRetrieval's item schema: uint8
    NHWC images from the seed, token ids from the shipped WordPiece vocab."""
    tok = WordPieceTokenizer(str(pathlib.Path(__file__).resolve().parent
                                 / "preweights" / "bert-base-uncased-vocab.txt"))
    captions = ["a red cotton t-shirt with a round neck and short sleeves",
                "slim-fit black denim jeans with a five-pocket styling",
                "white leather sneakers with a rubber sole and lace-up front",
                "a navy wool coat with notched lapels and a button closure",
                "gold-tone hoop earrings", "a floral silk midi dress"]
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
                phase: str = "slice", size: int = 256, per_forward: dict | None = None):
    """``model_name``, built for and run at ``size``, scores three bundles
    through the serving entry points, launching each kernel of ``path``
    ``per_forward[name]`` times a forward (default once per block) and no
    other kernel; ``stats`` keeps this run's launches. Returns the model,
    the bundles and the weights."""
    cfg = ModelConfig(name=model_name, compute_dtype="bfloat16",
                      loss_type=LossType(itm=True, mlm=False, t2i=False, cls=False))
    model = create_model(cfg, device="cuda", input_size=size).eval()
    sd = seeded_state_dict(model, SEED)
    model.load_state_dict(sd, strict=True)
    bundles = synthetic_bundles(3, SEED + 1, size, cfg.num_text_tokens)
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


def compare_cpu_fp32(model, bundle, sd, phase: str = "slice_vs_cpu_fp32") -> float:
    """ITM logits of two pairs against the same weights in fp32 on the CPU
    (plain path), beside the plain path's own bf16 error on the CPU."""
    cfg = model.cfg
    images = uint8_to_unit(torch.from_numpy(bundle["images_101"][:2]))
    ids = torch.from_numpy(bundle["ori_input_ids_101"][:2]).long()
    logits = {}
    for dtype in ("float32", "bfloat16"):
        cpu = create_model(dataclasses.replace(cfg, compute_dtype=dtype), device="cpu",
                           input_size=model.input_size).eval()
        cpu.load_state_dict(sd, strict=True)
        with torch.no_grad():
            logits[dtype] = cpu(images, ids)["itm_logits"].float()
    with torch.no_grad():
        got = model(images.cuda(), ids.cuda())["itm_logits"].float().cpu()
    want = logits["float32"]
    scale = want.abs().max().item()
    diff = (got - want).abs().max().item()
    rel = diff / scale
    ok = bool(rel <= SLICE_TOL)
    emit(phase, pairs=2, logits_card=got.flatten().tolist(),
         logits_cpu=want.flatten().tolist(), max_abs_diff=diff, rel_err=rel,
         rel_err_cpu_bf16_plain=(logits["bfloat16"] - want).abs().max().item() / scale,
         tol=SLICE_TOL, ok=ok)
    if not ok:
        raise AssertionError(f"ITM logits on the card differ from the CPU fp32 "
                             f"model by {rel:.3e} > {SLICE_TOL}")
    return rel


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


def check_v2_blocks(model, bundle) -> None:
    """Every block of one B = 101 pvlt_v2_tiny forward against the plain
    versions on the block's own input and parameters, within KERNEL_TOL:
    K/V element by element and the attention half (kernels A and C run
    again on the block's input and cached operands, as the forward ran
    them), and the block's output."""
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
    errs = {"kv": [], "attn": [], "out": []}
    for blk, x, hw, out in seen:
        (kv_p, attn_p, mlp_p), (kv_kw, attn_kw, mlp_kw) = blk.kernel_params(), blk.kernel_kwargs()
        kv_ops, attn_ops, _ = blk.kernel_operands(x.dtype)
        with torch.no_grad():
            k_ref, v_ref = sr_kv_reference(x, hw, *kv_p, **kv_kw)
            attn_ref = block_attention_reference(x, k_ref, v_ref, *attn_p, **attn_kw)
            want = dwconv_mlp_reference(attn_ref, hw, *mlp_p, **mlp_kw)
            k, v = fused_ln_sr_kv(x, hw, *kv_ops, **kv_kw)
            attn = fused_block_attention(x, k, v, *attn_ops, **attn_kw)
        errs["kv"].append(max(_rel_err(k, k_ref)[1], _rel_err(v, v_ref)[1]))
        errs["attn"].append(_rel_err(attn, attn_ref)[1])
        errs["out"].append(_rel_err(out, want)[1])
    worst = max(errs["kv"] + errs["attn"] + errs["out"])
    ok = len(errs["out"]) == sum(model.cfg.depths) and worst <= KERNEL_TOL
    emit("v2_slice_blocks_vs_plain", batch=BATCH, blocks=len(errs["out"]),
         rel_err_kv=errs["kv"], rel_err_attn=errs["attn"], rel_err_out=errs["out"],
         tol=KERNEL_TOL, ok=ok)
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
        compare_cpu_fp32(model, bundles[0], sd, prefix + "slice_vs_cpu_fp32")
        if size == 256:
            swin_init_gap(model, bundles[0], sd)
        phase_throughput(model, bundles, SWIN_GROUPS, prefix)
        del model
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
    record = record or {name: name for name in route}
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
         steps=TRAIN_STEPS, seconds_host_inclusive=seconds, losses=losses,
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
    the gradients of the block's K and V (the fused call's dK, dV)."""
    model = state.model
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    seen = {}

    def pre(blk, args):
        seen[blk] = {"x": args[0].detach(), "hw": args[1], "rng": args[2].get_state()}

    def post(blk, args, out):
        seen[blk]["out"] = out.detach()
        out.register_hook(lambda g: seen[blk].__setitem__("dy", g))

    blocks = [blk for blk in model.modules() if isinstance(blk, Block)]
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


def phase_cli(stats: dict) -> None:
    """The pre-training entry point on the card, as a user runs it:
    ``mvlt_tpu_torch.cli.main`` with configs/pretrain_exp21.py on synthetic
    data (B = 150, one step per epoch over 64 items x 3 repeats) for 2
    epochs, the VL eval in epoch 1; then ``--resume last`` for epoch 2;
    then one CLS fine-tune epoch (configs/finetune_exp48.py) from that
    checkpoint. Checks the logs, the checkpoints, finite losses and eval
    statistics, and that every kernel of the path launched: the MLM CE
    kernels once per pre-training step."""
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
        reset_launches()
        seconds = {}
        for label, argv in runs:
            start = time.perf_counter()
            cli.main(argv)
            torch.cuda.synchronize()
            seconds[label] = time.perf_counter() - start
        launches = read_launches()
        pre_log, ft_log = _train_log(pre), _train_log(ft)
        steps = int(torch.load(pre / "checkpoint" / "last" / "state.pt", map_location="cpu",
                               weights_only=True)["step"])
        with open(pre / "checkpoint" / "last.json") as f:
            last_epoch = json.load(f)["epoch"]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    evals = [{k: v for k, v in line.items() if k.startswith("eval_")}
             for line in pre_log + ft_log]
    finite = all(np.isfinite(v) for line in pre_log + ft_log for v in line.values())
    ok = ([line["epoch"] for line in pre_log] == [0, 1, 2] and len(ft_log) == 1
          and not evals[0] and all(evals[1:]) and finite and steps == 3 and last_epoch == 2
          and launches["mlm_ce_fwd"] == launches["mlm_ce_bwd"] == steps
          and all(launches[name] for name in
                  (*SERVING_WRAPPERS, *TRAINING_WRAPPERS, *MLM_WRAPPERS))
          and not any(launches[name] for name in V2_SERVING_WRAPPERS if name != "sr_kv")
          and not any(launches[name] for name in FBA_WRAPPERS))
    emit("cli", config="configs/pretrain_exp21.py", batch=TRAIN_BATCH, epochs_run=[0, 1, 2],
         resumed_at_epoch=2, pretrain_steps=steps, finetune_steps=1, seconds=seconds,
         losses={f"epoch{line['epoch']}": line["total_loss"] for line in pre_log},
         finetune_loss=ft_log[0]["total_loss"], eval_stats=[e for e in evals if e],
         launches=launches, finite=finite, ok=ok)
    if not ok:
        raise AssertionError(f"the CLI path failed its checks: logs {pre_log} {ft_log}, "
                             f"steps {steps}, launches {launches}")
    for name in MLM_WRAPPERS:
        stats[name]["launches"] = launches[name]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 2
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
    phase_train_kernels(stats)
    phase_mlm_kernels(stats)
    state, cfg, sd, batch = phase_train_slice(stats)
    check_train_blocks(state, cfg, batch)
    phase_train_throughput(state, cfg)
    del state, batch
    torch.cuda.empty_cache()
    phase_fba_train_kernels(stats)
    phase_fba_train(stats)
    compare_train_cpu(cfg, sd, {"train_vs_cpu_fp32": (False, False),
                                **{p + "_train_vs_cpu_fp32": f for p, f in FBA_FORMS.items()}})
    phase_cli(stats)
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
