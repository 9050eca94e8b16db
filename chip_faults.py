#!/usr/bin/env python3
"""Plant known faults in copies of the port's kernels and check that
chip_smoke.py's kernel checks catch each one.

    python3 chip_faults.py [fault ...]

run from the root of a checkout on a machine with a CUDA card and nvcc, as
chip_smoke.py is; with fault names, only those. For each fault it copies
``mvlt_tpu_torch/``, ``preweights/``, ``configs/`` and ``chip_smoke.py`` into
``build/planted_faults/<fault>/``, rewrites one line of a kernel source (or
of the model's glue) there, runs the chip_smoke phase that checks it
(``kernels``, ``v2_kernels``, ``swin_kernels``, ``fba_train_kernels``,
``train_kernels``, ``mlm_kernels``, ``train_glue``, ``v2_route``,
``remat``, ``ddp_two_ranks``, ``tp_kernels``, ``tp_two_ranks``,
``tp_families``, ``sp_two_ranks``, ``sp_swin``, ``sp_tp``, ``scan_steps`` or
``cli_eval``; on a machine with four cards ``nccl_tp_step`` or
``nccl_tp_zero1``) in that copy (its kernels built from the
changed source), and then, with the bound lifted, prints every check's
error at the B = 4 shapes. The copy is removed afterwards; the sources of the checkout are
never changed. It exits non-zero if a fault passes the phase.

Faults, kernel A's chain (csrc/sr_kv.cu), phase kernels:
  sr_gather_swaps_rs  the SR conv's gather takes kernel offset (s, r) for
                   (r, s): the pixel of the transposed offset;
  text_rows_sr_ln  the text rows of the K/V input go through SR-LN instead
                   of being LN1 as they are;
  split_slot_dropped  the SR-LN row kernel's in-order sum of the SR conv's
                   slots leaves out the last contraction range.
Kernel B's chain (csrc/block_fused.cu on csrc/attn_chain.cuh), phase
kernels:
  a_head_stride    the [B, H, N, hd] view of the attention output steps
                   hd / 2 columns a head instead of hd (seen only with more
                   than one head);
  mlp_reads_x      the MLP half's LN2 and residual read the block's input x
                   instead of h.
Kernel C's chain (csrc/block_attention.cu on csrc/attn_chain.cuh), phase
v2_kernels:
  c_head_stride    the [B, H, N, hd] view of the attention output steps
                   hd / 2 columns a head instead of hd (B's a_head_stride,
                   caught by C's own checks).
Kernel D's conv (csrc/dwconv_mlp.cu:dwconv_stencil_kernel), phase
v2_kernels:
  halo_wrap        a token's left and right neighbours bounded by the flat
                   row index within the grid, so they wrap into the previous
                   or next grid row;
  no_conv_bias     the depthwise conv's bias dropped.
Kernel E's chain (csrc/swin_block.cu, ops/swin_band.py) and kernel F
(csrc/swin_attention.cu), phase swin_kernels:
  window_index_no_shift  E's token -> window-slot index built without the
                   shift (the additive table keeps it);
  proj_next_window E's out-projection gathers each row from the same slot
                   of the next window;
  qkv_head_stride  E's q/k/v epilogue steps ws^2 x hd / 2 a head instead of
                   ws^2 x hd (seen only with more than one head);
  table_off_window F reads the additive table of the next window;
  text_other_sample F reads the next sample's text K/V.
The fused attention half's forward (the chain of csrc/attn_chain.cuh under
FbaFwdRoute: #12's kernels, #10's forward in its statistics mode), phase
fba_train_kernels:
  fwd_row_scale_first_row  the out-projection's epilogue takes the DropPath
                   scale of its tile's first row (seen where a 128-row tile
                   spans two samples of different scales);
  stats_max_log2   the statistics' row max written in exp2 units (times
                   log2 e), not natural ones.
The fused attention half's backward (csrc/block_attention_train.cu, its
attention core on csrc/attention.cu), phase fba_train_kernels:
  dk_one_tile      dK keeps only one q tile's dS^T Q (its sum restarts on
                   every tile);
  dbp_unscaled     the projection bias gradient sums dy without the row
                   scale, so a dropped sample's rows reach it;
  fba_wgrad_range_dropped  the in-order sum of dWq's and dWp's slots drops
                   the last range of rows;
  q_head_stride    the [B, H, N, hd] views of Q, dO, A and dQ step hd / 2
                   columns a head instead of hd (seen only with more than one
                   head);
  lse_stats_log2   the statistics form takes lse = max - log2(1/den), the
                   base-2 log of the natural statistics.
Their tensor-parallel modes (a rank's heads, hd apart from D), phase
tp_kernels:
  fba_tp_q_stride  the forward's Q view steps D a row, as the whole
                   width does, instead of the rank's heads' width;
  fba_tp_dx_with_dy  the backward's partial dx adds dy on every rank (the
                   model group's sum then holds tp dy).
The training attention kernels (csrc/attention.cu), phase train_kernels:
  no_online_rescale    the forward keeps the running sum and output as they
                       are when a later K/V chunk raises a row's max (seen
                       only at M above one 64-column chunk, peaked logits);
  one_split_slot       the slot sum drops the last range's dK/dV partial;
  lse_natural_vs_log2  the backward takes lse (natural log) as a base-2
                       exponent.
The LN-MLP backward (csrc/ln_mlp_bwd.cu), phase train_kernels:
  wgrad_range_dropped  the in-order sum of dW1's and dW2's slots drops the
                       last range of rows;
  dys_unscaled         s.dy written without the row scale: dW2, dh1 and
                       all that follows see the dropped sample and miss
                       the 1/keep factor;
  no_gelu_grad         dh1 = dG, GELU'(h1) left out.
The LN-MLP forward (csrc/ln_mlp.cu, its epilogue in csrc/ln_mlp.cuh), phase
train_kernels:
  gelu_last_chunk_skipped  the one-launch kernel passes the last 64 hidden
                       columns to fc2 without GELU;
  row_scale_first_row  every row takes the DropPath scale of its tile's first
                       row (seen where a 128-row tile spans two samples).
The MLM CE kernels (csrc/mlm_ce.cu), phase mlm_kernels:
  no_onehot            the backward's dl keeps the softmax at the label, the
                       onehot not subtracted;
  one_slot_dropped     the backward's slot sum drops the last slot: dx loses
                       its last vocabulary range, db its last row tile;
  padded_vocab_at_zero the forward counts the padded vocabulary columns
                       (zero rows of E) at logit 0 instead of -inf;
  merge_last_dropped   the forward's merge leaves out the last vocabulary
                       tile's partial.
The training paths' glue (models/swin.py, ops/sr_kv.py, models/pvlt.py):
  swin_train_mask_row  Swin's window attention on its training route takes
                       the region/pad mask of the window one window row on
                       (phase train_glue, against kernel F and its plain
                       version);
  linear_sr_adaptive_pool  linear SR pools to an adaptive 7x7 grid instead
                       of floored windows (M = 177 at every stage; phase
                       train_glue, LINEAR_M);
  remat_redraws_masks  --remat hands the step's generator to the block
                       under checkpoint, so the recompute draws new DropPath
                       and dropout masks (phase remat: gradients and the
                       generator's end state);
  v2_fused_route       a v2 block takes the fused attention half when
                       fused_attn_train is set (phase v2_route: launches).
Data parallelism (models/heads.py, train/losses.py, parallel/sharding.py),
phase ddp_two_ranks (two gloo ranks on the card against one process):
  bn_per_rank_stats    the T2I head's BatchNorm normalises each rank's batch
                       by its own statistics, skipping the cross-rank sums;
  mlm_mean_of_means    each rank divides its MLM loss by its own labeled
                       count (DDP then averages the ranks' means);
  eval_pad_counted     the padded slots of a rank's eval shard enter the
                       gathered results;
  bn_grad_unreduced    the cross-rank sums' backward (parallel/sharding.py:
                       _AllReduceSum) returns each rank's own gradient
                       unreduced: the BatchNorms' statistics stay global,
                       their gradients miss the other rank's loss (a fault
                       of the gradients alone).
Tensor parallelism (parallel/tensor.py, models/pvlt.py, parallel/mesh.py;
the kernels' tensor-parallel modes), phase tp_kernels (the modes summed in
one process against the unsharded kernels and plain versions) or
tp_two_ranks (two gloo ranks of one model group against one process):
  tp_residual_every_rank  the LN-MLP half adds the residual x to each
                       rank's partial before the model group's sum, so x
                       counts tp + 1 times;
  tp_proj_bias_every_rank  a row-parallel product (the split attention's
                       out-projection) adds its bias to each rank's
                       partial before the sum (tp + 1 times);
  copy_to_model_unreduced  copy_to_model's backward returns the rank's own
                       gradient unreduced: LN1, the SR conv and everything
                       upstream of a split attention miss the other heads'
                       gradient (a fault of the gradients alone);
  tp_bwd_dy_passthrough  #13's tensor-parallel mode keeps the dy
                       passthrough in its partial dx, so the sum counts dy
                       tp times (phase tp_kernels);
  tp_vocab_start_off_by_one  #14's tensor-parallel mode maps a label to the
                       column one before its own (phase tp_kernels);
  generator_world_rank the mask generator seeded by world rank, not data
                       rank: the ranks of a model group draw different
                       DropPath and dropout masks for the same rows;
  tp_db2_rank_dependent  the split LN-MLP half's fc2.bias gradient (whole
                       on every rank, never summed) scaled by 1 + the model
                       rank: rank 0 holds the right tensors, rank 1's
                       replicated gradient differs (caught by ranks_equal
                       alone).
Tensor parallelism of the other backbones and training options
(models/bert_embeddings.py, parallel/tensor.py), phase tp_families (two
gloo ranks of one model group against one process, each case at B = 32):
  tp_dropout_local_mask  a split tensor's dropout mask drawn over the
                       rank's slice alone (the hidden, the rank's heads'
                       probabilities): other masks than one process's, and
                       the generator left elsewhere;
  swin_table_unsliced  every rank takes heads 0 .. h / tp of Swin's
                       relative-position tables, not its own columns;
  dwconv_wrong_slice   v2's depthwise conv takes the next rank's channels,
                       not those of its slice of fc1's output.
Sequence parallelism (parallel/sequence.py, models/bert_embeddings.py),
phase sp_two_ranks (two gloo ranks of one model group against one process
and each primitive against the whole tensor's rows):
  sp_kv_grad_unsummed  the K/V gather's backward keeps the rank's rows of
                       its own dK/dV without the other ranks' parts;
  sp_row_grads_unsummed  the blocks' gradients of a split stage are not
                       summed over the model group (each rank keeps its
                       rows' part);
  sp_no_halo           the halo rows arrive as zeros: kernel D and v2's
                       DWConv glue pad each band's edges as the grid's;
  sp_linear_pool_band  linear SR pools each band's share of the windows
                       without the all-reduce (the other bands' rows lost,
                       the divisor still the whole window's);
  sp_dropout_band_mask  a dropout mask of a rank's rows drawn over its rows
                       alone, not the one-process mask's rows.
Swin under sequence parallelism (parallel/sequence.py, models/swin.py),
phase sp_swin (sp_two_ranks on Swin alone: its bundle on the bands, its
step, the primitives):
  sp_swin_no_exchange  the shifted windows' roll takes no rows from the next
                       band: each rank rolls its own band cyclically;
  sp_swin_band_pool    the text queries' pool window taken from the band's
                       grid (h / n rows) instead of the whole grid's.
Sequence parallelism with tensor-parallel weights on one model group
(parallel/sequence.py:row_grad_params), phase sp_tp (sp_two_ranks' steps
with the weights split, alone):
  sptp_shard_grads_summed  the tensor-parallel shards' gradients summed over
                       the model group with the rest (each rank's shard
                       plus the other ranks' different shards);
  sptp_band_bias_unsummed  the out-projection's and fc2's biases, added on
                       the band after the reduce-scatter, left out of the
                       sum (each rank keeps its band's part).
Multi-step dispatch (train/step.py), phase scan_steps (two dispatched steps
against two single ones, in bits):
  scan_same_substep    every sub-step of a call takes the stacked batch's
                       first batch, batch[0], instead of batch[i].
The native host library (data/fashion_gen.py), phase cli_eval (the train
reader's images against the native crop-resize):
  native_crop_pil      the train reader ignores use_native_image_ops and
                       crops and resizes with Pillow.
Across four cards over NCCL (utils/checkpoint.py, parallel/mesh.py), on a
machine with four cards:
  zero1_moments_model_rank0  saving consolidates ZeRO-1's moments over the
                       model group from model rank 0's shard alone, after
                       Zero1AdamW gathered each shard's slices over the data
                       group (phase nccl_tp_zero1: the checkpoint's moments
                       against the plain split step's);
  zero1_moments_data_rank0  Zero1AdamW gathers each moment from data rank
                       0's slice alone (on one card: phase ddp_two_ranks,
                       its ZeRO-1 checkpoint's moments against the plain
                       step's);
  data_group_over_model_axis  each rank's data group is its model group
                       (the data axis taken for the model axis): DDP
                       averages the shards of the other heads and hidden
                       slices, and no gradient of the other data rank's rows
                       arrives (phase nccl_tp_step).
"""

from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parent
FAULTS = {
    "sr_gather_swaps_rs": (
        "kernels", "mvlt_tpu_torch/csrc/sr_kv.cu",
        "const long long off = ((long long)r * a.w + s) * a.d + ch;",
        "const long long off = ((long long)s * a.w + r) * a.d + ch;"),
    "text_rows_sr_ln": (
        "kernels", "mvlt_tpu_torch/csrc/sr_kv.cu",
        "if (text) return store_row<P>(dst, v, d);",
        ""),
    "split_slot_dropped": (
        "kernels", "mvlt_tpu_torch/csrc/sr_kv.cu",
        "for (int s = 0; s < a.splits; ++s) {",
        "for (int s = 0; s < a.splits - 1; ++s) {"),
    "c_head_stride": (
        "v2_kernels", "mvlt_tpu_torch/csrc/attn_chain.cuh",
        "const long long view_a[3] = {(long long)h.n * dh, hd, dh};",
        "const long long view_a[3] = {(long long)h.n * dh, hd / 2, dh};"),
    "a_head_stride": (
        "kernels", "mvlt_tpu_torch/csrc/attn_chain.cuh",
        "const long long view_a[3] = {(long long)h.n * dh, hd, dh};",
        "const long long view_a[3] = {(long long)h.n * dh, hd / 2, dh};"),
    "mlp_reads_x": (
        "kernels", "mvlt_tpu_torch/csrc/block_fused.cu",
        "return mvlt_ln_mlp_fwd(h, ln2_w,",
        "return mvlt_ln_mlp_fwd(x, ln2_w,"),
    "fwd_row_scale_first_row": (
        "fba_train_kernels", "mvlt_tpu_torch/csrc/ln_mlp.cuh",
        "a.s[row / a.n]",
        "a.s[(row & ~(hopper::kGemmTile - 1)) / a.n]"),
    "stats_max_log2": (
        "fba_train_kernels", "mvlt_tpu_torch/csrc/attention.cu",
        "make_float2(m0 * kLn2, i0)",
        "make_float2(m0, i0)"),
    "halo_wrap": (
        "v2_kernels", "mvlt_tpu_torch/csrc/dwconv_mlp.cu",
        "const bool in = xx >= 0 && xx < a.w;",
        "const bool in = yy * a.w + xx >= 0 && yy * a.w + xx < a.h * a.w;"),
    "no_conv_bias": (
        "v2_kernels", "mvlt_tpu_torch/csrc/dwconv_mlp.cu",
        "z[k][e] = a.bdw[c0 + e];",
        "z[k][e] = 0.0f;"),
    "window_index_no_shift": (
        "swin_kernels", "mvlt_tpu_torch/ops/swin_band.py",
        "window_partition(tokens, hw, window, shift)",
        "window_partition(tokens, hw, window, 0)"),
    "proj_next_window": (
        "swin_kernels", "mvlt_tpu_torch/csrc/swin_block.cu",
        "const int slot = ok ? a.index[row % hw] : 0;",
        "const int slot = ok ? (a.index[row % hw] + a.ws2) % (a.nw * a.ws2) : 0;"),
    "qkv_head_stride": (
        "swin_kernels", "mvlt_tpu_torch/csrc/swin_block.cu",
        "(size_t)head * a.ws2 * a.hd +",
        "(size_t)head * a.ws2 * (a.hd / 2) +"),
    "table_off_window": (
        "swin_kernels", "mvlt_tpu_torch/csrc/swin_attention.cu",
        "const float* tab = a.table + ((size_t)win * a.heads + h) * a.ws2 * m;",
        "const float* tab = a.table + ((size_t)((win + 1) % a.nw) * a.heads + h) * a.ws2 * m;"),
    "text_other_sample": (
        "swin_kernels", "mvlt_tpu_torch/csrc/swin_attention.cu",
        "const size_t txt = (size_t)b * a.txt_b",
        "const size_t txt = (size_t)((b + 1) % a.batch) * a.txt_b"),
    "dk_one_tile": (
        "fba_train_kernels", "mvlt_tpu_torch/csrc/attention.cu",
        "wgmma_rs<1>(dk, da[kk], make_desc<RB>(sq + (q0 + 16 * kk) * RB), 1);",
        "wgmma_rs<1>(dk, da[kk], make_desc<RB>(sq + (q0 + 16 * kk) * RB), kk | half);"),
    "dbp_unscaled": (
        "fba_train_kernels", "mvlt_tpu_torch/csrc/block_attention_train.cu",
        "sum[0][p][0] += dyv[k][p].x * sc, sum[0][p][1] += dyv[k][p].y * sc;",
        "sum[0][p][0] += dyv[k][p].x, sum[0][p][1] += dyv[k][p].y;"),
    "fba_wgrad_range_dropped": (
        "fba_train_kernels", "mvlt_tpu_torch/csrc/block_attention_train.cu",
        "const int ranges = splits;",
        "const int ranges = splits - 1;"),
    "fba_tp_q_stride": (
        "tp_kernels", "mvlt_tpu_torch/csrc/attn_chain.cuh",
        "const long long view_q[3] = {(long long)h.n * dh, hd, dh};",
        "const long long view_q[3] = {(long long)h.n * d, hd, d};"),
    "fba_tp_dx_with_dy": (
        "tp_kernels", "mvlt_tpu_torch/csrc/block_attention_train.cu",
        "= make_float2(l0, l1);",
        "= make_float2(dyv[k][p].x + l0, dyv[k][p].y + l1);"),
    "q_head_stride": (
        "fba_train_kernels", "mvlt_tpu_torch/csrc/block_attention_train.cu",
        "const long long sq[3] = {(long long)n * dh, hd, dh}",
        "const long long sq[3] = {(long long)n * dh, hd / 2, dh}"),
    "lse_stats_log2": (
        "fba_train_kernels", "mvlt_tpu_torch/csrc/block_attention_train.cu",
        "sr[0] - logf(sr[1]);",
        "sr[0] - log2f(sr[1]);"),
    "no_online_rescale": (
        "train_kernels", "mvlt_tpu_torch/csrc/attention.cu",
        "a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);",
        "a0 = 1.0f, a1 = 1.0f;"),
    "one_split_slot": (
        "train_kernels", "mvlt_tpu_torch/csrc/attention.cu",
        "for (int s = 0; s < splits; ++s) {",
        "for (int s = 0; s < splits - 1; ++s) {"),
    "lse_natural_vs_log2": (
        "train_kernels", "mvlt_tpu_torch/csrc/attention.cu",
        "a.lse[(size_t)bh * a.n + row] * kLog2e",
        "a.lse[(size_t)bh * a.n + row]"),
    "wgrad_range_dropped": (
        "train_kernels", "mvlt_tpu_torch/csrc/ln_mlp_bwd.cu",
        "const int ranges = splits;",
        "const int ranges = splits - 1;"),
    "dys_unscaled": (
        "train_kernels", "mvlt_tpu_torch/csrc/ln_mlp_bwd.cu",
        "store_bf16x2(a.dys + o, dv[k][p].x * sc, dv[k][p].y * sc);",
        "store_bf16x2(a.dys + o, dv[k][p].x, dv[k][p].y);"),
    "no_gelu_grad": (
        "train_kernels", "mvlt_tpu_torch/csrc/ln_mlp_bwd.cu",
        "dg[i] = dg[i] * gg.y;",
        "dg[i] = dg[i];"),
    "gelu_last_chunk_skipped": (
        "train_kernels", "mvlt_tpu_torch/csrc/ln_mlp.cu",
        "h[4 * jj + e] = gelu_erf(h[4 * jj + e] + (col < a.hidden ? a.b1[col] : 0.0f));",
        "h[4 * jj + e] += col < a.hidden ? a.b1[col] : 0.0f;\n"
        "        if (j + 1 < chunks) h[4 * jj + e] = gelu_erf(h[4 * jj + e]);"),
    "row_scale_first_row": (
        "train_kernels", "mvlt_tpu_torch/csrc/ln_mlp.cuh",
        "a.s[row / a.n]",
        "a.s[(row & ~(hopper::kGemmTile - 1)) / a.n]"),
    "no_onehot": (
        "mlm_kernels", "mvlt_tpu_torch/csrc/mlm_ce.cu",
        "dl = g[h] * (v + a.vocab_start == lab[h] ? p - 1.0f : p);",
        "dl = g[h] * p;"),
    "one_slot_dropped": (
        "mlm_kernels", "mvlt_tpu_torch/csrc/mlm_ce.cu",
        "for (int s = 0; s < count; ++s) sum += slots[s * stride + i];",
        "for (int s = 0; s < count - 1; ++s) sum += slots[s * stride + i];"),
    "padded_vocab_at_zero": (
        "mlm_kernels", "mvlt_tpu_torch/csrc/mlm_ce.cu",
        "const float l = v < a.vocab ? d[4 * j + e] + a.bias[v] : -INFINITY;",
        "const float l = d[4 * j + e] + (v < a.vocab ? a.bias[v] : 0.0f);"),
    "merge_last_dropped": (
        "mlm_kernels", "mvlt_tpu_torch/csrc/mlm_ce.cu",
        "for (int s = 0; s < parts; ++s) {",
        "for (int s = 0; s < parts - 1; ++s) {"),
    "swin_train_mask_row": (
        "train_glue", "mvlt_tpu_torch/models/swin.py",
        "k_txt, v_txt, bias, mask,\n",
        "k_txt, v_txt, bias, mask.roll(-(-w // ws), 0),\n"),
    "linear_sr_adaptive_pool": (
        "train_glue", "mvlt_tpu_torch/ops/sr_kv.py",
        "pooled = F.avg_pool2d(grid, win, win)",
        "pooled = F.adaptive_avg_pool2d(grid, LINEAR_SR_POOL)"),
    "remat_redraws_masks": (
        "remat", "mvlt_tpu_torch/models/pvlt.py",
        "    if generator is None:\n        return checkpoint(blk, z, hw, None, use_reentrant=False)",
        "    return checkpoint(blk, z, hw, generator, use_reentrant=False)"),
    "v2_fused_route": (
        "v2_route", "mvlt_tpu_torch/models/pvlt.py",
        "self.training and not self.v2 and not self.drop",
        "self.training and not self.drop"),
    "bn_per_rank_stats": (
        "ddp_two_ranks", "mvlt_tpu_torch/models/heads.py",
        "if group_size(self.group) == 1:",
        "if True:"),
    "mlm_mean_of_means": (
        "ddp_two_ranks", "mvlt_tpu_torch/train/losses.py",
        "    return loss * global_mean_scale(labels, group, total)",
        "    return loss"),
    "eval_pad_counted": (
        "ddp_two_ranks", "mvlt_tpu_torch/parallel/sharding.py",
        "mask[r, :EvalShard(shard.total, r, shard.world).count] = True",
        "mask[r, :] = True"),
    "bn_grad_unreduced": (
        "ddp_two_ranks", "mvlt_tpu_torch/parallel/sharding.py",
        "        dx = dy.clone(memory_format=torch.contiguous_format)\n"
        "        dist.all_reduce(dx, group=ctx.group)\n        return dx, None",
        "        return dy.clone(), None"),
    "tp_residual_every_rank": (
        "tp_two_ranks", "mvlt_tpu_torch/parallel/tensor.py",
        "        if sp is None:\n            total = _model_sum(part, group)",
        "        if sp is None:\n            total = _model_sum(part + x.to(part.dtype), group)"),
    "tp_proj_bias_every_rank": (
        "tp_two_ranks", "mvlt_tpu_torch/parallel/tensor.py",
        "    part = linear_partial(x, weight)\n",
        "    part = linear_partial(x, weight) + bias\n"),
    "copy_to_model_unreduced": (
        "tp_two_ranks", "mvlt_tpu_torch/parallel/tensor.py",
        "        return _model_sum(dy, ctx.group).to(dy.dtype), None",
        "        return dy, None"),
    "tp_bwd_dy_passthrough": (
        "tp_kernels", "mvlt_tpu_torch/csrc/ln_mlp_bwd.cu",
        "make_float2(l0, l1);",
        "make_float2(dyv[k][p].x + l0, dyv[k][p].y + l1);"),
    "tp_vocab_start_off_by_one": (
        "tp_kernels", "mvlt_tpu_torch/csrc/mlm_ce.cu",
        "const int c = l - a.vocab_start;",
        "const int c = l - (a.vocab_start + 1);"),
    "tp_db2_rank_dependent": (
        "tp_two_ranks", "mvlt_tpu_torch/parallel/tensor.py",
        "        grads = (dgamma, dbeta, dw1, db1, dw2, db2)",
        "        grads = (dgamma, dbeta, dw1, db1, dw2, db2 * (1 + dist.get_rank(ctx.group)))"),
    "generator_world_rank": (
        "tp_two_ranks", "mvlt_tpu_torch/parallel/mesh.py",
        "    return seed + data_rank()",
        "    return seed + rank()"),
    "tp_dropout_local_mask": (
        "tp_families", "mvlt_tpu_torch/models/bert_embeddings.py",
        "        shape[dim] *= tp\n"
        "    mask = torch.rand(shape, generator=generator, device=x.device) < keep\n"
        "    if split is not None:\n"
        "        mask = mask.narrow(dim, rank * x.shape[dim], x.shape[dim])",
        "        pass\n"
        "    mask = torch.rand(shape, generator=generator, device=x.device) < keep\n"
        "    if split is not None:\n"
        "        mask = mask.narrow(dim, 0, x.shape[dim])"),
    "swin_table_unsliced": (
        "tp_families", "mvlt_tpu_torch/parallel/tensor.py",
        "            new = torch.nn.Parameter(shard_tensor(old.data, kind, rank, tp),",
        "            new = torch.nn.Parameter(shard_tensor(\n"
        "                old.data, kind, 0 if name.endswith('bias_table') else rank, tp),"),
    "dwconv_wrong_slice": (
        "tp_families", "mvlt_tpu_torch/parallel/tensor.py",
        "            new = torch.nn.Parameter(shard_tensor(old.data, kind, rank, tp),",
        "            new = torch.nn.Parameter(shard_tensor(\n"
        "                old.data, kind, (rank + 1) % tp if '.dwconv.' in name else rank, tp),"),
    "zero1_moments_model_rank0": (
        "nccl_tp_zero1", "mvlt_tpu_torch/utils/checkpoint.py",
        "lambda n, t: consolidate({n: t}, group, cfg)[n]",
        "lambda n, t: consolidate({n: t * (dist.get_rank(group) == 0)}, group, cfg)[n]"),
    "zero1_moments_data_rank0": (
        "ddp_two_ranks", "mvlt_tpu_torch/parallel/sharding.py",
        "                full.narrow(*part).copy_(st[key])",
        "                full.narrow(*part).copy_(st[key] * (self.rank == 0))"),
    "sp_kv_grad_unsummed": (
        "sp_two_ranks", "mvlt_tpu_torch/parallel/sequence.py",
        "return (take(_summed(dy, ctx.plan), ctx.plan, ctx.m_vis, ctx.dim).contiguous(),",
        "return (take(dy, ctx.plan, ctx.m_vis, ctx.dim).contiguous(),"),
    "sp_row_grads_unsummed": (
        "sp_two_ranks", "mvlt_tpu_torch/parallel/sequence.py",
        "    dist.all_reduce(flat, group=group)\n",
        ""),
    "sp_no_halo": (
        "sp_two_ranks", "mvlt_tpu_torch/parallel/sequence.py",
        "        slots = _all_slots(edges, plan)  ",
        "        slots = _all_slots(edges, plan) * 0  "),
    "sp_linear_pool_band": (
        "sp_two_ranks", "mvlt_tpu_torch/parallel/sequence.py",
        "    total = all_reduce_sum(linear_pool_partial(band, plan, win, out), plan.group,\n"
        "                           differentiable=True)",
        "    total = linear_pool_partial(band, plan, win, out)"),
    "sp_dropout_band_mask": (
        "sp_two_ranks", "mvlt_tpu_torch/models/bert_embeddings.py",
        "        shape[dim] = plan.h * plan.w + plan.t\n",
        "        rows = None\n"),
    "sp_swin_no_exchange": (
        "sp_swin", "mvlt_tpu_torch/parallel/sequence.py",
        "plan)[roll_partner(plan, shift)]",
        "plan)[plan.rank]"),
    "sp_swin_band_pool": (
        "sp_swin", "mvlt_tpu_torch/models/swin.py",
        "win = max(1, whole[0] // TEXT_POOL)",
        "win = max(1, hw[0] // TEXT_POOL)"),
    "sptp_shard_grads_summed": (
        "sp_tp", "mvlt_tpu_torch/parallel/sequence.py",
        '            if not getattr(p, "tp_split", None)]',
        "            ]"),
    "sptp_band_bias_unsummed": (
        "sp_tp", "mvlt_tpu_torch/parallel/sequence.py",
        '            for p in getattr(model, f"block{i + 1}").parameters()\n',
        '            for n, p in getattr(model, f"block{i + 1}").named_parameters()\n'
        '            if not n.endswith(("proj.bias", "fc2.bias"))\n'),
    "data_group_over_model_axis": (
        "nccl_tp_step", "mvlt_tpu_torch/parallel/mesh.py",
        "            layout[\"data_group\"] = g",
        "            layout[\"data_group\"] = layout[\"model_group\"]"),
    "scan_same_substep": (
        "scan_steps", "mvlt_tpu_torch/train/step.py",
        "one_step(state, {k: v[i] for k, v in batch.items()})",
        "one_step(state, {k: v[0] for k, v in batch.items()})"),
    "native_crop_pil": (
        "cli_eval", "mvlt_tpu_torch/data/fashion_gen.py",
        'if self.split == "train" and cfg.use_native_image_ops:',
        "if False:"),
}
# per phase: the checks at B = 4 that print each error with the bound lifted
MARGINS = {
    # the phase's own line carries every gap beside its bound
    "ddp_two_ranks": """
pass
""",
    "tp_two_ranks": """
pass
""",
    # its kernel_check lines carry each error up to the first that fails
    "tp_kernels": """
pass
""",
    "tp_families": """
pass
""",
    "sp_two_ranks": """
pass
""",
    "sp_swin": """
pass
""",
    "sp_tp": """
pass
""",
    "nccl_tp_step": """
pass
""",
    "nccl_tp_zero1": """
pass
""",
    "scan_steps": """
pass
""",
    "cli_eval": """
pass
""",
    "kernels": """
gen = torch.Generator().manual_seed(c.SEED)
shapes = [(f"stage{i + 1}", (h, w, d, nh, sr, hid, c.TEXT))
          for i, (h, w, d, nh, sr, hid) in enumerate(c.STAGES)]
traps = [("ragged", c.RAGGED), ("ragged_heads", c.RAGGED_HEADS), ("m177", c.TRAIN_M177),
         ("v2_ragged", c.V2_RAGGED)]
for label, shape in shapes + traps:
    c.check_kernels(stats, gen, label, shape, c.SMOKE_BATCH)
""",
    "v2_kernels": """
gen = torch.Generator().manual_seed(c.SEED + 5)
shapes = [(f"v2_stage{i + 1}", (h, w, d, nh, sr, hid, c.TEXT))
          for i, (h, w, d, nh, sr, hid) in enumerate(c.STAGES)]
for label, shape in shapes + [("v2_ragged", c.V2_RAGGED)]:
    c.check_v2_kernels(stats, gen, label, shape, c.SMOKE_BATCH)
""",
    "swin_kernels": """
c.check_swin_kernels(stats, torch.Generator().manual_seed(c.SEED + 13), c.SMOKE_BATCH)
""",
    "train_kernels": """
gen = torch.Generator().manual_seed(c.SEED + 7)
shapes = [(f"stage{i + 1}", (h, w, d, nh, sr, hid, c.TEXT))
          for i, (h, w, d, nh, sr, hid) in enumerate(c.STAGES)]
extra = [("ragged", c.TRAIN_RAGGED), ("m177", c.TRAIN_M177), ("m272", c.TRAIN_M272)]
for label, shape in shapes + extra:
    c.check_train_kernels(stats, gen, label, shape, c.SMOKE_BATCH)
""",
    "mlm_kernels": """
c.phase_mlm_kernels(stats)
""",
    "fba_train_kernels": """
c.check_fba_traps(stats, torch.Generator().manual_seed(c.SEED + 17))
""",
    "train_glue": """
c.phase_train_glue(stats)
""",
    "v2_route": """
c.phase_v2_route(stats)
""",
    "remat": """
c.REMAT_TOL = math.inf
c.phase_remat(stats)
""",
}
RUN = """
import math, torch, chip_smoke as c
stats = c.new_stats()
c.phase_build()
try:
    c.phase_{phase}(stats)
    print("FAULT_PASSED")
except AssertionError as e:
    print("FAULT_CAUGHT", e)
c.KERNEL_TOL = math.inf
"""
# the margins run with the bound lifted; a check that raises all the same (a
# dropped sample's dx no longer its dy) ends the printout, not the fault's run
MARGIN_RUN = "try:\n{body}\nexcept AssertionError as e:\n    print('MARGINS_STOPPED', e)\n"


def run_fault(name: str, phase: str, source: str, good: str, bad: str) -> bool:
    """True if chip_smoke's ``phase`` fails on the planted fault."""
    dst = ROOT / "build" / "planted_faults" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "mvlt_tpu_torch", dst / "mvlt_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(ROOT / "preweights", dst / "preweights")
    shutil.copytree(ROOT / "configs", dst / "configs")
    shutil.copy(ROOT / "chip_smoke.py", dst)
    path = dst / source
    text = path.read_text()
    if text.count(good) != 1:
        raise RuntimeError(f"{name}: the line to change is not in {source} exactly once")
    path.write_text(text.replace(good, bad))
    try:
        margins = MARGIN_RUN.format(body=textwrap.indent(MARGINS[phase].strip(), "    "))
        proc = subprocess.run([sys.executable, "-c", RUN.format(phase=phase) + margins],
                              cwd=dst, capture_output=True, text=True, check=False)
    finally:
        shutil.rmtree(dst, ignore_errors=True)
    caught = "FAULT_CAUGHT" in proc.stdout
    checks = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    print(json.dumps({"fault": name, "phase": phase, "source": source, "caught": caught,
                      "message": next((ln for ln in proc.stdout.splitlines()
                                       if ln.startswith("FAULT_")), None),
                      "rel_err_by_check": [
                          [c["kernel"], c["shape"], c.get("batch"), c.get("rel_err")]
                          for c in checks if c.get("phase") == "kernel_check"],
                      "rc": proc.returncode}), flush=True)
    if proc.returncode:
        print(proc.stderr[-3000:], file=sys.stderr)
    return caught and proc.returncode == 0


def main() -> int:
    names = sys.argv[1:] or list(FAULTS)
    results = {name: run_fault(name, *FAULTS[name]) for name in names}
    print(json.dumps({"all_caught": all(results.values()), "caught": results}), flush=True)
    return 0 if all(results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
