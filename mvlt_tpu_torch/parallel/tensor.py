"""Tensor parallelism of the v1, v2, linear-SR v2 and Swin backbones:
Megatron column/row shards over a model group, a vocabulary-parallel word
embedding and MLM cross entropy.

Counterpart of mvlt_tpu/parallel/sharding.py's model axis (``_RULES`` :39,
``_spec_for`` :63). There GSPMD places the shards and inserts the
collectives; here each rank holds its shard and the collectives are
written out. The port reproduces the function, not GSPMD's layout:

  * ``RULES`` shards a block's attention by whole heads, and only where
    ``num_heads % tp == 0`` (JAX's divisibility guard looks at the output
    width, which at pvlt_tiny's 1 and 5 heads cuts through a head; the
    port keeps such an attention replicated), Swin's relative-position
    table [(2 ws - 1)^2, heads] by its head columns alongside; the MLP
    hidden where ``hidden % tp == 0``, v2's 3x3 depthwise conv by its
    channels alongside (the conv is per channel: a rank's channels are its
    slice of fc1's output); the word embedding's rows and
    ``mlm_head.bias`` where ``vocab % tp == 0``. Everything else is
    replicated (linear SR's pool, 1x1 conv and SR-LN, Swin's window index,
    masks and text pooling). The K/V weight [2D, D] holds K's rows then
    V's: a rank's shard is the K rows of its heads then the V rows of its
    heads, not a contiguous slice.
  * ``copy_to_model`` (identity forward, all-reduce backward) stands at the
    input of every column-parallel product (q's and kv's), so that every
    replicated tensor upstream gets its whole gradient on every rank;
    ``reduce_from_model`` (fp32 all-reduce forward, identity backward)
    after the row-parallel out-projection, before its bias and the
    residual, which are added once. The MLP half is one autograd function
    over kernels #12/#13 in their tensor-parallel modes
    (``fused_ln_mlp_tp``): the forward sums the ranks' fp32 partials, then
    adds b2 and x and rounds once; the backward sums (dx, dgamma, dbeta) of
    LN2's backward over the group: copy_to_model's all-reduce moved past
    LN2, which LN's backward, linear in its output gradient, allows. The
    other order (sum dLN2-out, then a replicated LN backward) would take
    LN's backward out of kernel #13 into another pass over the [rows, D]
    stream; this one keeps #13 whole and sums the same bytes. With
    dropout the MLP half is PyTorch glue over the same split
    (``row_parallel_linear`` after fc2), as it is without tensor
    parallelism; a dropout mask of a split tensor (the hidden, the
    attention probabilities of the rank's heads) is the rank's slice of the
    whole mask one process draws (models/bert_embeddings.py:dropout), so
    the ranks of a model group, which share one generator stream, keep the
    one-process masks.
  * On the ``fused_attn_train`` route a split attention half is one
    autograd function over kernels #6-#8 in their tensor-parallel modes
    (``fused_attn_tp``), as the MLP half is over #12/#13: the kernels take
    x whole (LN1 is inside them) and the rank's heads; the forward sums the
    ranks' fp32 partials s (A Wp^T), then adds s bp and x and rounds once;
    the backward sums the ranks' (dx, dgamma, dbeta) partials of LN1's
    backward in one all-reduce, as copy_to_model would sum x's gradient and
    LN1's, adds dy once, and takes dbp once from the whole s.dy (bp is
    replicated, as in ``row_parallel_linear``).
  * The MLM decode is vocabulary-parallel (``vocab_parallel_nll``): each
    rank's kernel #14 gives its range's (lse, picked logit), the group
    combines them in fp32 (the logsumexp of the lses, the sum of the
    picks), and #15 takes the global lse and gives the rows' partial
    gradient, summed by copy_to_model. The eval decode combines each rank's
    (max, first argmax + offset), the lowest index winning ties, and never
    gathers the logits (``VocabShardLogits``). With ``mlm_loss_chunk <= 0``
    the training decode keeps the rank's logits [..., V / tp] (its input
    through ``copy_to_model``) and the loss is
    ``vocab_parallel_cross_entropy``: the row max, the sum of exp and the
    picked logit combined over the group, softmax minus one-hot on the
    rank's columns in the backward.

  * Under sequence parallelism too (a model built with ``sp_group``, the
    same model group; parallel/sequence.py), a split stage's stream holds
    the rank's band between the blocks. ``model_input`` then all-gathers
    the LN'd band whole where ``copy_to_model`` stood (its backward a
    reduce-scatter), the tensor-parallel products run on the whole stream
    as above, and ``row_parallel_linear``, ``fused_ln_mlp_tp`` and
    ``fused_attn_tp`` reduce-scatter their fp32 partials to the band in
    place of the all-reduce, then add the bias and the residual on the band
    (Megatron-LM's sequence parallelism). Every replicated parameter of such
    a block is then used on the band's rows, or (SR, LN1 inside #8 and LN2
    inside #13) gets a gradient from the rank's heads or hidden slice
    alone: its gradient is
    this rank's part, which parallel/sequence.py:reduce_row_grads sums; a
    shard's is whole and stays.

The collectives are ``all_reduce`` sums only (gloo offers nothing else on
CUDA tensors): a rank's shard is placed in a zero-filled full tensor and
summed (``consolidate``), per-rank values in zero-filled slots.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional

import torch
import torch.distributed as dist

from mvlt_tpu_torch.ops.block_attention import (block_attention_train_bwd_tp,
                                                block_attention_train_fwd_tp)
from mvlt_tpu_torch.ops.fused_mlp import ln_mlp_bwd_tp, ln_mlp_fwd_tp
from mvlt_tpu_torch.ops.kernel_math import acc_dtype, linear, matmul_acc
from mvlt_tpu_torch.ops.mlm_ce import mlm_ce_bwd_tp, mlm_ce_fwd_tp
from mvlt_tpu_torch.parallel import mesh, sequence
from mvlt_tpu_torch.parallel.sharding import group_size

ROW, COL, KV = "row", "col", "kv"
# (state-dict name, the width whose divisibility decides, how the tensor
# splits): the first rule that matches a name decides; no match, replicated.
# ROW splits dim 0 (a column-parallel product's output rows, the
# vocabulary, the depthwise conv's channels), COL dim 1 (a row-parallel
# product's input columns, the bias table's heads), KV the K and V halves
# of dim 0 alike.
RULES = (
    (re.compile(r"^block(\d+)\.\d+\.attn\.q\.(weight|bias)$"), "heads", ROW),
    (re.compile(r"^block(\d+)\.\d+\.attn\.kv\.(weight|bias)$"), "heads", KV),
    (re.compile(r"^block(\d+)\.\d+\.attn\.proj\.weight$"), "heads", COL),
    (re.compile(r"^block(\d+)\.\d+\.attn\.relative_position_bias_table$"), "heads", COL),
    (re.compile(r"^block(\d+)\.\d+\.mlp\.fc1\.(weight|bias)$"), "hidden", ROW),
    (re.compile(r"^block(\d+)\.\d+\.mlp\.dwconv\.dwconv\.(weight|bias)$"), "hidden", ROW),
    (re.compile(r"^block(\d+)\.\d+\.mlp\.fc2\.weight$"), "hidden", COL),
    (re.compile(r"^text_embeddings\.word_embeddings\.weight$"), "vocab", ROW),
    (re.compile(r"^mlm_head\.bias$"), "vocab", ROW),
)


def _width(cfg, axis: str, stage: Optional[int]) -> int:
    if axis == "vocab":
        return cfg.vocab_size
    i = stage - 1
    if axis == "heads":
        return cfg.num_heads[i]
    return int(cfg.embed_dims[i] * cfg.mlp_ratios[i])


def split_of(name: str, cfg, tp: int) -> Optional[str]:
    """How the tensor ``name`` splits over ``tp`` ranks (ROW, COL or KV),
    or None: replicated."""
    if tp == 1:
        return None
    for rx, axis, kind in RULES:
        m = rx.match(name)
        if m:
            stage = int(m.group(1)) if axis != "vocab" else None
            return kind if _width(cfg, axis, stage) % tp == 0 else None
    return None


def layout(names, cfg, tp: int) -> Dict[str, Optional[str]]:
    """{name: split or None} for the state-dict names of a model of ``cfg``."""
    return {n: split_of(n, cfg, tp) for n in names}


def shard_tensor(t: torch.Tensor, kind: Optional[str], rank: int, tp: int) -> torch.Tensor:
    """Rank ``rank``'s shard of the whole tensor ``t`` (a copy with the
    strides of a new tensor: a view's, even where they do not matter, would
    differ from its gradient's under DDP)."""
    if kind is None:
        return t
    if kind == KV:
        k, v = t.chunk(2, 0)
        return torch.cat([k.chunk(tp, 0)[rank], v.chunk(tp, 0)[rank]])
    return t.chunk(tp, 0 if kind == ROW else 1)[rank].clone(memory_format=torch.contiguous_format)


def _placed(local: torch.Tensor, kind: str, rank: int, tp: int) -> torch.Tensor:
    """The whole tensor with ``local`` in rank ``rank``'s place, zeros
    elsewhere."""
    if kind == COL:
        full = local.new_zeros(local.shape[0], local.shape[1] * tp, *local.shape[2:])
        full[:, rank * local.shape[1]:(rank + 1) * local.shape[1]] = local
        return full
    full = local.new_zeros(local.shape[0] * tp, *local.shape[1:])
    if kind == ROW:
        full[rank * local.shape[0]:(rank + 1) * local.shape[0]] = local
        return full
    k, v = local.chunk(2, 0)
    n, half = k.shape[0], full.shape[0] // 2
    full[rank * n:(rank + 1) * n] = k
    full[half + rank * n:half + (rank + 1) * n] = v
    return full


def shard_state_dict(full: Mapping[str, torch.Tensor], model_rank: int, tp: int,
                     cfg) -> Dict[str, torch.Tensor]:
    """Rank ``model_rank``'s state dict of a whole one, under ``RULES``."""
    return {n: shard_tensor(t, split_of(n, cfg, tp), model_rank, tp) for n, t in full.items()}


def placed_state(local: Mapping[str, torch.Tensor], rank: int, tp: int,
                 cfg) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s state dict with each split tensor placed in a
    zero-filled whole one (replicated tensors as they are): summed over the
    ranks, the whole state dict."""
    out = {}
    for n, t in local.items():
        kind = split_of(n, cfg, tp)
        out[n] = t if kind is None else _placed(t.detach(), kind, rank, tp)
    return out


def consolidate(local: Mapping[str, torch.Tensor], group, cfg) -> Dict[str, torch.Tensor]:
    """The whole state dict from this rank's under the model ``group``, on
    every rank of it (each split tensor one all_reduce of its placed copy:
    exact, every other slot holds zeros), each tensor on its own device: a
    host tensor (ZeRO-1's consolidated moments) is summed on the device the
    collectives take (NCCL's are CUDA tensors)."""
    tp = group_size(group)
    if tp == 1:
        return dict(local)
    out = placed_state(local, dist.get_rank(group), tp, cfg)
    device = mesh.comm_device()
    for n, t in out.items():
        if split_of(n, cfg, tp) is not None:
            summed = t.to(device)
            dist.all_reduce(summed, group=group)
            out[n] = summed.to(t.device)
    return out


def _model_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the model group, taken in fp32 (fp64 for
    fp64), as a new tensor of that type."""
    y = t.to(acc_dtype(t.dtype), memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(y, group=group)
    return y


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _model_sum(dy, ctx.group).to(dy.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _model_sum(x, group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, the gradient summed over the model group (in fp32,
    rounded to x's type once): the input of a column-parallel product."""
    return _CopyToModel.apply(x, group)


def model_input(x: torch.Tensor, group, sp=None) -> torch.Tensor:
    """The input of a column-parallel product: ``copy_to_model``; under
    sequence parallelism (``sp``, the stage's row plan; x the band's rows)
    the whole stream gathered from the bands, the backward summing the
    ranks' gradients and keeping the band's (sequence.gather_kv)."""
    if sp is None:
        return copy_to_model(x, group)
    return sequence.gather_kv(x, sp, sp.hb * sp.w, dim=1)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the model group in fp32 (fp64 for fp64), identity
    backward: the output of a row-parallel product, before its bias."""
    return _ReduceFromModel.apply(x, group)


def linear_partial(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x W^T of a row-parallel product on this rank's input columns,
    unrounded (the operands in x's type, the sum in fp32): the partial that
    ``reduce_from_model`` sums."""
    return matmul_acc(x, weight.transpose(0, 1), x.dtype)


def row_parallel_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        group, sp=None) -> torch.Tensor:
    """x W^T + b of a row-parallel product on this rank's input columns:
    the ranks' fp32 partials summed over the model ``group``, then b added
    once and the sum rounded to x's type once. Without a group, ``linear``.
    ``sp``: x holds the whole stream's rows and the sum is reduce-scattered
    to the band of that row plan (sequence.scatter_rows), b added there."""
    if group is None:
        return linear(x, weight, bias)
    part = linear_partial(x, weight)
    total = reduce_from_model(part, group) if sp is None else sequence.scatter_rows(part, sp)
    return (total + bias.to(total.dtype)).to(x.dtype)


def split_dim(group, dim: int) -> Optional[tuple]:
    """(dim, rank, tp) of a tensor split along ``dim`` over the model
    ``group`` (models/bert_embeddings.py:dropout's ``split``); None without
    a group."""
    return None if group is None else (dim, dist.get_rank(group), group_size(group))


def sum_ln_partials(dx_part, dgamma, dbeta, group) -> tuple:
    """(dx, dgamma, dbeta) of a LayerNorm whose output feeds a product split
    over the model ``group``, from each rank's part of its backward: summed
    in one fp32 all_reduce (fp64 for fp64), as copy_to_model would sum the
    LayerNorm output's gradient before a replicated backward."""
    d = dx_part.shape[-1]
    summed = _model_sum(torch.cat([dx_part.reshape(-1), dgamma, dbeta]), group)
    return summed[:-2 * d].reshape(dx_part.shape), summed[-2 * d:-d], summed[-d:]


class _FusedLnMlpTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, row_scale, eps, group, sp):
        ctx.eps, ctx.group, ctx.sp = eps, group, sp
        ctx.param_dtypes = [t.dtype for t in (gamma, beta, w1, b1, w2, b2)]
        xw = x if sp is None else sequence.gather_rows(x, sp)
        ctx.save_for_backward(xw, gamma, beta, w1, b1, w2, row_scale)
        part = ln_mlp_fwd_tp(xw, gamma, beta, w1, b1, w2, row_scale, eps)
        if sp is None:
            total = _model_sum(part, group)
        else:
            total = sequence.take(_model_sum(part, group), sp, sp.hb * sp.w)
        s = row_scale.to(total.dtype)[:, None, None]
        return (x.to(total.dtype) + total + s * b2.to(total.dtype)).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, w1, b1, w2, row_scale = ctx.saved_tensors
        sp = ctx.sp
        dyw = dy.contiguous() if sp is None else sequence.gather_rows(dy, sp)
        dx_part, dgamma, dbeta, dw1, db1, dw2, db2 = ln_mlp_bwd_tp(
            x, gamma, beta, w1, b1, w2, row_scale, ctx.eps, dyw)
        if sp is None:
            dx_sum, dgamma, dbeta = sum_ln_partials(dx_part, dgamma, dbeta, ctx.group)
        else:
            # the band's rows; dgamma, dbeta and db2 stay this rank's parts
            # (sequence.reduce_row_grads sums them): b2 is added on the band
            dx_sum = sequence.take(_model_sum(dx_part, ctx.group), sp, sp.hb * sp.w)
            acc = dx_sum.dtype
            db2 = (dy.to(acc) * row_scale.to(acc)[:, None, None]).sum((0, 1))
        dx = (dy.to(dx_sum.dtype) + dx_sum).to(x.dtype)
        grads = (dgamma, dbeta, dw1, db1, dw2, db2)
        return (dx, *(g.to(t) for g, t in zip(grads, ctx.param_dtypes)), None, None, None,
                None)


def fused_ln_mlp_tp(x, gamma, beta, w1, b1, w2, b2, row_scale, eps: float, group, sp=None):
    """x + s * MLP(LN(x)) with the hidden split over the model ``group``
    (W1, b1 this rank's rows, W2 its columns, b2 whole): kernels #12/#13
    in their tensor-parallel modes on CUDA tensors, their plain versions on
    CPU tensors; the ranks' fp32 partials summed, then b2 and x added once
    and y rounded once, as the one-process kernel does. row_scale None
    means ones. ``sp``: x holds the band of that row plan; the kernels run
    on the stream gathered whole, their partials are reduce-scattered to
    the band, and LN2's and b2's gradients are this rank's parts."""
    if row_scale is None:
        row_scale = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    return _FusedLnMlpTp.apply(x, gamma, beta, w1, b1, w2, b2, row_scale, eps, group, sp)


class _FusedAttnTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, v, gamma, beta, wq, bq, wp, bp, row_scale, heads, eps, save_stats,
                group, sp):
        ctx.heads, ctx.eps, ctx.group, ctx.sp = heads, eps, group, sp
        ctx.param_dtypes = [t.dtype for t in (gamma, beta, wq, bq, wp, bp)]
        xw = x if sp is None else sequence.gather_rows(x, sp)
        if x.device.type == "cuda":
            xw, k, v = xw.contiguous(), k.contiguous(), v.contiguous()
        wq_c, wp_c = wq.detach().to(x.dtype), wp.detach().to(x.dtype)   # rounded once
        res = block_attention_train_fwd_tp(xw, k, v, gamma, beta, wq_c, bq, wp_c, row_scale,
                                           heads=heads, eps=eps, save_stats=save_stats)
        part, stats = res if save_stats else (res, None)
        ctx.save_for_backward(xw, k, v, gamma, beta, wq_c, bq, wp_c, row_scale, stats)
        total = _model_sum(part, group)
        if sp is not None:
            total = sequence.take(total, sp, sp.hb * sp.w)
        s = row_scale.to(total.dtype)[:, None, None]
        return (x.to(total.dtype) + total + s * bp.to(total.dtype)).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        xw, k, v, gamma, beta, wq_c, bq, wp_c, row_scale, stats = ctx.saved_tensors
        sp = ctx.sp
        dyw = dy.contiguous() if sp is None else sequence.gather_rows(dy, sp)
        dx_part, dk, dv, dgamma, dbeta, dwq, dbq, dwp, dbp = block_attention_train_bwd_tp(
            xw, k, v, gamma, beta, wq_c, bq, wp_c, row_scale, dyw.to(xw.dtype),
            heads=ctx.heads, eps=ctx.eps, stats=stats)
        if sp is None:
            dx_sum, dgamma, dbeta = sum_ln_partials(dx_part, dgamma, dbeta, ctx.group)
        else:
            # the band's rows; dgamma, dbeta and dbp stay this rank's parts
            # (sequence.reduce_row_grads sums them): bp is added on the band
            dx_sum = sequence.take(_model_sum(dx_part, ctx.group), sp, sp.hb * sp.w)
            acc = dx_sum.dtype
            dbp = (dy.to(acc) * row_scale.to(acc)[:, None, None]).sum((0, 1))
        dx = (dy.to(dx_sum.dtype) + dx_sum).to(xw.dtype)
        grads = (dgamma, dbeta, dwq, dbq, dwp, dbp)
        return (dx, dk, dv, *(g.to(t) for g, t in zip(grads, ctx.param_dtypes)), None, None,
                None, None, None, None)


def fused_attn_tp(x, k, v, gamma, beta, wq, bq, wp, bp, row_scale, *, heads: int, eps: float,
                  save_stats: bool, group, sp=None):
    """x + s * (proj(attention(LN1 x)) + bp) with the attention's heads
    split over the model ``group`` (Wq, bq this rank's ``heads`` heads'
    rows, Wp their columns, K and V those heads, bp whole): kernels #6-#8 in
    their tensor-parallel modes on CUDA tensors, their plain versions on CPU
    tensors (``save_stats`` picks the statistics forms); the ranks' fp32
    partials summed, then s bp and x added once and the output rounded
    once, as the one-process kernel does. row_scale None means ones.
    ``sp``: x holds the band of that row plan; the kernels run on the
    stream gathered whole, their partials are reduce-scattered to the band,
    and LN1's and bp's gradients are this rank's parts."""
    if row_scale is None:
        row_scale = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    return _FusedAttnTp.apply(x, k, v, gamma, beta, wq, bq, wp, bp, row_scale, heads, eps,
                              save_stats, group, sp)


def vocab_start(table: torch.Tensor, group) -> int:
    """The global index of this rank's first vocabulary row."""
    return dist.get_rank(group) * table.shape[0]


def vocab_parallel_embedding(ids: torch.Tensor, table: torch.Tensor, group) -> torch.Tensor:
    """The rows of ``ids`` of a vocabulary split over the model ``group``:
    each rank takes the ids inside its range and writes 0 elsewhere, then
    ``reduce_from_model`` sums (one rank holds each row: exact)."""
    start = vocab_start(table, group)
    local = ids.long() - start
    inside = (local >= 0) & (local < table.shape[0])
    rows = torch.nn.functional.embedding(torch.where(inside, local, 0), table)
    return reduce_from_model(torch.where(inside[..., None], rows, 0.0), group).to(table.dtype)


def _slots(values: List[torch.Tensor], group) -> torch.Tensor:
    """[len(values), tp, ...]: every rank's ``values`` in its slot, summed
    over the group (exact: the other slots hold zeros)."""
    tp, rank = group_size(group), dist.get_rank(group)
    first = values[0]
    buf = first.new_zeros((len(values), tp) + tuple(first.shape))
    for i, v in enumerate(values):
        buf[i, rank] = v
    dist.all_reduce(buf, group=group)
    return buf


class _VocabParallelNll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, table, bias, labels, group):
        start = vocab_start(table, group)
        table_c = table.detach().to(rows.dtype)   # rounded once for both directions
        lse_l, picked_l = mlm_ce_fwd_tp(rows, table_c, bias, labels, start)
        both = _slots([lse_l, picked_l], group)
        lse = torch.logsumexp(both[0], dim=0)
        nll = torch.where(labels >= 0, lse - both[1].sum(0), 0.0)
        ctx.start, ctx.dtypes = start, (rows.dtype, table.dtype, bias.dtype)
        ctx.save_for_backward(rows, table_c, bias, labels, lse)
        return nll

    @staticmethod
    def backward(ctx, g):
        rows, table_c, bias, labels, lse = ctx.saved_tensors
        grads = mlm_ce_bwd_tp(rows, table_c, bias, labels, lse, g, ctx.start)
        return (*(d.to(t) for d, t in zip(grads, ctx.dtypes)), None, None)


def vocab_parallel_nll(rows, table, bias, labels, group):
    """Per-row nll of rows [R, H] against this rank's vocabulary rows
    ``table`` + ``bias`` of a vocabulary split over the model ``group``,
    labels [R] global (-1 ignored); differentiable in rows (the gradient
    summed over the group by ``copy_to_model``), table and bias (this
    rank's). Kernels #14/#15 in their tensor-parallel modes on CUDA
    tensors, the plain versions on CPU tensors."""
    return _VocabParallelNll.apply(copy_to_model(rows, group), table, bias, labels, group)


def vocab_parallel_mlm_loss(hidden, table, bias, labels, group) -> torch.Tensor:
    """Mean nll over the labeled rows (0 when none is), as
    ops/mlm_ce.py:mlm_ce_loss, on a vocabulary split over ``group``."""
    rows = hidden.reshape(-1, hidden.shape[-1]).contiguous()
    labs = labels.reshape(-1)
    nll = vocab_parallel_nll(rows, table, bias, labs, group)
    return nll.sum() / (labs >= 0).sum().clamp(min=1)


class _VocabParallelCe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, start, group):
        lf = logits.to(acc_dtype(logits.dtype))
        v = lf.shape[-1]
        local = labels.long() - start
        inside = (labels >= 0) & (local >= 0) & (local < v)
        idx = torch.where(inside, local, 0)
        picked = torch.where(inside, lf.gather(-1, idx[:, None])[:, 0], 0.0)
        mx = _slots([lf.amax(-1)], group)[0].amax(0)          # the row max over the group
        both = _model_sum(torch.stack([torch.exp(lf - mx[:, None]).sum(-1), picked]), group)
        valid = labels >= 0
        nll = torch.where(valid, torch.log(both[0]) + mx - both[1], 0.0)
        ctx.save_for_backward(logits, mx, both[0], idx, inside, valid)
        return nll

    @staticmethod
    def backward(ctx, g):
        logits, mx, sumexp, idx, inside, valid = ctx.saved_tensors
        lf = logits.to(mx.dtype)
        dl = torch.exp(lf - mx[:, None]) / sumexp[:, None]
        dl.scatter_add_(-1, idx[:, None], -inside.to(dl.dtype)[:, None])
        g = torch.where(valid, g.to(dl.dtype), 0.0)   # an ignored row takes no gradient
        return (dl * g[:, None]).to(logits.dtype), None, None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, start: int,
                                 group) -> torch.Tensor:
    """The mean cross entropy over the labelled rows (labels -1 ignored; 0
    when none is labelled) of logits split over the model ``group`` by
    vocabulary: ``logits`` [..., V / tp] this rank's columns from the global
    index ``start``, ``labels`` [...] global, as F.cross_entropy(
    ignore_index=-1) of the whole logits. The row max, then the sum of exp
    and the picked logit, are combined over the group in fp32 (fp64 for
    fp64); the backward is softmax minus one-hot on the rank's columns."""
    rows = logits.reshape(-1, logits.shape[-1])
    labs = labels.reshape(-1)
    nll = _VocabParallelCe.apply(rows, labs, start, group)
    return nll.sum() / (labs >= 0).sum().clamp(min=1)


class VocabShardLogits:
    """The MLM decode of an eval forward on a vocabulary split over the
    model ``group``: this rank's fp32 logits [..., V / tp] from the global
    index ``start``. ``nll_and_argmax(labels)`` gives what one process
    reads from the whole logits, without gathering them."""

    def __init__(self, local: torch.Tensor, start: int, group):
        self.local, self.start, self.group = local, start, group

    def nll_and_argmax(self, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(nll at the label, 0 where it is -1; the argmax over the whole
        vocabulary, the lowest index among equal maxima), both [...]."""
        logits = self.local.float()
        v = logits.shape[-1]
        local = labels.long() - self.start
        inside = (labels >= 0) & (local >= 0) & (local < v)
        picked = torch.where(inside, logits.gather(-1, torch.where(inside, local, 0)[..., None])
                             [..., 0], 0.0)
        mx, arg = logits.max(-1)          # the first of equal maxima
        both = _slots([torch.logsumexp(logits, -1), picked, mx, (arg + self.start).float()],
                      self.group)
        lse = torch.logsumexp(both[0], dim=0)
        winner = both[2].argmax(0, keepdim=True)   # the lowest rank among equal maxima
        argmax = both[3].gather(0, winner)[0].long()
        return torch.where(labels >= 0, lse - both[1].sum(0), 0.0), argmax


def shard_model(model: torch.nn.Module, group) -> torch.nn.Module:
    """Shard a whole, initialised PVLT in place over the model ``group``
    under ``RULES``: each split parameter becomes this rank's shard (marked
    ``tp_split``), every block and the model learn the group (the model's
    ``vocab_group`` too where the vocabulary splits). Every rank must start
    from the same weights (the same seed, or a state dict loaded before). A
    sequence-parallel model (built with ``sp_group``, the same group) then
    runs each split stage on the band between its blocks (the module
    docstring)."""
    cfg = model.cfg
    if model.sp_group is not None and model.sp_group is not group:
        raise ValueError("a sequence-parallel model splits its weights over its own model "
                         "group (sp_group)")
    tp = group_size(group)
    if tp == 1:
        return model
    rank = dist.get_rank(group)
    split = layout(dict(model.named_parameters()), cfg, tp)
    with torch.no_grad():
        for name, kind in split.items():
            if kind is None:
                continue
            owner, attr = model.get_submodule(name.rsplit(".", 1)[0]), name.rsplit(".", 1)[1]
            old = getattr(owner, attr)
            new = torch.nn.Parameter(shard_tensor(old.data, kind, rank, tp),
                                     requires_grad=old.requires_grad)
            new.tp_split = kind
            setattr(owner, attr, new)
    for name, m in model.named_modules():
        if hasattr(m, "tp_group") and name.startswith("block"):
            m.tp_group = group
            m.attn_split = split.get(f"{name}.attn.q.weight") is not None
            m.mlp_split = split.get(f"{name}.mlp.fc1.weight") is not None
    if split.get("text_embeddings.word_embeddings.weight"):
        model.vocab_group = group
    model.tp_group = group
    return model


def describe(model: torch.nn.Module) -> str:
    """The layout of a sharded model, one line a stage and one for the
    vocabulary: which attentions and MLPs are split over how many ranks."""
    tp = group_size(getattr(model, "tp_group", None))
    lines = [f"tensor parallelism over {tp} ranks (model axis innermost; "
             f"{mesh.ranks_per_node()} ranks a node, each model group inside one):"]
    for i in range(model.cfg.num_stages):
        blocks = getattr(model, f"block{i + 1}")
        heads, hidden = model.cfg.num_heads[i], blocks[0].mlp.fc1.weight.shape[0] * (
            tp if blocks[0].mlp_split else 1)
        attn = (f"sharded, {heads // tp} of {heads} heads a rank" if blocks[0].attn_split
                else f"replicated ({heads} heads)")
        mlp = (f"sharded, {hidden // tp} of {hidden} a rank" if blocks[0].mlp_split
               else f"replicated ({hidden})")
        lines.append(f"  stage {i + 1} ({len(blocks)} blocks): attention {attn}; "
                     f"MLP hidden {mlp}")
    vocab = model.cfg.vocab_size
    lines.append("  vocabulary: " + (f"sharded, {vocab // tp} of {vocab} rows a rank"
                                     if model.vocab_group is not None
                                     else f"replicated ({vocab})")
                 + "; everything else replicated")
    return "\n".join(lines)
