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
  * The MLM decode is vocabulary-parallel (``vocab_parallel_nll``): each
    rank's kernel #14 gives its range's (lse, picked logit), the group
    combines them in fp32 (the logsumexp of the lses, the sum of the
    picks), and #15 takes the global lse and gives the rows' partial
    gradient, summed by copy_to_model. The eval decode combines each rank's
    (max, first argmax + offset), the lowest index winning ties, and never
    gathers the logits (``VocabShardLogits``).

The collectives are ``all_reduce`` sums only (gloo offers nothing else on
CUDA tensors): a rank's shard is placed in a zero-filled full tensor and
summed (``consolidate``), per-rank values in zero-filled slots.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional

import torch
import torch.distributed as dist

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


def refusals(cfg) -> List[str]:
    """What tensor parallelism does not cover yet, for a resolved model
    config: each a name."""
    out = {
        "fused_attn_train": bool(cfg.fused_attn_train),
        "mlm_loss_chunk <= 0 (the MLM loss through the logits)":
            bool(cfg.loss_type.mlm and cfg.mlm_loss_chunk <= 0),
    }
    return [name for name, on in out.items() if on]


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
                        group) -> torch.Tensor:
    """x W^T + b of a row-parallel product on this rank's input columns:
    the ranks' fp32 partials summed over the model ``group``, then b added
    once and the sum rounded to x's type once. Without a group, ``linear``."""
    if group is None:
        return linear(x, weight, bias)
    total = reduce_from_model(linear_partial(x, weight), group)
    return (total + bias.to(total.dtype)).to(x.dtype)


def split_dim(group, dim: int) -> Optional[tuple]:
    """(dim, rank, tp) of a tensor split along ``dim`` over the model
    ``group`` (models/bert_embeddings.py:dropout's ``split``); None without
    a group."""
    return None if group is None else (dim, dist.get_rank(group), group_size(group))


class _FusedLnMlpTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, row_scale, eps, group):
        ctx.eps, ctx.group = eps, group
        ctx.param_dtypes = [t.dtype for t in (gamma, beta, w1, b1, w2, b2)]
        ctx.save_for_backward(x, gamma, beta, w1, b1, w2, row_scale)
        part = ln_mlp_fwd_tp(x, gamma, beta, w1, b1, w2, row_scale, eps)
        total = _model_sum(part, group)
        s = row_scale.to(total.dtype)[:, None, None]
        return (x.to(total.dtype) + total + s * b2.to(total.dtype)).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, w1, b1, w2, row_scale = ctx.saved_tensors
        if dy.device.type == "cuda":
            dy = dy.contiguous()
        dx_part, dgamma, dbeta, dw1, db1, dw2, db2 = ln_mlp_bwd_tp(
            x, gamma, beta, w1, b1, w2, row_scale, ctx.eps, dy)
        d = dx_part.shape[-1]
        summed = _model_sum(torch.cat([dx_part.reshape(-1), dgamma, dbeta]), ctx.group)
        dx = (dy.to(summed.dtype) + summed[:-2 * d].reshape(dx_part.shape)).to(x.dtype)
        grads = (summed[-2 * d:-d], summed[-d:], dw1, db1, dw2, db2)
        return (dx, *(g.to(t) for g, t in zip(grads, ctx.param_dtypes)), None, None, None)


def fused_ln_mlp_tp(x, gamma, beta, w1, b1, w2, b2, row_scale, eps: float, group):
    """x + s * MLP(LN(x)) with the hidden split over the model ``group``
    (W1, b1 this rank's rows, W2 its columns, b2 whole): kernels #12/#13
    in their tensor-parallel modes on CUDA tensors, their plain versions on
    CPU tensors; the ranks' fp32 partials summed, then b2 and x added once
    and y rounded once, as the one-process kernel does. row_scale None
    means ones."""
    if row_scale is None:
        row_scale = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    return _FusedLnMlpTp.apply(x, gamma, beta, w1, b1, w2, b2, row_scale, eps, group)


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
    ``vocab_group`` too where the vocabulary splits). Every rank must start from the same weights (the same seed,
    or a state dict loaded before). Raises NotImplementedError for what
    ``refusals`` names, and for a sequence-parallel model
    (parallel/sequence.py:refusals)."""
    cfg = model.cfg
    sequence.refusals(cfg, model.sp_group, group)
    tp = group_size(group)
    refused = refusals(cfg)
    if refused:
        raise NotImplementedError(f"tensor parallelism does not cover: {'; '.join(refused)}")
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
    lines = [f"tensor parallelism over {tp} ranks (model axis innermost):"]
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
