"""Pre-training and fine-tuning objectives.

Counterpart of mvlt_tpu/train/losses.py (reference
engine_grid_masking.py:81-102): MLM cross entropy with ignore index -1
(weight 1), ITM cross entropy (1), the two CLS cross entropies (1 each) and
T2I SmoothL1 with beta 1 against the clean image (10). All reductions are
means. The MLM loss decodes the tied vocabulary through the fused CE kernels
on the card (``mlm_ce_kernel``: the fp32 logits never exist whole, the
backward writes their bf16 gradient once), or in row chunks, recomputing
each chunk's logits in the backward (activation checkpointing), so the
[rows, vocab] logits never exist whole; with the gather plan it decodes
only the labeled rows.

Under data parallelism (a process ``group`` of more than one rank, each
holding an equal share of the global batch, DDP averaging the gradients)
the step must equal the single-device step on the global batch, as the JAX
package's SPMD step does:
  * the ITM, CLS and T2I losses are means over rows (or pixels) of equal
    per-rank batches, so the mean of the ranks' means, which DDP's average
    of their gradients differentiates, is the global mean: no change;
  * the MLM loss is a mean over the labeled tokens, whose count differs by
    rank: each rank's mean is scaled by world * count / global count
    (``global_mean_scale``), so that the ranks' average is the global sum
    over the global count;
  * the MLM gather plan keeps the labeled rows before the *global*
    capacity: one exchange of the per-rank labeled counts offsets each
    rank's running count (``mlm_gather_plan``).
Under tensor parallelism ``group`` is the data group (the ranks of a model
group hold the same rows: a sum over the world would count each sample tp
times), and on a vocabulary split over the model group (``vocab_group``)
the MLM decode is parallel/tensor.py:vocab_parallel_mlm_loss, kernels
#14/#15 in their tensor-parallel modes on the card and their plain
versions on the CPU, whatever ``mlm_ce_kernel`` says; through the logits
(``mlm_loss_chunk <= 0``) it is parallel/tensor.py:
vocab_parallel_cross_entropy of the rank's columns.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from mvlt_tpu_torch.ops.mlm_ce import mlm_ce_loss
from mvlt_tpu_torch.parallel.sharding import all_reduce_sum, exclusive_prefix, group_size
from mvlt_tpu_torch.parallel.tensor import (VocabShardLogits, vocab_parallel_cross_entropy,
                                            vocab_parallel_mlm_loss)

MLM_LOSS_WEIGHT = 1.0
ITM_LOSS_WEIGHT = 1.0
T2I_LOSS_WEIGHT = 10.0
MLM_IGNORE_INDEX = -1


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: Optional[int] = None) -> torch.Tensor:
    """Mean softmax cross entropy in fp32; positions equal to ignore_index
    leave the mean (torch CrossEntropyLoss(ignore_index=...) semantics; 0
    when every position is ignored)."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    if ignore_index is None:
        return -log_probs.gather(-1, labels[..., None].long())[..., 0].mean()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    nll = -log_probs.gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp(min=1)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """torch SmoothL1Loss (mean) in fp32."""
    diff = (pred.float() - target.float()).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta).mean()


def _chunk_nll(rows, labels, table, bias):
    """(sum of nll over labeled rows, labeled count) of one chunk."""
    logits = torch.matmul(rows, table.to(rows.dtype).transpose(0, 1)).float() + bias
    valid = labels != MLM_IGNORE_INDEX
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, safe[:, None])[:, 0]
    return torch.where(valid, nll, 0.0).sum(), valid.sum()


def chunked_mlm_loss(hidden: torch.Tensor, table: torch.Tensor, bias: torch.Tensor,
                     labels: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """Cross entropy of hidden [..., H] against the tied table [vocab, H] +
    bias, labels [...] with -1 ignored; the same value as cross_entropy over
    the full logits. Logits are made chunk rows at a time and recomputed in
    the backward."""
    rows = hidden.reshape(-1, hidden.shape[-1])
    labs = labels.reshape(-1)
    total = rows.new_zeros((), dtype=torch.float32)
    count = labs.new_zeros(())
    for i in range(0, rows.shape[0], chunk):
        args = (rows[i:i + chunk], labs[i:i + chunk], table, bias)
        s, c = (checkpoint(_chunk_nll, *args, use_reentrant=False)
                if torch.is_grad_enabled() else _chunk_nll(*args))
        total, count = total + s, count + c
    return total / count.clamp(min=1)


def global_mean_scale(labels: torch.Tensor, group,
                      total: Optional[torch.Tensor] = None) -> torch.Tensor:
    """world * (this rank's labeled count) / (the global labeled count): the
    factor that turns a rank's mean over its labeled tokens into its share
    of the global mean under DDP's gradient average. The global count is
    ``total`` when the caller has it (the gather plan's), else one
    all_reduce."""
    count = (labels != MLM_IGNORE_INDEX).sum().to(torch.float32)
    if total is None:
        total = all_reduce_sum(count, group)
    return group_size(group) * count / total.to(torch.float32).clamp(min=1.0)


def _global_mean(loss: torch.Tensor, labels: torch.Tensor, group,
                 total: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A rank's MLM mean as its share of the global one (unchanged without a
    group of more than one rank)."""
    if group_size(group) == 1:
        return loss
    return loss * global_mean_scale(labels, group, total)


def _mlm_decode_loss(hidden, table, bias, labels, chunk: int, use_kernel: bool, group=None,
                     total=None, vocab_group=None):
    """The MLM decode: with ``use_kernel``, on the card, the fused vocab-tiled
    CE kernels (ops/mlm_ce.py:mlm_ce_loss: the logits never in device
    memory, their gradient once, in bf16, in the backward); otherwise, and
    always on the CPU, the chunked loss, as in the JAX package off the TPU
    (mvlt_tpu/train/losses.py:_mlm_decode_loss); on a vocabulary split over
    ``vocab_group`` the vocabulary-parallel loss. Under ``group``, the
    rank's share of the global mean (``total``: the global labeled count,
    if known)."""
    if vocab_group is not None:
        loss = vocab_parallel_mlm_loss(hidden, table, bias, labels, vocab_group)
    elif use_kernel and hidden.device.type == "cuda":
        loss = mlm_ce_loss(hidden, table, bias, labels)
    else:
        loss = chunked_mlm_loss(hidden, table, bias, labels, chunk=chunk)
    return _global_mean(loss, labels, group, total)


def mlm_gather_plan(labels: torch.Tensor, capacity_frac: float = 0.25, chunk: int = 2048,
                    group=None):
    """Static-capacity gather plan for the labeled MLM rows: (idx [slots],
    sel_labels [slots], chunk, kept), or None when the capacity would not
    shrink the stream; ``kept`` is the count of labeled rows the plan keeps
    over every rank, the MLM mean's divisor. capacity = ceil(int(B*T * frac) / 512) * 512 (at least 512);
    the labeled rows go to the front in order, without a sort; unfilled
    slots point at distinct rows (their own index) with label -1; labeled
    rows past the capacity are dropped from the mean, never mislabeled. The
    decode chunk shrinks to a divisor of the slots.

    Under ``group`` (ranks holding equal consecutive shares of the global
    batch, rank order = row order) B*T and the capacity are the global
    batch's; one exchange of the ranks' labeled counts gives each rank the
    count before its rows, so a row is kept when its global position among
    the labeled rows is below the capacity, as in the single-device plan
    on the global batch. A rank may keep up to min(its rows, capacity)."""
    labs = labels.reshape(-1)
    n = labs.shape[0]
    world = group_size(group)
    capacity = max(512, -(-int(n * world * capacity_frac) // 512) * 512)
    if capacity >= n * world:
        return None
    valid = labs != MLM_IGNORE_INDEX
    pos = torch.cumsum(valid, 0) - 1
    offset, total = exclusive_prefix(valid.sum(), group)
    keep = valid & (pos + offset < capacity)
    slots = min(n, capacity)
    chunk = math.gcd(slots, max(512, chunk // 512 * 512))
    dest = torch.where(keep, pos, slots)
    base = torch.cat([torch.arange(slots, device=labs.device),
                      torch.zeros(1, dtype=torch.long, device=labs.device)])
    # slot `slots` collects every unplaced row and is cut off
    idx = base.scatter(0, dest, torch.arange(n, device=labs.device))[:slots]
    filled = torch.arange(slots, device=labs.device) < keep.sum()
    sel = torch.where(filled, labs[idx], torch.full_like(labs[idx], MLM_IGNORE_INDEX))
    return idx, sel, chunk, total.clamp(max=capacity)


def gathered_mlm_loss(hidden, table, bias, labels, capacity_frac: float = 0.25,
                      chunk: int = 2048, ce_kernel: bool = False, group=None,
                      vocab_group=None) -> torch.Tensor:
    """MLM cross entropy decoding only the labeled rows of a full [B, T, H]
    hidden stream."""
    plan = mlm_gather_plan(labels, capacity_frac=capacity_frac, chunk=chunk, group=group)
    if plan is None:
        return _mlm_decode_loss(hidden, table, bias, labels, chunk, ce_kernel, group,
                                vocab_group=vocab_group)
    idx, sel, chunk, kept = plan
    rows = hidden.reshape(-1, hidden.shape[-1])[idx]
    return _mlm_decode_loss(rows[None], table, bias, sel[None], chunk, ce_kernel, group, kept,
                            vocab_group)


def compute_losses(outputs: Dict[str, Any], batch: Dict[str, torch.Tensor],
                   num_super: int = 48, num_sub: int = 122, mlm_chunk: int = 2048,
                   mlm_capacity_frac: float = 1.0, mlm_ce_kernel: bool = False,
                   group=None, mlm_count: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
    """Every enabled objective for one step, and their weighted sum as
    ``total_loss``. batch: images [B, H, W, 3] (the clean T2I target),
    mlm_labels [B, T] (-1 unmasked), itm_labels [B], sup/sub_cls_labels [B].
    Under a data-parallel ``group`` the MLM loss is the rank's share of the
    global mean (see the module's docstring; ``mlm_count``: the global
    labeled count when the caller has it, as a gather plan does); the others
    need no change. On a vocabulary split over a model group (the model's
    ``mlm_vocab_group`` output, or split logits, a
    parallel/tensor.py:VocabShardLogits) the MLM loss is
    vocabulary-parallel."""
    ref = next(v for v in outputs.values() if isinstance(v, torch.Tensor))
    zero = torch.zeros((), dtype=torch.float32, device=ref.device)
    losses = {k: zero for k in ("loss_mlm", "loss_itm", "loss_sup_cls", "loss_sub_cls",
                                "loss_t2i")}
    total = zero
    logits = outputs.get("mlm_logits")
    if logits is not None:
        labels = batch["mlm_labels"].reshape(-1)
        if isinstance(logits, VocabShardLogits):
            loss = vocab_parallel_cross_entropy(logits.local, labels, logits.start, logits.group)
        else:
            loss = cross_entropy(logits.reshape(-1, logits.shape[-1]), labels,
                                 ignore_index=MLM_IGNORE_INDEX)
        losses["loss_mlm"] = MLM_LOSS_WEIGHT * _global_mean(loss, labels, group)
    elif outputs.get("mlm_hidden") is not None:
        args = (outputs["mlm_hidden"], outputs["mlm_table"], outputs["mlm_bias"],
                batch["mlm_labels"])
        vocab_group = outputs.get("mlm_vocab_group")
        if mlm_capacity_frac < 1.0:
            loss = gathered_mlm_loss(*args, capacity_frac=mlm_capacity_frac,
                                     chunk=mlm_chunk, ce_kernel=mlm_ce_kernel, group=group,
                                     vocab_group=vocab_group)
        else:
            loss = _mlm_decode_loss(*args, mlm_chunk, mlm_ce_kernel, group, mlm_count,
                                    vocab_group)
        losses["loss_mlm"] = MLM_LOSS_WEIGHT * loss
    if outputs.get("itm_logits") is not None:
        losses["loss_itm"] = ITM_LOSS_WEIGHT * cross_entropy(
            outputs["itm_logits"].reshape(-1, 2), batch["itm_labels"].reshape(-1))
    if outputs.get("sup_cls_logits") is not None:
        losses["loss_sup_cls"] = cross_entropy(
            outputs["sup_cls_logits"].reshape(-1, num_super), batch["sup_cls_labels"].reshape(-1))
        losses["loss_sub_cls"] = cross_entropy(
            outputs["sub_cls_logits"].reshape(-1, num_sub), batch["sub_cls_labels"].reshape(-1))
    if outputs.get("t2i_logits") is not None:
        losses["loss_t2i"] = T2I_LOSS_WEIGHT * smooth_l1(outputs["t2i_logits"], batch["images"])
    for k in ("loss_mlm", "loss_itm", "loss_sup_cls", "loss_sub_cls", "loss_t2i"):
        if losses[k] is not zero:
            total = total + losses[k]
    losses["total_loss"] = total
    return losses
