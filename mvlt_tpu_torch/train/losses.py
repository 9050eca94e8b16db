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
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from mvlt_tpu_torch.ops.mlm_ce import mlm_ce_loss

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


def _mlm_decode_loss(hidden, table, bias, labels, chunk: int, use_kernel: bool):
    """The MLM decode: with ``use_kernel``, on the card, the fused vocab-tiled
    CE kernels (ops/mlm_ce.py:mlm_ce_loss: the logits never in device
    memory, their gradient once, in bf16, in the backward); otherwise, and
    always on the CPU, the chunked loss, as in the JAX package off the TPU
    (mvlt_tpu/train/losses.py:_mlm_decode_loss)."""
    if use_kernel and hidden.device.type == "cuda":
        return mlm_ce_loss(hidden, table, bias, labels)
    return chunked_mlm_loss(hidden, table, bias, labels, chunk=chunk)


def mlm_gather_plan(labels: torch.Tensor, capacity_frac: float = 0.25, chunk: int = 2048):
    """Static-capacity gather plan for the labeled MLM rows: (idx [capacity],
    sel_labels [capacity], chunk), or None when the capacity would not shrink
    the stream. capacity = ceil(int(B*T * frac) / 512) * 512 (at least 512);
    the labeled rows go to the front in order, without a sort; unfilled
    slots point at distinct rows (their own index) with label -1; labeled
    rows past the capacity are dropped from the mean, never mislabeled. The
    decode chunk shrinks to a divisor of the capacity."""
    labs = labels.reshape(-1)
    n = labs.shape[0]
    capacity = max(512, -(-int(n * capacity_frac) // 512) * 512)
    if capacity >= n:
        return None
    chunk = math.gcd(capacity, max(512, chunk // 512 * 512))
    valid = labs != MLM_IGNORE_INDEX
    pos = torch.cumsum(valid, 0) - 1
    dest = torch.where(valid & (pos < capacity), pos, capacity)
    base = torch.cat([torch.arange(capacity, device=labs.device),
                      torch.zeros(1, dtype=torch.long, device=labs.device)])
    # slot `capacity` collects every unplaced row and is cut off
    idx = base.scatter(0, dest, torch.arange(n, device=labs.device))[:capacity]
    filled = torch.arange(capacity, device=labs.device) < valid.sum().clamp(max=capacity)
    sel = torch.where(filled, labs[idx], torch.full_like(labs[idx], MLM_IGNORE_INDEX))
    return idx, sel, chunk


def gathered_mlm_loss(hidden, table, bias, labels, capacity_frac: float = 0.25,
                      chunk: int = 2048, ce_kernel: bool = False) -> torch.Tensor:
    """MLM cross entropy decoding only the labeled rows of a full [B, T, H]
    hidden stream."""
    plan = mlm_gather_plan(labels, capacity_frac=capacity_frac, chunk=chunk)
    if plan is None:
        return _mlm_decode_loss(hidden, table, bias, labels, chunk, ce_kernel)
    idx, sel, chunk = plan
    rows = hidden.reshape(-1, hidden.shape[-1])[idx]
    return _mlm_decode_loss(rows[None], table, bias, sel[None], chunk, ce_kernel)


def compute_losses(outputs: Dict[str, Any], batch: Dict[str, torch.Tensor],
                   num_super: int = 48, num_sub: int = 122, mlm_chunk: int = 2048,
                   mlm_capacity_frac: float = 1.0,
                   mlm_ce_kernel: bool = False) -> Dict[str, torch.Tensor]:
    """Every enabled objective for one step, and their weighted sum as
    ``total_loss``. batch: images [B, H, W, 3] (the clean T2I target),
    mlm_labels [B, T] (-1 unmasked), itm_labels [B], sup/sub_cls_labels [B]."""
    ref = next(v for v in outputs.values() if isinstance(v, torch.Tensor))
    zero = torch.zeros((), dtype=torch.float32, device=ref.device)
    losses = {k: zero for k in ("loss_mlm", "loss_itm", "loss_sup_cls", "loss_sub_cls",
                                "loss_t2i")}
    total = zero
    if outputs.get("mlm_logits") is not None:
        vocab = outputs["mlm_logits"].shape[-1]
        losses["loss_mlm"] = MLM_LOSS_WEIGHT * cross_entropy(
            outputs["mlm_logits"].reshape(-1, vocab), batch["mlm_labels"].reshape(-1),
            ignore_index=MLM_IGNORE_INDEX)
    elif outputs.get("mlm_hidden") is not None:
        args = (outputs["mlm_hidden"], outputs["mlm_table"], outputs["mlm_bias"],
                batch["mlm_labels"])
        if mlm_capacity_frac < 1.0:
            loss = gathered_mlm_loss(*args, capacity_frac=mlm_capacity_frac,
                                     chunk=mlm_chunk, ce_kernel=mlm_ce_kernel)
        else:
            loss = _mlm_decode_loss(*args, mlm_chunk, mlm_ce_kernel)
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
