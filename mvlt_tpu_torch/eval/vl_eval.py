"""Pre-training validation: MLM / ITM / CLS accuracy and T2I PSNR.

Counterpart of mvlt_tpu/eval/vl_eval.py (reference
engine_grid_masking.py:153-333). Three eval-mode forwards per batch:
  1. (clean images, masked text ids) -> MLM loss and token accuracy;
  2. (clean images, clean text ids)  -> ITM and CLS losses and accuracies;
  3. (masked images, clean text ids) -> T2I loss and PSNR.
The forwards give per-row values (each row's nll sums, correct and labeled
counts, T2I means); a batch's masked SUMS and COUNTS, not means, are taken
from them: rows padded by ``pad_eval_batch`` carry label -1 and valid 0, so
a ragged last batch counts exactly. The summed quality score ``mlm_acc +
itm_acc + sup_cls_acc + sub_cls_acc`` picks the best checkpoint
(main_vl.py:462-498).

Across data-parallel ranks (the JAX package's ``mesh=``) every rank reads
each batch, pads it to a multiple of the ranks, and scores its contiguous
share of the rows; the per-row values are gathered into zero-filled buffers
that all_reduce sums, and every rank takes the batch's sums from all rows
in order, as one process does (one rank scores every row). Under tensor
parallelism the rows are split over the data ranks, the ranks of a model
group score the same rows together, and the MLM decode of a split
vocabulary combines the ranks' nll and argmax
(parallel/tensor.py:VocabShardLogits).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

import numpy as np
import torch

from mvlt_tpu_torch.data.fashion_gen import batch_to_device
from mvlt_tpu_torch.eval.metrics import psnr_from_mse
from mvlt_tpu_torch.parallel import mesh
from mvlt_tpu_torch.parallel.sharding import EvalShard, gather_slots
from mvlt_tpu_torch.parallel.tensor import VocabShardLogits
from mvlt_tpu_torch.utils.logging import MetricLogger

PAD_LABEL = -1


def make_vl_eval_fn(model, cfg) -> Callable[[Dict], Dict[str, float]]:
    """``eval_batch(batch) -> sums and counts`` of ``model`` in eval mode,
    without gradients, on a padded host batch (``pad_eval_batch``), moved
    to the model's device; ``eval_batch.rows(batch)`` gives the per-row
    values the sums are taken from (``batch_sums``)."""
    lt = cfg.loss_type

    def forward(images, ids):
        return model(images.float(), ids.long())

    def row_nll(logits, labels):
        """Per-row (nll sum, correct, labeled count) of logits [B, ..., C]
        against labels [B, ...], ignoring -1; an argmax is never -1, so
        padded rows and ignored tokens count nothing."""
        if isinstance(logits, VocabShardLogits):
            b = labels.shape[0]
            labels = labels.reshape(b, -1)
            nll, argmax = logits.nll_and_argmax(labels)
            valid = labels != PAD_LABEL
            return (nll.sum(1), ((argmax == labels) & valid).sum(1).float(),
                    valid.sum(1).float())
        b = logits.shape[0]
        logits = logits.reshape(b, -1, logits.shape[-1]).float()
        labels = labels.reshape(b, -1)
        valid = labels != PAD_LABEL
        safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
        nll = -torch.log_softmax(logits, dim=-1).gather(-1, safe[..., None])[..., 0]
        correct = (logits.argmax(-1) == labels) & valid
        return (torch.where(valid, nll, 0.0).sum(1), correct.sum(1).float(),
                valid.sum(1).float())

    @torch.no_grad()
    def eval_rows(batch: Dict) -> Dict[str, torch.Tensor]:
        model.eval()
        batch = batch_to_device(batch, next(model.parameters()).device)
        r = {"valid": batch["valid"].float()}                # [B], 0 on padding
        if lt.mlm:
            out = forward(batch["images"], batch["input_ids"])
            r["mlm_nll"], r["mlm_correct"], r["mlm_count"] = row_nll(
                out["mlm_logits"], batch["mlm_labels"])     # padded rows: all -1
        if lt.itm or lt.cls:
            out = forward(batch["images"], batch["ori_input_ids"])
            if lt.itm:
                r["itm_nll"], r["itm_correct"], r["itm_count"] = row_nll(
                    out["itm_logits"], batch["itm_labels"])  # padded rows: -1
            if lt.cls:
                r["sup_nll"], r["sup_correct"], r["cls_count"] = row_nll(
                    out["sup_cls_logits"], batch["sup_cls_labels"])
                r["sub_nll"], r["sub_correct"], _ = row_nll(
                    out["sub_cls_logits"], batch["sub_cls_labels"])
        if lt.t2i:
            out = forward(batch["masked_images"], batch["ori_input_ids"])
            pred = out["t2i_logits"].float()
            tgt = batch["images"].float()
            diff = (pred - tgt).abs()
            sl1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
            r["t2i_sl1"] = sl1.reshape(pred.shape[0], -1).mean(-1)
            r["t2i_mse"] = (pred - tgt).square().reshape(pred.shape[0], -1).mean(-1)
        return r

    def eval_batch(batch: Dict) -> Dict[str, float]:
        return batch_sums(eval_rows(batch))

    eval_batch.rows = eval_rows
    return eval_batch


def batch_sums(rows: Dict) -> Dict[str, float]:
    """A batch's sums and counts (the JAX eval step's keys) from its per-row
    values, in float64 over the rows in order: ``total_loss`` is the sum of
    the enabled losses' means (MLM over the labeled tokens, ITM and CLS over
    the labeled rows, T2I SmoothL1 x 10 over the valid rows)."""
    r = {k: torch.as_tensor(v).detach().cpu().double().numpy() for k, v in rows.items()}
    total_of = {k: float(v.sum()) for k, v in r.items()}
    nv = total_of["valid"]
    m = {"n_valid": nv}
    total = 0.0
    if "mlm_nll" in r:
        total += total_of["mlm_nll"] / max(total_of["mlm_count"], 1.0)
        m["mlm_correct"], m["mlm_count"] = total_of["mlm_correct"], total_of["mlm_count"]
    if "itm_nll" in r:
        total += total_of["itm_nll"] / max(total_of["itm_count"], 1.0)
        m["itm_correct"] = total_of["itm_correct"]
    if "sup_nll" in r:
        cls_count = max(total_of["cls_count"], 1.0)
        total += total_of["sup_nll"] / cls_count + total_of["sub_nll"] / cls_count
        m["sup_correct"], m["sub_correct"] = total_of["sup_correct"], total_of["sub_correct"]
    if "t2i_sl1" in r:
        total += 10.0 * float((r["t2i_sl1"] * r["valid"]).sum()) / max(nv, 1.0)
        m["t2i_mse_sum"] = float((r["t2i_mse"] * r["valid"]).sum())
    m["total_loss"] = total
    return m


def _sharded_rows(eval_batch_fn, feed: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Every row's values of a batch padded to a multiple of the ranks, each
    rank scoring its contiguous share (parallel/sharding.py:gather_slots)."""
    shard = EvalShard.of_this_rank(feed["valid"].shape[0])
    local = {k: v[shard.start:shard.start + shard.slots] for k, v in feed.items()}
    rows = eval_batch_fn.rows(local)
    keys = sorted(rows)
    every = gather_slots(torch.stack([rows[k].double() for k in keys], dim=1), shard)
    return {k: every[:, i] for i, k in enumerate(keys)}


def pad_eval_batch(feed: Dict[str, np.ndarray], multiple: int) -> Dict[str, np.ndarray]:
    """Pad every array's leading dim to ``multiple`` and add the ``valid``
    mask. Label arrays are padded with -1 (the ignore index), everything
    else with zeros."""
    b = int(feed["images"].shape[0])
    pad = (-b) % multiple
    out = {}
    for k, v in feed.items():
        v = np.asarray(v)
        if pad:
            fill = PAD_LABEL if k.endswith("labels") else 0
            v = np.pad(v, [(0, pad)] + [(0, 0)] * (v.ndim - 1), constant_values=fill)
        out[k] = v
    out["valid"] = np.concatenate([np.ones(b, np.float32), np.zeros(pad, np.float32)])
    return out


def evaluate_vl(eval_batch_fn: Callable, loader: Iterable, log_every: int = 10,
                is_main: bool = True) -> Dict[str, float]:
    """Run the VL eval over host batches, each batch's rows split over the
    data ranks (every rank reads the same batches; the padding
    rows count nothing; in one process no row is padded). Returns the
    meters' global averages and ``quality_score``, the same on every rank."""
    logger = MetricLogger(is_main=is_main)
    for batch in logger.log_every(loader, log_every, header="Eval:"):
        feed = pad_eval_batch({k: v for k, v in batch.items() if isinstance(v, np.ndarray)},
                              mesh.data_size())
        m = batch_sums(_sharded_rows(eval_batch_fn, feed))
        nv = m["n_valid"]
        if "mlm_correct" in m:
            cnt = m["mlm_count"]
            logger.meters["mlm_acc"].update(m["mlm_correct"] / max(cnt, 1.0), n=int(max(cnt, 1)))
        if "itm_correct" in m:
            logger.meters["itm_acc"].update(m["itm_correct"] / max(nv, 1.0), n=int(nv))
        if "sup_correct" in m:
            logger.meters["sup_cls_acc"].update(m["sup_correct"] / max(nv, 1.0), n=int(nv))
            logger.meters["sub_cls_acc"].update(m["sub_correct"] / max(nv, 1.0), n=int(nv))
        logger.meters["total_loss"].update(m["total_loss"], n=int(nv))
        if "t2i_mse_sum" in m:
            # PSNR of the per-batch MSE, peak 255 on [0, 1] images as the
            # reference (libs/vl_scores.py:57-63)
            logger.meters["t2i_psnr"].update(psnr_from_mse(m["t2i_mse_sum"] / max(nv, 1.0)),
                                             n=int(nv))
    stats = logger.global_averages()
    stats["quality_score"] = sum(
        stats.get(k, 0.0) for k in ("mlm_acc", "itm_acc", "sup_cls_acc", "sub_cls_acc"))
    if is_main:
        print("eval:", {k: round(v, 5) for k, v in stats.items()}, flush=True)
    return stats
