"""Pre-training validation: MLM / ITM / CLS accuracy and T2I PSNR.

Counterpart of mvlt_tpu/eval/vl_eval.py (reference
engine_grid_masking.py:153-333). Three eval-mode forwards per batch:
  1. (clean images, masked text ids) -> MLM loss and token accuracy;
  2. (clean images, clean text ids)  -> ITM and CLS losses and accuracies;
  3. (masked images, clean text ids) -> T2I loss and PSNR.
The per-batch function returns masked SUMS and COUNTS, not means: rows
padded by ``pad_eval_batch`` carry label -1 and valid 0, so a ragged last
batch counts exactly. The summed quality score ``mlm_acc + itm_acc +
sup_cls_acc + sub_cls_acc`` picks the best checkpoint (main_vl.py:462-498).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

import numpy as np
import torch

from mvlt_tpu_torch.data.fashion_gen import batch_to_device
from mvlt_tpu_torch.eval.metrics import argmax_accuracy_count, psnr_from_mse
from mvlt_tpu_torch.train.losses import cross_entropy
from mvlt_tpu_torch.utils.logging import MetricLogger

PAD_LABEL = -1


def make_vl_eval_fn(model, cfg) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """``eval_batch(batch) -> sums and counts`` (device scalars) of
    ``model`` in eval mode, without gradients, on a padded host batch
    (``pad_eval_batch``), moved to the model's device."""
    lt = cfg.loss_type

    def forward(images, ids):
        return model(images.float(), ids.long())

    def masked_correct(logits, labels):
        # an argmax is never -1, so padded rows and ignored tokens count nothing
        return argmax_accuracy_count(logits, labels.reshape(logits.shape[:-1])).float()

    @torch.no_grad()
    def eval_batch(batch: Dict) -> Dict[str, torch.Tensor]:
        model.eval()
        batch = batch_to_device(batch, next(model.parameters()).device)
        valid = batch["valid"].float()                       # [B], 0 on padding
        nv = valid.sum()
        m = {"n_valid": nv}
        total = torch.zeros((), dtype=torch.float32, device=valid.device)

        if lt.mlm:
            out = forward(batch["images"], batch["input_ids"])
            labels = batch["mlm_labels"]                     # padded rows: all -1
            logits = out["mlm_logits"]
            total = total + cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                          labels.reshape(-1), ignore_index=PAD_LABEL)
            tok_valid = labels != PAD_LABEL
            m["mlm_correct"] = masked_correct(logits, labels)
            m["mlm_count"] = tok_valid.sum().float()

        if lt.itm or lt.cls:
            out = forward(batch["images"], batch["ori_input_ids"])
            if lt.itm:
                labels = batch["itm_labels"].reshape(-1)     # padded rows: -1
                logits = out["itm_logits"].reshape(-1, 2)
                total = total + cross_entropy(logits, labels, ignore_index=PAD_LABEL)
                m["itm_correct"] = masked_correct(logits, labels)
            if lt.cls:
                b = batch["images"].shape[0]
                sup = out["sup_cls_logits"].reshape(b, -1)
                sub = out["sub_cls_logits"].reshape(b, -1)
                total = total + cross_entropy(sup, batch["sup_cls_labels"].reshape(-1),
                                              ignore_index=PAD_LABEL)
                total = total + cross_entropy(sub, batch["sub_cls_labels"].reshape(-1),
                                              ignore_index=PAD_LABEL)
                m["sup_correct"] = masked_correct(sup, batch["sup_cls_labels"])
                m["sub_correct"] = masked_correct(sub, batch["sub_cls_labels"])

        if lt.t2i:
            out = forward(batch["masked_images"], batch["ori_input_ids"])
            pred = out["t2i_logits"].float()
            tgt = batch["images"].float()
            diff = (pred - tgt).abs()
            sl1_rows = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
            sl1_rows = sl1_rows.reshape(pred.shape[0], -1).mean(-1)
            total = total + 10.0 * (sl1_rows * valid).sum() / nv.clamp(min=1.0)
            mse_rows = (pred - tgt).square().reshape(pred.shape[0], -1).mean(-1)
            m["t2i_mse_sum"] = (mse_rows * valid).sum()

        m["total_loss"] = total
        return m

    return eval_batch


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
    """Run the VL eval over host batches on one device (no padding: the
    ``valid`` mask is all ones); returns the meters' global averages and
    ``quality_score``."""
    logger = MetricLogger(is_main=is_main)
    for batch in logger.log_every(loader, log_every, header="Eval:"):
        feed = pad_eval_batch({k: v for k, v in batch.items() if isinstance(v, np.ndarray)}, 1)
        m = {k: float(v) for k, v in eval_batch_fn(feed).items()}
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
