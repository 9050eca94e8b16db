"""Evaluation metric primitives.

Counterpart of mvlt_tpu/eval/metrics.py (reference libs/vl_scores.py and the
sklearn calls at engine_grid_masking.py:465-474): token and argmax
accuracy on tensors, PSNR, and accuracy with macro / micro / weighted F1 in
numpy, with no sklearn.

A reference quirk is kept: PSNR takes a peak of 255 although the images lie
in [0, 1] (libs/vl_scores.py:57-63), so reported ``t2i_psnr`` values compare
with the reference's logs.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def mlm_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                 ignore_index: int = -1) -> torch.Tensor:
    """Token accuracy over the positions not ``ignore_index``
    (libs/vl_scores.py:5-33); 0 where there is none."""
    valid = labels != ignore_index
    correct = ((logits.argmax(-1) == labels) & valid).sum()
    total = valid.sum()
    return torch.where(total > 0, correct / total.clamp(min=1), torch.zeros((), device=total.device))


def argmax_accuracy_count(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Rows whose argmax is their label (libs/vl_scores.py:36-50); logits
    [N, C], labels [N]."""
    return (logits.argmax(-1) == labels).sum()


def psnr_from_mse(mse: float, pixel_max: float = 255.0) -> float:
    """PSNR of a mean squared error, 100 for a perfect match."""
    if mse == 0:
        return 100.0
    return 20 * math.log10(pixel_max / math.sqrt(mse))


def psnr(pred: torch.Tensor, target: torch.Tensor, pixel_max: float = 255.0) -> float:
    """PSNR with the reference's peak of 255 (libs/vl_scores.py:53-63)."""
    pred, target = torch.as_tensor(pred), torch.as_tensor(target)
    return psnr_from_mse(float((pred.float() - target.float()).square().mean()), pixel_max)


def _confusion_counts(labels: np.ndarray, preds: np.ndarray,
                      num_classes: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(true positives, predicted count, true count) per class."""
    labels = np.asarray(labels).reshape(-1)
    preds = np.asarray(preds).reshape(-1)
    tp = np.bincount(labels[labels == preds], minlength=num_classes)[:num_classes]
    pred_count = np.bincount(preds, minlength=num_classes)[:num_classes]
    true_count = np.bincount(labels, minlength=num_classes)[:num_classes]
    return tp.astype(np.float64), pred_count.astype(np.float64), true_count.astype(np.float64)


def f1_scores(labels: np.ndarray, preds: np.ndarray, num_classes: int) -> dict:
    """Macro, micro and weighted F1 with sklearn's semantics: macro and
    weighted average over the classes present in the labels or the
    predictions; a 0/0 precision, recall or F1 is 0."""
    tp, pc, tc = _confusion_counts(labels, preds, num_classes)
    present = (pc + tc) > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pc > 0, tp / np.maximum(pc, 1), 0.0)
        recall = np.where(tc > 0, tp / np.maximum(tc, 1), 0.0)
        f1 = np.where(precision + recall > 0,
                      2 * precision * recall / np.maximum(precision + recall, 1e-300), 0.0)
    macro = float(f1[present].mean()) if present.any() else 0.0
    support = tc[present]
    weighted = float((f1[present] * support).sum() / support.sum()) if support.sum() else 0.0
    micro_tp, micro_pc, micro_tc = tp.sum(), pc.sum(), tc.sum()
    micro_p = micro_tp / micro_pc if micro_pc else 0.0
    micro_r = micro_tp / micro_tc if micro_tc else 0.0
    micro = 2 * micro_p * micro_r / (micro_p + micro_r) if micro_p + micro_r else 0.0
    return {"macro_f1": macro, "micro_f1": float(micro), "weighted_f1": weighted}


def cls_metrics(labels: np.ndarray, preds: np.ndarray,
                num_classes: int) -> Tuple[float, float, float, float]:
    """(accuracy, macro F1, micro F1, weighted F1), the tuple of the
    reference's calculate_cls_metrics (engine_grid_masking.py:465-474)."""
    labels = np.asarray(labels).reshape(-1)
    preds = np.asarray(preds).reshape(-1)
    acc = float((labels == preds).mean()) if labels.size else 0.0
    f1 = f1_scores(labels, preds, num_classes)
    return acc, f1["macro_f1"], f1["micro_f1"], f1["weighted_f1"]
