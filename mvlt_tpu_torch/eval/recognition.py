"""M-CR / S-CR recognition evaluation.

Counterpart of mvlt_tpu/eval/recognition.py (protocol
engine_grid_masking.py:396-474): the whole valid split goes through the
model with clean text ids, the 48-way (super) and 122-way (sub) heads are
argmaxed, and accuracy with macro / micro / weighted F1 is reported per
head, beside a JSON artifact of the predictions (the reference writes text
files under ./visulization/<hdr>/). The last batch keeps its ragged size.
Across data-parallel ranks (``shard=``, the JAX package's ``mesh=``) each
rank scores its contiguous shard of the items; predictions and labels are
gathered into zero-filled buffers that all_reduce sums, the padded slots
dropped, and rank 0 writes the artifact (the names from the dataset).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from mvlt_tpu_torch.eval.metrics import cls_metrics
from mvlt_tpu_torch.eval.retrieval import uint8_to_unit
from mvlt_tpu_torch.parallel.sharding import EvalShard, gather_slots


@torch.no_grad()
def cls_logits(model, device, images, input_ids) -> Tuple[torch.Tensor, torch.Tensor]:
    """(super, sub) logits [B, classes] in fp32 of a batch of images
    (uint8 NHWC divided by 255 on ``device``, or float) and clean ids."""
    images = torch.as_tensor(images, device=device)
    if images.dtype == torch.uint8:
        images = uint8_to_unit(images)
    out = model(images, torch.as_tensor(input_ids, device=device).long())
    b = images.shape[0]
    return (out["sup_cls_logits"].reshape(b, -1).float(),
            out["sub_cls_logits"].reshape(b, -1).float())


def make_cls_scorer(model) -> Callable:
    """Batch scorer -> (super, sub) argmax predictions [B] on the model's
    device."""
    device = next(model.parameters()).device

    def score(images, input_ids):
        sup, sub = cls_logits(model, device, images, input_ids)
        return sup.argmax(-1), sub.argmax(-1)

    return score


def evaluate_recognition(scorer: Callable, loader: Iterable, num_super: int = 48,
                         num_sub: int = 122, artifact_dir: Optional[str] = None,
                         is_main: bool = True, shard: Optional[EvalShard] = None,
                         names: Optional[list] = None) -> Dict[str, float]:
    """Run the recognition protocol over ``loader``'s batches (images,
    ori_input_ids, sup/sub_cls_labels, optional info_list names); writes
    ``recognition_predictions.json`` into ``artifact_dir`` when given. With
    ``shard`` the loader yields this rank's slots of the items
    (``shard.indices()``), the metrics are those of every rank's real slots
    together, the same on every rank, and the artifact's names are
    ``names`` (every item's, in order) when given."""
    given_names = names
    sup_labels, sup_preds, sub_labels, sub_preds, names = [], [], [], [], []
    for batch in loader:
        imgs = np.asarray(batch["images"])
        if imgs.dtype != np.uint8:   # uint8 ships as it is; the scorer divides
            imgs = imgs.astype(np.float32)
        sup, sub = scorer(imgs, np.asarray(batch["ori_input_ids"]))
        sup_preds.extend(torch.as_tensor(sup).cpu().tolist())
        sub_preds.extend(torch.as_tensor(sub).cpu().tolist())
        sup_labels.extend(np.asarray(batch["sup_cls_labels"]).reshape(-1).tolist())
        sub_labels.extend(np.asarray(batch["sub_cls_labels"]).reshape(-1).tolist())
        if "info_list" in batch:
            names.extend(batch["info_list"])
    if shard is not None:
        every = gather_slots(torch.tensor([sup_labels, sup_preds, sub_labels, sub_preds],
                                          dtype=torch.float64).T.reshape(-1, 4), shard)
        sup_labels, sup_preds, sub_labels, sub_preds = every.long().T.tolist()
        if given_names is not None:
            names = list(given_names)
        elif shard.world > 1:   # this rank's names only: none rather than some
            names = []

    sup_acc, sup_macro, sup_micro, sup_weighted = cls_metrics(sup_labels, sup_preds, num_super)
    sub_acc, sub_macro, sub_micro, sub_weighted = cls_metrics(sub_labels, sub_preds, num_sub)
    results = {
        "sup_accuracy": sup_acc, "sup_macro_f1": sup_macro,
        "sup_micro_f1": sup_micro, "sup_weighted_f1": sup_weighted,
        "sub_accuracy": sub_acc, "sub_macro_f1": sub_macro,
        "sub_micro_f1": sub_micro, "sub_weighted_f1": sub_weighted,
    }
    if artifact_dir and is_main:
        os.makedirs(artifact_dir, exist_ok=True)
        with open(os.path.join(artifact_dir, "recognition_predictions.json"), "w") as f:
            json.dump({"sup_labels": sup_labels, "sup_preds": sup_preds,
                       "sub_labels": sub_labels, "sub_preds": sub_preds,
                       "names": names, "metrics": results}, f)
    if is_main:
        print(f"recognition: sup acc={sup_acc:.7f} macro_f1={sup_macro:.7f} | "
              f"sub acc={sub_acc:.7f} macro_f1={sub_macro:.7f}", flush=True)
    return results
