"""Zero-shot ITR/TIR retrieval evaluation.

Counterpart of mvlt_tpu/eval/retrieval.py (protocol engine_grid_masking.py:
336-393): each query is a bundle of 101 image-text pairs, index 0 the ground
truth; every pair is scored with the ITM head's positive-class softmax
probability, candidates are ranked by a stable descending sort, and
acc@1/5/10 are reported over the reference's fixed denominator of 1000
queries, with the true-count accuracies beside them. Across data-parallel
ranks (``shard=``, the JAX package's ``mesh=``) each rank scores its
contiguous shard of the bundles; the ranks of the ground truth are gathered
into zero-filled buffers that all_reduce sums, the padded slots dropped.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from mvlt_tpu_torch.parallel.sharding import EvalShard, gather_slots
from mvlt_tpu_torch.utils.profiling import annotate

FIXED_DENOM = 1000  # reference protocol constant (engine_grid_masking.py:393)


def uint8_to_unit(images: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 / 255 on the images' device, bit-equal to the host's
    ``np.float32(u) / np.float32(255)``. The divisor is a tensor on that
    device, not a Python scalar: PyTorch turns division by a CPU scalar into
    a multiply by its reciprocal, which is not the correctly rounded quotient."""
    return images.to(torch.float32) / torch.tensor(255.0, device=images.device)


@torch.no_grad()
def _score(model, device, images, input_ids) -> torch.Tensor:
    with annotate("mvlt.retrieval.h2d"):
        images = torch.as_tensor(images, device=device)
        if images.dtype == torch.uint8:
            images = uint8_to_unit(images)
        input_ids = torch.as_tensor(input_ids, device=device)
    with annotate("mvlt.retrieval.forward"):
        out = model(images, input_ids)
        logits = out["itm_logits"].reshape(-1, 2).float()
        return torch.softmax(logits, dim=-1)[:, 1]


def make_itm_scorer(model) -> Callable:
    """[N, ...] pair scorer -> positive-class softmax probability [N], on the
    model's device. uint8 NHWC images are divided by 255 there."""
    device = next(model.parameters()).device
    return lambda images, input_ids: _score(model, device, images, input_ids)


def rank_of_ground_truth(scores: np.ndarray) -> int:
    """Rank (0-based) of candidate 0 when sorted by score descending, ties
    broken by original order (torch.sort(descending=True) semantics)."""
    order = np.argsort(-scores, kind="stable")
    return int(np.nonzero(order == 0)[0][0])


def evaluate_retrieval(scorer: Callable, loader: Iterable, log_every: int = 50,
                       is_main: bool = True,
                       shard: Optional[EvalShard] = None) -> Dict[str, float]:
    """Run the retrieval protocol. ``loader`` yields dicts with images_101
    [Q?, 101, H, W, 3] (uint8 or float) and ori_input_ids_101 [Q?, 101, T].
    With ``shard`` the loader yields this rank's slots of the bundles
    (``shard.indices()``), and the results are those of every rank's real
    slots together, the same on every rank."""
    ranks = []
    batches = iter(loader)
    while True:
        # one loader item's work; the last call finds the loader at its end
        with annotate("mvlt.retrieval.call"):
            with annotate("mvlt.retrieval.fetch"):
                batch = next(batches, None)
            if batch is None:
                break
            with annotate("mvlt.retrieval.stage"):
                imgs = np.asarray(batch["images_101"])
                ids = np.asarray(batch["ori_input_ids_101"])
                if imgs.ndim == 4:  # single bundle
                    imgs, ids = imgs[None], ids[None]
                q, c = imgs.shape[0], imgs.shape[1]
                flat_imgs = imgs.reshape((q * c,) + imgs.shape[2:])
                if flat_imgs.dtype != np.uint8:
                    flat_imgs = flat_imgs.astype(np.float32)
                flat_ids = ids.reshape(q * c, -1).astype(np.int64)
            with annotate("mvlt.retrieval.score"):
                scores = scorer(flat_imgs, flat_ids)
            with annotate("mvlt.retrieval.readback"):
                scores = torch.as_tensor(scores).float().cpu().numpy().reshape(q, c)
            with annotate("mvlt.retrieval.rank"):
                ranks.extend(rank_of_ground_truth(scores[qi]) for qi in range(q))
                if is_main and len(ranks) % log_every < q:
                    hits = {k: sum(r < k for r in ranks) for k in (1, 5, 10)}
                    print(f"retrieval [{len(ranks)}] "
                          f"acc@1={hits[1]/FIXED_DENOM:.3f} "
                          f"acc@5={hits[5]/FIXED_DENOM:.3f} "
                          f"acc@10={hits[10]/FIXED_DENOM:.3f}", flush=True)
    if shard is not None:
        ranks = gather_slots(torch.tensor(ranks, dtype=torch.float64)[:, None],
                             shard)[:, 0].long().tolist()
    counts = {k: sum(r < k for r in ranks) for k in (1, 5, 10)}
    n_queries = len(ranks)
    results = {f"acc@{k}": counts[k] / FIXED_DENOM for k in counts}
    results.update({f"acc@{k}_true": counts[k] / max(n_queries, 1) for k in counts})
    results["num_queries"] = n_queries
    return results
