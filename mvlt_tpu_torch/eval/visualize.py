"""Qualitative samples: the original image, the masked input and the T2I
reconstruction as PNGs, and the MLM and ITM predictions as text.

Counterpart of mvlt_tpu/eval/visualize.py (the reference's ``visual_vl``,
engine_grid_masking.py:477-685, which reads keys the pipeline no longer
produces; this one reads the live forward's): for each validation sample,
``original.png``, ``masked.png``, ``reconstruction.png`` when the T2I head
is on, and ``predictions.txt`` with the MLM top-1 token at every masked
position and the ITM verdict. PIL is imported at first use.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable

import numpy as np
import torch


def _save_png(img, path: str) -> None:
    """float [H, W, 3] in [0, 1] -> an 8-bit PNG."""
    from PIL import Image

    arr = np.clip(np.asarray(img), 0.0, 1.0)
    Image.fromarray((arr * 255).astype(np.uint8)).save(path)


def visualize_vl(eval_step: Callable, loader: Iterable, tokenizer, out_dir: str,
                 max_samples: int = 32) -> int:
    """Write up to ``max_samples`` samples under ``out_dir``; returns how
    many. ``eval_step(images, ids)`` is the model's eval forward (a dict of
    logits, None for a head that is off)."""
    os.makedirs(out_dir, exist_ok=True)
    written = 0
    for batch in loader:
        images = np.asarray(batch["images"])
        masked = np.asarray(batch["masked_images"])
        out_recon = eval_step(masked, batch["ori_input_ids"])
        out_mlm = eval_step(images, batch["input_ids"])
        host = lambda t: None if t is None else torch.as_tensor(t).float().cpu().numpy()
        recon, mlm, itm = (host(out_recon.get("t2i_logits")), host(out_mlm.get("mlm_logits")),
                           host(out_mlm.get("itm_logits")))
        for i in range(images.shape[0]):
            if written >= max_samples:
                return written
            sample_dir = os.path.join(out_dir, f"sample_{written:04d}")
            os.makedirs(sample_dir, exist_ok=True)
            _save_png(images[i], os.path.join(sample_dir, "original.png"))
            _save_png(masked[i], os.path.join(sample_dir, "masked.png"))
            if recon is not None:
                _save_png(recon[i], os.path.join(sample_dir, "reconstruction.png"))
            lines = []
            if mlm is not None:
                labels = np.asarray(batch["mlm_labels"][i])
                preds = mlm[i].argmax(-1)
                for p in np.nonzero(labels != -1)[0]:
                    want = tokenizer.convert_ids_to_tokens([int(labels[p])])[0]
                    got = tokenizer.convert_ids_to_tokens([int(preds[p])])[0]
                    mark = "OK " if want == got else "BAD"
                    lines.append(f"[{mark}] pos {p:3d}: label={want!r} pred={got!r}")
            if itm is not None:
                logits = itm[i].reshape(-1)
                prob = float(np.exp(logits[1]) / np.exp(logits).sum())
                label = int(np.asarray(batch["itm_labels"][i]).reshape(()))
                lines.append(f"ITM: p(match)={prob:.4f} label={label}")
            with open(os.path.join(sample_dir, "predictions.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
            written += 1
    return written
