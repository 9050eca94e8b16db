"""The synthetic Fashion-Gen pre-training set, the dataset factory, batching,
and the move to the device.

``SyntheticFashionGen`` is the port's copy of
mvlt_tpu/data/fashion_gen.py:SyntheticFashionGen: items with the exact
pre-training schema, each a deterministic function of (seed, epoch, index),
captions tokenised with the shipped vocab. ``build_dataset`` returns it; the
readers of the on-disk Fashion-Gen tree (pre-training, retrieval,
recognition) are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from mvlt_tpu_torch.config import DataConfig
from mvlt_tpu_torch.data.masks import apply_mask, generate_grid_mask
from mvlt_tpu_torch.data.pipeline import collate
from mvlt_tpu_torch.data.text_masking import process_caption
from mvlt_tpu_torch.data.tokenizer import make_tokenizer


class SyntheticFashionGen:
    """In-memory dataset with the pre-training item schema."""

    CAPTIONS = [
        "long sleeve shirt in midnight blue stretch cotton",
        "wool blend twill coat with double breasted button closure",
        "leather ankle boots with stacked heel and almond toe",
        "ribbed knit beanie in heathered merino wool",
        "relaxed fit denim jeans with distressed detailing",
    ]

    def __init__(self, cfg: DataConfig, size: int = 64, itm_enabled: bool = True,
                 seed: int = 0, num_super: int = 48, num_sub: int = 122):
        self.cfg = cfg
        self.size = size
        self.itm_enabled = itm_enabled
        self.seed = seed
        self.epoch = 0
        self.num_super = num_super
        self.num_sub = num_sub
        self.tokenizer = make_tokenizer(cfg.vocab_file)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((self.seed, self.epoch, index))
        image = rng.random((cfg.input_size, cfg.input_size, 3), np.float32)
        if self.itm_enabled and rng.random() <= 0.5:
            text_idx, itm_label = int(rng.integers(0, len(self.CAPTIONS))), 0
        else:
            text_idx, itm_label = index % len(self.CAPTIONS), 1
        caption = self.CAPTIONS[text_idx % len(self.CAPTIONS)]
        img_mask = generate_grid_mask(cfg.input_size, cfg.mask_ratio, 16, rng)
        text = process_caption(caption, self.tokenizer, cfg.num_text_tokens,
                               cfg.word_mask_rate, rng)
        return {
            "images": image,
            "masked_images": apply_mask(image, img_mask),
            "t2i_labels": img_mask,
            "input_ids": text["input_ids"],
            "ori_input_ids": text["ori_input_ids"],
            "attention_mask": text["attention_mask"],
            "segment_ids": text["segment_ids"],
            "mlm_labels": text["mlm_labels"],
            "itm_labels": np.int32(itm_label),
            "sup_cls_labels": np.int32(rng.integers(0, self.num_super)),
            "sub_cls_labels": np.int32(rng.integers(0, self.num_sub)),
        }


def build_dataset(split: str, cfg: DataConfig, itm_enabled: bool = True, seed: int = 0):
    """Dataset factory (mvlt_tpu/data/fashion_gen.py:build_dataset): the
    synthetic set for ``cfg.synthetic`` or an empty ``data_path``; the
    on-disk readers raise."""
    if cfg.synthetic or not cfg.data_path:
        return SyntheticFashionGen(cfg, itm_enabled=itm_enabled, seed=seed)
    raise NotImplementedError(
        f"the on-disk Fashion-Gen readers (FashionGenPretrain, {split} split of "
        f"{cfg.data_path!r}) are not ported yet: use synthetic data")


def batches(dataset, batch_size: int, drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Sequential batches of ``dataset`` through ``collate``."""
    stop = len(dataset) - (len(dataset) % batch_size if drop_last else 0)
    for start in range(0, stop, batch_size):
        yield collate([dataset[i] for i in range(start, min(start + batch_size, stop))])


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``device`` (no copy
    for a tensor already there)."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
