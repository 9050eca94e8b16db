"""Fashion-Gen datasets: the on-disk readers (pre-training, retrieval,
recognition), the synthetic pre-training set, the dataset factory, batching,
and the move to the device.

The readers are the port's copies of mvlt_tpu/data/fashion_gen.py and read
the reference's layout (mcloader/fashion_gen.py):

  <root>/extracted_{train,valid}_images/   one image file per pair
  <root>/full_{train,valid}_info_PAI/      one pickled dict per pair (keys
        product_id, img_name, super_cls_id, sub_cls_id, captions, ...)
  <root>/retrieve_ITR/, retrieve_TIR/      pickled 101-candidate bundles
        (candidate 0 the ground truth)
  <root>/generated_valid_masking{ratio:.2f}_size{sz}_images/ (or
        generated_valid_noise_images/)   pickled masks for the valid split

Every item is a deterministic function of (seed, epoch, index). A missing
directory raises, as ``os.listdir`` does; no reader falls back to synthetic
data. As in the JAX package, the train split's images go through the native
host library's crop-resize (data/native.py) when ``use_native_image_ops``
is set (the default; within 1.5/255 of PIL, equal to the JAX reader's in
bits), and through PIL otherwise; the valid split and the eval readers
always take PIL (``image_ops``). Text goes through the native C++ tokenizer
(``make_tokenizer``), the retrieval bundle's 101 captions in one
``encode_batch`` call. Where the native library does not build, the readers
raise.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from mvlt_tpu_torch.config import DataConfig
from mvlt_tpu_torch.data.image_ops import decode_rgb, load_image, load_image_u8
from mvlt_tpu_torch.data.masks import (apply_mask, generate_grid_mask, generate_square_mask,
                                       generate_stroke_mask)
from mvlt_tpu_torch.data.native import native_crop_resize
from mvlt_tpu_torch.data.pipeline import collate
from mvlt_tpu_torch.data.text_masking import process_caption
from mvlt_tpu_torch.data.tokenizer import make_tokenizer


def _listdir_sorted(d: str) -> List[str]:
    return sorted(os.path.join(d, f) for f in os.listdir(d))


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


class FashionGenPretrain:
    """Map-style pre-training dataset (train or valid split)."""

    def __init__(self, root: str, split: str, cfg: DataConfig,
                 itm_enabled: bool = True, seed: int = 0):
        if split not in ("train", "valid"):
            raise ValueError(f"unknown split {split!r}")
        self.cfg = cfg
        self.split = split
        self.itm_enabled = itm_enabled
        self.seed = seed
        self.epoch = 0
        self.tokenizer = make_tokenizer(cfg.vocab_file)
        self.images = _listdir_sorted(os.path.join(root, f"extracted_{split}_images"))
        self.text_dicts = _listdir_sorted(os.path.join(root, f"full_{split}_info_PAI"))
        if len(self.images) != len(self.text_dicts):
            raise ValueError(
                f"image/text count mismatch: {len(self.images)} vs {len(self.text_dicts)}")
        self.size = len(self.images)

        # the valid split's stored masks make its eval reproducible
        # (mcloader/fashion_gen.py:170-174)
        self.mask_files: Optional[List[str]] = None
        if split == "valid":
            if cfg.mask_strategy == "random_grid":
                mask_root = os.path.join(root, f"generated_valid_masking{cfg.mask_ratio:.2f}"
                                               f"_size{cfg.mask_patch_size}_images")
            else:
                mask_root = os.path.join(root, "generated_valid_noise_images")
            if os.path.isdir(mask_root):
                self.mask_files = _listdir_sorted(mask_root)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _make_mask(self, rng: np.random.Generator, index: int) -> np.ndarray:
        cfg = self.cfg
        if self.mask_files is not None:
            m = np.asarray(_load_pickle(self.mask_files[index]), np.float32)
            return m[0] if m.ndim == 3 else m   # the reference pickles CHW
        if cfg.mask_strategy == "random_grid":
            return generate_grid_mask(cfg.input_size, cfg.mask_ratio, patch_size=16, rng=rng)
        if cfg.mask_strategy == "square":
            return generate_square_mask(cfg.input_size, int(cfg.input_size // cfg.mask_ratio),
                                        rng=rng)
        if cfg.mask_strategy == "stroke":
            return generate_stroke_mask(cfg.input_size, rng=rng)
        raise ValueError(f"invalid mask_strategy {cfg.mask_strategy!r}")

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((self.seed, self.epoch, index))
        if self.itm_enabled and rng.random() <= 0.5:
            # a negative: the text of the item index + offset, the offset in
            # [50, size / 2) (mcloader/fashion_gen.py:134), clamped so that
            # a set of fewer than ~100 items still has low < high
            lo = min(50, max(1, self.size - 2))
            hi = max(self.size // 2, lo + 1)
            text_idx = (index + int(rng.integers(lo, hi))) % self.size
            itm_label = 0
        else:
            text_idx, itm_label = index, 1
        text_dict = _load_pickle(self.text_dicts[text_idx])
        if self.split == "train" and cfg.use_native_image_ops:
            image = native_crop_resize(decode_rgb(self.images[index]), cfg.input_size, crop=True)
        else:
            image = load_image(self.images[index], cfg.input_size)
        img_mask = self._make_mask(rng, index)
        text = process_caption(text_dict["captions"], self.tokenizer, cfg.num_text_tokens,
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
            "sup_cls_labels": np.int32(text_dict["super_cls_id"]),
            "sub_cls_labels": np.int32(text_dict["sub_cls_id"]),
        }


class FashionGenRetrieval:
    """Zero-shot retrieval: each item is one pickled 101-candidate bundle,
    candidate 0 the ground truth (mcloader/fashion_gen.py:436-511), as uint8
    images and clean text ids."""

    def __init__(self, root: str, cfg: DataConfig, direction: str):
        if direction not in ("itr", "tir"):
            raise ValueError("direction must be 'itr' or 'tir'")
        self.cfg = cfg
        self.tokenizer = make_tokenizer(cfg.vocab_file)
        self.image_root = os.path.join(root, "extracted_valid_images")
        self.bundles = _listdir_sorted(os.path.join(root, f"retrieve_{direction.upper()}"))
        self.size = len(self.bundles)

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        images, captions, info = [], [], []
        for cand in _load_pickle(self.bundles[index]).values():
            images.append(load_image_u8(os.path.join(self.image_root, cand["img_name"]),
                                        cfg.input_size))
            captions.append(cand["captions"])
            info.append({"img_name": cand["img_name"], "prod_caption": cand["captions"]})
        return {
            "images_101": np.stack(images),
            # clean ids: encode == process_caption's ori_input_ids at rate 0
            "ori_input_ids_101": self.tokenizer.encode_batch(captions, cfg.num_text_tokens),
            "info_list": info,
        }


class FashionGenRecognition:
    """Recognition eval over the whole valid split with clean text ids
    (mcloader/fashion_gen.py:630-799): uint8 images, labels and names."""

    def __init__(self, root: str, cfg: DataConfig):
        self.cfg = cfg
        self.tokenizer = make_tokenizer(cfg.vocab_file)
        self.images = _listdir_sorted(os.path.join(root, "extracted_valid_images"))
        self.text_dicts = _listdir_sorted(os.path.join(root, "full_valid_info_PAI"))
        if len(self.images) != len(self.text_dicts):
            raise ValueError("image/text count mismatch")
        self.size = len(self.images)

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        text_dict = _load_pickle(self.text_dicts[index])
        text = process_caption(text_dict["captions"], self.tokenizer, cfg.num_text_tokens,
                               word_mask_rate=0.0, rng=np.random.default_rng(index))
        return {
            "images": load_image_u8(self.images[index], cfg.input_size),
            "ori_input_ids": text["ori_input_ids"],
            "sup_cls_labels": np.int32(text_dict["super_cls_id"]),
            "sub_cls_labels": np.int32(text_dict["sub_cls_id"]),
            "info_list": text_dict["img_name"],
        }

    def names(self) -> list:
        """Every item's name, in order (a sharded run's artifact)."""
        return [_load_pickle(p)["img_name"] for p in self.text_dicts]


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


def build_dataset(split: str, cfg: DataConfig, itm_enabled: bool = True, seed: int = 0,
                  synthetic_size: int = 64):
    """Dataset factory (mvlt_tpu/data/fashion_gen.py:build_dataset): the
    synthetic set of ``synthetic_size`` items for ``cfg.synthetic`` or an
    empty ``data_path``, else the ``split`` of the tree at ``data_path``."""
    if cfg.synthetic or not cfg.data_path:
        return SyntheticFashionGen(cfg, size=synthetic_size, itm_enabled=itm_enabled, seed=seed)
    return FashionGenPretrain(cfg.data_path, split, cfg, itm_enabled=itm_enabled, seed=seed)


def batches(dataset, batch_size: int, drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Sequential batches of ``dataset`` through ``collate``."""
    stop = len(dataset) - (len(dataset) % batch_size if drop_last else 0)
    for start in range(0, stop, batch_size):
        yield collate([dataset[i] for i in range(start, min(start + batch_size, stop))])


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``device`` (no copy
    for a tensor already there)."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
