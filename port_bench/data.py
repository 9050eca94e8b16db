"""Inputs made from the seed: captions and retrieval bundles.

Text follows bert-base-uncased's id layout: [PAD] 0, [CLS] 101, [SEP] 102,
and the word pieces at ids 999-30521 (the entries before are special or
unused). A caption is [CLS], a number of word pieces drawn from the mix's
range, [SEP], then [PAD] to the text length.

Everything is a function of the seed alone; the same seed gives the same
arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

PAD, CLS, SEP = 0, 101, 102


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng((seed, *stream))


def captions(g: np.random.Generator, rows: int, tokens: int, pieces: tuple,
             piece_ids: tuple) -> np.ndarray:
    """int32 [rows, tokens] clean ids: [CLS] pieces [SEP] [PAD]..."""
    lo, hi = pieces
    lengths = g.integers(lo, min(hi, tokens - 2) + 1, rows)
    body = g.integers(piece_ids[0], piece_ids[1], (rows, tokens), dtype=np.int64).astype(np.int32)
    pos = np.arange(tokens)[None, :]
    ids = np.where(pos <= lengths[:, None], body, PAD).astype(np.int32)
    ids[:, 0] = CLS
    ids[np.arange(rows), lengths + 1] = SEP
    return ids


def retrieval_pool(seed: int, mix: dict, device) -> Dict[str, np.ndarray]:
    """``mix['pool_items']`` loader items of ``queries_per_call`` bundles of
    ``candidates`` pairs: uint8 images_101 [items, Q, C, S, S, 3] (drawn on
    ``device`` one item at a time, then held on the host) and int64
    ori_input_ids_101 [items, Q, C, T]."""
    items, q, c = mix["pool_items"], mix["queries_per_call"], mix["candidates"]
    s, t = mix["image_size"], mix["text_tokens"]
    gen = torch.Generator(device=device).manual_seed(seed)
    images = np.empty((items, q, c, s, s, 3), np.uint8)
    for i in range(items):
        images[i] = torch.randint(0, 256, (q, c, s, s, 3), generator=gen, device=device,
                                  dtype=torch.uint8).cpu().numpy()
    ids = captions(rng(seed, 1), items * q * c, t, tuple(mix["caption_pieces"]),
                   tuple(mix["piece_ids"]))
    return {"images_101": images, "ori_input_ids_101": ids.astype(np.int64).reshape(items, q, c, t)}
