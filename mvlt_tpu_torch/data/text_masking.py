"""BERT-style 80/10/10 text masking.

Counterpart of mvlt_tpu/data/text_masking.py (reference
random_masking_features, mcloader/fashion_gen.py:383-409): each token is
selected with probability word_mask_rate; a selected token becomes [MASK]
with p 0.8, a uniformly random vocab id with p 0.1, or stays, with p 0.1,
and its id becomes the MLM label; other positions get label -1. Output
[CLS] + tokens + [SEP] + [PAD]*, labels -1 at CLS, SEP and PAD.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from mvlt_tpu_torch.data.tokenizer import WordPieceTokenizer

IGNORE = -1


def mask_tokens(token_ids: Sequence[int], vocab_size: int, mask_id: int,
                word_mask_rate: float, rng: np.random.Generator) -> Tuple[List[int], List[int]]:
    """80/10/10 masking over a bare (no CLS/SEP) token-id list."""
    out_ids: List[int] = []
    labels: List[int] = []
    for tid in token_ids:
        p = rng.random()
        if p < word_mask_rate:
            q = p / word_mask_rate
            if q < 0.8:
                out_ids.append(mask_id)
            elif q < 0.9:
                out_ids.append(int(rng.integers(0, vocab_size)))
            else:
                out_ids.append(tid)
            labels.append(tid)
        else:
            out_ids.append(tid)
            labels.append(IGNORE)
    return out_ids, labels


def process_caption(caption: str, tokenizer: WordPieceTokenizer, max_len: int,
                    word_mask_rate: float, rng: np.random.Generator) -> dict:
    """Tokenize, truncate, mask and pad one caption: int32 input_ids
    (masked), ori_input_ids (clean), attention_mask, segment_ids (zeros) and
    mlm_labels."""
    ids = tokenizer.tokenize_to_ids(caption)[: max_len - 2]
    masked_ids, labels = mask_tokens(ids, len(tokenizer), tokenizer.mask_id,
                                     word_mask_rate, rng)

    def wrap(core: List[int], fill: int) -> np.ndarray:
        seq = [tokenizer.cls_id] + core + [tokenizer.sep_id]
        return np.asarray(seq + [fill] * (max_len - len(seq)), np.int32)

    mlm_labels = np.full(max_len, IGNORE, np.int32)
    mlm_labels[1: 1 + len(labels)] = labels
    attention_mask = np.zeros(max_len, np.int32)
    attention_mask[:len(ids) + 2] = 1
    return {
        "input_ids": wrap(masked_ids, tokenizer.pad_id),
        "ori_input_ids": wrap(ids, tokenizer.pad_id),
        "attention_mask": attention_mask,
        "segment_ids": np.zeros(max_len, np.int32),
        "mlm_labels": mlm_labels,
    }
