"""BERT text embeddings: word + position + token type, LayerNorm, dropout.

Counterpart of mvlt_tpu/models/bert_embeddings.py (HF ``BertEmbeddings`` as
the reference builds it). Position ids are arange(T) and the token type is
always 0, so the type embedding is one row broadcast over [B, T], not a
gather. LayerNorm eps is 1e-12; dropout (0.1) acts in training only, with
its mask drawn from the generator the caller passes. Under tensor
parallelism (a ``vocab_group`` passed in) the word embedding holds this
rank's rows of the vocabulary and the lookup is vocabulary-parallel.
"""

from __future__ import annotations

import torch
from torch import nn

from mvlt_tpu_torch.parallel.sequence import take
from mvlt_tpu_torch.parallel.tensor import vocab_parallel_embedding


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            split: tuple | None = None, rows: tuple | None = None) -> torch.Tensor:
    """Inverted dropout with the mask from ``generator``: kept elements are
    scaled by 1 / (1 - rate), as flax's Dropout does. ``split`` = (dim,
    rank, tp): ``x`` is slice ``rank`` of ``tp`` equal slices along ``dim``
    of the tensor one process drops (tensor parallelism); ``rows`` = (dim,
    plan): ``x`` holds a sequence-parallel rank's rows along ``dim``
    (parallel/sequence.py:RowPlan, its band's grid rows then its text
    rows). Either way the whole mask is drawn, as one process draws it, and
    this rank's part of it kept, since a generator's draws depend on the
    element count."""
    keep = 1.0 - rate
    shape = list(x.shape)
    if rows is not None:
        dim, plan = rows
        shape[dim] = plan.h * plan.w + plan.t
    if split is not None:
        dim, rank, tp = split
        shape[dim] *= tp
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if split is not None:
        mask = mask.narrow(dim, rank * x.shape[dim], x.shape[dim])
    if rows is not None:
        mask = take(mask, plan, plan.hb * plan.w, dim)
    return torch.where(mask, x / keep, torch.zeros_like(x))


class BertEmbeddings(nn.Module):
    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768,
                 max_position_embeddings: int = 512, type_vocab_size: int = 2,
                 ln_eps: float = 1e-12, dropout_rate: float = 0.1):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab_size, hidden_size)
        self.position_embeddings = nn.Embedding(max_position_embeddings, hidden_size)
        self.token_type_embeddings = nn.Embedding(type_vocab_size, hidden_size)
        self.LayerNorm = nn.LayerNorm(hidden_size, eps=ln_eps)
        self.dropout_rate = dropout_rate

    def forward(self, input_ids: torch.Tensor,
                generator: torch.Generator | None = None, vocab_group=None) -> torch.Tensor:
        """input_ids [B, T] -> fp32 [B, T, hidden]."""
        t = input_ids.shape[-1]
        words = (self.word_embeddings(input_ids) if vocab_group is None else
                 vocab_parallel_embedding(input_ids, self.word_embeddings.weight, vocab_group))
        x = (words
             + self.position_embeddings.weight[:t]
             + self.token_type_embeddings.weight[0])
        x = self.LayerNorm(x)
        if self.training and self.dropout_rate:
            x = dropout(x, self.dropout_rate, generator)
        return x
