"""Per-process index sampling for the input pipeline.

The port's copy of mvlt_tpu/data/samplers.py (reference samplers.py:8-59,
main_vl.py:219-242), numpy only; tests/test_torch_port_pipeline.py pins the
index streams to the originals:

  * ``RepeatedAugmentSampler`` -- RASampler semantics: a seeded per-epoch
    shuffle where each index appears ``num_repeats`` (3) times in
    consecutive shuffle slots, sharded round-robin across processes,
    truncated to ``floor(len/256) * 256 / world`` selected samples per
    process;
  * ``DistributedSampler`` -- plain seeded shuffle, padded to a multiple of
    the world size, round-robin sharded (torch DistributedSampler
    semantics, the non-RA path at main_vl.py:231-236);
  * ``SequentialSampler`` -- deterministic order for eval.
"""

from __future__ import annotations

import math
from typing import Iterator, List

import numpy as np


class RepeatedAugmentSampler:
    def __init__(self, dataset_len: int, rank: int, world_size: int,
                 num_repeats: int = 3, seed: int = 0):
        self.dataset_len = dataset_len
        self.rank = rank
        self.world_size = world_size
        self.num_repeats = num_repeats
        self.seed = seed
        self.epoch = 0
        self.num_samples = int(math.ceil(dataset_len * num_repeats / world_size))
        self.total_size = self.num_samples * world_size
        # reference truncation rule (samplers.py:28): floor(len/256)*256/world;
        # degenerates to 0 for datasets under 256 items (tests/debug subsets),
        # so clamp to the full repeated shard there.
        self.num_selected = int(math.floor(dataset_len // 256 * 256 / world_size))
        if self.num_selected == 0:
            self.num_selected = self.num_samples

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.num_selected

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng((self.seed, self.epoch))
        order = rng.permutation(self.dataset_len)
        indices: List[int] = [int(i) for i in order for _ in range(self.num_repeats)]
        indices += indices[: self.total_size - len(indices)]
        shard = indices[self.rank: self.total_size: self.world_size]
        return iter(shard[: self.num_selected])


class DistributedSampler:
    def __init__(self, dataset_len: int, rank: int, world_size: int,
                 shuffle: bool = True, seed: int = 0):
        self.dataset_len = dataset_len
        self.rank = rank
        self.world_size = world_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.num_samples = int(math.ceil(dataset_len / world_size))
        self.total_size = self.num_samples * world_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.num_samples

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            indices = [int(i) for i in rng.permutation(self.dataset_len)]
        else:
            indices = list(range(self.dataset_len))
        indices += indices[: self.total_size - len(indices)]
        return iter(indices[self.rank: self.total_size: self.world_size])


class SequentialSampler:
    def __init__(self, dataset_len: int):
        self.dataset_len = dataset_len

    def set_epoch(self, epoch: int) -> None:
        pass

    def __len__(self) -> int:
        return self.dataset_len

    def __iter__(self) -> Iterator[int]:
        return iter(range(self.dataset_len))
