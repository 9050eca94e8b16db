"""Input pipeline: threaded batch assembly and device prefetch.

Counterpart of mvlt_tpu/data/pipeline.py (the reference's DataLoader with
pin_memory and non_blocking copies, and its CUDA-stream prefetcher,
mcloader/data_prefetcher.py): a pool of decode threads builds the items, a
producer thread collates the batches, drops the keys the step never reads,
moves each batch to the device (``to_device``: pinned host memory,
non_blocking copies) and keeps up to ``prefetch_depth`` of them in a bounded
queue; an error in the producer is raised in the consumer. With
``stack_steps = k`` it groups k consecutive batches into one, every array
stacked on a leading [k] axis, for the step that runs k optimizer steps a
call (train/step.py:make_train_step(scan_steps=k), ``--steps-per-dispatch``).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch


def collate(items) -> Dict[str, Any]:
    """Stack a list of item dicts into batch arrays; non-array values are
    collected into lists (e.g. info_list)."""
    out: Dict[str, Any] = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], (np.ndarray, np.generic, int, float)):
            out[key] = np.stack([np.asarray(v) for v in vals])
        else:
            out[key] = vals
    return out


def stack_group(group) -> Dict[str, Any]:
    """k collated batches as one: arrays stacked on a new leading [k] axis,
    other values (info lists) collected into k-lists."""
    out: Dict[str, Any] = {}
    for key in group[0]:
        vals = [b[key] for b in group]
        out[key] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
    return out


def to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """The batch's arrays as tensors on ``device``: for a CUDA device copied
    from pinned host memory without blocking the host (the copy is ordered
    on the current stream); lists stay on the host."""
    device = torch.device(device)
    out: Dict[str, Any] = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(v)
            out[k] = (t.pin_memory().to(device, non_blocking=True)
                      if device.type == "cuda" else t.to(device))
        else:
            out[k] = v
    return out


class DataLoader:
    """Iterable over device-ready batches.

    Args:
      dataset: map-style dataset (``__len__`` / ``__getitem__``).
      sampler: index sampler with ``set_epoch`` (data/samplers.py).
      batch_size: per-process batch size.
      put_fn: host batch -> device batch (e.g. ``partial(to_device,
        device=...)``); None keeps batches on the host.
      num_workers: decode threads.
      drop_last: drop the trailing partial batch (True for training).
      drop_keys: batch keys removed on the host before put_fn: the
        ``masked_images`` the step remakes on the device with device masks
        (or never reads without T2I), and the ``t2i_labels`` no loss reads.
      stack_steps: k > 1 groups k consecutive batches into one item
        (``stack_group``: [k, B, ...] arrays, k-lists of the rest) that
        put_fn moves to the device at once; a trailing partial group is
        dropped, and the length counts groups.
    """

    def __init__(self, dataset, sampler, batch_size: int,
                 put_fn: Optional[Callable] = None, num_workers: int = 4,
                 prefetch_depth: int = 2, drop_last: bool = True, drop_keys: tuple = (),
                 stack_steps: int = 1):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.put_fn = put_fn
        self.num_workers = max(1, num_workers)
        self.prefetch_depth = max(1, prefetch_depth)
        self.drop_last = drop_last
        self.drop_keys = tuple(drop_keys)
        self.stack_steps = max(1, stack_steps)

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.sampler)
        n = n // self.batch_size if self.drop_last else -(-n // self.batch_size)
        return n // self.stack_steps

    def __iter__(self) -> Iterator[Any]:
        indices = list(self.sampler)
        if self.drop_last:
            indices = indices[: len(indices) // self.batch_size * self.batch_size]

        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch_depth)
        sentinel = object()
        errors = []

        def produce():
            try:
                group = []
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for start in range(0, len(indices), self.batch_size):
                        chunk = indices[start: start + self.batch_size]
                        batch = collate(list(pool.map(self.dataset.__getitem__, chunk)))
                        for key in self.drop_keys:
                            batch.pop(key, None)
                        if self.stack_steps > 1:
                            group.append(batch)
                            if len(group) < self.stack_steps:
                                continue
                            batch, group = stack_group(group), []
                        if self.put_fn is not None:
                            batch = self.put_fn(batch)
                        out_q.put(batch)
            except BaseException as e:  # raised again in the consumer
                errors.append(e)
            finally:
                out_q.put(sentinel)

        threading.Thread(target=produce, daemon=True).start()
        while True:
            item = out_q.get()
            if item is sentinel:
                if errors:
                    raise errors[0]
                return
            yield item
