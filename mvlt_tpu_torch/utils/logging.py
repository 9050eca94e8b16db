"""Metric smoothing and periodic training-loop logging, single process.

Counterpart of mvlt_tpu/utils/logging.py (reference libs/utils.py:18-161):
windowed meters with global averages and periodic iteration lines. The
multi-process meter reduction comes with the port of ``parallel/``.
"""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch


class SmoothedValue:
    """A series with a smoothing window and a global average."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.window: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        value = float(value)
        self.window.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        return float(np.median(self.window)) if self.window else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.window)) if self.window else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.window) if self.window else 0.0

    @property
    def value(self) -> float:
        return self.window[-1] if self.window else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg, global_avg=self.global_avg,
                               max=self.max, value=self.value)


def _device_mem_mb() -> Optional[float]:
    if not torch.cuda.is_available():
        return None
    return torch.cuda.memory_allocated() / (1024.0 * 1024.0)


class MetricLogger:
    def __init__(self, delimiter: str = "  ", is_main: bool = True):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.is_main = is_main

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self) -> str:
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def global_averages(self) -> Dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}

    def log_every(self, iterable: Iterable, print_freq: int, header: str = "") -> Iterator:
        """Yield the items, printing progress every print_freq of them
        (iteration, ETA, meters, step and data time, device memory)."""
        total = len(iterable) if hasattr(iterable, "__len__") else None
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        start = end = time.time()
        for i, obj in enumerate(iterable):
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            end = time.time()
            if self.is_main and (i % print_freq == 0 or (total and i == total - 1)):
                if total:
                    eta = datetime.timedelta(seconds=int(iter_time.global_avg * (total - i)))
                    prefix = f"{header} [{i}/{total}] eta: {eta}"
                else:
                    prefix = f"{header} [{i}]"
                parts = [prefix, str(self), f"time: {iter_time}", f"data: {data_time}"]
                mem = _device_mem_mb()
                if mem is not None:
                    parts.append(f"mem: {mem:.0f}MB")
                print(self.delimiter.join(parts), flush=True)
        if self.is_main:
            elapsed = datetime.timedelta(seconds=int(time.time() - start))
            print(f"{header} done in {elapsed}", flush=True)
