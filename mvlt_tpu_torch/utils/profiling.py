"""Profiling hooks on torch.profiler and torch.cuda.memory.

Counterpart of mvlt_tpu/utils/profiling.py (the reference has no profiler,
only wall-clock meters, libs/utils.py:115-161):

  * ``trace(dir)``: a context manager that records the enclosed block with
    torch.profiler (host operators, and the card's kernels where there is
    a card) and writes a Chrome trace into ``dir``; a no-op for an empty
    ``dir``;
  * ``annotate(name)``: a named span of host work in the trace;
  * ``step_marker(step)``: a span per training step, so steps group in
    the trace viewer;
  * ``device_memory_profile(path)``: the caching allocator's snapshot of
    the card's memory, pickled to ``path``.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the enclosed block when ``log_dir`` is set (the trace goes
    to ``<log_dir>/trace_<time>.json``); no-op otherwise."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


def annotate(name: str):
    return record_function(name)


def step_marker(step: int):
    return record_function(f"train_step_{step}")


def device_memory_profile(path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(torch.cuda.memory._snapshot(), f)
