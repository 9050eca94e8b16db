"""Profiling hooks on torch.profiler and torch.cuda.memory.

Counterpart of mvlt_tpu/utils/profiling.py (the reference has no profiler,
only wall-clock meters, libs/utils.py:115-161):

  * ``trace(dir)``: a context manager that records the enclosed block with
    torch.profiler (host operators, and the card's kernels where there is
    a card) and writes a Chrome trace into ``dir``; a no-op for an empty
    ``dir``;
  * ``annotate(name)``: the program's one kind of span, a named range of
    host work in the trace (``record_function``, category
    ``user_annotation``), on the clock of the device's events. It records
    only while a profiler records: otherwise it returns a shared null
    context, so a span costs one check when nobody traces;
  * ``step_marker(step)``: the span ``mvlt.train.step`` around a call of
    the training step (k steps under ``--steps-per-dispatch k``);
  * ``op_span``: the decorator that puts an op wrapper's whole call inside
    the span ``mvlt.op::<wrapper>``;
  * ``device_memory_profile(path)``: the caching allocator's snapshot of
    the card's memory, pickled to ``path``.

The spans of the program (every name starts with ``mvlt.``):

  * serving, ``eval/retrieval.py``: ``mvlt.retrieval.call`` around one
    loader item's work, holding ``.fetch`` (the loader's next), ``.stage``
    (numpy staging), ``.score`` (the scorer; in ``_score``: ``.h2d``, the
    copy to the device and uint8 / 255, and ``.forward``, the model and
    the softmax), ``.readback`` (the scores to the host: the wait on the
    device) and ``.rank``;
  * the model, ``models/pvlt.py``: ``mvlt.model.embed`` (the text
    embeddings, then each stage's patch and text embeddings, position
    tables and concat: five a forward at four stages),
    ``mvlt.model.blocks`` (each stage's blocks) and ``mvlt.model.heads``;
  * the op wrappers, ``ops/*``: ``mvlt.op::<wrapper>`` around every call
    of a launch-counted wrapper, on the CPU path too;
  * training: ``mvlt.train.fetch``, ``mvlt.train.step`` and
    ``mvlt.train.drain`` (``train/engine.py``); inside the step
    ``mvlt.train.h2d``, ``.forward``, ``.loss``, ``.backward``, ``.clip``
    and ``.optimizer`` (``train/step.py``);
  * collectives: ``mvlt.sync.bn`` (BatchNorm's statistics across ranks,
    ``models/heads.py``) and ``mvlt.sync.mlm_count`` (the global MLM
    count, ``train/losses.py``).
"""

from __future__ import annotations

import contextlib
import functools
import os
import pickle
import time
from typing import Callable, Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

OP_PREFIX = "mvlt.op::"
STEP = "mvlt.train.step"

_OFF = contextlib.nullcontext()


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
    """The span ``name`` around a ``with`` block while a profiler records;
    a shared null context, entered at no cost, while none does."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return record_function(name)


def step_marker(step: int):
    """The span ``mvlt.train.step`` around one call of the training step,
    from step ``step`` on. Every call takes the one name, so that time sums
    by name across calls; the exported trace keeps no argument of a range,
    so the n-th such range of a trace is the n-th call it recorded: the
    n-th step, or the n-th dispatch of k steps under
    ``--steps-per-dispatch k``."""
    return annotate(STEP)


def op_span(fn: Callable) -> Callable:
    """``fn`` with each call inside the span ``mvlt.op::<fn's name>``."""
    name = OP_PREFIX + fn.__name__

    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with annotate(name):
            return fn(*args, **kwargs)

    return spanned


def device_memory_profile(path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(torch.cuda.memory._snapshot(), f)
