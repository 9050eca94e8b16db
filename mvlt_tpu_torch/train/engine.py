"""Training engine: one epoch.

Counterpart of mvlt_tpu/train/engine.py (reference
engine_grid_masking.py:27-150): runs the step over a loader, reads each
step's losses one step late so the host queues the next step before it
waits for the card, logs them, and on a non-finite total loss warns and
goes on (the reference's semantics). Under data parallelism only the main
rank prints, and the epoch's averages are every rank's together (the
meters are synchronized first). With ``steps_per_dispatch = k`` each call
of the step takes k optimizer steps (train/step.py:make_train_step(
scan_steps=k), fed by DataLoader(stack_steps=k)) and the engine logs its k
rows of losses, one call late, with the LR of the last of them.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch

from mvlt_tpu_torch.utils.logging import MetricLogger
from mvlt_tpu_torch.utils.profiling import annotate, step_marker


def train_one_epoch(train_step, state, loader: Iterable, epoch: int = 0,
                    lr_schedule: Optional[Callable[[int], float]] = None,
                    log_every: int = 10, is_main: bool = True, steps_per_dispatch: int = 1):
    """Run one epoch; returns (state, dict of the losses' global averages).
    ``steps_per_dispatch = k``: every loss the step returns is a [k] tensor,
    one value per optimizer step of the call."""
    logger = MetricLogger(is_main=is_main)
    pending = None   # (step index, device losses), read one step late
    batches = iter(logger.log_every(loader, log_every, header=f"Epoch [{epoch}]"))
    while True:
        with annotate("mvlt.train.fetch"):
            batch = next(batches, None)
        if batch is None:
            break
        step_idx = state.step
        feed = {k: v for k, v in batch.items() if not isinstance(v, list)}   # info lists
        with step_marker(step_idx):
            state, losses = train_step(state, feed)
        if pending is not None:
            with annotate("mvlt.train.drain"):
                _drain(pending, logger, lr_schedule, steps_per_dispatch)
        pending = (step_idx, losses)
    if pending is not None:
        with annotate("mvlt.train.drain"):
            _drain(pending, logger, lr_schedule, steps_per_dispatch)
    logger.synchronize_between_processes()
    stats = logger.global_averages()
    if is_main:
        print(f"epoch {epoch} averaged stats:", {k: round(v, 5) for k, v in stats.items()},
              flush=True)
    return state, stats


def _drain(pending, logger: MetricLogger, lr_schedule, steps_per_dispatch: int = 1) -> None:
    """Log the losses of one call of the step: k rows for k steps a call,
    row i being step ``step_idx + i``; the LR of the call's last step."""
    step_idx, losses = pending
    # one read a key: a scalar for one step a call, k values for k
    cols = {k: torch.as_tensor(v).reshape(-1).tolist() for k, v in losses.items()}
    lens = {k: len(c) for k, c in cols.items()}
    if set(lens.values()) != {steps_per_dispatch}:
        raise ValueError(f"steps_per_dispatch {steps_per_dispatch}: the step returned "
                         f"rows {lens}")
    rows = [{k: c[i] for k, c in cols.items()} for i in range(steps_per_dispatch)]
    for i, host in enumerate(rows):
        total = host.get("total_loss", 0.0)
        if not math.isfinite(total):
            parts = " | ".join(f"{k}={v:.4f}" for k, v in host.items())
            print(f"[warning] non-finite total loss at step {step_idx + i}: {parts} "
                  f"-- continuing (reference semantics: warn, don't abort)", flush=True)
        logger.update(**host)
    if lr_schedule is not None:
        logger.update(lr=lr_schedule(step_idx + len(rows) - 1))
