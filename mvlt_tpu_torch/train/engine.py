"""Training engine: one epoch.

Counterpart of mvlt_tpu/train/engine.py (reference
engine_grid_masking.py:27-150): runs the step over a loader, reads each
step's losses one step late so the host queues the next step before it
waits for the card, logs them, and on a non-finite total loss warns and
goes on (the reference's semantics).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

from mvlt_tpu_torch.utils.logging import MetricLogger


def train_one_epoch(train_step, state, loader: Iterable, epoch: int = 0,
                    lr_schedule: Optional[Callable[[int], float]] = None,
                    log_every: int = 10, is_main: bool = True):
    """Run one epoch; returns (state, dict of the losses' global averages)."""
    logger = MetricLogger(is_main=is_main)
    pending = None   # (step index, device losses), read one step late
    for batch in logger.log_every(loader, log_every, header=f"Epoch [{epoch}]"):
        step_idx = state.step
        state, losses = train_step(state, batch)
        if pending is not None:
            _drain(pending, logger, lr_schedule)
        pending = (step_idx, losses)
    if pending is not None:
        _drain(pending, logger, lr_schedule)
    stats = logger.global_averages()
    if is_main:
        print(f"epoch {epoch} averaged stats:", {k: round(v, 5) for k, v in stats.items()},
              flush=True)
    return state, stats


def _drain(pending, logger: MetricLogger, lr_schedule) -> None:
    step_idx, losses = pending
    host = {k: float(v) for k, v in losses.items()}
    total = host.get("total_loss", 0.0)
    if not math.isfinite(total):
        parts = " | ".join(f"{k}={v:.4f}" for k, v in host.items())
        print(f"[warning] non-finite total loss at step {step_idx}: {parts} "
              f"-- continuing (reference semantics: warn, don't abort)", flush=True)
    logger.update(**host)
    if lr_schedule is not None:
        logger.update(lr=lr_schedule(step_idx))
