"""Train state: the step counter, the model (parameters and BatchNorm
buffers), the optimizer, the LR schedule and the generator of the
dropout and DropPath masks.

Counterpart of mvlt_tpu/train/state.py. PyTorch updates in place, so the
step returns the same object it was given, advanced by one step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from mvlt_tpu_torch.config import OptimConfig
from mvlt_tpu_torch.train.schedule import make_lr_schedule, make_optimizer


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    lr_schedule: Callable[[int], float]
    generator: torch.Generator

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def create_train_state(model: torch.nn.Module, cfg: OptimConfig, global_batch_size: int,
                       steps_per_epoch: int, seed: int = 0) -> TrainState:
    """A state at step 0 on the model's device; the mask generator lives
    there too and is seeded from ``seed``."""
    device = next(model.parameters()).device
    return TrainState(step=0, model=model, optimizer=make_optimizer(cfg, model),
                      lr_schedule=make_lr_schedule(cfg, global_batch_size, steps_per_epoch),
                      generator=torch.Generator(device=device).manual_seed(seed))
