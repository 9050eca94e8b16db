"""Train state: the step counter, the model (parameters and BatchNorm
buffers), the optimizer, the LR schedule, the generator of the dropout,
DropPath and device grid masks, and the gradient-clipping bound; under data
parallelism also the model's DDP wrap (over the data group), under tensor
parallelism the model group its parameters are split over.

Counterpart of mvlt_tpu/train/state.py. PyTorch updates in place, so the
step returns the same object it was given, advanced by one step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.nn.parallel import DistributedDataParallel

from mvlt_tpu_torch.config import OptimConfig
from mvlt_tpu_torch.train.schedule import make_lr_schedule, make_optimizer


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    lr_schedule: Callable[[int], float]
    generator: torch.Generator
    clip_grad: Optional[float] = None   # global-norm bound before AdamW
    ddp: Optional[DistributedDataParallel] = None   # ``model`` under DDP
    model_group: Optional[object] = None   # tensor parallelism's process group

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def net(self) -> torch.nn.Module:
        """What the step runs: the DDP wrap, else the model itself.
        ``model`` stays the unwrapped module (its state dict keeps the
        reference's names)."""
        return self.ddp if self.ddp is not None else self.model

    @property
    def group(self):
        """The data-parallel process group (the data group under tensor
        parallelism), None with one data rank."""
        return self.ddp.process_group if self.ddp is not None else None


def create_train_state(model: torch.nn.Module, cfg: OptimConfig, global_batch_size: int,
                       steps_per_epoch: int, seed: int = 0,
                       ddp: Optional[DistributedDataParallel] = None,
                       zero1: bool = False, model_group=None) -> TrainState:
    """A state at step 0 on the model's device; the mask generator lives
    there too and is seeded from ``seed`` (the CLI passes
    parallel/mesh.py:rank_seed, seed + data rank, as the JAX CLI seeds each
    host). The LR schedule scales with ``global_batch_size``, every data
    rank's batch together. With ``ddp`` the step runs the wrap; ``zero1``
    partitions the AdamW state over its group's ranks; ``model_group``: the
    group a tensor-parallel model is split over."""
    device = next(model.parameters()).device
    group = ddp.process_group if ddp is not None else None
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(cfg, model, zero1_group=group if zero1 else None),
                      lr_schedule=make_lr_schedule(cfg, global_batch_size, steps_per_epoch),
                      generator=torch.Generator(device=device).manual_seed(seed),
                      clip_grad=cfg.clip_grad or None, ddp=ddp, model_group=model_group)
