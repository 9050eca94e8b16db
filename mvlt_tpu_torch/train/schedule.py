"""LR schedule and optimizer.

Counterpart of mvlt_tpu/train/schedule.py (reference main_vl.py:306-311):
the linear scaling lr * global_batch / 512, a per-step warmup-cosine
schedule (optax.warmup_cosine_decay_schedule: linear from warmup_lr to the
peak over the warmup steps, then cosine to min_lr at the last step), and
AdamW with no weight decay on 1-D parameters (biases, LayerNorm and
BatchNorm scales; timm's add_weight_decay), as torch.optim.AdamW parameter
groups.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from mvlt_tpu_torch.config import OptimConfig


def scaled_base_lr(cfg: OptimConfig, global_batch_size: int) -> float:
    """Linear LR scaling rule (reference main_vl.py:306)."""
    return cfg.lr * global_batch_size / cfg.lr_batch_denom


def make_lr_schedule(cfg: OptimConfig, global_batch_size: int,
                     steps_per_epoch: int) -> Callable[[int], float]:
    """LR as a pure function of the optimizer step (0 for the first)."""
    peak = scaled_base_lr(cfg, global_batch_size)
    warmup = max(1, cfg.warmup_epochs * steps_per_epoch)
    decay = max(warmup + 1, cfg.epochs * steps_per_epoch) - warmup

    def lr(step: int) -> float:
        if step < warmup:
            return cfg.warmup_lr + (peak - cfg.warmup_lr) * step / warmup
        t = min(step - warmup, decay) / decay
        return cfg.min_lr + (peak - cfg.min_lr) * 0.5 * (1.0 + math.cos(math.pi * t))

    return lr


def make_optimizer(cfg: OptimConfig, model: torch.nn.Module) -> torch.optim.AdamW:
    """AdamW over the model's parameters, weight decay on those with more
    than one dimension only. The LR is set per step from the schedule."""
    if cfg.clip_grad:
        raise NotImplementedError("clip_grad is not ported yet")
    params = [p for p in model.parameters() if p.requires_grad]
    groups = [{"params": [p for p in params if p.dim() > 1], "weight_decay": cfg.weight_decay},
              {"params": [p for p in params if p.dim() <= 1], "weight_decay": 0.0}]
    return torch.optim.AdamW(groups, lr=cfg.lr, betas=cfg.betas, eps=cfg.eps)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
