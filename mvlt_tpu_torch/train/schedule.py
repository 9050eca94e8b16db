"""LR schedule and optimizer.

Counterpart of mvlt_tpu/train/schedule.py (reference main_vl.py:306-311):
the linear scaling lr * global_batch / 512, a per-step warmup-cosine
schedule (optax.warmup_cosine_decay_schedule: linear from warmup_lr to the
peak over the warmup steps, then cosine to min_lr at the last step), and
AdamW with no weight decay on 1-D parameters (biases, LayerNorm and
BatchNorm scales; timm's add_weight_decay), as torch.optim.AdamW parameter
groups, optionally after optax.clip_by_global_norm (``clip_grad``); under
ZeRO-1 the same groups with each moment sharded by element over the
data-parallel ranks.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from mvlt_tpu_torch.config import OptimConfig
from mvlt_tpu_torch.parallel.sharding import Zero1AdamW, all_reduce_sum


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


def make_optimizer(cfg: OptimConfig, model: torch.nn.Module,
                   zero1_group=None) -> torch.optim.Optimizer:
    """AdamW over the model's parameters, weight decay on those with more
    than one dimension only. The LR is set per step from the schedule;
    ``cfg.clip_grad`` is applied by the step (``clip_by_global_norm``).
    With ``zero1_group`` (a process group, the data group) the same groups
    under ZeRO-1 by element (parallel/sharding.py:Zero1AdamW): each rank
    keeps its slice of every moment that splits."""
    params = [p for p in model.parameters() if p.requires_grad]
    groups = [{"params": [p for p in params if p.dim() > 1], "weight_decay": cfg.weight_decay},
              {"params": [p for p in params if p.dim() <= 1], "weight_decay": 0.0}]
    if zero1_group is not None:
        return Zero1AdamW(groups, zero1_group, lr=cfg.lr, betas=cfg.betas, eps=cfg.eps)
    return torch.optim.AdamW(groups, lr=cfg.lr, betas=cfg.betas, eps=cfg.eps)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The LR of every group."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def clip_by_global_norm(params, max_norm: float, model_group=None) -> torch.Tensor:
    """optax.clip_by_global_norm on the gradients of ``params``, in place:
    with the global norm at or above ``max_norm`` every gradient g becomes
    (g / norm) * max_norm, below it none changes (torch's
    clip_grad_norm_ would scale by max_norm / (norm + 1e-6) instead).
    Under tensor parallelism (``model_group``) a parameter split over the
    group (``tp_split``, parallel/tensor.py) adds its shards' squares summed
    over the group, a replicated one its own once. Returns the norm, a
    device scalar; nothing waits for the device."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    square = sum(g.float().square().sum() for p, g in zip(params, grads)
                 if not getattr(p, "tp_split", None))
    split = [g for p, g in zip(params, grads) if getattr(p, "tp_split", None)]
    if split:
        square = square + all_reduce_sum(sum(g.float().square().sum() for g in split),
                                         model_group)
    norm = torch.sqrt(square)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm
