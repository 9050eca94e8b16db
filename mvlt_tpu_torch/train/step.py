"""The pre-training / fine-tuning step.

Counterpart of mvlt_tpu/train/step.py:make_train_step. Kept from it:
  * the reference's alternation by step parity when T2I is on: clean images
    on even steps, ``masked_images`` on odd ones (engine_grid_masking.py:
    72-78); every enabled loss is computed on the forward that ran;
  * the MLM gather plan: the labeled text rows are gathered before the MLM
    head, and the loss is taken against the plan's labels;
  * ``train_mode``: False reproduces the fine-tune quirk of training in eval
    mode (no dropout or DropPath, BatchNorm on its running statistics), with
    gradients to every parameter;
  * the BatchNorm running statistics, updated by the training forward.
Not ported yet, and refused: ``grad_accum > 1``, ``scan_steps > 1`` and
``device_masks=True``.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from mvlt_tpu_torch.config import ModelConfig
from mvlt_tpu_torch.data.fashion_gen import batch_to_device
from mvlt_tpu_torch.train.losses import compute_losses, mlm_gather_plan
from mvlt_tpu_torch.train.schedule import set_lr
from mvlt_tpu_torch.train.state import TrainState


def make_train_step(cfg: ModelConfig, *, device_masks: bool = False,
                    train_mode: bool = True, scan_steps: int = 1,
                    grad_accum: int = 1) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """``train_step(state, batch) -> (state, losses)``: one forward, backward
    and AdamW update of ``state.model`` on ``batch`` (numpy arrays or
    tensors; moved to the model's device), with the LR of
    ``state.lr_schedule(state.step)``. ``losses`` holds detached scalars on
    the device (reading them waits for the step)."""
    if grad_accum != 1 or scan_steps != 1 or device_masks:
        raise NotImplementedError("grad_accum > 1, scan_steps > 1 and device_masks=True "
                                  "are not ported yet")
    use_masked_input = cfg.loss_type.t2i

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        model = state.model
        batch = batch_to_device(batch, state.device)
        images = batch["images"].float()
        if use_masked_input and state.step % 2 == 1:
            images = batch["masked_images"].float()

        kwargs, loss_batch = {}, batch
        mlm_chunk = max(cfg.mlm_loss_chunk, 1)
        mlm_frac = cfg.mlm_capacity_frac
        if cfg.loss_type.mlm and train_mode and cfg.mlm_loss_chunk > 0 and mlm_frac < 1.0:
            plan = mlm_gather_plan(batch["mlm_labels"], capacity_frac=mlm_frac,
                                   chunk=mlm_chunk)
            if plan is not None:
                idx, sel, mlm_chunk = plan
                kwargs["mlm_row_idx"] = idx
                loss_batch = {**batch, "mlm_labels": sel[None]}
                mlm_frac = 1.0

        model.train(train_mode)
        out = model(images, batch["input_ids"].long(), generator=state.generator, **kwargs)
        losses = compute_losses(out, loss_batch, cfg.num_super_classes, cfg.num_sub_classes,
                                mlm_chunk=mlm_chunk, mlm_capacity_frac=mlm_frac,
                                mlm_ce_kernel=cfg.mlm_ce_kernel)
        state.optimizer.zero_grad(set_to_none=True)
        losses["total_loss"].backward()
        set_lr(state.optimizer, state.lr_schedule(state.step))
        state.optimizer.step()
        state.step += 1
        return state, {k: v.detach() for k, v in losses.items()}

    return train_step
