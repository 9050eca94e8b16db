"""The pre-training / fine-tuning step.

Counterpart of mvlt_tpu/train/step.py:make_train_step. Kept from it:
  * the reference's alternation by step parity when T2I is on: clean images
    on even steps, masked images on odd ones (engine_grid_masking.py:
    72-78), either the batch's ``masked_images`` or, with
    ``device_masks``, grid masks made on the device on odd steps only; every
    enabled loss is computed on the forward that ran;
  * the MLM gather plan: the labeled text rows are gathered before the MLM
    head, and the loss is taken against the plan's labels;
  * ``train_mode``: False reproduces the fine-tune quirk of training in eval
    mode (no dropout or DropPath, BatchNorm on its running statistics), with
    gradients to every parameter;
  * ``grad_accum = k``: the batch is split into k microbatches in order,
    which share the optimizer step's parity; the gradients are averaged,
    the losses are the means of the microbatch means, and the BatchNorm
    running statistics pass through the microbatches in order;
  * the global-norm gradient clipping of ``state.clip_grad`` before AdamW;
  * the BatchNorm running statistics, updated by the training forward.
Under data parallelism (``state.ddp``) the step runs the DDP wrap, whose
backward averages the gradients over the ranks; the losses take the global
MLM mean and gather plan (train/losses.py) and the BatchNorms the global
statistics (models/heads.py), so the step equals the single-device step on
every rank's batch together (mvlt_tpu/train/step.py under a data mesh).
With ``grad_accum = k`` each rank's batch must hold its share of each
global microbatch in order; every microbatch but the last runs under
``no_sync``, so the gradients are reduced once. Clipping sees the reduced
gradients, the same on every rank.
Under tensor parallelism (``state.model_group``) the losses take a split
vocabulary's parallel decode and clipping sums the shards' squares over the
model group; ``state.group`` is the data group. Under sequence parallelism
(a model built with ``sp_group``) each rank's gradients of the blocks of a
split stage hold its rows' part: parallel/sequence.py:reduce_row_grads sums
them over the model group after the backward, before the clip, which then
sees whole gradients on every rank.
``scan_steps = k``: one call takes a batch stacked on a leading [k] axis
(data/pipeline.py:DataLoader(stack_steps=k)) and runs the single step k
times in a Python loop (JAX's lax.scan), on ``batch[i]`` in order, each
sub-step with its own parity from ``state.step``, its own draws from
``state.generator``, its own DDP all-reduce, clip, ZeRO-1 update and
sequence-parallel row sums: the same arithmetic as k calls, bit for bit.
The losses come back stacked [k], on the device.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Tuple

import torch

from mvlt_tpu_torch.config import ModelConfig
from mvlt_tpu_torch.data.fashion_gen import batch_to_device
from mvlt_tpu_torch.data.masks import device_apply_mask, device_grid_masks
from mvlt_tpu_torch.parallel.sequence import reduce_row_grads
from mvlt_tpu_torch.train.losses import compute_losses, mlm_gather_plan
from mvlt_tpu_torch.train.schedule import clip_by_global_norm, set_lr
from mvlt_tpu_torch.train.state import TrainState
from mvlt_tpu_torch.utils.profiling import annotate


def make_train_step(cfg: ModelConfig, *, device_masks: bool = False, mask_ratio: float = 0.5,
                    mask_patch_size: int = 16, train_mode: bool = True, scan_steps: int = 1,
                    grad_accum: int = 1) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """``train_step(state, batch) -> (state, losses)``: one optimizer step of
    ``state.model`` on ``batch`` (numpy arrays or tensors; moved to the
    model's device): forward and backward over ``grad_accum``
    microbatches, clipping, and the AdamW update with the LR of
    ``state.lr_schedule(state.step)``. ``losses`` holds detached scalars on
    the device (reading them waits for the step). With ``scan_steps = k``
    the batch is stacked [k, B, ...], the call takes k such steps, and each
    loss is a [k] tensor of the sub-steps' values."""
    if scan_steps < 1:
        raise ValueError(f"scan_steps {scan_steps}: must be at least 1")
    use_masked_input = cfg.loss_type.t2i

    def forward_backward(state: TrainState, batch: Dict, scale: float) -> Dict:
        """Losses of one (micro)batch; its gradients, times ``scale``, are
        added to the parameters' .grad."""
        with annotate("mvlt.train.forward"):
            images = batch["images"].float()
            if use_masked_input and state.step % 2 == 1:
                if device_masks:
                    masks = device_grid_masks(state.generator, images.shape[0], images.shape[1],
                                              mask_ratio, mask_patch_size)
                    images = device_apply_mask(images, masks)
                else:
                    images = batch["masked_images"].float()

            kwargs, loss_batch, mlm_count = {}, batch, None
            mlm_chunk = max(cfg.mlm_loss_chunk, 1)
            mlm_frac = cfg.mlm_capacity_frac
            if cfg.loss_type.mlm and train_mode and cfg.mlm_loss_chunk > 0 and mlm_frac < 1.0:
                plan = mlm_gather_plan(batch["mlm_labels"], capacity_frac=mlm_frac,
                                       chunk=mlm_chunk, group=state.group)
                if plan is not None:
                    idx, sel, mlm_chunk, mlm_count = plan
                    kwargs["mlm_row_idx"] = idx
                    loss_batch = {**batch, "mlm_labels": sel[None]}
                    mlm_frac = 1.0

            out = state.net(images, batch["input_ids"].long(), generator=state.generator,
                            **kwargs)
        with annotate("mvlt.train.loss"):
            losses = compute_losses(out, loss_batch, cfg.num_super_classes, cfg.num_sub_classes,
                                    mlm_chunk=mlm_chunk, mlm_capacity_frac=mlm_frac,
                                    mlm_ce_kernel=cfg.mlm_ce_kernel, group=state.group,
                                    mlm_count=mlm_count)
        with annotate("mvlt.train.backward"):
            (losses["total_loss"] * scale).backward()
        return {k: v.detach() for k, v in losses.items()}

    def one_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        state.model.train(train_mode)
        state.optimizer.zero_grad(set_to_none=True)
        if grad_accum == 1:
            losses = forward_backward(state, batch, 1.0)
        else:
            n = next(iter(batch.values())).shape[0]
            if n % grad_accum:
                raise ValueError(f"grad_accum {grad_accum} does not divide the batch {n}")
            mb = n // grad_accum
            parts = []
            for i in range(grad_accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                # DDP reduces the gradients once, in the last microbatch's backward
                sync = state.ddp is None or i == grad_accum - 1
                with contextlib.nullcontext() if sync else state.ddp.no_sync():
                    parts.append(forward_backward(state, micro, 1.0 / grad_accum))
            losses = {k: torch.stack([p[k] for p in parts]).mean() for k in parts[0]}
        with annotate("mvlt.train.clip"):
            reduce_row_grads(state.model)
            if state.clip_grad:
                clip_by_global_norm(state.model.parameters(), state.clip_grad, state.model_group)
        with annotate("mvlt.train.optimizer"):
            set_lr(state.optimizer, state.lr_schedule(state.step))
            state.optimizer.step()
        state.step += 1
        return state, losses

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        with annotate("mvlt.train.h2d"):
            batch = batch_to_device(batch, state.device)
        if scan_steps == 1:
            return one_step(state, batch)
        leads = {k: v.shape[0] if v.dim() else None for k, v in batch.items()}
        if set(leads.values()) != {scan_steps}:
            raise ValueError(f"scan_steps {scan_steps}: expected every array stacked on a "
                             f"leading [{scan_steps}] axis, got {leads}")
        rows = []
        for i in range(scan_steps):
            state, losses = one_step(state, {k: v[i] for k, v in batch.items()})
            rows.append(losses)
        return state, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    return train_step
