"""Command-line entry point of the port.

Counterpart of mvlt_tpu/cli.py (the reference's main_vl.py): the same
flags, the same config loading (every key of the config file wins over a
flag, a flag over the default), its eval dispatch (main_vl.py:348-399) and
its training branch. Training: the Fashion-Gen tree at ``--data-path`` or
the synthetic set through the sampler and the prefetching loader, optional
gradient accumulation, device grid masks and gradient clipping, the VL eval
in the last third of the epochs, two-phase checkpoints, ``--resume`` and the
``--finetune`` init, ``train_log.jsonl`` with the same keys, and a
torch.profiler trace of the first trained epoch with ``--profile-dir``.
``--eval`` runs the VL eval alone, ``--viz`` writes qualitative samples,
``--eval-retrieval-itr`` / ``-tir`` the zero-shot retrieval protocol and
``--eval-recognition`` the M-CR / S-CR protocol (at B = 500 on the card, 64
on the CPU), each on the weights of ``--resume`` (a reference ``.pth``, a
checkpoint of the port, or none: a fresh init). It runs on the card unless
``--device cpu`` is given, and raises when there is no card.

``--remat`` recomputes each block's activations in the backward
(torch.utils.checkpoint, models/pvlt.py:checkpoint_block).

Data parallelism: launched by torchrun, each rank joins the process group
the environment names (NCCL on the card, gloo with ``--device cpu``), wraps
the model in DDP, draws its share of the samples with ``seed + rank`` for
its masks, trains with the LR of the global batch (``--batch-size`` per
rank), and scores its shard of every eval; only rank 0 prints, writes
``train_log.jsonl`` and saves. ``--zero1`` partitions the AdamW state over
the ranks (in one process there is nothing to partition and AdamW runs as
it is).

Tensor parallelism: ``--tp-size N`` under torchrun splits the world into
model groups of N consecutive ranks and data groups
(parallel/mesh.py:init_model_parallel, the model axis innermost); the
model of the training branch (v1, v2, linear-SR v2 or Swin) is split over
its model group (parallel/tensor.py:shard_model; rank 0 prints the
layout), DDP, ``--zero1`` and the cross-rank sums act over the data group,
each data rank draws its share of the samples and its masks from seed +
data rank (the ranks of a model group the same), ``--remat`` recomputes a
split block's collectives in the backward, and the LR takes the global
batch of ``--batch-size`` per data rank. The VL eval (in training
and ``--eval``) runs on the split model, each model group scoring its data
rank's rows; the checkpoints hold the whole model and resume at any tp. The
other eval modes and ``--viz`` build the whole model on every rank and
shard the rows over the world, as without tensor parallelism. Every model
option the JAX package takes runs under ``--tp-size`` (``fused_attn_train``
and ``mlm_loss_chunk <= 0`` included). A model group stays inside a node:
``--tp-size`` must divide torchrun's ``LOCAL_WORLD_SIZE``. ``--zero1``
shards each AdamW moment by element over the data group
(parallel/sharding.py:Zero1AdamW).

``--steps-per-dispatch k`` takes k optimizer steps in each call of the step
(train/step.py:make_train_step(scan_steps=k)) on k batches the loader
stacks and moves to the device at once (DataLoader(stack_steps=k)); the
engine logs each step's losses. The steps equal k single ones bit for bit,
alone or with any of the options above; the LR schedule still counts
``len(sampler) // batch`` steps an epoch, and an epoch runs
``steps // k`` calls. A checkpoint resumes at any k.

Usage:
  python -m mvlt_tpu_torch.cli --config configs/pretrain_exp21.py --data-path <root>
  python -m torch.distributed.run --nproc_per_node=8 -m mvlt_tpu_torch.cli \\
      --config configs/pretrain_exp21.py --data-path <root> [--zero1 | --tp-size 2]
  python -m mvlt_tpu_torch.cli --config configs/finetune_exp48.py --data-path <root> \\
      --finetune ./runs/pretrain_exp21
  python -m mvlt_tpu_torch.cli --config configs/pretrain_exp21.py --data-path <root> \\
      --eval-retrieval-itr --resume checkpoint_retrieval.pth
  python -m mvlt_tpu_torch.cli --config configs/finetune_exp48.py --data-path <root> \\
      --eval-recognition --resume checkpoint_recognition.pth
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time

import torch

from mvlt_tpu_torch.config import RunConfig, apply_overrides, load_config_file
from mvlt_tpu_torch.parallel import mesh
from mvlt_tpu_torch.parallel.sharding import EvalShard, wrap_model


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("MVLT (PyTorch)", add_help=True)
    p.add_argument("--config", default="", help="experiment preset (.py with cfg=dict(...) or .json)")
    p.add_argument("--output-dir", default="")
    p.add_argument("--data-path", default="")
    p.add_argument("--resume", default="")
    p.add_argument("--finetune", default="", help="load model weights only, dropping mismatched heads")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=0, help="per-process batch (0: from config)")
    p.add_argument("--epochs", type=int, default=0)
    p.add_argument("--tp-size", type=int, default=1)
    p.add_argument("--model", default="", help="registry name (pvlt_tiny/.../pvlt_v2_*)")
    p.add_argument("--lr", type=float, default=0.0)
    p.add_argument("--weight-decay", type=float, default=-1.0)
    p.add_argument("--clip-grad", type=float, default=0.0)
    p.add_argument("--drop-path", type=float, default=-1.0)
    p.add_argument("--input-size", type=int, default=0)
    p.add_argument("--num-text-tokens", type=int, default=0)
    p.add_argument("--word-mask-rate", type=float, default=-1.0)
    p.add_argument("--mask-ratio", type=float, default=-1.0)
    p.add_argument("--mask-strategy", default="")
    p.add_argument("--num-workers", type=int, default=0)
    p.add_argument("--no-repeated-aug", action="store_true",
                   help="plain distributed shuffle instead of the x3 "
                        "repeated-augmentation sampler (main_vl.py:221-242)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each block's activations in the backward")
    p.add_argument("--synthetic-data", action="store_true")
    p.add_argument("--fp32", action="store_true",
                   help="float32 compute (the reference's --fp32/no-AMP switch)")
    p.add_argument("--device-masks", action="store_true",
                   help="generate grid masks on the device (halves image H2D traffic)")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="k>1 runs k optimizer steps in one call of the step on k stacked "
                        "batches (equal to k single steps; losses still logged per step)")
    p.add_argument("--zero1", action="store_true",
                   help="partition the AdamW state over the data-parallel ranks (ZeRO-1)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="k>1 splits each batch into k sequential microbatches inside "
                        "the step (averaged grads, BN stats threaded through)")
    p.add_argument("--eval", action="store_true", help="pre-train metric eval on valid")
    p.add_argument("--eval-retrieval-itr", action="store_true")
    p.add_argument("--eval-retrieval-tir", action="store_true")
    p.add_argument("--parity-heads", action="store_true",
                   help="retrieval scores with every head of the config, as the reference "
                        "does (engine_grid_masking.py:358); by default with the ITM head "
                        "only: the same ranks, without the MLM decode and the T2I head")
    p.add_argument("--eval-recognition", action="store_true")
    p.add_argument("--viz", action="store_true", help="dump qualitative samples")
    p.add_argument("--viz-samples", type=int, default=32)
    p.add_argument("--profile-dir", default="",
                   help="torch.profiler trace of the first trained epoch, written here")
    p.add_argument("--device", default="cuda", help="torch device to run on (cuda or cpu)")
    return p


def build_run_config(args) -> RunConfig:
    """The run's config: the preset file, then the flags the file leaves at
    their defaults (mvlt_tpu/cli.py:build_run_config)."""
    cfg = RunConfig()
    if args.config:
        cfg = load_config_file(args.config, cfg)
    overrides = {}
    for flat_key, val in (("output_dir", args.output_dir), ("data_path", args.data_path),
                          ("resume", args.resume), ("finetune", args.finetune)):
        if val:
            overrides[flat_key] = val
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.epochs:
        overrides["epochs"] = args.epochs
    if args.model:
        overrides["model"] = args.model
    if args.lr > 0:
        overrides["lr"] = args.lr
    if args.weight_decay >= 0:
        overrides["weight_decay"] = args.weight_decay
    if args.clip_grad > 0:
        overrides["clip_grad"] = args.clip_grad
    if args.drop_path >= 0:
        overrides["drop_path"] = args.drop_path
    if args.input_size:
        overrides["input_size"] = args.input_size
    if args.num_text_tokens:
        overrides["num_text_tokens"] = args.num_text_tokens
    if args.word_mask_rate >= 0:
        overrides["word_mask_rate"] = args.word_mask_rate
    if args.mask_ratio >= 0:
        overrides["mask_ratio"] = args.mask_ratio
    if args.mask_strategy:
        overrides["mask_strategy"] = args.mask_strategy
    if args.num_workers:
        overrides["num_workers"] = args.num_workers
    overrides["seed"] = args.seed
    cfg = apply_overrides(cfg, overrides)
    if args.synthetic_data:
        cfg = apply_overrides(cfg, {"data": {"synthetic": True}})
    if args.no_repeated_aug:
        cfg = apply_overrides(cfg, {"data": {"repeated_aug": 1}})
    if args.fp32:
        cfg = apply_overrides(cfg, {"model_overrides": {"compute_dtype": "float32"}})
    if args.remat:
        cfg = apply_overrides(cfg, {"model_overrides": {"remat": True}})
    if args.tp_size != 1:
        cfg = apply_overrides(cfg, {"tp_size": args.tp_size})
    return cfg


def _check_flags(args, cfg: RunConfig) -> None:
    """Raise ValueError before any process group starts on a --tp-size below 1."""
    if cfg.tp_size < 1:
        raise ValueError(f"--tp-size {cfg.tp_size}: must be at least 1")


def load_eval_model(cfg: RunConfig, device):
    """The eval model of ``cfg`` on ``device`` in eval mode, with the weights
    of ``cfg.resume`` (mvlt_tpu/cli.py:_load_eval_variables): a reference
    ``.pth`` (its ``model`` entry), a checkpoint or output directory of the
    port, or none (the seeded init, useful only for smoke tests). Weights
    merge by name, so a model with fewer heads than the checkpoint drops the
    others' tensors; it raises when no tensor matched."""
    from mvlt_tpu_torch.models.pvlt import create_model
    from mvlt_tpu_torch.utils.checkpoint import load_finetune_state

    model = create_model(cfg.model, device=device, input_size=cfg.data.input_size)
    if cfg.resume:
        load_finetune_state(cfg.resume, model)
    return model.eval()


def _simple_loader(dataset, batch: int = 1, shard=None):
    """Host batches of an eval dataset in order, the last one ragged; with
    ``shard`` (parallel/sharding.py:EvalShard) those of this rank's slots."""
    from mvlt_tpu_torch.data.pipeline import DataLoader
    from mvlt_tpu_torch.data.samplers import SequentialSampler

    sampler = SequentialSampler(len(dataset)) if shard is None else shard.indices()
    return DataLoader(dataset, sampler, batch, num_workers=4, drop_last=False)


def _eval_retrieval(args, cfg: RunConfig, device) -> dict:
    from mvlt_tpu_torch.data.fashion_gen import FashionGenRetrieval
    from mvlt_tpu_torch.eval.retrieval import evaluate_retrieval, make_itm_scorer

    direction = "itr" if args.eval_retrieval_itr else "tir"
    lt = cfg.model.loss_type
    if not args.parity_heads and (lt.mlm or lt.t2i or lt.cls):
        # the reference scores retrieval under the full pre-training config,
        # paying the MLM decode and the T2I decoder per pair and discarding
        # them (engine_grid_masking.py:358); the ITM ranks are the same
        # without them, and the checkpoint's other heads are dropped on load
        cfg = apply_overrides(cfg, {"loss_type": {"itm": 1, "mlm": 0, "t2i": 0, "cls": 0}})
    model = load_eval_model(cfg, device)
    dataset = FashionGenRetrieval(cfg.data.data_path, cfg.data, direction)
    shard = EvalShard.of_this_rank(len(dataset))
    results = evaluate_retrieval(make_itm_scorer(model), _simple_loader(dataset, 1, shard),
                                 is_main=mesh.is_main(), shard=shard)
    if mesh.is_main():
        print(f"retrieval {direction.upper()}: "
              + " ".join(f"acc@{k}: {results[f'acc@{k}']}" for k in (1, 5, 10)), flush=True)
    return results


def _eval_recognition(cfg: RunConfig, device) -> dict:
    from mvlt_tpu_torch.data.fashion_gen import FashionGenRecognition
    from mvlt_tpu_torch.eval.recognition import evaluate_recognition, make_cls_scorer

    if not cfg.model.loss_type.cls:
        # recognition needs the CLS heads whatever the config trains (the
        # reference runs it with the fine-tune config)
        cfg = apply_overrides(cfg, {"loss_type": {"cls": 1}})
    model = load_eval_model(cfg, device)
    dataset = FashionGenRecognition(cfg.data.data_path, cfg.data)
    # the reference protocol batches recognition at 500 (main_vl.py:374-385)
    rec_batch = 500 if device.type == "cuda" else 64
    shard = EvalShard.of_this_rank(len(dataset))
    names = dataset.names() if mesh.world_size() > 1 and mesh.is_main() else None
    return evaluate_recognition(
        make_cls_scorer(model), _simple_loader(dataset, rec_batch, shard),
        num_super=cfg.model.num_super_classes, num_sub=cfg.model.num_sub_classes,
        artifact_dir=os.path.join(cfg.output_dir or ".", "visualization"),
        is_main=mesh.is_main(), shard=shard, names=names)


def main(argv=None) -> "dict | None":
    """CLI entry point. Returns the metrics of the eval modes (retrieval,
    recognition, ``--eval``), so that callers such as eval/parity.py read
    them; training and ``--viz`` return None."""
    from mvlt_tpu_torch.data.fashion_gen import build_dataset
    from mvlt_tpu_torch.data.pipeline import DataLoader, to_device
    from mvlt_tpu_torch.data.samplers import (DistributedSampler, RepeatedAugmentSampler,
                                              SequentialSampler)
    from mvlt_tpu_torch.eval.vl_eval import evaluate_vl, make_vl_eval_fn
    from mvlt_tpu_torch.models.pvlt import create_model
    from mvlt_tpu_torch.train.engine import train_one_epoch
    from mvlt_tpu_torch.train.state import create_train_state
    from mvlt_tpu_torch.train.step import make_train_step
    from mvlt_tpu_torch.utils.checkpoint import CheckpointManager, load_finetune_state
    from mvlt_tpu_torch.utils.profiling import trace

    args = get_args_parser().parse_args(argv)
    cfg = build_run_config(args)
    _check_flags(args, cfg)
    # a rank of a torchrun launch joins its group (and names its device);
    # without the environment, one process on --device
    device = mesh.maybe_init_distributed(args.device) or torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: torch sees no CUDA device "
                           f"(pass --device cpu to run on the host)")
    world, is_main = mesh.world_size(), mesh.is_main()
    if is_main:
        print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                     if device.type == "cuda" else "")
              + (f"; {world} ranks ({torch.distributed.get_backend()})"
                 if mesh.initialized() else ""), flush=True)
    torch.manual_seed(cfg.seed)

    if args.eval_retrieval_itr or args.eval_retrieval_tir:
        return _eval_retrieval(args, cfg, device)
    if args.eval_recognition:
        return _eval_recognition(cfg, device)

    tp = 1 if args.viz else cfg.tp_size   # --viz: the whole model, rank 0 alone
    if tp > 1 and not mesh.initialized():
        raise ValueError(f"--tp-size {tp} needs a process group of a multiple of {tp} ranks: "
                         f"launch with python -m torch.distributed.run")
    mesh.init_model_parallel(tp)
    # every rank builds the same whole model from the seed, then keeps its shard
    model = create_model(cfg.model, device=device, input_size=cfg.data.input_size)
    if tp > 1:
        from mvlt_tpu_torch.parallel.tensor import describe, shard_model

        shard_model(model, mesh.model_group())
        if is_main:
            print(describe(model), flush=True)
    # DDP broadcasts rank 0's weights before anything casts or caches them
    ddp = (wrap_model(model, device, mesh.data_group())
           if mesh.initialized() and (tp == 1 or mesh.data_size() > 1) else None)
    data_rank, dp = mesh.data_rank(), mesh.data_size()

    # the synthetic set holds at least one global batch (64 items, as the
    # JAX package's, give one process a batch of 150 under RA x3 but four
    # data ranks none)
    repeats = max(1, cfg.data.repeated_aug)
    train_ds = build_dataset("train", cfg.data, itm_enabled=cfg.model.loss_type.itm,
                             seed=cfg.seed,
                             synthetic_size=max(64, -(-cfg.optim.batch_size * dp // repeats)))
    # the reference's --repeated-aug switch (main_vl.py:221-242): RA x3 by
    # default, a plain shuffle otherwise; each data rank its share
    if cfg.data.repeated_aug > 1:
        sampler = RepeatedAugmentSampler(len(train_ds), data_rank, dp, cfg.data.repeated_aug,
                                         cfg.seed)
    else:
        sampler = DistributedSampler(len(train_ds), data_rank, dp, seed=cfg.seed)
    batch = cfg.optim.batch_size
    steps_per_epoch = max(1, len(sampler) // batch)
    if args.grad_accum > 1 and batch % args.grad_accum:
        raise ValueError(f"--grad-accum {args.grad_accum} must divide the batch {batch}")
    if args.zero1 and ddp is None and is_main:
        print("--zero1 with one data rank: nothing to partition, AdamW as it is", flush=True)

    # the schedule scales with the global batch, the masks draw seed + data
    # rank (mvlt_tpu/cli.py:172, :245)
    state = create_train_state(model, cfg.optim, batch * dp, steps_per_epoch,
                               seed=mesh.rank_seed(cfg.seed), ddp=ddp, zero1=args.zero1,
                               model_group=mesh.model_group())
    ckpt = CheckpointManager(cfg.output_dir or "./runs/default", cfg)
    start_epoch = 0
    if cfg.resume:
        state, start_epoch = ckpt.restore(state, cfg.resume)
        if is_main:
            print(f"resumed at epoch {start_epoch} (step {state.step})", flush=True)
    elif cfg.finetune:
        load_finetune_state(cfg.finetune, model)
        if is_main:
            print(f"finetune init from {cfg.finetune}", flush=True)

    device_masks = args.device_masks and cfg.data.mask_strategy == "random_grid"
    # t2i_labels is never read (the T2I loss compares with the full image);
    # masked_images is not needed with device masks or without T2I (CLS
    # fine-tuning trains on clean images on every step)
    drop_keys = ("t2i_labels",)
    if device_masks or not cfg.model.loss_type.t2i:
        drop_keys += ("masked_images",)
    # k steps a call: the loader stacks k batches, one copy to the device
    spd = max(1, args.steps_per_dispatch)
    loader = DataLoader(train_ds, sampler, batch,
                        put_fn=functools.partial(to_device, device=device),
                        num_workers=cfg.data.num_workers, prefetch_depth=cfg.data.prefetch_depth,
                        drop_keys=drop_keys, stack_steps=spd)
    train_step = make_train_step(
        cfg.model, device_masks=device_masks, mask_ratio=cfg.data.mask_ratio,
        mask_patch_size=cfg.data.mask_patch_size,
        # reference quirk (main_vl.py:435): fine-tuning from a checkpoint
        # trains with dropout and DropPath off
        train_mode=not cfg.finetune, scan_steps=spd, grad_accum=max(1, args.grad_accum))
    eval_fn = make_vl_eval_fn(model, cfg.model)
    valid_ds = build_dataset("valid", cfg.data, itm_enabled=cfg.model.loss_type.itm,
                             seed=cfg.seed + 10_000)
    # eval keeps every sample: the ragged last batch counts exactly; under a
    # process group every rank reads each batch and scores its data rank's
    # share of the rows
    valid_loader = DataLoader(valid_ds, SequentialSampler(len(valid_ds)), batch,
                              put_fn=None, drop_last=False)
    run_eval = functools.partial(evaluate_vl, eval_fn, valid_loader, is_main=is_main)

    if args.eval:
        return run_eval()

    if args.viz:
        from mvlt_tpu_torch.eval.visualize import visualize_vl

        model.eval()

        @torch.no_grad()
        def viz_step(images, ids):
            return model(torch.as_tensor(images, device=device).float(),
                         torch.as_tensor(ids, device=device).long())

        if is_main:   # the samples of the first batches: rank 0 alone
            n = visualize_vl(viz_step, valid_loader, valid_ds.tokenizer,
                             os.path.join(cfg.output_dir or ".", "visualization"),
                             max_samples=args.viz_samples)
            print(f"wrote {n} visualization samples", flush=True)
        return None

    log_path = os.path.join(cfg.output_dir or ".", "train_log.jsonl")
    if is_main:
        os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
    for epoch in range(start_epoch, cfg.optim.epochs):
        loader.set_epoch(epoch)
        t0 = time.time()
        # a trace of the first trained epoch only (rank 0's), when asked for
        with trace(args.profile_dir if epoch == start_epoch and is_main else ""):
            state, stats = train_one_epoch(train_step, state, loader, epoch,
                                           lr_schedule=state.lr_schedule,
                                           log_every=cfg.log_every, is_main=is_main,
                                           steps_per_dispatch=spd)
        quality = None
        if epoch >= int(cfg.optim.epochs * cfg.save_every_frac):
            eval_stats = run_eval()
            quality = eval_stats["quality_score"]
            stats.update({f"eval_{k}": v for k, v in eval_stats.items()})
        # every rank (ZeRO-1 consolidates the optimizer state); rank 0 writes
        ckpt.save_epoch(state, epoch, cfg.optim.epochs, quality, cfg.save_every_frac)
        if is_main:   # one JSON line per epoch (main_vl.py:500-502)
            with open(log_path, "a") as f:
                f.write(json.dumps({"epoch": epoch, "time": time.time() - t0,
                                    **{k: round(float(v), 6) for k, v in stats.items()}}) + "\n")
    return None


if __name__ == "__main__":
    try:
        main()
    finally:
        mesh.destroy()
