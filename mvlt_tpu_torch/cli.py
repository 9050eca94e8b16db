"""Command-line entry point of the port.

Counterpart of mvlt_tpu/cli.py (the reference's main_vl.py): the same
flags, the same config loading (every key of the config file wins over a
flag, a flag over the default), and its training branch: the synthetic
data set through the sampler and the prefetching loader, optional gradient
accumulation, device grid masks and gradient clipping, the VL eval in the
last third of the epochs, two-phase checkpoints, ``--resume`` and the
``--finetune`` init, ``train_log.jsonl`` with the same keys; ``--eval`` runs
the VL eval alone. It runs on the card unless ``--device cpu`` is given.

Not ported, and refused with NotImplementedError: the retrieval and
recognition evals and ``--viz`` (they need the on-disk Fashion-Gen readers),
``--zero1``, ``--tp-size`` other than 1, ``--steps-per-dispatch`` above 1,
``--remat`` and ``--profile-dir``.

Usage:
  python -m mvlt_tpu_torch.cli --config configs/pretrain_exp21.py --synthetic-data
  python -m mvlt_tpu_torch.cli --config configs/finetune_exp48.py --synthetic-data \\
      --finetune ./runs/pretrain_exp21
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time

import torch

from mvlt_tpu_torch.config import RunConfig, apply_overrides, load_config_file


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
    p.add_argument("--remat", action="store_true", help="not ported")
    p.add_argument("--synthetic-data", action="store_true")
    p.add_argument("--fp32", action="store_true",
                   help="float32 compute (the reference's --fp32/no-AMP switch)")
    p.add_argument("--device-masks", action="store_true",
                   help="generate grid masks on the device (halves image H2D traffic)")
    p.add_argument("--steps-per-dispatch", type=int, default=1, help="not ported (1 only)")
    p.add_argument("--zero1", action="store_true", help="not ported")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="k>1 splits each batch into k sequential microbatches inside "
                        "the step (averaged grads, BN stats threaded through)")
    p.add_argument("--eval", action="store_true", help="pre-train metric eval on valid")
    p.add_argument("--eval-retrieval-itr", action="store_true", help="not ported")
    p.add_argument("--eval-retrieval-tir", action="store_true", help="not ported")
    p.add_argument("--parity-heads", action="store_true", help="not ported")
    p.add_argument("--eval-recognition", action="store_true", help="not ported")
    p.add_argument("--viz", action="store_true", help="not ported")
    p.add_argument("--viz-samples", type=int, default=32)
    p.add_argument("--profile-dir", default="", help="not ported")
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


def _refuse_unported(args, cfg: RunConfig) -> None:
    unported = {
        "--eval-retrieval-itr / --eval-retrieval-tir / --eval-recognition (they need the "
        "on-disk Fashion-Gen readers)":
            args.eval_retrieval_itr or args.eval_retrieval_tir or args.eval_recognition,
        "--viz (it needs the on-disk Fashion-Gen readers)": args.viz,
        "--zero1": args.zero1,
        "--tp-size other than 1": cfg.tp_size != 1,
        "--steps-per-dispatch above 1": args.steps_per_dispatch > 1,
        "--remat": cfg.model.remat,
        "--profile-dir": bool(args.profile_dir),
    }
    refused = [name for name, on in unported.items() if on]
    if refused:
        raise NotImplementedError(f"not ported to mvlt_tpu_torch yet: {'; '.join(refused)}")


def main(argv=None) -> "dict | None":
    """CLI entry point. Returns the eval stats for ``--eval``; training
    returns None."""
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

    args = get_args_parser().parse_args(argv)
    cfg = build_run_config(args)
    _refuse_unported(args, cfg)
    device = torch.device(args.device)
    print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                 if device.type == "cuda" else ""), flush=True)

    torch.manual_seed(cfg.seed)
    model = create_model(cfg.model, device=device, input_size=cfg.data.input_size)

    train_ds = build_dataset("train", cfg.data, itm_enabled=cfg.model.loss_type.itm,
                             seed=cfg.seed)
    # the reference's --repeated-aug switch (main_vl.py:221-242): RA x3 by
    # default, a plain shuffle otherwise; one process
    if cfg.data.repeated_aug > 1:
        sampler = RepeatedAugmentSampler(len(train_ds), 0, 1, cfg.data.repeated_aug, cfg.seed)
    else:
        sampler = DistributedSampler(len(train_ds), 0, 1, seed=cfg.seed)
    batch = cfg.optim.batch_size
    steps_per_epoch = max(1, len(sampler) // batch)
    if args.grad_accum > 1 and batch % args.grad_accum:
        raise ValueError(f"--grad-accum {args.grad_accum} must divide the batch {batch}")

    state = create_train_state(model, cfg.optim, batch, steps_per_epoch, seed=cfg.seed)
    ckpt = CheckpointManager(cfg.output_dir or "./runs/default", cfg)
    start_epoch = 0
    if cfg.resume:
        state, start_epoch = ckpt.restore(state, cfg.resume)
        print(f"resumed at epoch {start_epoch} (step {state.step})", flush=True)
    elif cfg.finetune:
        load_finetune_state(cfg.finetune, model)
        print(f"finetune init from {cfg.finetune}", flush=True)

    device_masks = args.device_masks and cfg.data.mask_strategy == "random_grid"
    # t2i_labels is never read (the T2I loss compares with the full image);
    # masked_images is not needed with device masks or without T2I (CLS
    # fine-tuning trains on clean images on every step)
    drop_keys = ("t2i_labels",)
    if device_masks or not cfg.model.loss_type.t2i:
        drop_keys += ("masked_images",)
    loader = DataLoader(train_ds, sampler, batch,
                        put_fn=functools.partial(to_device, device=device),
                        num_workers=cfg.data.num_workers, prefetch_depth=cfg.data.prefetch_depth,
                        drop_keys=drop_keys)
    train_step = make_train_step(
        cfg.model, device_masks=device_masks, mask_ratio=cfg.data.mask_ratio,
        mask_patch_size=cfg.data.mask_patch_size,
        # reference quirk (main_vl.py:435): fine-tuning from a checkpoint
        # trains with dropout and DropPath off
        train_mode=not cfg.finetune, grad_accum=max(1, args.grad_accum))
    eval_fn = make_vl_eval_fn(model, cfg.model)
    valid_ds = build_dataset("valid", cfg.data, itm_enabled=cfg.model.loss_type.itm,
                             seed=cfg.seed + 10_000)
    # eval keeps every sample: the ragged last batch counts exactly
    valid_loader = DataLoader(valid_ds, SequentialSampler(len(valid_ds)), batch,
                              put_fn=None, drop_last=False)

    if args.eval:
        return evaluate_vl(eval_fn, valid_loader)

    log_path = os.path.join(cfg.output_dir or ".", "train_log.jsonl")
    os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
    for epoch in range(start_epoch, cfg.optim.epochs):
        loader.set_epoch(epoch)
        t0 = time.time()
        state, stats = train_one_epoch(train_step, state, loader, epoch,
                                       lr_schedule=state.lr_schedule, log_every=cfg.log_every)
        quality = None
        if epoch >= int(cfg.optim.epochs * cfg.save_every_frac):
            eval_stats = evaluate_vl(eval_fn, valid_loader)
            quality = eval_stats["quality_score"]
            stats.update({f"eval_{k}": v for k, v in eval_stats.items()})
        ckpt.save_epoch(state, epoch, cfg.optim.epochs, quality, cfg.save_every_frac)
        with open(log_path, "a") as f:   # one JSON line per epoch (main_vl.py:500-502)
            f.write(json.dumps({"epoch": epoch, "time": time.time() - t0,
                                **{k: round(float(v), 6) for k, v in stats.items()}}) + "\n")
    return None


if __name__ == "__main__":
    main()
