#!/usr/bin/env python3
"""A short first check of the fused attention half's training kernels on one
NVIDIA GPU.

    PYTHONPATH=. python3 scripts/probe_fba.py

from the root of a checkout, on a machine with a CUDA card and nvcc. It
builds the port's kernels, prints ptxas's lines for the kernels of
csrc/block_attention_train.cu, holds the forward (with and without
statistics) and both backward forms against their plain versions with
chip_smoke.py's check at the four pvlt_tiny stage shapes and a ragged one
at B = 4, and at stages 1 and 4 at B = 150, then takes one pre-training
step at B = 150 on each form of the fused_attn_train route and prints its
losses and launches. chip_smoke.py makes the full checks and measurements;
this is its quick, short-lived precursor for a new kernel's first call on
the card.
"""

import dataclasses
import json
import time

import torch

import chip_smoke as c
from mvlt_tpu_torch.ops import _build


def main() -> None:
    t0 = time.time()
    c.phase_device()
    _, log, secs = _build.build()
    print("build", secs, flush=True)
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and "fba" in ln:
            print("\n".join(lines[i:i + 3]))
    _build.load_library()
    stats = c.new_stats()
    gen = torch.Generator().manual_seed(c.SEED + 17)
    shapes = [(f"stage{i + 1}", (h, w, d, nh, sr, hid, c.TEXT))
              for i, (h, w, d, nh, sr, hid) in enumerate(c.STAGES)]
    for label, shape in shapes + [("ragged", c.TRAIN_RAGGED)]:
        c.check_fba_kernels(stats, gen, label, shape, c.SMOKE_BATCH)
    for label, shape in (shapes[0], shapes[3]):
        c.check_fba_kernels(stats, gen, label, shape, c.TRAIN_BATCH)
        torch.cuda.empty_cache()
    batch = c.batch_to_device(c.train_batch(c.SEED, c.TRAIN_BATCH), "cuda")
    for form, (fused, with_stats) in c.FBA_FORMS.items():
        cfg = dataclasses.replace(c.train_config(), fused_attn_train=fused,
                                  fused_attn_stats=with_stats)
        model = c.create_model(cfg)
        model.load_state_dict(c.seeded_state_dict(model, c.SEED), strict=True)
        state = c.create_train_state(model, c.OptimConfig(warmup_epochs=0), c.TRAIN_BATCH, 1)
        c.reset_launches()
        start = time.perf_counter()
        state, losses = c.make_train_step(cfg)(state, batch)
        torch.cuda.synchronize()
        print(json.dumps({"form": form, "seconds": time.perf_counter() - start,
                          "losses": {k: float(v) for k, v in losses.items()},
                          "launches": c.read_launches()}), flush=True)
        del model, state
        torch.cuda.empty_cache()
    print("total", time.time() - t0)


if __name__ == "__main__":
    main()
