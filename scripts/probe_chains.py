#!/usr/bin/env python3
"""A short first check of the attention-half chains (kernel B and the fused
attention forward) on one NVIDIA GPU.

    PYTHONPATH=. python3 scripts/probe_chains.py

from the root of a checkout, on a machine with a CUDA card and nvcc. It
builds the port's kernels and prints ptxas's lines for the kernels the
chains run under their route tags (BlockFusedRoute, FbaFwdRoute) and their
HGMMA counts, holds kernel B and the fused attention forward (both forms,
every statistics column) against their plain versions with chip_smoke.py's
checks at B = 4 (the stage shapes and the trap shapes), then at the main
paths' batches (B = 101 for B, 150 for the forward) prints each stage's
error, its time by CUDA events and by torch.profiler device time, and its
device time by kernel.
chip_smoke.py makes the full checks and measurements; this is its quick,
short-lived precursor for a new kernel's first call on the card.
"""

import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as c
from mvlt_tpu_torch.ops import _build

TAGS = ("BlockFusedRoute", "FbaFwdRoute")


def by_kernel(fn, calls: int = 5) -> list:
    """Device ms a call by kernel name over ``calls`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key[:90], e.self_device_time_total / 1e3 / calls) for e in prof.key_averages()
            if c.is_kernel(e) and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def main() -> None:
    t0 = time.time()
    c.phase_device()
    path, log, secs = _build.build()
    lines = log.splitlines()
    ptxas = [" ".join(lines[i:i + 3]) for i, ln in enumerate(lines)
             if "Compiling entry" in ln and any(tag in ln for tag in TAGS)]
    _build.load_library()
    hgmma = {k: v for k, v in c.hgmma_counts(path).items() if any(tag in k for tag in TAGS)}
    print(json.dumps({"build_s": secs, "ptxas": ptxas, "hgmma": hgmma}), flush=True)

    stats = c.new_stats()
    gen = torch.Generator().manual_seed(c.SEED)
    shapes = [(f"stage{i + 1}", (h, w, d, nh, sr, hid, c.TEXT))
              for i, (h, w, d, nh, sr, hid) in enumerate(c.STAGES)]
    for label, shape in shapes + [("ragged", c.RAGGED), ("ragged_heads", c.RAGGED_HEADS),
                                  ("m177", c.TRAIN_M177)]:
        c.check_kernels(stats, gen, label, shape, c.SMOKE_BATCH)
    c.check_fba_traps(stats, torch.Generator().manual_seed(c.SEED + 17))

    for label, shape in shapes:
        p, x, k, v, _, kw_b = c.check_kernels(stats, gen, label, shape, c.BATCH)
        p = {name: c.kernel_operand(t, torch.bfloat16) for name, t in p.items()}
        run = lambda: c.fused_block(x, k, v, *c._block_args(p), **kw_b)
        print(json.dumps({"kernel": "block_fused", "shape": label, "batch": c.BATCH,
                          "ms": c.cuda_time_ms(run), "device_ms": c.device_time_ms(run),
                          "by_kernel": by_kernel(run)}), flush=True)
        del x, k, v
        torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(c.SEED + 17)
    for label, shape in shapes:
        a = c.check_fba_kernels(stats, gen, label, shape, c.TRAIN_BATCH)
        for name, save in (("fba_train_fwd", False), ("fba_train_fwd_stats", True)):
            run = lambda: c.block_attention_train_fwd(*c._fba_fwd_args(a), save_stats=save,
                                                      **a["kw"])
            print(json.dumps({"kernel": name, "shape": label, "batch": c.TRAIN_BATCH,
                              "ms": c.cuda_time_ms(run), "device_ms": c.device_time_ms(run),
                              "by_kernel": by_kernel(run)}), flush=True)
        del a
        torch.cuda.empty_cache()
    print(json.dumps({"max_abs_err": {k: v["max_abs_err"] for k, v in stats.items()
                                      if v["max_abs_err"]},
                      "total_s": time.time() - t0}), flush=True)


if __name__ == "__main__":
    main()
