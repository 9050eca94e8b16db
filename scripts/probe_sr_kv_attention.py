#!/usr/bin/env python3
"""Kernels A (the K/V front end) and C (the v2 attention half) on one NVIDIA
GPU: a short first check of their chains, and their times per stage shape
for an A/B of two trees in one call.

    PYTHONPATH=. python3 scripts/probe_sr_kv_attention.py [--root DIR] [--label NAME]

from the root of a checkout, on a machine with a CUDA card and nvcc. It
imports chip_smoke.py and the port from ``--root`` (default: this checkout;
another tree, e.g. an earlier commit unpacked under build/, builds its own
library there), builds the kernels and prints ptxas's lines and the HGMMA
counts of A's and C's kernels, holds A and C against their plain versions
with chip_smoke.py's checks at B = 4 (the stage shapes and the trap
shapes), then at B = 101 prints for each stage shape A's time (the v1
stages) and C's (the v2 stages) by CUDA events and by torch.profiler
device time, their device time by kernel, and, where the tree has them,
the bf16 PyTorch compositions of their work (yardsticks). One JSON line
each, tagged with ``--label``.
"""

import argparse
import json
import pathlib
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=".")
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as c
    from mvlt_tpu_torch.ops import _build

    def out(**fields):
        print(json.dumps({"label": args.label, **fields}), flush=True)

    def by_kernel(fn, calls: int = 5) -> list:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key[:90], e.self_device_time_total / 1e3 / calls)
                for e in prof.key_averages() if c.is_kernel(e) and e.self_device_time_total > 0]
        return sorted(rows, key=lambda r: -r[1])

    t0 = time.time()
    out(nvidia_smi=c.nvidia_smi_line(), root=str(pathlib.Path(args.root).resolve()))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    path, log, secs = _build.build()
    names = ("SrKvRoute", "BlockAttentionRoute", "sr_kv_kernel", "block_attention_kernel")
    lines = log.splitlines()
    ptxas = [" ".join(lines[i:i + 4]) for i, ln in enumerate(lines)
             if "Compiling entry" in ln and any(n in ln for n in names)]
    _build.load_library()
    c.WGMMA_KERNELS = names[:2]   # hgmma_counts: every kernel under A's and C's tags
    counts = c.hgmma_counts(path)
    out(build_s=secs, ptxas=ptxas, hgmma=counts)

    stats = c.new_stats()
    shapes = [(f"stage{i + 1}", (h, w, d, nh, sr, hid, c.TEXT))
              for i, (h, w, d, nh, sr, hid) in enumerate(c.STAGES)]
    gen = torch.Generator().manual_seed(c.SEED)
    for label, shape in shapes + [("ragged", c.RAGGED), ("ragged_heads", c.RAGGED_HEADS),
                                  ("v2_ragged", c.V2_RAGGED)]:
        c.check_kernels(stats, gen, label, shape, c.SMOKE_BATCH)
    gen = torch.Generator().manual_seed(c.SEED + 5)
    for label, shape in shapes + [("v2_ragged", c.V2_RAGGED)]:
        c.check_v2_kernels(stats, gen, "v2_" + label, shape, c.SMOKE_BATCH)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(c.SEED + 23)
    for label, (h, w, d, nh, sr, hid, t) in shapes:
        p = c.v2_stage_params(gen, d, sr, hid, dev)
        x = torch.randn(c.BATCH, h * w + t, d, generator=gen).to(dev, torch.bfloat16)
        kw_kv = dict(sr=sr, heads=nh, eps1=1e-6, eps_sr=1e-5)
        k, v = c.sr_kv_reference(x, (h, w), *c._kv_args(p), **kw_kv)
        kw_c = dict(heads=nh, eps=1e-6)
        p = {name: c.kernel_operand(t_, torch.bfloat16) for name, t_ in p.items()}
        runs = {"sr_kv": lambda: c.fused_ln_sr_kv(x, (h, w), *c._kv_args(p), **kw_kv),
                "block_attention": lambda: c.fused_block_attention(x, k, v, *c._c_args(p),
                                                                   **kw_c)}
        for name, run in runs.items():
            fields = {"ms": c.cuda_time_ms(run), "device_ms": c.device_time_ms(run),
                      "by_kernel": by_kernel(run)}
            if hasattr(c, "yardsticks"):
                comp = (c.sr_kv_composition(x, (h, w), p, sr) if name == "sr_kv"
                        else c.attention_half_composition(x, k, v, p, nh))
                fields.update(composition_ms=c.cuda_time_ms(comp),
                              composition_device_ms=c.device_time_ms(comp))
            out(kernel=name, shape=label, batch=c.BATCH, **fields)
        del x, k, v, runs
        torch.cuda.empty_cache()
    out(max_abs_err={k_: v_["max_abs_err"] for k_, v_ in stats.items() if v_["max_abs_err"]},
        total_s=time.time() - t0)


if __name__ == "__main__":
    main()
