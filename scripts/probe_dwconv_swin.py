#!/usr/bin/env python3
"""A short check of kernel D (csrc/dwconv_mlp.cu) and kernel E
(csrc/swin_block.cu) on one NVIDIA GPU.

    PYTHONPATH=. python3 scripts/probe_dwconv_swin.py [--checks-only]

from the root of a checkout, on a machine with a CUDA card and nvcc. It
builds the port's kernels and prints ptxas's lines and the HGMMA counts of
D's and E's kernels; holds D against its plain version at chip_smoke's v2
shapes at B = 4 and the stage shapes at B = 101, and E at chip_smoke's Swin
shapes (unshifted and shifted) at B = 4 and the stage shapes at B = 101,
each with its error against the plain version; then, unless --checks-only,
times D and E at the stage shapes at B = 101 (CUDA events, torch.profiler
device time in all and by kernel, the scratch's peak) beside the plain
version, the bound and the bf16 PyTorch composition. Every error is printed without stopping; chip_smoke.py makes
the full checks and measurements. The work runs in a child process that is
killed after 600 s.
"""

import json
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as c
from mvlt_tpu_torch.models.pvlt import kernel_operand
from mvlt_tpu_torch.ops import _build
from mvlt_tpu_torch.ops.dwconv_mlp import dwconv_mlp_reference, fused_dwconv_mlp
from mvlt_tpu_torch.ops.swin_band import fused_swin_block, swin_block_reference


def build_report() -> None:
    _, log, secs = _build.build()
    lines, keep = log.splitlines(), []
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and any(k in ln for k in ("dwconv_", "swin_", "ln_mlp_fwd")):
            keep += [x.strip() for x in lines[i:i + 4]
                     if "Compiling" in x or "registers" in x or "spill" in x]
    hgmma = {k: v for k, v in c.hgmma_counts(_build.library_path()).items()
             if any(f in k for f in ("dwconv", "swin", "ln_mlp_fwd"))}
    print(json.dumps({"build_s": secs, "ptxas": keep, "hgmma": hgmma}), flush=True)
    _build.load_library()


def by_kernel(fn, calls: int = 10) -> dict:
    """Device time per call by kernel (name without namespaces and argument
    list), from torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.self_device_time_total > 0:
            name = evt.key.replace("(anonymous namespace)::", "").replace("mvlt::", "")
            name = name.replace("void ", "").split("(")[0]
            out[name] = out.get(name, 0.0) + evt.self_device_time_total / 1e3 / calls
    return out


def peak_extra_mib(fn) -> float:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def rel(got, want) -> float:
    return c._rel_err(got, want)[1]


def probe_d(timed: bool) -> None:
    stages = [(f"v2_stage{i + 1}", (h, w, d, nh, sr, hid, c.TEXT))
              for i, (h, w, d, nh, sr, hid) in enumerate(c.STAGES)]
    gen = torch.Generator().manual_seed(c.SEED + 5)
    for batch, shapes in ((c.SMOKE_BATCH, stages + [("v2_ragged", c.V2_RAGGED)]),
                          (c.BATCH, stages)):
        for label, (h, w, d, nh, sr, hid, t) in shapes:
            p = c.v2_stage_params(gen, d, sr, hid, torch.device("cuda"))
            x = torch.randn(batch, h * w + t, d, generator=gen).to("cuda", torch.bfloat16)
            args = (x, (h, w), *c._d_args(p))
            want = dwconv_mlp_reference(*args, eps=1e-6)
            row = {"kernel": "dwconv_mlp", "shape": label, "batch": batch}
            try:
                row["rel_err"] = rel(fused_dwconv_mlp(*args, eps=1e-6), want)
                torch.cuda.synchronize()
                if timed and batch == c.BATCH:
                    ops = {k: kernel_operand(v, torch.bfloat16) for k, v in p.items()}
                    kernel = lambda: fused_dwconv_mlp(x, (h, w), *c._d_args(ops), eps=1e-6)
                    row.update(ms=c.cuda_time_ms(kernel), device_ms=c.device_time_ms(kernel),
                               by_kernel=by_kernel(kernel), peak_extra_mib=peak_extra_mib(kernel))
            except Exception as exc:  # noqa: BLE001
                row["error"] = repr(exc)[:500]
            if timed and batch == c.BATCH:
                ops = {k: kernel_operand(v, torch.bfloat16) for k, v in p.items()}
                comp = c.dwconv_mlp_composition(x, (h, w), ops)
                row.update(plain_ms=c.cuda_time_ms(
                    lambda: dwconv_mlp_reference(x, (h, w), *c._d_args(ops), eps=1e-6)),
                    bound_ms=c.v2_bounds((h, w, d, nh, sr, hid, t), batch)["dwconv_mlp"][0],
                    composition_ms=c.cuda_time_ms(comp),
                    composition_device_ms=c.device_time_ms(comp))
            print(json.dumps(row), flush=True)
            del x, want, args
            torch.cuda.empty_cache()


def probe_e(timed: bool) -> None:
    e_shapes, _ = c.swin_kernel_shapes()
    gen = torch.Generator().manual_seed(c.SEED + 13)
    for batch, shapes in ((c.SMOKE_BATCH, e_shapes), (c.BATCH, e_shapes[:-1])):
        for shift in (False, True):
            for label, shape in shapes:
                row = {"kernel": "swin_block", "shape": label, "batch": batch, "shift": shift}
                try:
                    h, w, d, nh, hid, t, ws, pool = shape
                    dev = torch.device("cuda")
                    x = torch.randn(batch, h * w, d, generator=gen).to(dev, torch.bfloat16)
                    kt, vt = (torch.randn(batch, t, d, generator=gen).to(dev, torch.bfloat16)
                              for _ in range(2))
                    args = (x, kt, vt, *c.swin_block_params(gen, d, nh, hid, ws, dev))
                    kw = dict(hw=(h, w), heads=nh, window=ws, shift=ws // 2 if shift else 0,
                              pool=pool, eps1=1e-6, eps2=1e-6)
                    out, pooled = fused_swin_block(*args, **kw, table=c.swin_table(args, kw))
                    want_out, want_pooled = swin_block_reference(*args, **kw)
                    torch.cuda.synchronize()
                    row.update(rel_err_out=rel(out, want_out), rel_err_pooled=rel(pooled, want_pooled))
                    if timed and batch == c.BATCH:
                        ops = tuple(kernel_operand(a, torch.bfloat16) if i > 3 else a
                                    for i, a in enumerate(args))
                        table = c.swin_table(ops, kw)
                        kernel = lambda: fused_swin_block(*ops, **kw, table=table)
                        comp = c.swin_block_composition(ops, kw)
                        row.update(ms=c.cuda_time_ms(kernel), device_ms=c.device_time_ms(kernel),
                                   by_kernel=by_kernel(kernel), peak_extra_mib=peak_extra_mib(kernel),
                                   plain_ms=c.cuda_time_ms(lambda: swin_block_reference(*ops, **kw)),
                                   bound_ms=c.swin_e_bound(shape, batch)[0],
                                   composition_ms=c.cuda_time_ms(comp),
                                   composition_device_ms=c.device_time_ms(comp))
                except Exception as exc:  # noqa: BLE001
                    row["error"] = repr(exc)[:500]
                print(json.dumps(row), flush=True)
                torch.cuda.empty_cache()


def main(timed: bool) -> None:
    t0 = time.time()
    c.phase_device()
    build_report()
    probe_d(timed)
    probe_e(timed)
    print(json.dumps({"seconds": time.time() - t0}), flush=True)


if __name__ == "__main__":
    if "--child" in sys.argv:
        main("--checks-only" not in sys.argv)
    else:   # a watchdog: a kernel that never returns is killed with its process
        sys.exit(subprocess.run([sys.executable, __file__, "--child", *sys.argv[1:]],
                                timeout=600, check=False).returncode)
