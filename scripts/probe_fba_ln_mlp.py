#!/usr/bin/env python3
"""A short first check of the wgmma LN-MLP forward (csrc/ln_mlp.cu) and the
wgmma fused attention backward (csrc/block_attention_train.cu) on one
NVIDIA GPU.

    PYTHONPATH=. python3 scripts/probe_fba_ln_mlp.py

from the root of a checkout, on a machine with a CUDA card and nvcc. It
builds the port's kernels and prints ptxas's lines and the HGMMA counts of
both; holds the LN-MLP forward against its plain version at chip_smoke's
training shapes at B = 4 and the stage shapes at B = 150, and times it there
(CUDA events, torch.profiler device time by kernel, the plain version, a
bf16 cuBLAS composition) in both of its forms where both take the width (D
<= 128: one launch, or three through LN(x) and G in device memory); holds
the fused attention backward in both forms against its plain versions at
chip_smoke's fba shapes at B = 4 and the stage shapes at B = 150, with a
dropped sample's dx against its dy, two calls at B = 150 bit-equal, its
times and device time by kernel, and the scratch's peak. Every error is
printed without stopping; chip_smoke.py makes the full checks and
measurements. The work runs in a child process that is killed after 600 s.
"""

import json
import subprocess
import sys
import time

import torch

import chip_smoke as c
from probe_attention import device_ms
from mvlt_tpu_torch.ops import _build
from mvlt_tpu_torch.ops.block_attention import (block_attention_bwd_reference,
                                                block_attention_train_bwd,
                                                block_attention_train_fwd)
from mvlt_tpu_torch.ops.fused_mlp import _check, fwd_scratch, ln_mlp_fwd, ln_mlp_reference

KERNELS = ("ln_mlp_fwd_", "fba_bwd_", "attn_fwd_hopper")


def build_report() -> None:
    _, log, secs = _build.build()
    lines, keep = log.splitlines(), []
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and any(k in ln for k in KERNELS):
            keep += [x.strip() for x in lines[i:i + 4]
                     if "Compiling" in x or "registers" in x or "spill" in x]
    print(json.dumps({"build_s": secs, "ptxas": keep,
                      "hgmma": c.hgmma_counts(_build.library_path())}), flush=True)
    _build.load_library()


def ln_mlp_fwd_form(fused: bool, x, gamma, beta, w1, b1, w2, b2, row_scale, eps):
    """The forward's C entry in the given form (the wrapper picks one by D)."""
    g, be, w1_, b1_, w2_, b2_, s = _check("probe", x, gamma, beta, w1, b1, w2, b2, row_scale)
    b, n, d = x.shape
    scratch = [torch.empty(max(k, 1), dtype=dt, device=x.device)
               for k, dt in fwd_scratch(b * n, d, w1.shape[0], fused).values()]
    out = torch.empty_like(x)
    err = _build.load_library().mvlt_ln_mlp_fwd(
        x.data_ptr(), g.data_ptr(), be.data_ptr(), w1_.data_ptr(), b1_.data_ptr(),
        w2_.data_ptr(), b2_.data_ptr(), s.data_ptr(), out.data_ptr(),
        *(t.data_ptr() for t in scratch), b * n, n, d, w1.shape[0], int(fused), 0, eps,
        torch.cuda.current_stream().cuda_stream)
    _build.check_launch("probe", err)
    return out


def check_ln_mlp(gen) -> None:
    stages = [(f"stage{i + 1}", (h, w, d, nh, sr, hid, c.TEXT))
              for i, (h, w, d, nh, sr, hid) in enumerate(c.STAGES)]
    extra = [("ragged", c.TRAIN_RAGGED), ("m177", c.TRAIN_M177), ("m272", c.TRAIN_M272)]
    for batch, shapes in ((c.SMOKE_BATCH, stages + extra), (c.TRAIN_BATCH, stages)):
        for label, shape in shapes:
            row = {"ln_mlp_fwd": label, "batch": batch}
            try:
                a = c.train_kernel_inputs(gen, shape, batch)
                args = c._mlp_fwd_args(a)
                want = ln_mlp_reference(*args)
                row["y"] = c._rel_err(ln_mlp_fwd(*args), want)[1]
                d = a["x"].shape[-1]
                if d <= 128:
                    row["y_three_launch"] = c._rel_err(ln_mlp_fwd_form(False, *args), want)[1]
                if batch == c.TRAIN_BATCH:
                    kernel = lambda: ln_mlp_fwd(*args)
                    row.update(ms=c.cuda_time_ms(kernel), device_ms=c.device_time_ms(kernel),
                               plain_ms=c.cuda_time_ms(lambda: ln_mlp_reference(*args)),
                               bound_ms=c.train_bounds(shape, batch)["ln_mlp_fwd"][0],
                               by_kernel=device_ms(kernel))
                    if d <= 128:
                        three = lambda: ln_mlp_fwd_form(False, *args)
                        row.update(three_launch_ms=c.cuda_time_ms(three),
                                   three_launch_device_ms=c.device_time_ms(three))
                    comp = getattr(c, "ln_mlp_fwd_composition", None)
                    if comp:
                        row.update(composition_ms=c.cuda_time_ms(comp(a)),
                                   composition_device_ms=c.device_time_ms(comp(a)))
            except Exception as exc:  # noqa: BLE001 -- a probe prints every failure and goes on
                row["error"] = repr(exc)[:500]
            print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()


def check_fba(gen) -> None:
    stages = [(f"stage{i + 1}", (h, w, d, nh, sr, hid, c.TEXT))
              for i, (h, w, d, nh, sr, hid) in enumerate(c.STAGES)]
    for batch, shapes in ((c.SMOKE_BATCH, stages + [("ragged", c.TRAIN_RAGGED)]),
                          (c.TRAIN_BATCH, stages)):
        for label, shape in shapes:
            for form in ("recompute", "stats"):
                row = {"fba_bwd": label, "form": form, "batch": batch}
                try:
                    a = c.fba_inputs(gen, shape, batch)
                    kw = a["kw"]
                    st = st_ref = None
                    if form == "stats":
                        _, st = block_attention_train_fwd(*c._fba_fwd_args(a), save_stats=True,
                                                          **kw)
                        _, st_ref = c.block_attention_train_reference(
                            *c._fba_fwd_args(a), save_stats=True, **kw)
                    args = c._fba_bwd_args(a)
                    got = block_attention_train_bwd(*args, stats=st, **kw)
                    want = block_attention_bwd_reference(*args, stats=st_ref, **kw)
                    torch.cuda.synchronize()
                    row.update({k: c._rel_err(x, y)[1] for k, x, y in zip(c.FBA_GRADS, got, want)})
                    row["dropped_dx_is_dy"] = bool(torch.equal(got[0][0], a["dy"][0]))
                    row["dropped_dkdv_zero"] = not (got[1][0].any() or got[2][0].any())
                    if batch == c.TRAIN_BATCH:
                        again = block_attention_train_bwd(*args, stats=st, **kw)
                        row["bit_equal"] = all(torch.equal(x, y) for x, y in zip(got, again))
                        del again, want, got
                        kernel = lambda: block_attention_train_bwd(*args, stats=st, **kw)
                        row.update(ms=c.cuda_time_ms(kernel), device_ms=c.device_time_ms(kernel),
                                   bound_ms=c.fba_bounds(shape, batch)["fba_train_bwd"][0],
                                   by_kernel=device_ms(kernel))
                        torch.cuda.reset_peak_memory_stats()
                        base = torch.cuda.memory_allocated()
                        kernel()
                        torch.cuda.synchronize()
                        row["peak_extra_mib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
                except Exception as exc:  # noqa: BLE001
                    row["error"] = repr(exc)[:500]
                print(json.dumps(row), flush=True)
                torch.cuda.empty_cache()


def main() -> None:
    t0 = time.time()
    c.phase_device()
    build_report()
    check_ln_mlp(torch.Generator().manual_seed(c.SEED + 7))
    check_fba(torch.Generator().manual_seed(c.SEED + 17))
    print(json.dumps({"seconds": time.time() - t0}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        main()
    else:   # a watchdog: a kernel that never returns is killed with its process
        sys.exit(subprocess.run([sys.executable, __file__, "--child"], timeout=600,
                                check=False).returncode)
