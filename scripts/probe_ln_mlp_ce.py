#!/usr/bin/env python3
"""A short first check of the wgmma LN-MLP backward (csrc/ln_mlp_bwd.cu) and
MLM CE forward (csrc/mlm_ce.cu) on one NVIDIA GPU.

    PYTHONPATH=. python3 scripts/probe_ln_mlp_ce.py

from the root of a checkout, on a machine with a CUDA card and nvcc. It
builds the port's kernels and prints ptxas's lines and the HGMMA counts of
both; holds the LN-MLP backward against its plain version (every output) at
chip_smoke's training shapes at B = 4 and the stage shapes at B = 150, with
a dropped sample's dx against its dy, two calls at B = 150 bit-equal, and
its times there (CUDA events, torch.profiler device time by kernel, the
bf16 cuBLAS composition, the plain version); holds the MLM CE forward
against its plain version at chip_smoke's MLM checks, two calls bit-equal,
and times it beside the cuBLAS logits + F.cross_entropy yardstick. Every
error is printed without stopping; chip_smoke.py makes the full checks and
measurements. The work runs in a child process that is killed after 480 s.
"""

import json
import subprocess
import sys
import time

import torch

import chip_smoke as c
from probe_attention import device_ms
from mvlt_tpu_torch.ops import _build
from mvlt_tpu_torch.ops.fused_mlp import ln_mlp_bwd, ln_mlp_bwd_reference
from mvlt_tpu_torch.ops.mlm_ce import mlm_ce_fwd, mlm_nll_reference

KERNELS = ("ln_mlp_bwd_", "mlm_ce_fwd", "mlm_ce_merge")
GRADS = ("dx", "dgamma", "dbeta", "dW1", "db1", "dW2", "db2")


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


def check_ln_mlp(gen) -> None:
    stages = [(f"stage{i + 1}", (h, w, d, nh, sr, hid, c.TEXT))
              for i, (h, w, d, nh, sr, hid) in enumerate(c.STAGES)]
    extra = [("ragged", c.TRAIN_RAGGED), ("m177", c.TRAIN_M177), ("m272", c.TRAIN_M272)]
    for batch, shapes in ((c.SMOKE_BATCH, stages + extra), (c.TRAIN_BATCH, stages)):
        for label, shape in shapes:
            row = {"ln_mlp_bwd": label, "batch": batch}
            try:
                a = c.train_kernel_inputs(gen, shape, batch)
                args = c._mlp_bwd_args(a)
                got = ln_mlp_bwd(*args)
                want = ln_mlp_bwd_reference(*args)
                torch.cuda.synchronize()
                row.update({k: c._rel_err(x, y)[1] for k, x, y in zip(GRADS, got, want)})
                row["dropped_dx_is_dy"] = bool(torch.equal(got[0][0], a["dy"][0]))
                if batch == c.TRAIN_BATCH:
                    again = ln_mlp_bwd(*args)
                    row["bit_equal"] = all(torch.equal(x, y) for x, y in zip(got, again))
                    del again, want
                    kernel = lambda: ln_mlp_bwd(*args)
                    row.update(ms=c.cuda_time_ms(kernel),
                               plain_ms=c.cuda_time_ms(lambda: ln_mlp_bwd_reference(*args)),
                               composition_ms=c.cuda_time_ms(c.ln_mlp_bwd_composition(a)),
                               bound_ms=c.train_bounds(shape, batch)["ln_mlp_bwd"][0],
                               by_kernel=device_ms(kernel))
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    kernel()
                    torch.cuda.synchronize()
                    row["peak_extra_mib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
            except Exception as exc:  # noqa: BLE001 -- a probe prints every failure and goes on
                row["error"] = repr(exc)[:500]
            print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()


def check_mlm(gen) -> None:
    for label, rows, frac, kw in c.MLM_CHECKS:
        row = {"mlm_ce_fwd": label}
        try:
            x, table, bias, labels, _ = c.mlm_inputs(gen, rows, frac, **kw)
            nll, lse = mlm_ce_fwd(x, table, bias, labels)
            want_nll, want_lse = mlm_nll_reference(x, table, bias, labels)
            torch.cuda.synchronize()
            if frac == 0.0:
                row["nonzero"] = int(torch.count_nonzero(nll))
            row.update(nll=c._rel_err(nll, want_nll)[1], lse=c._rel_err(lse, want_lse)[1])
            if label == "path":
                again = mlm_ce_fwd(x, table, bias, labels)
                row["bit_equal"] = torch.equal(nll, again[0]) and torch.equal(lse, again[1])
                fwd, _, _ = c.library_ce_calls(x, table, bias, labels)
                kernel = lambda: mlm_ce_fwd(x, table, bias, labels)
                row.update(ms=c.cuda_time_ms(kernel), library_ms=c.cuda_time_ms(fwd),
                           device_ms=c.device_time_ms(kernel),
                           library_device_ms=c.device_time_ms(fwd),
                           by_kernel=device_ms(kernel))
        except Exception as exc:  # noqa: BLE001
            row["error"] = repr(exc)[:500]
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()


def main() -> None:
    t0 = time.time()
    c.phase_device()
    build_report()
    gen = torch.Generator().manual_seed(c.SEED + 7)
    check_mlm(gen)
    check_ln_mlp(gen)
    print(json.dumps({"seconds": time.time() - t0}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        main()
    else:   # a watchdog: a kernel that never returns is killed with its process
        sys.exit(subprocess.run([sys.executable, __file__, "--child"], timeout=480,
                                check=False).returncode)
