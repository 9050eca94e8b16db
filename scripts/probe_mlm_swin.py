#!/usr/bin/env python3
"""A short first check of the wgmma MLM CE backward (csrc/mlm_ce.cu) and
kernel F (csrc/swin_attention.cu) on one NVIDIA GPU.

    PYTHONPATH=. python3 scripts/probe_mlm_swin.py

from the root of a checkout, on a machine with a CUDA card and nvcc. It
builds the port's kernels and prints ptxas's lines and the HGMMA count of
both kernels; holds the MLM CE backward against its plain version at the
pre-training shape (R = 3,072, V = 30,522, H = 768), a ragged R, widths 64
and 256 with ragged vocabularies, and every row ignored, and checks that
two calls at the pre-training shape are bit-equal; holds kernel F against
its plain version at the pvlt_swin_tiny window-path shapes at 224 and the
ragged hd-32 grid, unshifted and shifted, at B = 4 and 101; and times both
(CUDA events and torch.profiler device time) beside their library
yardsticks. Every error is printed without stopping; chip_smoke.py makes
the full checks and measurements. The work runs in a child process that is
killed after 480 s.
"""

import json
import subprocess
import sys
import time

import torch

import chip_smoke as c
from probe_attention import device_ms
from mvlt_tpu_torch.ops import _build
from mvlt_tpu_torch.ops.mlm_ce import mlm_ce_bwd, mlm_nll_bwd_reference, mlm_nll_reference
from mvlt_tpu_torch.ops.swin_attention import fused_swin_attention, swin_attention_reference

KERNELS = ("mlm_ce_dlogits", "mlm_ce_gemm", "mlm_ce_slot_sum", "swin_attn_hopper")


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


def mlm_inputs(gen, r, v, h, frac):
    dev = torch.device("cuda")
    x = torch.randn(r, h, generator=gen).to(dev, torch.bfloat16)
    table = (3.0 / h ** 0.5 * torch.randn(v, h, generator=gen)).to(dev, torch.bfloat16)
    bias = (0.1 * torch.randn(v, generator=gen)).to(dev)
    labels = torch.where(torch.rand(r, generator=gen) < frac,
                         torch.randint(max(0, v - 70), v, (r,), generator=gen)
                         if frac == 1.0 else torch.randint(0, v, (r,), generator=gen), -1).to(dev)
    g = torch.rand(r, generator=gen).to(dev)
    return x, table, bias, labels, g


def check_mlm(gen) -> None:
    for r, v, h, frac in ((3072, 30522, 768, 0.15), (1000, 30522, 768, 0.3),
                          (70, 1000, 64, 0.5), (513, 4099, 256, 0.2), (64, 64, 768, 1.0),
                          (512, 30522, 768, 0.0)):
        row = {"mlm": [r, v, h, frac]}
        try:
            x, table, bias, labels, g = mlm_inputs(gen, r, v, h, frac)
            _, lse = mlm_nll_reference(x, table, bias, labels)
            got = mlm_ce_bwd(x, table, bias, labels, lse, g)
            want = mlm_nll_bwd_reference(x, table, bias, labels, lse, g)
            torch.cuda.synchronize()
            if frac == 0.0:
                row["nonzero"] = sum(int(torch.count_nonzero(t)) for t in got)
            else:
                row.update({n: c._rel_err(a, b)[1] for n, a, b in
                            zip(("d_rows", "d_table", "d_bias"), got, want)})
            if r == 3072:
                again = mlm_ce_bwd(x, table, bias, labels, lse, g)
                row["bit_equal"] = all(torch.equal(a, b) for a, b in zip(got, again))
                _, bwd, _ = c.library_ce_calls(x, table, bias, labels)
                kernel = lambda: mlm_ce_bwd(x, table, bias, labels, lse, g)
                row.update(ms=c.cuda_time_ms(kernel), library_ms=c.cuda_time_ms(bwd),
                           device_ms=c.device_time_ms(kernel),
                           library_device_ms=c.device_time_ms(bwd),
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


def check_swin(gen) -> None:
    shapes = c.swin_kernel_shapes()[1]
    for batch in (c.SMOKE_BATCH, c.BATCH):
        for shift in (False, True):
            for label, shape in shapes:
                if batch == c.BATCH and label.endswith("ragged"):
                    continue
                row = {"swin": label, "batch": batch, "shift": shift}
                try:
                    args, scale = c.swin_attention_inputs(gen, shape, shift, batch)
                    got = fused_swin_attention(*args, scale=scale)
                    want = swin_attention_reference(*args, scale=scale)
                    torch.cuda.synchronize()
                    row["rel_err"] = c._rel_err(got, want)[1]
                    if batch == c.BATCH and not shift:
                        kernel = lambda: fused_swin_attention(*args, scale=scale)
                        sdpa = c.sdpa_window(args, scale)
                        row.update(ms=c.cuda_time_ms(kernel), sdpa_ms=c.cuda_time_ms(sdpa),
                                   device_ms=c.device_time_ms(kernel),
                                   sdpa_device_ms=c.device_time_ms(sdpa))
                except Exception as exc:  # noqa: BLE001
                    row["error"] = repr(exc)[:500]
                print(json.dumps(row), flush=True)


def main() -> None:
    t0 = time.time()
    c.phase_device()
    build_report()
    gen = torch.Generator().manual_seed(0)
    check_swin(gen)
    check_mlm(gen)
    print(json.dumps({"seconds": time.time() - t0}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        main()
    else:   # a watchdog: a kernel that never returns is killed with its process
        sys.exit(subprocess.run([sys.executable, __file__, "--child"], timeout=480,
                                check=False).returncode)
