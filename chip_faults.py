#!/usr/bin/env python3
"""Plant known faults in copies of the port's kernels and check that
chip_smoke.py's kernel checks catch each one.

    python3 chip_faults.py

run from the root of a checkout on a machine with a CUDA card and nvcc, as
chip_smoke.py is. For each fault it copies ``mvlt_tpu_torch/`` and
``chip_smoke.py`` into ``build/planted_faults/<fault>/``, rewrites one line
of a kernel source there, runs the chip_smoke phase that checks that kernel
(``v2_kernels``, ``swin_kernels``, ``fba_train_kernels`` or
``train_kernels``) in that copy (its kernels built from the
changed source), and then, with the bound lifted, prints every check's error
at the B = 4 shapes. The copy is removed afterwards; the sources of the
checkout are never changed. It exits non-zero if a fault passes the phase.

Faults, kernel D (csrc/dwconv_mlp.cu), phase v2_kernels:
  halo_wrap        a token's left and right neighbours taken from the flat
                   row index, so they wrap into the previous or next grid row;
  no_conv_bias     the depthwise conv's bias dropped.
Kernel E (csrc/swin_block.cu) and kernel F (csrc/swin_attention.cu), phase
swin_kernels:
  no_region_mask   E ignores the shifted-window region mask;
  rel_bias_swapped E indexes the relative-position bias with dy and dx
                   swapped;
  table_off_window F reads the additive table of the next window.
The fused attention half's backward (csrc/block_attention_train.cu), phase
fba_train_kernels:
  dk_one_tile      dK keeps only one row tile's dS^T Q (its sum restarts on
                   every tile);
  dbp_unscaled     the projection bias gradient sums dy without the row
                   scale, so a dropped sample's rows reach it.
The training attention kernels (csrc/attention.cu), phase train_kernels:
  no_online_rescale    the forward keeps the running sum and output as they
                       are when a later K/V chunk raises a row's max (seen
                       only at M above one 64-column chunk, peaked logits);
  one_split_slot       the slot sum drops the last range's dK/dV partial;
  lse_natural_vs_log2  the backward takes lse (natural log) as a base-2
                       exponent.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent
FAULTS = {
    "halo_wrap": (
        "v2_kernels", "mvlt_tpu_torch/csrc/dwconv_mlp.cu",
        "              if (xx < 0 || xx >= w) continue;",
        "              if ((yy - g_lo) * w + xx < 0 ||\n"
        "                  (yy - g_lo) * w + xx >= (min(a.h, y0 + a.band + 1) - g_lo) * w)\n"
        "                continue;"),
    "no_conv_bias": (
        "v2_kernels", "mvlt_tpu_torch/csrc/dwconv_mlp.cu",
        "          z = a.bdw[c0 + c];",
        "          z = 0.0f;"),
    "no_region_mask": (
        "swin_kernels", "mvlt_tpu_torch/csrc/swin_block.cu",
        "          if (region(wy * ws + iq, a.h) != region(wy * ws + ik, a.h) ||\n"
        "              region(wx * ws + jq, a.w) != region(wx * ws + jk, a.w))\n"
        "            return -INFINITY;\n",
        ""),
    "rel_bias_swapped": (
        "swin_kernels", "mvlt_tpu_torch/csrc/swin_block.cu",
        "(iq - ik + ws - 1) * (2 * ws - 1) + (jq - jk + ws - 1)",
        "(jq - jk + ws - 1) * (2 * ws - 1) + (iq - ik + ws - 1)"),
    "table_off_window": (
        "swin_kernels", "mvlt_tpu_torch/csrc/swin_attention.cu",
        "a.table + ((size_t)win * a.heads + head)",
        "a.table + ((size_t)((win + 1) % a.nw) * a.heads + head)"),
    "dk_one_tile": (
        "fba_train_kernels", "mvlt_tpu_torch/csrc/block_attention_train.cu",
        "gemm_acc<false>(tt, ldt, qt, ldq, mp, hd, tq, acc, hd, n0 == 0);",
        "gemm_acc<false>(tt, ldt, qt, ldq, mp, hd, tq, acc, hd, true);"),
    "dbp_unscaled": (
        "fba_train_kernels", "mvlt_tpu_torch/csrc/block_attention_train.cu",
        "sbp += __bfloat162float(dyb[(size_t)r * d + c]) * sc;",
        "sbp += __bfloat162float(dyb[(size_t)r * d + c]);"),
    "no_online_rescale": (
        "train_kernels", "mvlt_tpu_torch/csrc/attention.cu",
        "const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);",
        "const float a0 = 1.0f, a1 = 1.0f;"),
    "one_split_slot": (
        "train_kernels", "mvlt_tpu_torch/csrc/attention.cu",
        "for (int s = 0; s < splits; ++s) {",
        "for (int s = 0; s < splits - 1; ++s) {"),
    "lse_natural_vs_log2": (
        "train_kernels", "mvlt_tpu_torch/csrc/attention.cu",
        "a.lse[(size_t)bh * a.n + row] * kLog2e",
        "a.lse[(size_t)bh * a.n + row]"),
}
# per phase: the checks at B = 4 that print each error with the bound lifted
MARGINS = {
    "v2_kernels": """
gen = torch.Generator().manual_seed(c.SEED + 5)
shapes = [(f"v2_stage{i + 1}", (h, w, d, nh, sr, hid, c.TEXT))
          for i, (h, w, d, nh, sr, hid) in enumerate(c.STAGES)]
for label, shape in shapes + [("v2_ragged", c.V2_RAGGED)]:
    c.check_v2_kernels(stats, gen, label, shape, c.SMOKE_BATCH)
""",
    "swin_kernels": """
c.check_swin_kernels(stats, torch.Generator().manual_seed(c.SEED + 13), c.SMOKE_BATCH)
""",
    "train_kernels": """
gen = torch.Generator().manual_seed(c.SEED + 7)
shapes = [(f"stage{i + 1}", (h, w, d, nh, sr, hid, c.TEXT))
          for i, (h, w, d, nh, sr, hid) in enumerate(c.STAGES)]
extra = [("ragged", c.TRAIN_RAGGED), ("m177", c.TRAIN_M177), ("m272", c.TRAIN_M272)]
for label, shape in shapes + extra:
    c.check_train_kernels(stats, gen, label, shape, c.SMOKE_BATCH)
""",
    "fba_train_kernels": """
gen = torch.Generator().manual_seed(c.SEED + 17)
shapes = [(f"stage{i + 1}", (h, w, d, nh, sr, hid, c.TEXT))
          for i, (h, w, d, nh, sr, hid) in enumerate(c.STAGES)]
for label, shape in shapes + [("ragged", c.TRAIN_RAGGED)]:
    c.check_fba_kernels(stats, gen, label, shape, c.SMOKE_BATCH)
""",
}
RUN = """
import math, torch, chip_smoke as c
stats = c.new_stats()
c.phase_build()
try:
    c.phase_{phase}(stats)
    print("FAULT_PASSED")
except AssertionError as e:
    print("FAULT_CAUGHT", e)
c.KERNEL_TOL = math.inf
"""


def run_fault(name: str, phase: str, source: str, good: str, bad: str) -> bool:
    """True if chip_smoke's ``phase`` fails on the planted fault."""
    dst = ROOT / "build" / "planted_faults" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "mvlt_tpu_torch", dst / "mvlt_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", dst)
    path = dst / source
    text = path.read_text()
    if text.count(good) != 1:
        raise RuntimeError(f"{name}: the line to change is not in {source} exactly once")
    path.write_text(text.replace(good, bad))
    try:
        proc = subprocess.run([sys.executable, "-c", RUN.format(phase=phase) + MARGINS[phase]],
                              cwd=dst, capture_output=True, text=True, check=False)
    finally:
        shutil.rmtree(dst, ignore_errors=True)
    caught = "FAULT_CAUGHT" in proc.stdout
    checks = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    print(json.dumps({"fault": name, "phase": phase, "source": source, "caught": caught,
                      "message": next((ln for ln in proc.stdout.splitlines()
                                       if ln.startswith("FAULT_")), None),
                      "rel_err_by_check": [
                          [c["kernel"], c["shape"], c["batch"], c["rel_err"]]
                          for c in checks if c.get("phase") == "kernel_check"],
                      "rc": proc.returncode}), flush=True)
    if proc.returncode:
        print(proc.stderr[-3000:], file=sys.stderr)
    return caught and proc.returncode == 0


def main() -> int:
    results = {name: run_fault(name, *fault) for name, fault in FAULTS.items()}
    print(json.dumps({"all_caught": all(results.values()), "caught": results}), flush=True)
    return 0 if all(results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
