#!/usr/bin/env python3
"""A short first check of the fused attention half's tensor-parallel modes
(#6/#7/#8 on a rank's heads) on one NVIDIA GPU.

    PYTHONPATH=. python3 scripts/probe_fba_tp.py

from the root of a checkout, on a machine with a CUDA card and nvcc. It
builds the port's kernels, prints ptxas's lines for the kernels of
csrc/block_attention_train.cu, then runs chip_smoke.py's
phase_fba_tp_kernels: each mode summed over 2 and 4 slices of the heads
against the unsharded kernel and the plain version at the pvlt_tiny stages
whose heads split (B = 150) and a ragged shape (B = 4), one rank's launch
timed at tp = 2, and prints the kernels' entries. chip_smoke.py's
tp_kernels phase runs the same checks; this is its quick precursor.
"""

import json
import time

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
    c.phase_fba_tp_kernels(stats)
    print(json.dumps({k: v for k, v in stats.items() if k.startswith("fba_train")}), flush=True)
    print("total", time.time() - t0)


if __name__ == "__main__":
    main()
