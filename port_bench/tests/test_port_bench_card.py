"""On the card: each one-card cell runs once through ``run.py`` at a short
window and is correct. Skips where there is no card.

    python -m pytest port_bench/tests -q        (on a machine with an H100)
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from port_bench import common

ROOT = pathlib.Path(common.__file__).resolve().parents[1]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in common.benchmark()["workloads"]])
def test_cell_runs_and_is_correct(workload):
    import torch

    chips = common.find(common.benchmark()["workloads"], workload, "workload")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"{workload} needs {chips} CUDA device(s)")
    proc = subprocess.run([sys.executable, str(ROOT / "port_bench" / "run.py"), "--workload",
                           workload, "--seed", str(2 ** 31 + 99), "--seconds", "3",
                           "--trace", "0"], capture_output=True, text=True, timeout=1200,
                          cwd=ROOT, env=dict(os.environ))
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["compared"]
