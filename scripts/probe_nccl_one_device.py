#!/usr/bin/env python3
"""Two ranks on one CUDA device over NCCL: what NCCL answers.

    python3 scripts/probe_nccl_one_device.py

starts two processes with the torchrun environment, each joining the
process group through mvlt_tpu_torch.parallel.mesh.maybe_init_distributed
on cuda:0 with NCCL (the backend the CLI takes on the card) and summing
one tensor; prints each rank's outcome (its error's text where NCCL
refuses) and the card's name and power limit, one JSON line. This is why
the two-rank phase of chip_smoke.py runs gloo on a one-card machine.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
RANK_CODE = """
import torch, torch.distributed as dist
from mvlt_tpu_torch.parallel import mesh
device = mesh.maybe_init_distributed(device="cuda:0")
t = torch.ones(4, device=device)
dist.all_reduce(t)
torch.cuda.synchronize()
print("SUM", t.tolist(), flush=True)
mesh.destroy()
"""


def main() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for r in range(2):
        env = {**os.environ, "RANK": str(r), "WORLD_SIZE": "2", "LOCAL_RANK": str(r),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "NCCL_DEBUG": "WARN",
               "PYTHONPATH": str(REPO)}
        procs.append(subprocess.Popen([sys.executable, "-c", RANK_CODE], cwd=REPO, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    ranks = []
    for r, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        lines = [ln for ln in (out + err).splitlines()
                 if any(w in ln for w in ("NCCL", "Duplicate", "Error", "SUM", "rror:"))]
        ranks.append({"rank": r, "rc": p.returncode, "lines": lines[-12:]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip()
    print(json.dumps({"probe": "nccl_two_ranks_one_device", "ranks": ranks, "nvidia_smi": smi}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
