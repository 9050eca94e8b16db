"""Readings that the correctness limits are set from, for one cell, in one
process (under torchrun for a cell on more than one chip):

    python3 port_bench/control.py --workload <cell> [--program-seeds 12]
        [--control-seeds 3] [--faults half_batch,...] [--seconds 1]

For each program seed the cell runs as the benchmark runs it, on a short
window, and prints the numbers its check compares (the lower readings);
for each control seed the reference in float8 stands in the program's place
(the control); each fault named is planted in the program and read on as
many seeds as the control. The last line sums up: the largest program
reading and the smallest control and fault readings of each number. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from port_bench import common  # noqa: E402


def seeds(n: int, salt: int) -> list:
    return [2 ** 31 + 104729 * (salt * 1000 + k) + 17 for k in range(n)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser("port_bench control")
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    os.environ.update(common.run_env(ROOT))

    import torch

    bench = common.benchmark()
    cell = common.find(bench["workloads"], args.workload, "workload")
    rank, local, world = common.env_rank()
    device = torch.device("cuda", local)
    torch.cuda.set_device(device)
    mix = common.traffic(cell["traffic"])
    runs = [("program", s, None, False) for s in seeds(args.program_seeds, 1)]
    runs += [("control", s, None, True) for s in seeds(args.control_seeds, 2)]
    for f in filter(None, args.faults.split(",")):
        runs += [(f, s, f, False) for s in seeds(args.control_seeds, 3)]
    rows = []
    for kind, seed, fault, control in runs:
        ctx = common.Context(cell, common.config(cell["config"]), mix,
                             common.limits(cell["name"]), seed, args.seconds, False, device,
                             time.time(), rank, world, fault=fault, control=control)
        out = common.driver(mix["driver"]).run(ctx)
        numbers = {k: n for k, (n, _) in out["compared"].items()}
        rows.append((kind, numbers))
        if ctx.is_main:
            print(json.dumps({"kind": kind, "seed": seed, "numbers": numbers}), flush=True)
        torch.cuda.empty_cache()
    if rank == 0:
        summary = {}
        for kind in dict.fromkeys(k for k, _ in rows):
            picked = [n for k, n in rows if k == kind]
            agg = max if kind == "program" else min
            summary[kind] = {name: agg(n[name] for n in picked) for name in picked[0]}
        print(json.dumps({"summary": summary}), flush=True)
    if world > 1:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
