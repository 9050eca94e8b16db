"""Run one cell of the port's benchmark once.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``workloads`` in BENCHMARK.json) names its
configuration (configs/<config>.json), its traffic mix
(traffic/<traffic>.json, whose ``driver`` names drivers/<driver>.py) and
its chips; the limits of its correctness check are limits/<cell>.json and
each per-layer metric is read by metrics/<metric>.py. The run sets up the
program from the seed, measures for ``--seconds``, checks what the timed
path produced against the plain reference (reference/), and prints one JSON
line last on standard output. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a profiled stretch of the
window. A cell on more than one chip starts its own torchrun on a free
port; rank 0 prints the line.
"""

from __future__ import annotations

import time

STARTED = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from port_bench import common  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser("port_bench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(args, chips: int) -> int:
    """torchrun over ``chips`` local processes running this file; waits for it."""
    env = dict(os.environ, PORT_BENCH_STARTED=repr(STARTED))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(chips), "--master_port", str(free_port()),
           str(pathlib.Path(__file__).resolve()), "--workload", args.workload,
           "--seed", str(args.seed), "--seconds", repr(args.seconds),
           "--trace", str(args.trace)]
    proc = subprocess.Popen(cmd, env=env)
    try:
        return proc.wait()
    finally:
        if proc.poll() is None:
            proc.terminate()
            proc.wait()


def device_info(chips: int, memory_peak: int, readings=None) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(memory_peak)}
    if readings is not None and readings.trace is not None:
        info["busy_s"] = readings.busy_s_mean
        info["window_s"] = readings.window_s
    return info


def main(argv=None) -> int:
    args = parse(argv)
    if not (ROOT / common.PROGRAM).is_dir():
        common.log(f"the program ({common.PROGRAM}) is not in {ROOT}: nothing to measure")
        return 2
    bench = common.benchmark()
    cell = common.find(bench["workloads"], args.workload, "workload")
    chips = int(cell["chips"])
    os.environ.update(common.run_env(ROOT))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        common.log(f"{args.workload} needs {chips} CUDA device(s); torch sees "
                   f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    rank, local, world = common.env_rank()
    if chips > 1 and world == 1:
        return launch(args, chips)

    started = float(os.environ.get("PORT_BENCH_STARTED", STARTED))
    device = torch.device("cuda", local)
    torch.cuda.set_device(device)
    mix = common.traffic(cell["traffic"])
    ctx = common.Context(cell, common.config(cell["config"]), mix, common.limits(cell["name"]),
                         args.seed, args.seconds, bool(args.trace), device, started, rank, world)
    try:
        out = common.driver(mix["driver"]).run(ctx)
    finally:
        if world > 1 and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()

    found = common.forbidden_loaded()
    if found:
        common.log("modules that may not be loaded in a run:", ", ".join(found))
        return 4
    if not ctx.is_main:
        return 0

    from port_bench.readers import per_layer_values

    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    readings = out.get("readings")
    if args.trace:
        metrics = per_layer_values(bench, cell["name"], readings)
        breakdown = readings.breakdown() if readings is not None else None
    else:
        metrics = {name: out["e2e"][name] if name != "setup_s" else out["setup_s"]
                   for name in (m["name"] for m in common.end_to_end_for(bench, cell["name"]))}
        breakdown = None
    for k, v in {**out.get("info", {}), **out.get("e2e", {})}.items():
        common.log(f"info {k}: {v!r}")
    if readings is not None:
        for line in readings.describe():
            common.log(line)
    common.log(f"setup_s {out['setup_s']!r}")
    print(common.compared_lines(out["compared"]), file=sys.stderr, flush=True)
    print(common.result_line(out["correct"], out["attempted"], out["failed"],
                             {k: (v, units[k]) for k, v in metrics.items()},
                             device_info(chips, out["memory_peak_bytes"],
                                         readings if args.trace else None),
                             out["compared"], breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
