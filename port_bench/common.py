"""What every part of the benchmark shares: the checkout's layout, loading
of the pieces a cell names (configuration, traffic mix, driver, metric
readers, op counts), the result line and the checks around a run.
"""

from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import sys
from typing import Any, Dict, List, Optional

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
PROGRAM = "mvlt_tpu_torch"
# top-level module names that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "mvlt_tpu")

# NVIDIA's published dense peaks of one H100 SXM (data sheet)
PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES = 3.35e12


def load_json(path: pathlib.Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"port_bench: no {what} named {name!r} in BENCHMARK.json")


def load_module(path: pathlib.Path, name: Optional[str] = None):
    """A module from a file, whatever characters its name holds."""
    spec = importlib.util.spec_from_file_location(
        name or "port_bench_piece_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config(name: str, bench_dir: pathlib.Path = BENCH_DIR) -> dict:
    return load_json(bench_dir / "configs" / f"{name}.json")


def traffic(name: str, bench_dir: pathlib.Path = BENCH_DIR) -> dict:
    return load_json(bench_dir / "traffic" / f"{name}.json")


def driver(name: str, bench_dir: pathlib.Path = BENCH_DIR):
    return load_module(bench_dir / "drivers" / f"{name}.py")


def limits(workload: str, bench_dir: pathlib.Path = BENCH_DIR) -> dict:
    return load_json(bench_dir / "limits" / f"{workload}.json")


def metric_reader(name: str, bench_dir: pathlib.Path = BENCH_DIR):
    return load_module(bench_dir / "metrics" / f"{name}.py")


def count_modules(bench_dir: pathlib.Path = BENCH_DIR) -> Dict[str, Any]:
    """Every op count under counts/, by the wrapper it counts (file stem)."""
    return {p.stem: load_module(p) for p in sorted((bench_dir / "counts").glob("*.py"))}


def per_layer_for(bench: dict, workload: str) -> List[dict]:
    """The per-layer metrics a cell reports: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_for(bench, workload)}
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif m["moves"] in e2e:
            out.append(m)
    return out


def end_to_end_for(bench: dict, workload: str) -> List[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]]


def forbidden_loaded(modules=None) -> List[str]:
    """Names in ``sys.modules`` whose top-level name is a forbidden one."""
    modules = sys.modules if modules is None else modules
    return sorted(n for n in modules if n.split(".", 1)[0] in FORBIDDEN)


def run_env(root: pathlib.Path = ROOT) -> Dict[str, str]:
    """The environment of a run, set before torch is imported: fixed cache
    directories inside the checkout for every builder the program may use;
    the switches that keep libraries from loading JAX; one OpenMP thread a
    process, as torchrun gives every rank (scripts/torch_pretrain.sh starts
    even one card's training through torchrun), so that idle OpenMP threads
    do not spin beside a host-bound step."""
    cache = root / "build" / "port_bench_cache"
    return {"TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
            "TRITON_CACHE_DIR": str(cache / "triton"),
            "USE_FLAX": "0", "USE_JAX": "0", "USE_TF": "0", "OMP_NUM_THREADS": "1"}


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict[str, tuple],
                device: dict, compared: Dict[str, tuple],
                breakdown: Optional[dict] = None) -> str:
    """The last line of a run: metrics as name -> (value, unit), compared as
    name -> (number, limit); ``compared`` comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": {k: {"value": v, "unit": u} for k, (v, u) in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = {k: {"number": n, "limit": lim} for k, (n, lim) in compared.items()}
    return json.dumps(out)


def compared_lines(compared: Dict[str, tuple]) -> str:
    return "\n".join(f"compared {k}: {n!r} (limit {lim!r})" for k, (n, lim) in compared.items())


def log(*parts) -> None:
    print("port_bench:", *parts, file=sys.stderr, flush=True)


def env_rank() -> tuple:
    """(rank, local rank, world) from torchrun's environment, else (0, 0, 1)."""
    return (int(os.environ.get("RANK", 0)), int(os.environ.get("LOCAL_RANK", 0)),
            int(os.environ.get("WORLD_SIZE", 1)))


class Context:
    """One run of one cell: the cell's entries and files, the run's
    arguments, where it runs, and (in tests) a fault planted in the program
    and the sizes of a configuration cut down for the CPU."""

    def __init__(self, workload: dict, config: dict, mix: dict, limits: dict, seed: int,
                 seconds: float, trace: bool, device, started: float, rank: int = 0,
                 world: int = 1, fault: Optional[str] = None, control: bool = False):
        self.workload, self.config, self.mix, self.limits = workload, config, mix, limits
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.started = device, started
        self.rank, self.world = rank, world
        self.fault, self.control = fault, control

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def model_config(self, **loss_type):
        """The program's ModelConfig of this configuration, with the heads given."""
        from mvlt_tpu_torch.config import LossType, ModelConfig

        fields = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in self.config["model"].items()}
        return ModelConfig(**fields, loss_type=LossType(**loss_type))
