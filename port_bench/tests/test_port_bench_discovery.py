"""A cell added by new files alone: a throwaway configuration, traffic mix,
limits and per-layer metric beside a copy of the benchmark make a cell that
the harness finds by name and runs, and no file that was there changes."""

import hashlib
import json
import pathlib
import shutil

import torch

from port_bench import common, profiling
from port_bench.tests import micro

ROOT = pathlib.Path(common.__file__).resolve().parents[1]


def digest(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_from_new_files_alone(tmp_path):
    bench_dir = tmp_path / "port_bench"
    shutil.copytree(ROOT / "port_bench", bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(bench_dir)

    cfg = micro.config("pvlt_tiny")
    cfg["name"] = "throwaway_tiny"
    (bench_dir / "configs" / "throwaway_tiny.json").write_text(json.dumps(cfg))
    mix = micro.mix("retrieval_q4")
    mix["queries_per_call"] = 2
    (bench_dir / "traffic" / "throwaway_q2.json").write_text(json.dumps(mix))
    (bench_dir / "limits" / "throwaway_cell.json").write_text(json.dumps(
        {"numbers": {"score_gap": {"limit": 1e-3}, "rank_miss": {"limit": 0}}}))
    (bench_dir / "metrics" / "calls_traced.serve.py").write_text(
        "def read(readings):\n    return float(readings.units) if readings.units else None\n")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "throwaway_cell", "config": "throwaway_tiny",
                               "traffic": "throwaway_q2", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "calls_traced.serve", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "scorer (eval/retrieval.py)",
                               "moves": "serve_pairs_per_s", "workloads": ["throwaway_cell"]})

    cell = common.find(bench["workloads"], "throwaway_cell", "workload")
    found_mix = common.traffic(cell["traffic"], bench_dir)
    ctx = common.Context(cell, common.config(cell["config"], bench_dir), found_mix,
                         common.limits(cell["name"], bench_dir), 2 ** 31 + 5, 0.5, False,
                         torch.device("cpu"), 0.0)
    out = common.driver(found_mix["driver"], bench_dir).run(ctx)
    assert out["correct"], out["compared"]
    assert out["attempted"] % 2 == 0

    names = [m["name"] for m in common.per_layer_for(bench, "throwaway_cell")]
    assert names == ["calls_traced.serve"]
    value = common.metric_reader("calls_traced.serve", bench_dir).read(
        profiling.Readings(units=10))
    assert value == 10.0
    assert digest(bench_dir).items() >= before.items()
    assert set(digest(bench_dir)) - set(before) == {
        "configs/throwaway_tiny.json", "traffic/throwaway_q2.json", "limits/throwaway_cell.json",
        "metrics/calls_traced.serve.py"}
