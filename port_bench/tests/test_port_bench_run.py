"""The run's contract on the CPU: the last line's keys, and the runs that
must print no result and exit with another code than 0."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

from port_bench import common

ROOT = pathlib.Path(common.__file__).resolve().parents[1]


def run(root: pathlib.Path, *extra, env=None):
    return subprocess.run([sys.executable, str(root / "port_bench" / "run.py"), "--workload",
                           "retrieval_v1_q4", "--seed", str(2 ** 31 + 3), "--seconds", "1",
                           "--trace", "0", *extra],
                          capture_output=True, text=True, timeout=300, cwd=root,
                          env=env or dict(os.environ))


def test_result_line_has_the_contract_keys_and_compared_last():
    line = common.result_line(True, 4, 0, {"setup_s": (1.5, "s")},
                              {"platform": "gpu", "kind": "x", "count": 1,
                               "memory_peak_bytes": 7},
                              {"score_gap": (0.01, 0.02)})
    out = json.loads(line)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "compared"
    assert out["metrics"]["setup_s"] == {"value": 1.5, "unit": "s"}
    assert common.compared_lines({"score_gap": (0.01, 0.02)}) == \
        "compared score_gap: 0.01 (limit 0.02)"


def test_no_card_no_result():
    """Without a card (as here) the run exits with another code than 0 and
    prints nothing on standard output."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = run(ROOT, env=env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the files under paths, the
    run exits with another code than 0 and prints nothing on standard output."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = run(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_benchmark_json_names_files_that_exist():
    bench = common.benchmark()
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert common.config(c["name"])["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        mix = common.traffic(w["traffic"])
        assert (common.BENCH_DIR / "drivers" / f"{mix['driver']}.py").is_file()
        assert common.limits(w["name"])["numbers"]
        for m in common.per_layer_for(bench, w["name"]):
            assert (common.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
