"""The readers of the program's own spans on a canned profiler trace.

The canned trace (times in microseconds): a window 0-100 on host thread 1,
two scorer calls. ``mvlt.retrieval.h2d`` at -10-10 (clipped to 10) and
50-60: 20 in all. ``mvlt.retrieval.forward`` at 20-40 and 60-70: 30.
``mvlt.retrieval.readback`` at 40-45 and 90-120 (clipped to 10): 15.
``mvlt.model.embed`` at 20-25 launches kernel K1 (device 30-40) and a copy
(left out), at 60-62 a set (70-75), at 95-99 kernel K3 (98-110, clipped to
98-100); kernel K2, launched at 30 outside every embed range, is left
out: 17 of device time.
"""

import pytest

from port_bench import common, profiling
from port_bench import trace as tr


def ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
            "args": args}


BASE = [
    ev("port_bench.window", "user_annotation", 0, 100),
    ev("cudaLaunchKernel", "cuda_runtime", 30, 1, correlation=2),
    ev("K2", "kernel", 41, 5, tid=7, correlation=2, stream=7),
]
SPANS = [
    ev("mvlt.retrieval.h2d", "user_annotation", -10, 20),
    ev("mvlt.retrieval.h2d", "user_annotation", 50, 10),
    ev("mvlt.retrieval.forward", "user_annotation", 20, 20),
    ev("mvlt.retrieval.forward", "user_annotation", 60, 10),
    ev("mvlt.retrieval.readback", "user_annotation", 40, 5),
    ev("mvlt.retrieval.readback", "user_annotation", 90, 30),
    ev("mvlt.model.embed", "user_annotation", 20, 5),
    ev("cudaLaunchKernel", "cuda_runtime", 21, 1, correlation=1),
    ev("K1", "kernel", 30, 10, tid=7, correlation=1, stream=7),
    ev("cudaMemcpyAsync", "cuda_runtime", 22, 1, correlation=3),
    ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 46, 4, tid=8, correlation=3, stream=7),
    ev("mvlt.model.embed", "user_annotation", 60, 2),
    ev("cudaMemsetAsync", "cuda_runtime", 61, 1, correlation=4),
    ev("Memset (Device)", "gpu_memset", 70, 5, tid=7, correlation=4, stream=7),
    ev("mvlt.model.embed", "user_annotation", 95, 4),
    ev("cudaLaunchKernel", "cuda_runtime", 96, 1, correlation=5),
    ev("K3", "kernel", 98, 12, tid=7, correlation=5, stream=7),
]
WANT = {"copy_host_ms.serve": 20e-3 / 2, "launch_ms.serve": 30e-3 / 2,
        "wait_ms.serve": 15e-3 / 2, "embed_ms.serve": 17e-3 / 2}


def read(name, events, units=2):
    readings = profiling.Readings(trace=tr.load(events), units=units)
    return common.metric_reader(name).read(readings)


@pytest.mark.parametrize("name", sorted(WANT))
def test_span_readers_clip_to_the_window_and_divide_by_units(name):
    assert read(name, BASE + SPANS) == pytest.approx(WANT[name])
    assert read(name, BASE + SPANS, units=4) == pytest.approx(WANT[name] / 2)


@pytest.mark.parametrize("name", sorted(WANT))
def test_span_readers_give_none_without_spans(name):
    assert read(name, BASE) is None
    assert common.metric_reader(name).read(profiling.Readings()) is None
    assert common.metric_reader(name).read(None) is None
    assert read(name, BASE + SPANS, units=0) is None
