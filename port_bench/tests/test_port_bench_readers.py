"""The trace reductions and metric readers on a canned profiler trace.

The canned trace (times in microseconds): a window 0-100 on host thread 1;
an op range ``port_bench.op::fused_block`` 10-30 that launches kernel K1
(device 12-22) and a glue range launching K2 (40-50), overlapped by a copy
(45-60); an NCCL kernel (55-75) of which 55-60 is covered by the copy only
and 70-75 by kernel K3 (70-80). Busy: 12-22, 40-80 = 50 of 100. Exposed
NCCL time (not under another kernel): 55-70 = 15.
"""

import pytest

from port_bench import common, profiling, readers
from port_bench import trace as tr


def ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
            "args": args}


EVENTS = [
    ev("port_bench.window", "user_annotation", 0, 100),
    ev("port_bench.op::fused_block", "user_annotation", 10, 20),
    ev("cuLaunchKernelEx", "cuda_driver", 11, 1, correlation=1),
    ev("K1", "kernel", 12, 10, tid=7, correlation=1, stream=7),
    ev("aten::add", "cpu_op", 38, 4),
    ev("cudaLaunchKernel", "cuda_runtime", 39, 1, correlation=2),
    ev("K2", "kernel", 40, 10, tid=7, correlation=2, stream=7),
    ev("cudaMemcpyAsync", "cuda_runtime", 44, 1, correlation=3),
    ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 45, 15, tid=8, correlation=3, stream=8),
    ev("ncclDevKernel_AllReduce_Sum_f32", "kernel", 55, 20, tid=9, correlation=4, stream=9),
    ev("K3", "kernel", 70, 10, tid=7, correlation=5, stream=7),
    ev("outside", "kernel", 200, 10, tid=7, correlation=6, stream=7),
]


@pytest.fixture()
def trace():
    return tr.load(EVENTS)


def test_union_and_busy(trace):
    assert tr.union([(5, 10), (0, 3), (2, 4), (9, 12)]) == [(0, 4), (5, 12)]
    assert trace.window == (0.0, 100.0)
    assert tr.busy_us(trace) == pytest.approx(50.0)


def test_exposed_nccl(trace):
    assert tr.exposed_nccl_us(trace) == pytest.approx(15.0)


def test_attribution_to_op_ranges(trace):
    owned = tr.attribute(trace)
    assert [d.name for d in owned["fused_block"]] == ["K1"]
    assert sorted(d.name for d in owned[None]) == sorted(
        ["K2", "Memcpy HtoD (Pinned -> Device)", "ncclDevKernel_AllReduce_Sum_f32", "K3"])


def test_idle_gaps_name_the_host(trace):
    gaps = dict((k, v) for k, v in tr.idle_gaps(trace))
    # 0-12 and 22-40 and 80-100: the op range covers 10-30 (the middle of
    # 0-12 is 6, of 22-40 is 31, of 80-100 is 90: none under a range)
    assert sum(gaps.values()) == pytest.approx(50e-6)


def readings(trace, **kw):
    r = profiling.Readings(trace=trace, units=2, spans={"data_wait": [0.001, 0.003]},
                           model_flops=2 * common.PEAK_FLOPS_BF16 * 100e-6 * 0.25,
                           op_calls={"fused_block": [(common.PEAK_FLOPS_BF16 * 5e-6, 0.0)]})
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def test_metric_readers(trace):
    r = readings(trace)
    assert readers.idle_share(r) == pytest.approx(50.0)
    assert readers.comm_exposed_ms(r) == pytest.approx(15e-3 / 2)
    assert readers.span_mean_ms(r, "data_wait") == pytest.approx(2.0)
    assert readers.h2d_ms(r) == pytest.approx(15e-3 / 2)
    # glue: K2 and K3 outside the op ranges (copies and NCCL left out)
    assert readers.glue_ms(r) == pytest.approx(20e-3 / 2)
    # fused_block: 5 us of roofline over 10 us of device time
    assert readers.kernel_roofline(r) == pytest.approx(50.0)
    assert readers.mfu(r) == pytest.approx(50.0)
    r.chips = 2
    assert readers.mfu(r) == pytest.approx(25.0)


def test_readers_find_nothing_without_a_trace():
    empty = profiling.Readings()
    for fn in (readers.idle_share, readers.comm_exposed_ms, readers.glue_ms, readers.h2d_ms,
               readers.kernel_roofline, readers.mfu):
        assert fn(empty) is None
    assert readers.span_mean_ms(empty, "data_wait") is None


def test_metric_files_read_through_the_readers(trace):
    bench = common.benchmark()
    values = readers.per_layer_values(bench, "retrieval_v1_q4", readings(trace))
    assert set(values) <= {m["name"] for m in common.per_layer_for(bench, "retrieval_v1_q4")}
    assert values["idle_share.serve"] == pytest.approx(50.0)
