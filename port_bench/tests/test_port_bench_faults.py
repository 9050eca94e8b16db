"""The check fails where it must: each cell's control (the plain reference
in float8 put in the program's place) and each fault the cell can have,
planted under a run driven as the benchmark drives it (the look for a chip
skipped, the CPU and a micro size in its place), make ``correct`` false; a
sound run is correct. The limit of ``score_gap`` here is 1e-3 (a float32
micro run, where the program and the reference agree to rounding: about
1e-6 of the head's scale), of ``rank_miss`` 0 in effect (a count).

The faults: ``answer``, a served score altered where it is produced;
``ln_shift`` and ``bias``, a LayerNorm shift and kernel A's kv bias left
out of the program's model alone, as a kernel that drops one would serve;
``rank``, the protocol's host rank step ranking the wrong candidate as the
true pair."""

import pytest

from port_bench import common
from port_bench.tests import micro

CELLS = [w["name"] for w in common.benchmark()["workloads"]]


def outcome(workload, **kw):
    ctx = micro.context(workload, **kw)
    return common.driver(ctx.mix["driver"]).run(ctx)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    out = outcome(workload)
    assert out["correct"], out["compared"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    out = outcome(workload, control=True)
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("fault", ["answer", "ln_shift", "bias", "rank"])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(workload, fault):
    out = outcome(workload, fault=fault)
    assert not out["correct"], out["compared"]
