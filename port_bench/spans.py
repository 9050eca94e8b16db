"""Readings of the program's own spans (``mvlt.*`` profiler ranges, see
mvlt_tpu_torch/utils/profiling.py) in the traced stretch, per unit. A
program without such spans gives None."""

from __future__ import annotations

from typing import Optional

from port_bench import readers
from port_bench import trace as tr


def host_ms(readings, name: str) -> Optional[float]:
    """Host ms per unit inside the ranges named ``name``, each clipped to
    the window."""
    if readings is None or readings.trace is None:
        return None
    rows = [r for r in readings.trace.host if r.name == name]
    if not rows:
        return None
    w0, w1 = readings.trace.window
    return readers.per_unit_ms(sum(max(0.0, min(r.end, w1) - max(r.start, w0)) for r in rows),
                               readings)


def device_ms(readings, name: str) -> Optional[float]:
    """Device ms per unit of the kernels and sets (copies left out) whose
    launch lies inside a range named ``name``."""
    if readings is None or readings.trace is None:
        return None
    if not any(r.name == name for r in readings.trace.host):
        return None
    rows = tr.attribute(readings.trace, name).get("", [])
    return readers.per_unit_ms(sum(d.dur for d in rows if d.cat != "gpu_memcpy"), readings)
