"""Shared arithmetic of the per-layer metric readers (metrics/<name>.py), and
the loop that asks each reader of a cell for its value."""

from __future__ import annotations

from typing import Dict, Optional

from port_bench import common
from port_bench import trace as tr


def per_layer_values(bench: dict, workload: str, readings) -> Dict[str, float]:
    """name -> value of every per-layer metric of the cell whose reader finds
    something to read; a reader that returns None is left out."""
    out = {}
    for m in common.per_layer_for(bench, workload):
        value = common.metric_reader(m["name"]).read(readings) if readings is not None else None
        if value is not None:
            out[m["name"]] = value
    return out


def per_unit_ms(total_us: float, readings) -> Optional[float]:
    if readings is None or readings.trace is None or readings.units <= 0:
        return None
    return total_us * 1e-3 / readings.units


def span_mean_ms(readings, key: str) -> Optional[float]:
    if readings is None or not readings.spans.get(key):
        return None
    rows = readings.spans[key]
    return 1e3 * sum(rows) / len(rows)


def glue_ms(readings) -> Optional[float]:
    """Device ms per unit of kernels and sets launched outside every op
    wrapper's call (copies and NCCL left out)."""
    if readings is None or readings.trace is None:
        return None
    rows = readings.by_wrapper().get(None, [])
    return per_unit_ms(sum(d.dur for d in rows if d.cat != "gpu_memcpy" and not d.is_nccl),
                       readings)


def h2d_ms(readings) -> Optional[float]:
    if readings is None or readings.trace is None:
        return None
    rows = [d for d in readings.trace.device if d.cat == "gpu_memcpy" and "HtoD" in d.name]
    return per_unit_ms(sum(d.dur for d in rows), readings) if rows else None


def kernel_roofline(readings) -> Optional[float]:
    """100 x summed roofline time / summed device time over the counted op
    wrappers' calls."""
    if readings is None or readings.trace is None:
        return None
    roof = readings.roofline()
    t_roof = sum(r[0] for r in roof.values())
    t_dev = sum(r[1] for r in roof.values())
    return 100.0 * t_roof / t_dev if t_dev > 0 else None


def mfu(readings) -> Optional[float]:
    """100 x model FLOPs completed in the stretch / (its seconds x the peak of
    every chip)."""
    if readings is None or readings.trace is None or readings.model_flops <= 0:
        return None
    return 100.0 * readings.model_flops / (readings.window_s * common.PEAK_FLOPS_BF16
                                           * readings.chips)


def idle_share(readings) -> Optional[float]:
    if readings is None or readings.trace is None or readings.window_s <= 0:
        return None
    return 100.0 * (1.0 - readings.busy_s / readings.window_s)


def comm_exposed_ms(readings) -> Optional[float]:
    if readings is None or readings.trace is None:
        return None
    if not any(d.is_nccl for d in readings.trace.device):
        return None
    return per_unit_ms(tr.exposed_nccl_us(readings.trace), readings)
