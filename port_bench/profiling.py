"""The traced span of a ``--trace 1`` run and what the metric readers read.

``TracedSpan`` starts torch.profiler (host and device activities) around a
steady stretch of the window, opens the host range ``port_bench.window``
around it, taps the op wrappers (ops_tap.py), and on ``stop`` reduces the
exported Chrome trace to a ``trace.Trace``. ``Readings`` carries the trace
and the benchmark's own counts of that stretch to the metric readers.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from port_bench import common
from port_bench import trace as tr


@dataclass
class Readings:
    """What one traced stretch gives the per-layer metric readers."""

    trace: Optional[tr.Trace] = None
    units: int = 0                  # steps or scorer calls completed in the stretch
    spans: Dict[str, List[float]] = field(default_factory=dict)   # host seconds
    model_flops: float = 0.0        # model FLOPs of the work completed in it
    op_calls: Dict[str, list] = field(default_factory=dict)     # wrapper -> [(flops, bytes)]
    uncounted: Dict[str, int] = field(default_factory=dict)
    chips: int = 1
    busy_s_ranks: List[float] = field(default_factory=list)   # every rank's, DDP

    @property
    def window_s(self) -> float:
        return self.trace.window_us * 1e-6 if self.trace is not None else 0.0

    @property
    def busy_s(self) -> float:
        return tr.busy_us(self.trace) * 1e-6

    @property
    def busy_s_mean(self) -> float:
        """Device-busy seconds averaged over the chips of the run."""
        ranks = self.busy_s_ranks or [self.busy_s]
        return sum(ranks) / len(ranks)

    def by_wrapper(self) -> Dict[Optional[str], list]:
        if not hasattr(self, "_attributed"):
            self._attributed = tr.attribute(self.trace)
        return self._attributed

    def roofline(self) -> Dict[str, tuple]:
        """wrapper -> (roofline seconds, device seconds, calls) over the
        counted wrappers' calls in the stretch."""
        out = {}
        owned = self.by_wrapper()
        for name, rows in self.op_calls.items():
            t_roof = sum(max(f / common.PEAK_FLOPS_BF16, b / common.PEAK_BYTES) for f, b in rows)
            t_dev = sum(d.dur for d in owned.get(name, [])) * 1e-6
            out[name] = (t_roof, t_dev, len(rows))
        return out

    def breakdown(self) -> dict:
        return {"device_ops": [[n[:160], s] for n, s in tr.device_ops(self.trace)],
                "idle_gaps": [[n[:160], s] for n, s in tr.idle_gaps(self.trace)]}

    def describe(self) -> List[str]:
        """Lines for standard error: launches and device time per wrapper, each
        counted wrapper's roofline share, wrappers without a count."""
        lines = [f"traced stretch: {self.units} units in {self.window_s!r} s, device busy "
                 f"{self.busy_s!r} s, model FLOPs {self.model_flops!r}"]
        owned = self.by_wrapper()
        for name, (t_roof, t_dev, n) in sorted(self.roofline().items()):
            share = 100.0 * t_roof / t_dev if t_dev > 0 else float("nan")
            lines.append(f"op {name}: {n} calls, device {t_dev * 1e3!r} ms, roofline "
                         f"{t_roof * 1e3!r} ms, share {share!r} %")
        for name, n in sorted(self.uncounted.items()):
            t_dev = sum(d.dur for d in owned.get(name, [])) * 1e-6
            lines.append(f"op {name}: {n} calls, device {t_dev * 1e3!r} ms, no count file: "
                         f"left out of kernel_roofline")
        glue = sum(d.dur for d in owned.get(None, []) if d.cat != "gpu_memcpy") * 1e-6
        lines.append(f"outside the op wrappers: device {glue * 1e3!r} ms")
        return lines


class TracedSpan:
    def __init__(self, device):
        self.device = device
        self.prof = None
        self.tap = None
        self._rf = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        from port_bench.ops_tap import OpTap

        self.tap = OpTap(common.count_modules())
        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self._rf = record_function(tr.WINDOW)
        self._rf.__enter__()
        self.tap.active = True

    def stop(self) -> tr.Trace:
        import torch

        torch.cuda.synchronize(self.device)
        self.tap.active = False
        self._rf.__exit__(None, None, None)
        self.prof.stop()
        self.tap.restore()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="port_bench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            return tr.load(path)
        finally:
            os.remove(path)

    def readings(self, trace: tr.Trace, units: int, spans: Dict[str, List[float]],
                 model_flops: float, chips: int = 1) -> Readings:
        """The stretch's readings; op counts held as device tensors are read now."""
        calls = {}
        for name, rows in self.tap.calls.items():
            calls[name] = [(float(f), float(b)) for f, b in rows]
        return Readings(trace, units, spans, model_flops, calls, dict(self.tap.uncounted), chips)
