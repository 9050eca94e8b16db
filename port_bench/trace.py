"""Reductions of a torch.profiler trace (its Chrome trace JSON) that the
metric readers share.

A ``Trace`` holds the device's intervals (kernels, copies, sets) inside the
traced window, each tied through its launch's correlation id to the host
thread and time of the launch, and the host's ranges (record_function
annotations and operators). Times are microseconds as the trace gives them.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
OP_PREFIX = "port_bench.op::"
WINDOW = "port_bench.window"


@dataclass
class DeviceEvent:
    name: str
    cat: str
    start: float
    end: float
    stream: int
    launch_tid: Optional[int] = None
    launch_ts: Optional[float] = None
    args: dict = field(default_factory=dict)

    @property
    def dur(self) -> float:
        return self.end - self.start

    @property
    def is_nccl(self) -> bool:
        return self.cat == "kernel" and "nccl" in self.name.lower()


@dataclass
class HostRange:
    name: str
    cat: str
    tid: int
    start: float
    end: float


@dataclass
class Trace:
    window: Tuple[float, float]
    device: List[DeviceEvent]
    host: List[HostRange]
    main_tid: Optional[int] = None

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def ranges(self, prefix: str) -> List[HostRange]:
        return [r for r in self.host if r.name.startswith(prefix)]


def load(path_or_events, window_name: str = WINDOW) -> Trace:
    """A ``Trace`` from a Chrome trace file (or its event list), clipped to
    the span of the host range named ``window_name`` (the whole trace if
    there is none)."""
    if isinstance(path_or_events, (list, tuple)):
        events = list(path_or_events)
    else:
        with open(path_or_events) as f:
            events = json.load(f)["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    launches = {}
    for e in xs:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e["tid"], float(e["ts"]))
    host = [HostRange(e["name"], e["cat"], e["tid"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in xs if e.get("cat") in HOST_CATS]
    win = [r for r in host if r.name == window_name]
    if win:
        w0, w1 = min(r.start for r in win), max(r.end for r in win)
        main_tid = win[0].tid
    else:
        stamps = [float(e["ts"]) for e in xs] + [float(e["ts"]) + float(e["dur"]) for e in xs]
        w0, w1 = (min(stamps), max(stamps)) if stamps else (0.0, 0.0)
        main_tid = None
    device = []
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if t <= w0 or s >= w1:
            continue
        args = e.get("args", {})
        tid, ts = launches.get(args.get("correlation"), (None, None))
        device.append(DeviceEvent(e["name"], e["cat"], max(s, w0), min(t, w1),
                                  int(args.get("stream", -1)), tid, ts, args))
    device.sort(key=lambda d: d.start)
    return Trace((w0, w1), device, host, main_tid)


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted, non-overlapping intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def total(intervals: Iterable[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in intervals)


def busy_us(trace: Trace) -> float:
    """Microseconds of the window in which any kernel, copy or set ran."""
    return total(union((d.start, d.end) for d in trace.device))


def subtract(intervals: List[Tuple[float, float]], cover: List[Tuple[float, float]]) -> float:
    """The length of ``intervals`` (merged) not covered by ``cover`` (merged)."""
    left = 0.0
    for s, e in union(intervals):
        covered = 0.0
        i = bisect.bisect_left(cover, (s, s)) - 1
        i = max(i, 0)
        while i < len(cover) and cover[i][0] < e:
            cs, ce = cover[i]
            covered += max(0.0, min(e, ce) - max(s, cs))
            i += 1
        left += (e - s) - covered
    return left


def exposed_nccl_us(trace: Trace) -> float:
    """NCCL kernel time not overlapped by any other kernel."""
    nccl = [(d.start, d.end) for d in trace.device if d.is_nccl]
    compute = union((d.start, d.end) for d in trace.device if d.cat == "kernel" and not d.is_nccl)
    return subtract(nccl, compute)


def innermost(ranges: List[HostRange], points: List[float]) -> List[Optional[HostRange]]:
    """For each of ``points`` the latest-starting range of ``ranges`` (one
    thread's, so properly nested) that contains it, or None: one sweep with
    a stack of the open ranges."""
    order = sorted(range(len(points)), key=lambda k: points[k])
    ranges = sorted(ranges, key=lambda r: (r.start, -r.end))
    out: List[Optional[HostRange]] = [None] * len(points)
    stack: List[HostRange] = []
    i = 0
    for k in order:
        p = points[k]
        while i < len(ranges) and ranges[i].start <= p:
            while stack and stack[-1].end < ranges[i].start:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1].end < p:
            stack.pop()
        out[k] = stack[-1] if stack else None
    return out


def attribute(trace: Trace, prefix: str = OP_PREFIX) -> Dict[Optional[str], List[DeviceEvent]]:
    """Device events by the innermost host range named ``prefix`` + wrapper
    that encloses their launch on the launching thread (None: no such range)."""
    by_tid: Dict[int, List[HostRange]] = {}
    for r in trace.ranges(prefix):
        by_tid.setdefault(r.tid, []).append(r)
    owners: Dict[int, Optional[HostRange]] = {}
    for tid, rs in by_tid.items():
        mine = [k for k, d in enumerate(trace.device)
                if d.launch_tid == tid and d.launch_ts is not None]
        for k, r in zip(mine, innermost(rs, [trace.device[k].launch_ts for k in mine])):
            owners[k] = r
    out: Dict[Optional[str], List[DeviceEvent]] = {}
    for k, d in enumerate(trace.device):
        r = owners.get(k)
        out.setdefault(r.name[len(prefix):] if r is not None else None, []).append(d)
    return out


def idle_gaps(trace: Trace, top: int = 10) -> List[list]:
    """The device's idle time in the window, summed by what the main host
    thread was doing at each gap's middle (its innermost range), longest
    first."""
    busy = union((d.start, d.end) for d in trace.device)
    gaps, at = [], trace.window[0]
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if trace.window[1] > at:
        gaps.append((at, trace.window[1]))
    ranges = [r for r in trace.host if r.tid == trace.main_tid and r.name != WINDOW]
    sums: Dict[str, float] = {}
    for (s, e), inner in zip(gaps, innermost(ranges, [0.5 * (s + e) for s, e in gaps])):
        name = inner.name if inner is not None else "host: outside any range"
        sums[name] = sums.get(name, 0.0) + (e - s)
    return [[k, v * 1e-6] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]


def device_ops(trace: Trace, top: int = 10) -> List[list]:
    """Device time in seconds by operation name, longest first."""
    sums: Dict[str, float] = {}
    for d in trace.device:
        sums[d.name] = sums.get(d.name, 0.0) + d.dur
    return [[k, v * 1e-6] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]
