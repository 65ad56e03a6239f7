"""A traced stretch: ``torch.profiler`` over a few steady ticks of the
window, read back from its Chrome trace.

:class:`Stretch` holds what the per-layer readers and the result line
take from it: the device operations (kernels, copies, fills) with their
times, the host's operations, the benchmark's own spans
(``cellbench.*``), the stretch's wall window and the device's busy time
in it, and the breakdown of device time by operation and of idle time
by what the host was doing.

A stretch traced with the device's activity alone has no host events:
its window runs from its first device operation's start to its last
one's end (``window="device"``).  A stretch traced with the host's
activity too takes its window from the benchmark's span around it
(``window="span"``).
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
STRETCH_SPAN = "cellbench.stretch"

Interval = Tuple[float, float]  # start, end in microseconds


@dataclass
class Stretch:
    ticks: int
    window: Interval
    device_ops: List[Tuple[str, str, float, float]]  # cat, name, ts, dur (us)
    host_ops: List[Tuple[str, float, float]]  # name, ts, dur (us)
    kernel_calls: Dict[str, list] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def kernels(self, substring: str) -> List[Tuple[float, float]]:
        """(ts, dur) of the kernels whose name holds ``substring``, in
        launch order."""
        return sorted((ts, dur) for cat, name, ts, dur in self.device_ops
                      if cat == "kernel" and substring in name)

    def busy_intervals(self) -> List[Interval]:
        return union(
            (max(ts, self.window[0]), min(ts + dur, self.window[1]))
            for _, _, ts, dur in self.device_ops
        )

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def top_device_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for _, name, _, dur in self.device_ops:
            by[name[:120]] += dur * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle device time summed by what the host was doing at each
        gap's middle: the innermost benchmark span and the innermost host
        operation that cover it."""
        by: Dict[str, float] = defaultdict(float)
        spans = sorted((ts, ts + dur, name) for name, ts, dur in self.host_ops)
        i, active = 0, []
        for a, b in gaps(self.busy_intervals(), self.window):
            mid = (a + b) / 2
            while i < len(spans) and spans[i][0] <= mid:
                active.append(spans[i])
                i += 1
            active = [s for s in active if s[1] > mid]
            covering = [(e - s, name) for s, e, name in active]
            ours = [c for c in covering
                    if c[1].startswith("cellbench.") and c[1] != STRETCH_SPAN]
            ops = [c for c in covering if not c[1].startswith("cellbench.")]
            label = " / ".join(x for x in (
                min(ours)[1] if ours else "", min(ops)[1] if ops else "") if x)
            by[label or "host outside any span"] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def union(intervals) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(iv for iv in intervals if iv[1] > iv[0]):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def gaps(busy: List[Interval], window: Interval) -> List[Interval]:
    out, t = [], window[0]
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if window[1] > t:
        out.append((t, window[1]))
    return out


def export(prof) -> str:
    """Write ``prof``'s Chrome trace to a temporary file and return its
    path.  A stopped profile written out after another profile has
    started reads its device events with zero times (torch 2.11 on an
    H100), so each is written out as soon as it stops."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    prof.export_chrome_trace(path)
    return path


def read_trace(path: str, ticks: int, window: str = "span") -> Stretch:
    """Read the Chrome trace at ``path`` and delete the file."""
    try:
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return from_events(events, ticks, window)


def from_events(events: list, ticks: int, window: str = "span") -> Stretch:
    if window not in ("span", "device"):
        raise ValueError(f"window is 'span' or 'device', not {window!r}")
    device, host, span = [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((cat, name, ts, dur))
        elif cat in HOST_CATS:
            host.append((name, ts, dur))
            if name == STRETCH_SPAN and cat == "user_annotation":
                span = (ts, ts + dur)
    if window == "device":
        if not device:
            raise RuntimeError("the trace holds no device operation")
        span = (min(ts for _, _, ts, _ in device), max(ts + d for _, _, ts, d in device))
    if span is None:
        raise RuntimeError(f"the trace holds no {STRETCH_SPAN!r} span")
    return Stretch(ticks=ticks, window=span, device_ops=device, host_ops=host)
