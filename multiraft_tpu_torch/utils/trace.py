"""Structured tracing: Chrome-trace (catapult JSON) event capture.

A copy of ``multiraft_tpu/utils/trace.py`` for the PyTorch port, which
imports nothing of the reference package.  Attach a :class:`Tracer` to
an :class:`~multiraft_tpu_torch.engine.host.EngineDriver` and every
device tick becomes a span carrying its metrics.  Export with
:meth:`Tracer.save` and open in ``chrome://tracing`` / Perfetto.

Timestamps are microseconds of the host's wall clock.

The tick's own phase spans are not :class:`Tracer` events: they go
through ``torch.profiler``'s ``record_function``, the one mechanism whose
host ranges share the device trace's clock, and only while the profiler
records (:func:`phases`, :func:`span`).  :data:`PHASES` keeps the device
time of those phases from CUDA events (:class:`PhaseRecorder`).
"""

from __future__ import annotations

import contextlib
import gzip
import json
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

__all__ = ["Tracer", "PhaseRecorder", "PHASES", "phases", "span"]


class Tracer:
    """Bounded in-memory event buffer in Chrome trace-event format.

    ``max_events`` guards long runs: once full, new events are dropped
    and :attr:`dropped` counts them (a trace that silently self-truncates
    is worse than one that says so).
    """

    def __init__(self, max_events: int = 200_000) -> None:
        self.events: List[Dict[str, Any]] = []
        self.max_events = max_events
        self.dropped = 0

    # -- recording --------------------------------------------------------

    def _emit(self, ev: Dict[str, Any]) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def span(
        self,
        name: str,
        ts_us: float,
        dur_us: float,
        track: str = "main",
        pid: int = 0,
        **args: Any,
    ) -> None:
        """A complete event: ``[ts, ts+dur]`` on ``track``."""
        self._emit(
            {
                "ph": "X",
                "name": name,
                "ts": ts_us,
                "dur": max(dur_us, 0.0),
                "pid": pid,
                "tid": track,
                "args": args,
            }
        )

    def instant(
        self, name: str, ts_us: float, track: str = "main", pid: int = 0, **args: Any
    ) -> None:
        self._emit(
            {
                "ph": "i",
                "s": "t",
                "name": name,
                "ts": ts_us,
                "pid": pid,
                "tid": track,
                "args": args,
            }
        )

    def counter(
        self,
        name: str,
        ts_us: float,
        values: Dict[str, float],
        pid: int = 0,
        track: str = "counters",
    ) -> None:
        """A counter sample (renders as a stacked area in the viewer).

        ``track`` becomes the event's ``tid`` — without one, Perfetto
        lumps every counter onto thread 0 of the process.
        """
        self._emit(
            {
                "ph": "C",
                "name": name,
                "ts": ts_us,
                "pid": pid,
                "tid": track,
                "args": values,
            }
        )

    def process_name(self, pid: int, name: str) -> None:
        """Metadata event: labels ``pid``'s row in the viewer."""
        self._emit(
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid,
                "tid": 0,
                "args": {"name": name},
            }
        )

    def drain(self) -> Tuple[List[Dict[str, Any]], int]:
        """Hand off the buffered events (and drop count) and reset the
        buffer — the scrape protocol: repeated drains never duplicate."""
        evs, dropped = self.events, self.dropped
        self.events, self.dropped = [], 0
        return evs, dropped

    # -- export -----------------------------------------------------------

    def to_json(self) -> Dict[str, Any]:
        meta: Dict[str, Any] = {"displayTimeUnit": "ms"}
        if self.dropped:
            meta["otherData"] = {"dropped_events": self.dropped}
        return {"traceEvents": self.events, **meta}

    def save(self, path: str) -> str:
        """Write catapult JSON; a ``.gz`` suffix selects gzip transport
        (Perfetto opens either, and fleet traces compress ~20x)."""
        if path.endswith(".gz"):
            with gzip.open(path, "wt", encoding="utf-8") as f:
                json.dump(self.to_json(), f)
        else:
            with open(path, "w") as f:
                json.dump(self.to_json(), f)
        return path

    @staticmethod
    def load(path: str) -> Dict[str, Any]:
        """Round-trip loader for :meth:`save` output (either transport).

        Transport is sniffed from the gzip magic bytes, not trusted
        from the suffix — a ``.gz``-named file that is actually plain
        JSON (or vice versa: a crash between rename and write) should
        parse or fail on its CONTENT, with json/gzip's own diagnostic,
        rather than on its name."""
        with open(path, "rb") as fb:
            head = fb.read(2)
        if head == b"\x1f\x8b":
            with gzip.open(path, "rt", encoding="utf-8") as f:
                return json.load(f)
        with open(path, "r") as f:
            return json.load(f)


# -- phase spans inside the tick -------------------------------------------


class PhaseRecorder:
    """Device time of the tick's phases, from CUDA events recorded while
    the profiler records, with no synchronise in the tick.

    A timed tick is a row of events: one at its start, one where each
    phase ends, and one where a nested phase begins, so that the phase
    around it splits in two.  The device time between two consecutive
    events goes to the phase the later event names.  Where the card
    paces the tick that is the phase's device time; where the host
    paces it, the gap is the host's pace.

    Rows group into sessions: a session is a run of consecutive timed
    ticks, ended by a tick that finds the profiler off.  Events come
    from a pool of ``max_events``, made at the first timed tick; when it
    is empty an event is dropped and :attr:`dropped` counts it, and its
    tick is left out of :meth:`read`.  One recorder serves the process,
    as the profiler does, and one thread should tick while it times.
    """

    def __init__(
        self,
        max_events: int = 4096,
        device_types: Tuple[str, ...] = ("cuda",),
        event: Optional[Callable[[], Any]] = None,
    ) -> None:
        self.max_events = max_events
        self.device_types = device_types
        self._event = event or (lambda: torch.cuda.Event(enable_timing=True))
        self._free: Optional[List[Any]] = None  # the pool, made at the first timed tick
        self.dropped = 0
        self.sessions: List[List[list]] = []  # rows of (phase, event)
        self._session: Optional[List[list]] = None
        self._row: Optional[list] = None

    def open_row(self) -> bool:
        """Begin a timed tick; False if one is already open (a tick
        nested in a loop's row joins that row)."""
        if self._row is not None:
            return False
        if self._free is None:
            self._free = [self._event() for _ in range(self.max_events)]
        if self._session is None:
            self._session = []
            self.sessions.append(self._session)
        self._row = []
        self._session.append(self._row)
        self.mark(None)
        return True

    def mark(self, phase: Optional[str]) -> None:
        """Record an event ending ``phase``'s stretch of the open row."""
        if self._row is None:
            return
        ev = self._free.pop() if self._free else None
        if ev is None:
            self.dropped += 1
        else:
            ev.record()
        self._row.append((phase, ev))

    def close_row(self) -> None:
        self._row = None

    def pause(self) -> None:
        """End the open session: a tick ran with the profiler off."""
        self._session = None

    def read(self) -> List[List[Dict[str, float]]]:
        """Per session, each whole tick's device milliseconds by phase.
        Resolves the events, so call it after a synchronise that follows
        the last timed tick."""
        out = []
        for session in self.sessions:
            ticks = []
            for row in session:
                if len(row) < 2 or any(ev is None for _, ev in row):
                    continue
                ms: Dict[str, float] = {}
                for (_, a), (phase, b) in zip(row, row[1:]):
                    ms[phase] = ms.get(phase, 0.0) + a.elapsed_time(b)
                ticks.append(ms)
            out.append(ticks)
        return out


PHASES = PhaseRecorder()


class _Off:
    """What a tick gets while the profiler is off: every call a no-op."""

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None

    def phase(self, name: Optional[str]) -> None:
        return None

    def span(self, name: str) -> "_Off":
        return self


_OFF = _Off()


class TickPhases:
    """One tick's phase spans while the profiler records: ``name``'s
    range (if any) around the tick, one ``record_function`` range per
    phase inside it, and the recorder's events at their ends.  The event
    that ends a phase is recorded once the phase's range has closed, so
    the recorder's own host time falls outside the phase it times."""

    def __init__(self, name: Optional[str], recorder: Optional[PhaseRecorder]) -> None:
        self._name = name
        self._rec = recorder
        self._ranges: List[Any] = []  # open ranges, innermost last
        self._phase: Optional[str] = None
        self._own_row = False

    def __enter__(self) -> "TickPhases":
        if self._rec is not None:
            self._own_row = self._rec.open_row()
        if self._name is not None:
            self._push(self._name)
        return self

    def __exit__(self, *exc: Any) -> None:
        self.phase(None)
        while self._ranges:
            self._ranges.pop().__exit__(None, None, None)
        if self._own_row:
            self._rec.close_row()

    def _push(self, name: str) -> None:
        r = torch.autograd.profiler.record_function(name)
        r.__enter__()
        self._ranges.append(r)

    def _mark(self, phase: str) -> None:
        if self._rec is not None:
            self._rec.mark(phase)

    def phase(self, name: Optional[str]) -> None:
        """End the open phase, if any, and begin ``name`` (None: no
        phase)."""
        if self._phase is not None:
            self._ranges.pop().__exit__(None, None, None)
            self._mark(self._phase)
        self._phase = name
        if name is not None:
            self._push(name)

    @contextlib.contextmanager
    def span(self, name: str):
        """A phase nested in the open one, or one of the tick's own
        outside any: the open phase's time splits around it."""
        if self._phase is not None:
            self._mark(self._phase)
        self._push(name)
        try:
            yield
        finally:
            self._ranges.pop().__exit__(None, None, None)
            self._mark(name)


def phases(device: torch.device, name: Optional[str] = None):
    """The phase spans of a tick on ``device``: a no-op unless
    ``torch.profiler`` records, which is the one flag read it costs.
    While it records, the ticks on a CUDA device are timed by
    :data:`PHASES`."""
    if not torch.autograd.profiler._is_profiler_enabled:
        PHASES.pause()
        return _OFF
    timed = PHASES if device.type in PHASES.device_types else None
    return TickPhases(name, timed)


def span(name: str):
    """A ``record_function`` range named ``name`` while the profiler
    records; otherwise a no-op."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _OFF
    return torch.autograd.profiler.record_function(name)
