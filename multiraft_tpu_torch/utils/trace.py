"""Structured tracing: Chrome-trace (catapult JSON) event capture.

A copy of ``multiraft_tpu/utils/trace.py`` for the PyTorch port, which
imports nothing of the reference package.  Attach a :class:`Tracer` to
an :class:`~multiraft_tpu_torch.engine.host.EngineDriver` and every
device tick becomes a span carrying its metrics.  Export with
:meth:`Tracer.save` and open in ``chrome://tracing`` / Perfetto.

Timestamps are microseconds of the host's wall clock.
"""

from __future__ import annotations

import gzip
import json
from typing import Any, Dict, List, Tuple

__all__ = ["Tracer"]


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
