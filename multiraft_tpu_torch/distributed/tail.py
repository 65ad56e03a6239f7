"""Per-request lifecycle exemplars with tail-based sampling.

Every aggregate the observability plane keeps (stage histograms, CPU
segment clocks, flight records) answers "how is the fleet doing" —
none can answer "which requests make up the p99.9 and where did EACH
of them wait".  This module is the tail microscope ("The Tail at
Scale", Dean & Barroso; Dapper-style tail sampling): the serving path
accumulates a compact per-request lifecycle record (the StageClock's
stage vector split into queue WAITS vs work, plus admission outcome,
engine tick id, and ambient queue context at completion), and a
bounded per-process :class:`TailStore` retains:

* **guaranteed**: every request whose total exceeds ``MRT_TAIL_SLO_MS``
  (up to ``MRT_TAIL_SLO_CAP``; overflow is counted, never silently
  dropped from the books);
* **windowed top-k**: the ``MRT_TAIL_TOPK`` slowest since the last
  drain, even when under the SLO (the tail is interesting relative to
  its window, not only to a fixed bound);
* **reservoir**: a uniform ``MRT_TAIL_RESERVOIR``-sized sample of
  ALL completed requests — the baseline the outliers are read against.

Drain semantics mirror ``Obs.profile``: ``Obs.tail`` (chaos-exempt,
loop-thread) drains-on-read by default so fleet scrapes window
naturally; ``{"reset": false}`` peeks non-destructively (bundles use
this — evidence collection must not consume the evidence).

Crash path: retained over-SLO completions and every new window-slowest
are breadcrumbed as TAIL flight records (code=dominant-wait,
a=total_us, b=wait_us, c=tick_id, tag=rid), so a SIGKILL'd process's
ring still names its slowest request and the queue it died waiting in
(past the SLO cap only new-slowest rings — at saturation a record per
completion would just wrap the ring at flush-stage CPU cost).

The queue-wait vocabulary (``WAITS``) is shared verbatim with the
stage clocks: wire / dispatch / pump / flush are the parked states,
handler / engine / ack are work.  ``dominant_wait`` of an exemplar is
the largest of the four waits — the attribution loadcurve and the
postmortem doctor report.
"""

from __future__ import annotations

import heapq
import random
import threading
from typing import Any, Dict, List, Optional

from ..utils.knobs import knob_bool, knob_float, knob_int
from . import flightrec

__all__ = [
    "WAITS",
    "WORK",
    "TailStore",
    "tail_enabled",
    "dominant_wait",
    "exemplar_from_clock",
    "merge_drains",
]

# Queue-wait vs work split of the StageClock vocabulary (observe.py
# STAGES plus the pump wait the engine services contribute).  Codes
# come from flightrec.TAIL_WAIT_CODES so ring records and live drains
# agree.
WAITS = ("wire", "dispatch", "pump", "flush")
WORK = ("handler", "engine", "ack")

_TAIL = knob_bool("MRT_TAIL")


def tail_enabled() -> bool:
    """Process-wide kill switch, read once at import (the A/B lever
    for the overhead benchmark, like ``stageclock_enabled``)."""
    return _TAIL


def dominant_wait(ex: Dict[str, Any]) -> str:
    """The wait stage this exemplar parked longest in; ``"work"`` when
    every wait is zero (a purely CPU-bound request has no queue to
    blame)."""
    waits = ex.get("waits") or {}
    best, best_v = "work", 0.0
    for w in WAITS:
        v = waits.get(w, 0.0) or 0.0
        if v > best_v:
            best, best_v = w, v
    return best


def exemplar_from_clock(
    st: Any,
    outcome: str = "ok",
    ambient: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Finalize a completed StageClock (flush already folded) into a
    codec-safe exemplar dict.

    The engine stage straddles a queue: the proposal is parked until
    the next fused pump tick picks it up (``st.pump_wait_s``, stamped
    by the engine services), then does real device work.  The split
    here subtracts the pump wait from the engine stage so ``waits``
    and ``work`` partition the lifecycle instead of double counting.
    """
    vec = st.vec or {}
    engine = max(0.0, vec.get("engine", 0.0))
    pump = max(0.0, st.pump_wait_s)
    if engine:
        pump = min(pump, engine)
    waits = {
        "wire": max(0.0, vec.get("wire", 0.0)),
        "dispatch": max(0.0, vec.get("dispatch", 0.0)),
        "pump": pump,
        "flush": max(0.0, vec.get("flush", 0.0)),
    }
    ex: Dict[str, Any] = {
        "rid": st.rid,
        "outcome": outcome,
        "total_s": round(max(0.0, st.last - st.t0), 6),
        "tick": st.tick,
        "stages": {k: round(v, 6) for k, v in vec.items()},
        "waits": {k: round(v, 6) for k, v in waits.items()},
        "work": {
            "handler": round(max(0.0, vec.get("handler", 0.0)), 6),
            "engine": round(max(0.0, engine - pump), 6),
            "ack": round(max(0.0, vec.get("ack", 0.0)), 6),
        },
    }
    if ambient:
        ex["ambient"] = ambient
    return ex


class TailStore:
    """Bounded per-process exemplar store; ``offer`` runs on the
    node's loop thread, ``drain``/``snapshot`` via the Obs verb (also
    loop-thread) — the lock exists for direct test access and the
    blocking facades."""

    def __init__(
        self,
        slo_ms: Optional[float] = None,
        reservoir: Optional[int] = None,
        topk: Optional[int] = None,
        slo_cap: Optional[int] = None,
        frec: Optional[Any] = None,
        seed: int = 0x7A11,
    ) -> None:
        self.slo_s = (slo_ms if slo_ms is not None
                      else knob_float("MRT_TAIL_SLO_MS")) / 1e3
        self.reservoir_n = (reservoir if reservoir is not None
                            else knob_int("MRT_TAIL_RESERVOIR"))
        self.topk_n = topk if topk is not None else knob_int("MRT_TAIL_TOPK")
        self.slo_cap = (slo_cap if slo_cap is not None
                        else knob_int("MRT_TAIL_SLO_CAP"))
        self.frec = frec
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._slo: List[Dict[str, Any]] = []
        # Min-heap of (total_s, tiebreak, exemplar): the k slowest of
        # the window; the tiebreak keeps heapq off dict comparisons.
        self._topk: List[Any] = []
        self._res: List[Dict[str, Any]] = []
        self._seen = 0          # completions this window
        self._seen_total = 0    # completions since creation
        self._over_slo = 0      # over-SLO this window
        self._dropped_slo = 0   # over-SLO past the cap this window
        self._slowest_s = 0.0   # slowest total this window (breadcrumb)
        self._tie = 0

    # -- capture ------------------------------------------------------------

    def offer(self, ex: Dict[str, Any]) -> None:
        """Submit one completed request's lifecycle record.  ``ex`` is
        a plain dict (already codec-safe): at least ``rid``, ``total_s``
        and ``waits``; stage/ambient fields ride along untouched."""
        self.offer_deferred(float(ex.get("total_s") or 0.0), lambda: ex)

    def offer_deferred(self, total_s: float, build: Any) -> None:
        """Like :meth:`offer`, but the exemplar dict is only
        materialized (``build()``) when this completion will actually
        be retained or breadcrumbed — retention is decided from the
        total alone.  The serve path's flush loop uses this: at total
        saturation nearly every completion is over-SLO and past the
        cap, and it must cost one lock and three counter bumps, not a
        three-dict lifecycle record that is immediately dropped.

        Breadcrumb discipline (outside the lock — the ring has its
        own): retained over-SLO offers and every new window-slowest
        ring; a capped over-SLO offer that is not the new slowest does
        not, so saturation cannot turn the flush stage into a
        ring-writing loop while a SIGKILL'd process still names its
        slowest request."""
        total = float(total_s)
        ex = None
        stored_over = False
        with self._lock:
            self._seen += 1
            self._seen_total += 1
            over = total > self.slo_s
            if over:
                self._over_slo += 1
                if len(self._slo) < self.slo_cap:
                    ex = build()
                    self._slo.append(ex)
                    stored_over = True
                else:
                    self._dropped_slo += 1
            else:
                self._tie += 1
                want_topk = (len(self._topk) < self.topk_n
                             or (self._topk and total > self._topk[0][0]))
                if len(self._res) < self.reservoir_n:
                    res_j = len(self._res)
                elif self.reservoir_n > 0:
                    j = self._rng.randrange(self._seen)
                    res_j = j if j < self.reservoir_n else -1
                else:
                    res_j = -1
                if want_topk or res_j >= 0:
                    ex = build()
                if want_topk:
                    if len(self._topk) < self.topk_n:
                        heapq.heappush(self._topk, (total, self._tie, ex))
                    else:
                        heapq.heapreplace(self._topk,
                                          (total, self._tie, ex))
                if res_j >= 0:
                    if res_j == len(self._res):
                        self._res.append(ex)
                    else:
                        self._res[res_j] = ex
            new_slowest = total > self._slowest_s
            if new_slowest:
                self._slowest_s = total
        if self.frec is not None and (stored_over or new_slowest):
            if ex is None:
                ex = build()
            w = dominant_wait(ex)
            wait_s = (ex.get("waits") or {}).get(w, 0.0) or 0.0
            self.frec.record(
                flightrec.TAIL,
                code=flightrec.TAIL_WAIT_CODES.get(w, 0),
                a=int(total * 1e6), b=int(wait_s * 1e6),
                c=int(ex.get("tick") or 0),
                tag=str(ex.get("rid") or ""),
            )

    # -- read side ----------------------------------------------------------

    def _view(self) -> Dict[str, Any]:
        return {
            "slo_ms": round(self.slo_s * 1e3, 3),
            "seen": self._seen,
            "seen_total": self._seen_total,
            "over_slo": self._over_slo,
            "dropped_slo": self._dropped_slo,
            "slo": list(self._slo),
            "topk": [e for _, _, e in sorted(self._topk, reverse=True)],
            "reservoir": list(self._res),
        }

    def snapshot(self) -> Dict[str, Any]:
        """Non-destructive view (bundle collection peeks with this)."""
        with self._lock:
            return self._view()

    def drain(self) -> Dict[str, Any]:
        """Return the window's exemplars and reset the window — the
        fleet-scrape verb, mirroring the profiler's drain-on-read."""
        with self._lock:
            out = self._view()
            self._slo = []
            self._topk = []
            self._res = []
            self._seen = 0
            self._over_slo = 0
            self._dropped_slo = 0
            self._slowest_s = 0.0
            return out


def merge_drains(drains: List[Optional[Dict[str, Any]]]) -> Dict[str, Any]:
    """Fold per-process ``Obs.tail`` payloads (the ``"tail"`` member)
    into one fleet view: exemplar lists concatenated (slowest first),
    counters summed.  ``None``/missing entries (dead processes, tail
    plane off) are skipped."""
    out: Dict[str, Any] = {
        "seen": 0, "over_slo": 0, "dropped_slo": 0,
        "slo": [], "topk": [], "reservoir": [],
    }
    for d in drains:
        if not isinstance(d, dict):
            continue
        out["seen"] += int(d.get("seen") or 0)
        out["over_slo"] += int(d.get("over_slo") or 0)
        out["dropped_slo"] += int(d.get("dropped_slo") or 0)
        for k in ("slo", "topk", "reservoir"):
            out[k].extend(d.get(k) or [])
    for k in ("slo", "topk"):
        out[k].sort(key=lambda e: -(e.get("total_s") or 0.0))
    return out
