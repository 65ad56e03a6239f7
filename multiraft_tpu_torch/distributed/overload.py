"""Overload visibility: a periodic watch that turns saturation into
flight-recorder evidence *while it is happening*.

The closed-loop harness never sees queueing collapse — clerks wait for
replies, so offered load self-throttles.  Under open-loop traffic
(benchmarks/openloop.py) an overloaded server grows queues until
latency diverges; before this module the only witnesses were the
post-hoc flight recorder ring and whatever Obs.snapshot happened to be
scraped.  The watch closes that gap: every ``interval`` seconds it

* diffs each ``stage.*_s`` histogram against its previous scrape
  (``Hist.sub`` — the same windowing the fleet aggregator uses) and
  checks the WINDOWED p99 against a per-stage bound, and
* reads the live queue-depth gauges (tcp reply queues, engine dispatch
  backlog, WAL pending — ObsControl.gauges) against their bounds.

A crossing writes an ``OVERLOAD`` record (flightrec.py) naming the
stage or gauge, its value, and its bound; a stage trip additionally
records the deepest queue gauge at that instant (``gauge_ctx``) so the
postmortem doctor can name the first saturated stage *and* the queue
it backed up into — the "queueing collapse" anomaly.  Metrics mirror:
``overload.trips`` counts crossings, ``overload.active`` gauges how
many names are currently over bound (scrapeable mid-run, e.g. by the
load-curve sweep).

Bounds (env-tunable):

* ``MRT_OVERLOAD_P99_MS``   windowed stage-p99 bound, ms (default 100)
* ``MRT_OVERLOAD_REPLYQ``   total queued replies (default 1024)
* ``MRT_OVERLOAD_BACKLOG``  engine dispatch backlog (default 4096)
* ``MRT_OVERLOAD_WAL``      WAL appended-but-unsynced (default 4096)
* ``MRT_OVERLOAD_INTERVAL`` watch period, seconds (default 0.25)
* ``MRT_OVERLOAD_WATCH=0``  disable the watch entirely

The watch runs on the node's scheduler loop (same thread as dispatch),
so reading the loop-thread-only reply queues is safe; each tick costs
a handful of 128-int diffs — far below one pump tick.

Round 8 closes the loop: each tick also feeds a trip count into a
:class:`BrownoutMachine` (healthy → shedding → brownout, with
hysteresis so a p99 oscillating around the bound cannot flap the
state) — but only the trips admission can RELIEVE: post-admission
stage p99s (dispatch/handler/engine/ack/flush) and the queue gauges.
A tripping ``stage.wire`` is ingress parse backlog upstream of the
admission check; it is recorded and counted, but shedding harder
cannot drain it, so letting it drive the machine would pin the node
in brownout with no latency to show for the lost goodput.  The
machine's state drives the admission controller
(admission.py) — tightening the token buckets and the per-connection
dispatch bound as the node browns out, instead of only emitting
OVERLOAD flight records.  State *transitions* get their own OVERLOAD
record (kind "brownout") so the postmortem doctor reports "shedding
engaged" distinctly from "queueing collapse".

* ``MRT_BROWNOUT_UP``    consecutive tripping ticks to escalate (2)
* ``MRT_BROWNOUT_DOWN``  consecutive clean ticks to de-escalate (8)
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..utils.knobs import knob_bool, knob_float, knob_int
from ..utils.metrics import Hist
from . import flightrec
from .observe import ObsControl

__all__ = [
    "OverloadWatch",
    "BrownoutMachine",
    "install_overload_watch",
    "HEALTHY",
    "SHEDDING",
    "BROWNOUT",
]

# Minimum samples in a window before its p99 means anything — a
# two-sample window's "p99" is just its max.
_MIN_WINDOW_COUNT = 20


# -- brownout state machine -------------------------------------------------

HEALTHY, SHEDDING, BROWNOUT = 0, 1, 2

STATE_NAMES = {HEALTHY: "healthy", SHEDDING: "shedding",
               BROWNOUT: "brownout"}


class BrownoutMachine:
    """Overload trips → admission level, with hysteresis.

    One :meth:`update` per watch tick with that tick's trip count.
    Escalation needs ``up`` CONSECUTIVE tripping ticks; de-escalation
    needs ``down`` consecutive clean ones, and each crossing resets the
    opposite streak — a p99 oscillating around its bound (trip, clean,
    trip, clean, ...) can therefore neither escalate nor de-escalate:
    the state holds instead of flapping.  Pure and clock-free so the
    unit tests drive it tick by tick."""

    def __init__(self, up: Optional[int] = None,
                 down: Optional[int] = None) -> None:
        self.up = max(1, int(up if up is not None
                             else knob_int("MRT_BROWNOUT_UP")))
        self.down = max(1, int(down if down is not None
                               else knob_int("MRT_BROWNOUT_DOWN")))
        self.state = HEALTHY
        self._over = 0   # consecutive tripping ticks
        self._under = 0  # consecutive clean ticks

    def update(self, trips: int) -> int:
        if trips > 0:
            self._over += 1
            self._under = 0
            if self._over >= self.up and self.state < BROWNOUT:
                self.state += 1
                self._over = 0
        else:
            self._under += 1
            self._over = 0
            if self._under >= self.down and self.state > HEALTHY:
                self.state -= 1
                self._under = 0
        return self.state


class OverloadWatch:
    """Periodic stage-p99 + queue-gauge bound check on one node."""

    def __init__(self, node: Any, interval: Optional[float] = None) -> None:
        self.node = node
        self.interval = (
            interval if interval is not None
            else knob_float("MRT_OVERLOAD_INTERVAL")
        )
        self.p99_bound_s = knob_float("MRT_OVERLOAD_P99_MS") / 1e3
        self.gauge_bounds: Dict[str, float] = {
            "gauge.replyq": knob_float("MRT_OVERLOAD_REPLYQ"),
            "gauge.backlog": knob_float("MRT_OVERLOAD_BACKLOG"),
            "gauge.wal_pending": knob_float("MRT_OVERLOAD_WAL"),
        }
        self._ctl = ObsControl(node)
        self._prev: Dict[str, Hist] = {}  # stage hist snapshots, last tick
        self.brownout = BrownoutMachine()
        self._stopped = False
        node.sched.call_after(self.interval, self._tick)

    def stop(self) -> None:
        self._stopped = True

    # -- one watch tick ---------------------------------------------------

    def _tick(self) -> None:
        if self._stopped or getattr(self.node, "_closed", False):
            return
        try:
            self.check()
        except Exception:
            # The watch must never take the serving loop down.
            self.node.obs.metrics.inc("overload.watch_errors")
        self.node.sched.call_after(self.interval, self._tick)

    def check(self) -> int:
        """Run one bound check; returns the number of crossings."""
        m = self.node.obs.metrics
        frec = getattr(self.node, "_frec", None)
        gauges = self._ctl.gauges()
        trips = 0
        relievable = 0  # trips shedding can actually fix (post-admission)
        stage_tripped = False

        # Windowed stage p99s: cumulative hist minus last tick's copy.
        for name, h in list(m.hists.items()):
            if not name.startswith("stage."):
                continue
            prev = self._prev.get(name)
            window = Hist.sub(h, prev) if prev is not None else h
            # Snapshot for next tick (copy via dump round trip is
            # wasteful; clone counts directly).
            snap = Hist()
            snap.counts = list(h.counts)
            snap.count = h.count
            snap.total = h.total
            snap.vmin = h.vmin
            snap.vmax = h.vmax
            self._prev[name] = snap
            if window.count < _MIN_WINDOW_COUNT:
                continue
            p99 = window.percentile(0.99)
            if p99 is None or p99 <= self.p99_bound_s:
                continue
            trips += 1
            stage_tripped = True
            # The wire stage (client send -> socket read) sits BEFORE
            # admission: its backlog is ingress parse cost, and
            # admitting fewer requests cannot drain it — feeding it to
            # the brownout machine just death-spirals goodput while the
            # latency stays.  It still trips an OVERLOAD record (it is
            # how "queueing collapse" gets named); only the
            # post-admission stages drive shedding.
            if name != "stage.wire_s":
                relievable += 1
            m.inc("overload.trips")
            if frec is not None:
                frec.record(
                    flightrec.OVERLOAD,
                    code=flightrec.OVERLOAD_KIND_CODES["stage_p99"],
                    a=int(p99 * 1e6), b=int(self.p99_bound_s * 1e6),
                    c=window.count, tag=name,
                )

        # Queue gauges against their bounds.
        for gname, bound in self.gauge_bounds.items():
            val = gauges.get(gname)
            if val is None or val <= bound:
                continue
            trips += 1
            relievable += 1  # queue gauges are all post-admission
            m.inc("overload.trips")
            if frec is not None:
                frec.record(
                    flightrec.OVERLOAD,
                    code=flightrec.OVERLOAD_KIND_CODES["gauge"],
                    a=int(val), b=int(bound), tag=gname,
                )

        # Context record: the deepest queue at the moment a stage
        # tripped, even if under its own bound — the doctor pairs it
        # with the first saturated stage.
        if stage_tripped and frec is not None and gauges:
            deepest = max(gauges, key=lambda k: gauges[k])
            frec.record(
                flightrec.OVERLOAD,
                code=flightrec.OVERLOAD_KIND_CODES["gauge_ctx"],
                a=int(gauges[deepest]),
                b=int(self.gauge_bounds.get(deepest, 0)),
                tag=deepest,
            )
        m.set("overload.active", float(trips))

        # Feed the brownout machine and drive admission.  Transitions
        # (either direction) are flight-recorded; the steady state is
        # just a gauge.
        prev_state = self.brownout.state
        state = self.brownout.update(relievable)
        if state != prev_state:
            m.inc("overload.brownout_transitions")
            if frec is not None:
                frec.record(
                    flightrec.OVERLOAD,
                    code=flightrec.OVERLOAD_KIND_CODES["brownout"],
                    a=state, b=prev_state, c=trips, tag="brownout",
                )
        m.set("overload.state", float(state))
        adm = getattr(self.node, "admission", None)
        if adm is not None:
            adm.set_level(state)
        return trips


def install_overload_watch(
    node: Any, interval: Optional[float] = None
) -> Optional[OverloadWatch]:
    """Attach the watch to a serving node (no-op when
    ``MRT_OVERLOAD_WATCH=0``).  Returns the watch, kept reachable on
    ``node.overload_watch``."""
    if not knob_bool("MRT_OVERLOAD_WATCH"):
        return None
    watch = OverloadWatch(node, interval=interval)
    node.overload_watch = watch
    return watch
