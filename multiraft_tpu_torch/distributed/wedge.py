"""Wedge detection: a per-group no-progress watchdog.

Gray failures wedge groups without killing anything: a leader severed
from its quorum (but not from its clients) keeps accepting proposals
that can never commit; a one-way partition leaves heartbeats flowing
in the direction that placates followers while append replies die in
the other.  Every liveness signal built on "is the process up" stays
green.  The only honest symptom is *no progress*: the group's commit
frontier stops advancing while proposals are pending.

This watch turns that symptom into evidence while the wedge is live.
Every ``interval`` seconds it scrapes the per-group commit frontier
(``ObsControl.groups``) and the driver's per-group ``Start()`` backlog,
and counts consecutive scrapes in which a group had work pending but
its commit index did not move.  At ``stall_ticks`` consecutive
no-progress scrapes the group is declared WEDGED:

* a ``WEDGE`` flight record (flightrec.py) names the group, its stall
  length, the stalled commit index, the pending backlog, and — in the
  tag — the stuck leader and its term (``"p<peer>@t<term>"``, ``p-1``
  when the group has no leader at all);
* ``gauge.wedged_groups`` (ObsControl.gauges) carries the live count,
  so a fleet scrape sees the wedge mid-run;
* ``wedge.trips`` counts wedge onsets, ``wedge.active`` mirrors the
  gauge in the metrics registry.

Recovery is detected the same way: one commit advance (or an emptied
backlog) clears the group's stall count, drops it from the wedged set,
and the gauge falls.  The postmortem doctor pairs the WEDGE records
with the chaos fault windows to name the partition that caused the
wedge (analysis/postmortem.py, "wedged leadership").

Knobs (env-tunable):

* ``MRT_WEDGE_INTERVAL``  watch period, seconds (default 0.25)
* ``MRT_WEDGE_TICKS``     consecutive stalled scrapes before a group
                          is declared wedged (default 8 — i.e. two
                          seconds of no progress at the default period,
                          comfortably past an election round-trip)
* ``MRT_WEDGE_WATCH=0``   disable the watch entirely

Like the overload watch it runs on the node's scheduler loop (same
thread as dispatch), so the loop-thread-only driver state is safe to
read, and a watch tick must never take the serving loop down.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Set

from ..utils.knobs import knob_bool, knob_float, knob_int
from . import flightrec
from .observe import ObsControl

__all__ = ["WedgeWatch", "install_wedge_watch"]


class WedgeWatch:
    """Periodic commit-frontier-vs-backlog progress check on one node."""

    def __init__(self, node: Any, interval: Optional[float] = None,
                 stall_ticks: Optional[int] = None) -> None:
        self.node = node
        self.interval = (
            interval if interval is not None
            else knob_float("MRT_WEDGE_INTERVAL")
        )
        self.stall_ticks = max(1, int(
            stall_ticks if stall_ticks is not None
            else knob_int("MRT_WEDGE_TICKS")
        ))
        self._ctl = ObsControl(node)
        self._prev_commit: Optional[List[int]] = None
        self._stall: Dict[int, int] = {}  # group -> consecutive stalls
        self.wedged: Set[int] = set()     # groups currently wedged
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
            self.node.obs.metrics.inc("wedge.watch_errors")
        self.node.sched.call_after(self.interval, self._tick)

    def check(self) -> int:
        """Run one progress check; returns the wedged-group count."""
        m = self.node.obs.metrics
        groups = self._ctl.groups()
        if groups is None:  # no engine service on this node
            return 0
        driver = getattr(self._ctl._engine_kv(), "driver", None)
        backlog = getattr(driver, "backlog", None)
        commit: List[int] = groups["commit"]
        prev, self._prev_commit = self._prev_commit, list(commit)
        frec = getattr(self.node, "_frec", None)
        # Groups intentionally paused are NOT wedges: a sealed group is
        # mid-migration (its frontier freezes by design until the
        # destination adopts), and a reconfiguring group's commit may
        # legitimately stall while the joint phase waits on BOTH
        # quorums.  Counting either would fire a false "wedged
        # leadership" anomaly exactly when self-healing is working.
        sealed = groups.get("sealed") or []
        reconfig = groups.get("reconfig") or []
        for g in range(len(commit)):
            pend = int(backlog[g]) if backlog is not None else 0
            moved = prev is None or g >= len(prev) or commit[g] > prev[g]
            exempt = bool(
                (g < len(sealed) and sealed[g])
                or (g < len(reconfig) and reconfig[g])
            )
            if exempt:
                self._stall[g] = 0
                if g in self.wedged:
                    self.wedged.discard(g)
                m.inc("wedge.reconfig_exempt")
                continue
            if moved or pend <= 0:
                # Progress, or nothing owed: not a wedge.  (An idle
                # group with a severed leader is invisible here by
                # design — no client is being harmed.)
                self._stall[g] = 0
                self.wedged.discard(g)
                continue
            self._stall[g] = self._stall.get(g, 0) + 1
            if self._stall[g] < self.stall_ticks:
                continue
            if g not in self.wedged:
                self.wedged.add(g)
                m.inc("wedge.trips")
            # Re-recorded every stalled scrape while wedged: the ring
            # then shows the wedge's full extent, not just its onset,
            # and the doctor reads duration straight off the records.
            if frec is not None:
                frec.record(
                    flightrec.WEDGE,
                    code=g,
                    a=self._stall[g],
                    b=int(commit[g]),
                    c=pend,
                    tag=f"p{groups['leader'][g]}@t{groups['term'][g]}",
                )
        m.set("wedge.active", float(len(self.wedged)))
        return len(self.wedged)


def install_wedge_watch(
    node: Any, interval: Optional[float] = None
) -> Optional[WedgeWatch]:
    """Attach the watch to a serving node (no-op when
    ``MRT_WEDGE_WATCH=0``).  Returns the watch, kept reachable on
    ``node.wedge_watch`` (ObsControl.gauges reads it for
    ``gauge.wedged_groups``)."""
    if not knob_bool("MRT_WEDGE_WATCH"):
        return None
    watch = WedgeWatch(node, interval=interval)
    node.wedge_watch = watch
    return watch
