"""Fleet scraper: one merged, clock-aligned timeline per run.

Every server process carries an ``"Obs"`` control service
(distributed/observe.py) exposing its metrics registry and trace
buffer.  :class:`FleetObserver` is the host side: it scrapes the whole
fleet over a chaos-free :class:`~multiraft_tpu_torch.distributed.tcp.RpcNode`,
estimates each process's clock offset from scrape round trips, shifts
every remote event onto the host clock, and assembles ONE Chrome-trace
JSON where clerk spans (host process), server dispatch spans, engine
commit instants, and nemesis fault windows all line up on a shared
time axis — the "what was the fleet doing while that window was open"
view that per-process logs cannot give.

Clock alignment: ``Obs.clock`` returns the remote ``perf_counter`` in
µs.  For each process the observer takes several round trips and keeps
the offset measured at MINIMUM RTT (the sample least smeared by queue
delay): ``offset = remote_now − (t_send + t_recv)/2``.  Remote event
timestamps are then shifted by ``−offset``.  On one machine (the
process-cluster harness) the clocks share a timebase and offsets are
dominated by per-process ``perf_counter`` epochs — typically constant
to well under a millisecond, which is enough to order windows against
request spans.

Usage (the slow nemesis test is the canonical caller)::

    obs = FleetObserver(addrs)
    ...run nemesis + clerk load (collecting clerk events)...
    tracer = obs.merged_timeline(
        local_events=clerk_events, windows=nem.windows)
    tracer.save("trace_nemesis.json.gz")
    snaps = obs.snapshot_all()
    obs.close()

PyTorch port of ``multiraft_tpu/harness/observe.py``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..distributed.observe import now_us
from ..distributed.tcp import RpcNode
from ..sim.scheduler import TIMEOUT
from ..utils.trace import Tracer

__all__ = ["FleetObserver"]

Addr = Tuple[str, int]


class FleetObserver:
    """Scrapes ``Obs.*`` across a fleet and merges the results.

    The observer's own node carries no chaos, and ``Obs.*`` frames are
    control-exempt on the targets, so scrapes work mid-fault — a
    CRASHED process is unreachable and shows up as an explicit
    ``missing`` marker (and in :attr:`unreachable`), never as a
    silently shorter fleet."""

    def __init__(self, addrs: Sequence[Addr]) -> None:
        self.node = RpcNode()
        self.sched = self.node.sched
        self.addrs: List[Addr] = [tuple(a) for a in addrs]
        self.ends = {a: self.node.client_end(*a) for a in self.addrs}
        # addr -> best (min-RTT) clock offset estimate so far, µs.
        self.offsets: Dict[Addr, float] = {}
        # addr -> (pid, name) from the last successful snapshot — kept
        # so a process that later dies can still be identified in
        # postmortem bundles (its ring file is keyed by pid).
        self.idents: Dict[Addr, Tuple[int, str]] = {}
        self.unreachable: List[Addr] = []

    # -- raw scrape verbs --------------------------------------------------

    def call(
        self, addr: Addr, meth: str, args: Any = None,
        timeout: float = 2.0, retries: int = 3,
    ) -> Any:
        for attempt in range(retries):
            reply = self.sched.wait(
                self.ends[addr].call(f"Obs.{meth}", args), timeout
            )
            if reply is not None and reply is not TIMEOUT:
                return reply
            time.sleep(0.05 * (attempt + 1))
        return None

    def ping(self, addr: Addr) -> bool:
        return self.call(addr, "ping") == "pong"

    def snapshot(self, addr: Addr) -> Optional[Dict[str, Any]]:
        return self.call(addr, "snapshot")

    def snapshot_all(self) -> Dict[str, Dict[str, Any]]:
        """Scrape the whole fleet: ``{"host:port": snapshot}``.

        A process that died (or was partitioned from the scraper) gets
        an explicit ``{"missing": True, ...}`` marker instead of being
        silently absent — a postmortem that omits the dead process is
        hiding exactly the row that matters.  The marker carries the
        pid/name remembered from the last successful scrape, so the
        doctor can still pair the dead address with its on-disk flight
        ring."""
        out: Dict[str, Dict[str, Any]] = {}
        for a in self.addrs:
            key = f"{a[0]}:{a[1]}"
            snap = self.snapshot(a)
            if snap is not None:
                self.idents[a] = (int(snap.get("pid", -1)),
                                  str(snap.get("name", "")))
                out[key] = snap
            else:
                pid, name = self.idents.get(a, (-1, ""))
                out[key] = {"missing": True, "pid": pid, "name": name}
        return out

    def drain_trace(self, addr: Addr) -> Optional[Dict[str, Any]]:
        return self.call(addr, "trace", timeout=5.0)

    def hist(self, addr: Addr) -> Optional[Dict[str, Any]]:
        """One process's CUMULATIVE latency-histogram dumps + live
        queue gauges (``Obs.hist``).  Cumulative by design: callers
        window by diffing two scrapes (``Hist.sub``), so the scrape is
        read-only and concurrent observers can't clobber each other —
        harness/loadcurve.py is the aggregating caller."""
        return self.call(addr, "hist", timeout=5.0)

    def hist_all(self) -> Dict[str, Optional[Dict[str, Any]]]:
        """Scrape ``Obs.hist`` fleet-wide: ``{"host:port": dump}``,
        with ``None`` for unreachable processes (explicit, same as
        :meth:`snapshot_all`'s missing markers)."""
        return {f"{a[0]}:{a[1]}": self.hist(a) for a in self.addrs}

    def profile(
        self, addr: Addr, reset: bool = True
    ) -> Optional[Dict[str, Any]]:
        """One process's sampling-profiler aggregate (``Obs.profile``,
        profile.py).  Drain-on-read by default — each scrape returns
        exactly the samples taken since the previous one, the same
        windowing discipline the loadcurve uses; ``reset=False``
        peeks."""
        args = None if reset else {"reset": False}
        return self.call(addr, "profile", args, timeout=5.0)

    def profile_all(
        self, reset: bool = True
    ) -> Dict[str, Optional[Dict[str, Any]]]:
        """Scrape ``Obs.profile`` fleet-wide: ``{"host:port": reply}``,
        ``None`` for unreachable processes."""
        return {
            f"{a[0]}:{a[1]}": self.profile(a, reset) for a in self.addrs
        }

    def tail(
        self, addr: Addr, reset: bool = True
    ) -> Optional[Dict[str, Any]]:
        """One process's tail-exemplar store (``Obs.tail``, tail.py).
        Drain-on-read by default — same windowing discipline as
        :meth:`profile`; ``reset=False`` peeks (bundle collection)."""
        args = None if reset else {"reset": False}
        return self.call(addr, "tail", args, timeout=5.0)

    def tail_all(
        self, reset: bool = True
    ) -> Dict[str, Optional[Dict[str, Any]]]:
        """Scrape ``Obs.tail`` fleet-wide: ``{"host:port": reply}``,
        ``None`` for unreachable processes."""
        return {
            f"{a[0]}:{a[1]}": self.tail(a, reset) for a in self.addrs
        }

    @staticmethod
    def fleet_flame(
        dumps: Dict[str, Optional[Dict[str, Any]]],
    ) -> Dict[str, int]:
        """Merge per-process ``Obs.profile`` replies into ONE folded
        aggregate — the fleet flame.  Each process's stacks are
        prefixed with its Observability name (``pid123:9001;
        multiraft-loop/9001;tcp._run;...``), so one flamegraph shows
        the whole fleet with per-process, per-thread attribution.
        Unreachable (None) and not-profiling (``profile: None``)
        processes contribute nothing — the caller can tell them apart
        in ``dumps`` itself."""
        from ..distributed.profile import merge_folded

        parts: List[Dict[str, int]] = []
        for key, reply in dumps.items():
            prof = (reply or {}).get("profile")
            if not prof:
                continue
            name = str((reply or {}).get("name") or key)
            parts.append({
                f"{name};{stack}": n
                for stack, n in (prof.get("stacks") or {}).items()
            })
        return merge_folded(parts)

    @staticmethod
    def profile_counter_track(
        tracer: Tracer,
        dumps: Dict[str, Optional[Dict[str, Any]]],
        ts_us: Optional[float] = None,
    ) -> None:
        """Emit one Perfetto counter sample per process from a
        ``profile_all`` scrape — per-thread sample counts on a
        ``cpu_samples`` track (repeated scrapes across a sweep render
        as the fleet's CPU-attribution area chart next to the latency
        tracks)."""
        from ..distributed.profile import per_thread_totals

        if ts_us is None:
            ts_us = now_us()
        for pid, (key, reply) in enumerate(sorted(dumps.items())):
            prof = (reply or {}).get("profile")
            if not prof:
                continue
            totals = per_thread_totals(prof.get("stacks") or {})
            if totals:
                tracer.counter(
                    "cpu_samples", ts_us,
                    {t: float(n) for t, n in sorted(totals.items())},
                    pid=pid + 1, track="profile",
                )

    # -- clock alignment ---------------------------------------------------

    def clock_offset_us(
        self, addr: Addr, samples: int = 7,
    ) -> Optional[float]:
        """Min-RTT midpoint estimate of ``remote_clock − local_clock``
        (µs); ``None`` when the process is unreachable.  The freshest
        successful estimate is cached in :attr:`offsets` and reused
        when a later scrape finds the process unreachable."""
        best_rtt, best_off = None, None
        for _ in range(samples):
            t0 = now_us()
            remote = self.call(addr, "clock", retries=1, timeout=1.0)
            t1 = now_us()
            if remote is None:
                continue
            rtt = t1 - t0
            if best_rtt is None or rtt < best_rtt:
                best_rtt, best_off = rtt, float(remote) - (t0 + t1) / 2.0
        if best_off is None:
            return self.offsets.get(addr)
        self.offsets[addr] = best_off
        return best_off

    # -- merged timeline ---------------------------------------------------

    def merged_timeline(
        self,
        local_events: Sequence[Dict[str, Any]] = (),
        windows: Sequence[Dict[str, Any]] = (),
        schedule: Sequence[Tuple[float, str, Dict[str, Any]]] = (),
        t0_us: Optional[float] = None,
        local_name: str = "host (clerks + nemesis)",
    ) -> Tracer:
        """Drain every reachable process's trace buffer, shift each
        event onto the host clock, and return one :class:`Tracer`:

        * pid 0 — the host process: ``local_events`` verbatim (clerk
          request spans from :func:`~.nemesis.run_clerk_load`'s
          ``trace_sink``) plus one ``nemesis`` track annotating fault
          ``windows`` (:attr:`~.nemesis.Nemesis.windows` records, in
          host-clock µs already) and/or a planned ``schedule`` anchored
          at ``t0_us`` (:attr:`~.nemesis.Nemesis.t0_us`).
        * pid 1..N — one per fleet process, labelled with the remote
          ``Observability.name``, events shifted by the min-RTT clock
          offset.

        Unreachable processes are listed in :attr:`unreachable` AND get
        their own (empty) process row in the trace, labelled
        ``"MISSING"`` with an instant marking when the scrape failed —
        a merged trace must not silently present a partial fleet as
        the whole one."""
        parts: List[Tuple[Addr, float, Optional[Dict[str, Any]]]] = []
        self.unreachable = []
        for a in self.addrs:
            off = self.clock_offset_us(a)
            part = self.drain_trace(a) if off is not None else None
            if part is None:
                # Dead or partitioned: keep its slot in the merge (a
                # cached offset from an earlier scrape may survive).
                self.unreachable.append(a)
            parts.append((a, off if off is not None else 0.0, part))

        n_events = (
            len(local_events)
            + sum(len(p["events"]) for _, _, p in parts if p is not None)
            + 2 * (len(windows) + len(schedule))
            + 2 * len(parts)
            + 64
        )
        out = Tracer(max_events=n_events)
        out.process_name(0, local_name)
        for ev in local_events:
            ev = dict(ev)
            ev["pid"] = 0
            out._emit(ev)

        for i, (a, off, part) in enumerate(parts):
            pid = i + 1
            if part is None:
                label = self.idents.get(a, (-1, "?"))[1] or "?"
                out.process_name(pid, f"MISSING {label} @ {a[0]}:{a[1]}")
                out.instant(
                    "process_missing", now_us(),
                    track="obs", pid=pid, addr=f"{a[0]}:{a[1]}",
                )
                continue
            out.process_name(pid, f"{part.get('name')} @ {a[0]}:{a[1]}")
            for ev in part["events"]:
                ev = dict(ev)
                ev["ts"] = float(ev["ts"]) - off
                ev["pid"] = pid
                out._emit(ev)
            if part.get("dropped"):
                out.instant(
                    "trace_buffer_dropped",
                    float(part["now_us"]) - off,
                    track="obs", pid=pid, dropped=part["dropped"],
                )

        self._annotate(out, windows, schedule, t0_us)
        return out

    @staticmethod
    def _annotate(
        out: Tracer,
        windows: Sequence[Dict[str, Any]],
        schedule: Sequence[Tuple[float, str, Dict[str, Any]]],
        t0_us: Optional[float],
    ) -> None:
        """Fault windows onto pid 0's ``nemesis`` track: executed
        windows as spans (actual wall times + outcome args), planned
        schedule entries as instants (intent times)."""
        for w in windows:
            ts = float(w["t_start_us"])
            stop = w.get("t_stop_us")
            dur = max(0.0, float(stop) - ts) if stop is not None else 0.0
            args = {
                "acked": w.get("acked"), "hits": w.get("hits"),
                **{k: v for k, v in (w.get("p") or {}).items()},
            }
            if w.get("excused"):
                args["excused"] = w["excused"]
            if dur > 0:
                out.span(w["kind"], ts, dur, track="nemesis", pid=0, **args)
            else:
                out.instant(w["kind"], ts, track="nemesis", pid=0, **args)
        if t0_us is not None:
            for at, kind, p in schedule:
                out.instant(
                    f"plan:{kind}", t0_us + float(at) * 1e6,
                    track="nemesis-plan", pid=0,
                    **{k: v for k, v in (p or {}).items()},
                )

    def close(self) -> None:
        self.node.close()
