"""Per-process observability plane for the real-socket stack.

Every :class:`~multiraft_tpu_torch.distributed.tcp.RpcNode` owns an
:class:`Observability` — one :class:`~multiraft_tpu_torch.utils.metrics.Metrics`
registry plus one bounded :class:`~multiraft_tpu_torch.utils.trace.Tracer` —
and auto-registers the ``"Obs"`` control service on it, mirroring the
``"Chaos"`` pattern (chaos.py).  Like chaos control frames, ``Obs.*``
frames are exempt from fault injection (see
:func:`is_control`): an observability plane that a nemesis can
partition away goes dark exactly when you need it.

The service verbs:

* ``Obs.ping``     — liveness probe.
* ``Obs.clock``    — this process's ``perf_counter`` in µs.  The
  scraper estimates per-process clock offset from the round trip
  (offset = remote_now − local_midpoint, taken at minimum RTT), which
  is what lets :mod:`multiraft_tpu_torch.harness.observe` merge trace
  buffers from many processes onto one timeline.
* ``Obs.snapshot`` — metrics registry snapshot (+ chaos-rule hit
  counters when chaos is installed).
* ``Obs.trace``    — drain the trace buffer.  Drain, not read: repeated
  scrapes never duplicate events, and the server's memory stays bounded
  by ``max_events`` between scrapes (drops are counted and reported).
* ``Obs.profile``  — drain the process's continuous sampling profiler
  (profile.py): the folded-stack aggregate since the previous scrape.
  Drain-on-read like ``Obs.trace`` (pass ``{"reset": False}`` for a
  non-destructive peek); control-exempt like every Obs verb, so chaos
  cannot partition the profiler away.
* ``Obs.tail``     — drain the process's tail-exemplar store
  (tail.py): the per-request lifecycle records retained since the
  previous scrape (over-SLO guaranteed + windowed top-k + reservoir).
  Same drain-on-read / ``{"reset": False}`` contract as
  ``Obs.profile``, and chaos-exempt for the same reason — the tail
  microscope must stay readable during the overload it documents.

Timestamps everywhere are ``time.perf_counter() * 1e6`` — the same
clock the RPC spans and engine tick spans already use, so one process's
events need only a constant offset to land on the scraper's timeline.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional

from ..utils.knobs import knob_bool, knob_int
from ..utils.metrics import Metrics
from ..utils.trace import Tracer

__all__ = [
    "Observability",
    "ObsControl",
    "StageClock",
    "install_obs",
    "is_control",
    "now_us",
    "stageclock_enabled",
    "stage_metric",
    "CONTROL_PREFIXES",
    "STAGES",
]

# Control-plane RPC prefixes exempt from fault injection everywhere
# (outbound decide, inbound decide, reply decide — see tcp.py).
CONTROL_PREFIXES = ("Chaos.", "Obs.")


def is_control(svc_meth: str) -> bool:
    return svc_meth.startswith(CONTROL_PREFIXES)


def now_us() -> float:
    """This process's trace clock (µs, arbitrary epoch, monotonic)."""
    return time.perf_counter() * 1e6


try:
    _PAGE_MB = os.sysconf("SC_PAGE_SIZE") / (1024.0 * 1024.0)
except (ValueError, OSError, AttributeError):  # non-POSIX
    _PAGE_MB = 4096.0 / (1024.0 * 1024.0)


def _rss_mb() -> Optional[float]:
    """Resident set size in MB via /proc/self/statm (one small read,
    no fork, no psutil); None where /proc is absent."""
    try:
        with open("/proc/self/statm", "rb") as f:
            return float(int(f.read().split()[1])) * _PAGE_MB
    except (OSError, ValueError, IndexError):
        return None


# ---------------------------------------------------------------------------
# Per-stage latency decomposition (the stage clock)
# ---------------------------------------------------------------------------
#
# A tagged request is stamped at each hop of its life and the deltas
# fold into per-stage log-bucket histograms (Metrics.hists), named
# ``stage.<name>_s``:
#
#   wire     clerk ``call()`` → server socket read.  Both stamps are
#            CLOCK_MONOTONIC (machine-wide on Linux), so on one box the
#            delta is exact; across machines it absorbs the clock
#            offset and the fleet aggregator's min-RTT alignment is the
#            corrective lens.  Under overload this stage is where the
#            kernel socket backlog shows up — frames queue in the TCP
#            buffer while the loop thread is busy pumping.
#   dispatch socket read → handler dispatch (decode, chaos delay, the
#            loop's own event backlog).
#   handler  dispatch → engine submit (engine ops) or handler return
#            (plain RPCs).
#   engine   submit → raft commit observed (ticket resolution: tick
#            batches + quorum + apply).  Engine ops only.
#   ack      commit → reply enqueued (durability gate: fsync frontier /
#            checkpoint waits).  Engine ops only.
#   flush    reply enqueued → vectored write handed to the kernel (the
#            reply-coalescing wait).
#
# Clerk side, ``total`` (call → reply) folds into the CLIENT node's
# registry — the end-to-end number the load curve plots against the
# server-side decomposition.
#
# ``MRT_STAGECLOCK=0`` compiles the whole plane out (no send stamp, no
# StageClock allocation, no folds) — the A/B lever for the overhead
# budget in BENCHMARKS.
#
# CPU-SECONDS twins (``cpu.<stage>_s``, profiling plane): the same
# stage vocabulary carries explicit cost accounting — thread-CPU-clock
# deltas around each synchronous serve-path segment, observed into the
# same mergeable Hist machinery (so loadcurve windows them with
# Hist.sub exactly like the wall stages, and Hist.total is the
# window's CPU-seconds sum).  Segment accounting, not per-request:
# each loop-thread CPU second lands in exactly ONE stage, so the sums
# never double-count under pipelining —
#
#   cpu.wire_s      ingress frame decode (tcp._on_event)
#   cpu.dispatch_s  dispatch bookkeeping: admission, stage setup,
#                   handler lookup (tcp._dispatch entry → handler call)
#   cpu.handler_s   synchronous handler execution; engine write ops
#                   add their per-submit binding cost from the
#                   generator body (engine_server.command)
#   cpu.engine_s    pump tick CPU (engine_server._pump_loop) — the
#                   engine stage's CPU *is* the pump
#   cpu.ack_s       completion bookkeeping (tcp._dispatch._done)
#   cpu.flush_s     reply encode + vectored write (tcp._flush_replies)
#
# Coroutine-step scheduler overhead and generator bookkeeping outside
# the wrapped segments are not attributed (the sampling profiler is
# the exact lens); the counters answer "which stage burns the loop's
# CPU" at ~zero cost.  They ride the MRT_STAGECLOCK kill switch.

STAGES = ("wire", "dispatch", "handler", "engine", "ack", "flush", "total")

_STAGECLOCK = knob_bool("MRT_STAGECLOCK")


def stageclock_enabled() -> bool:
    """True unless MRT_STAGECLOCK=0 (read once at import)."""
    return _STAGECLOCK


def stage_metric(stage: str) -> str:
    """Histogram name for a stage (``wire`` → ``stage.wire_s``)."""
    return f"stage.{stage}_s"


class StageClock:
    """Mutable per-request stamp carrier (loop-thread only).

    Created at dispatch from the wire element's ``(rid, t_send)``; each
    ``fold`` observes now−last into the stage histogram and advances
    ``last``, so consecutive folds decompose the request's life into
    adjacent, non-overlapping intervals.  ``engine`` flags that the
    engine service folded handler/engine stages, so the dispatcher's
    completion fold knows whether it is closing ``ack`` (engine op) or
    ``handler`` (plain RPC).

    Lifecycle capture (the tail microscope, tail.py): when the node's
    tail plane is on, ``vec`` holds the request's own stage vector —
    every fold lands in it as well as the histogram — and the engine
    services deposit the pump-batch wait and engine tick id, so the
    completed request carries its full stage+wait decomposition to the
    tail store.  ``vec`` stays ``None`` with the tail plane off: the
    pure-StageClock path allocates nothing extra.
    """

    __slots__ = ("rid", "last", "engine", "t0", "vec", "tick",
                 "pump_wait_s", "ambient")

    def __init__(
        self, rid: str, last: float, vec: Optional[Dict[str, float]] = None
    ) -> None:
        self.rid = rid
        self.last = last
        self.engine = False
        self.t0 = last
        self.vec = vec
        self.tick = -1
        self.pump_wait_s = 0.0
        self.ambient: Optional[Dict[str, Any]] = None

    def fold(
        self, metrics: Metrics, stage: str, now: Optional[float] = None
    ) -> float:
        if now is None:
            now = time.perf_counter()
        dt = now - self.last
        if dt < 0.0:
            dt = 0.0
        metrics.observe(f"stage.{stage}_s", dt)
        if self.vec is not None:
            self.vec[stage] = self.vec.get(stage, 0.0) + dt
        self.last = now
        return dt


class Observability:
    """One process's metrics registry + trace buffer.

    ``max_events`` defaults from ``MRT_OBS_MAX_EVENTS`` (50k ≈ 10 MB
    worst case) — the buffer self-truncates under load and ``dropped``
    reports how much, so an unscrapped long run costs bounded memory.
    """

    def __init__(
        self, name: Optional[str] = None, max_events: Optional[int] = None
    ) -> None:
        if max_events is None:
            max_events = knob_int("MRT_OBS_MAX_EVENTS")
        self.name = name or f"pid{os.getpid()}"
        self.metrics = Metrics()
        self.tracer = Tracer(max_events=max_events)
        self.node: Any = None  # back-ref set by the owning RpcNode

    def current_trace(self) -> Optional[str]:
        """The request id of the RPC being dispatched right now, if any
        (loop-thread breadcrumb — lets service code deep in a handler
        tag its own spans/instants with the caller's id)."""
        n = self.node
        return getattr(n, "_cur_trace", None) if n is not None else None

    def current_stages(self) -> Optional[StageClock]:
        """The stage clock of the RPC being dispatched right now, if any
        (loop-thread breadcrumb, same discipline as current_trace) —
        lets the engine service fold handler/engine/ack stages onto the
        clock the dispatcher started."""
        n = self.node
        return getattr(n, "_cur_stages", None) if n is not None else None


class ObsControl:
    """The ``"Obs"`` service: scrape verbs over the node's own plane."""

    def __init__(self, node: Any) -> None:
        self._node = node
        # Commit-rate window state for groups(): (now_us, commit list)
        # of the previous scrape — rates are deltas BETWEEN scrapes, so
        # the placer reads load directly instead of diffing counters.
        self._g_prev: Optional[tuple] = None

    def _engine_kv(self):
        """The engine service's frontier service, whichever attribute
        it hangs off (``kv`` on EngineKVService, ``skv`` on the sharded
        services)."""
        svc = getattr(self._node, "engine_service", None)
        kv = getattr(svc, "kv", None)
        if kv is None:
            kv = getattr(svc, "skv", None)
        return kv

    def ping(self, args: Any = None) -> Any:
        """``"pong"``.  A placement controller's lease verb rides it,
        exempt from chaos as every control frame: ``("lease", kind,
        deadline)`` (EngineShardKVService.grant_lease) answers
        ``("pong", held)`` from a fleet shard server; every other
        server, the reference's among them, answers ``"pong"``."""
        if isinstance(args, tuple) and len(args) == 3 and args[0] == "lease":
            svc = getattr(self._node, "engine_service", None)
            grant = getattr(svc, "grant_lease", None)
            if grant is not None and getattr(svc, "_fleet", False):
                return ("pong", grant(args[1], args[2]))
        return "pong"

    def clock(self, args: Any = None) -> float:
        return now_us()

    def snapshot(self, args: Any = None) -> Dict[str, Any]:
        obs = self._node.obs
        out: Dict[str, Any] = {
            "name": obs.name,
            "pid": os.getpid(),
            "now_us": now_us(),
            "metrics": obs.metrics.snapshot(),
            "gauges": self.gauges(),
        }
        chaos = getattr(self._node, "chaos", None)
        if chaos is not None:
            out["chaos"] = chaos.snapshot()
        groups = self.groups()
        if groups is not None:
            out["groups"] = groups
        return out

    def gauges(self, args: Any = None) -> Dict[str, float]:
        """Live queue-depth / in-flight gauges — saturation visible in
        a scrape, not only in a postmortem.  Runs on the loop thread
        (all Obs verbs dispatch there), so reading the loop-thread-only
        reply queues is safe; engine attributes are getattr-guarded for
        nodes without an engine service."""
        node = self._node
        out: Dict[str, float] = {}
        outq = getattr(node, "_outq", None)
        if outq is not None:
            out["gauge.replyq"] = float(sum(len(v) for v in outq.values()))
        pending = getattr(node, "_pending", None)
        if pending is not None:
            out["gauge.inflight"] = float(len(pending))
        svc = getattr(node, "engine_service", None)
        if svc is not None:
            driver = getattr(self._engine_kv(), "driver", None)
            backlog = getattr(driver, "backlog", None)
            if backlog is not None:
                out["gauge.backlog"] = float(backlog.sum())
            ws = getattr(svc, "_write_seqs", None)
            if ws is not None:
                out["gauge.wal_unsynced"] = float(len(ws))
            wal = getattr(getattr(svc, "_dur", None), "wal", None)
            if wal is not None:
                out["gauge.wal_pending"] = float(
                    wal.appended - wal.synced
                )
        adm = getattr(node, "admission", None)
        if adm is not None:
            # Admission plane (admission.py): bucket depth plus the
            # bounded dispatched-unreplied count it enforces.
            out["gauge.admit_tokens"] = float(adm.tokens())
            out["gauge.admit_inflight"] = float(adm.inflight_total())
        ww = getattr(node, "wedge_watch", None)
        if ww is not None:
            # Wedge watchdog (wedge.py): groups whose commit frontier
            # is stalled with proposals pending — gray-failure liveness
            # visible in a scrape, before the postmortem.
            out["gauge.wedged_groups"] = float(len(ww.wedged))
        # Process resource gauges (stdlib only — no psutil): the CPU
        # clock is cumulative, so two scrapes diff into the window's
        # CPU-seconds; against the wall window that says whether the
        # process is CPU-pegged (the loadcurve records all three per
        # step).  rss via /proc/self/statm on Linux; absent elsewhere.
        out["gauge.cpu_s"] = time.process_time()
        out["gauge.threads"] = float(threading.active_count())
        rss = _rss_mb()
        if rss is not None:
            out["gauge.rss_mb"] = rss
        return out

    def hist(self, args: Any = None) -> Dict[str, Any]:
        """Cumulative log-bucket histogram dumps + live gauges — the
        fleet scraper's verb.  Cumulative by design: two scrapes diff
        into the window between them (Hist.sub), so repeated scrapes
        are idempotent reads, never destructive drains."""
        obs = self._node.obs
        return {
            "name": obs.name,
            "pid": os.getpid(),
            "now_us": now_us(),
            "hists": obs.metrics.hist_dumps(),
            "gauges": self.gauges(),
        }

    def groups(self, args: Any = None) -> Optional[Dict[str, Any]]:
        """Per-raft-group introspection (columnar, one entry per group):
        leader replica (−1 = none), max term, commit index, applied
        index, log length above the snapshot base, last snapshot index,
        the GLOBAL gid each local engine slot hosts (``gids``, −1 for
        the config RSM / spare slots), and a windowed per-group commit
        RATE (``commit_rate``, commits/s since the previous scrape of
        this verb — the placement controller's load signal).  ``None``
        on nodes without an engine service (pure clients, sim-backend
        servers).  The postmortem doctor uses the commit/applied columns
        to compute apply lag at time of death; folded into
        :meth:`snapshot` so every scrape carries it."""
        kv = self._engine_kv()
        driver = getattr(kv, "driver", None)
        if getattr(driver, "state", None) is None:
            return None
        # numpy/engine imports stay local: pure-client nodes must not
        # pull the torch stack in just to serve Obs.ping.
        import numpy as np

        from ..engine.core import LEADER

        # The planes come to the host through the driver's readback
        # (np.asarray of a card-resident tensor raises); only the
        # per-replica ones, not the [G, P, L] log planes.
        st = driver.np_state(_GROUP_PLANES)
        role = st["role"]
        alive = st["alive"].astype(bool)
        lead = (role == LEADER) & alive
        leader = np.where(lead.any(axis=1), lead.argmax(axis=1), -1)
        G = int(role.shape[0])
        commit = st["commit"].max(axis=1).tolist()
        now = now_us()
        rate = [0.0] * G
        prev = self._g_prev
        if prev is not None and len(prev[1]) == G:
            dt_s = (now - prev[0]) / 1e6
            if dt_s > 0:
                rate = [
                    max(0.0, (c - p) / dt_s)
                    for c, p in zip(commit, prev[1])
                ]
        self._g_prev = (now, list(commit))
        # Local slot → global gid (fleet mode); −1 marks the config RSM
        # (slot 0) and idle spare slots.
        l2g = getattr(kv, "_l2g", None)
        gids = (
            [l2g.get(g, -1) for g in range(G)]
            if l2g is not None else list(range(G))
        )
        out = {
            "G": G,
            "gids": gids,
            "leader": leader.tolist(),
            "term": st["term"].max(axis=1).tolist(),
            "commit": commit,
            "commit_rate": rate,
            "applied": st["applied"].max(axis=1).tolist(),
            "log_len": st["log_len"].max(axis=1).tolist(),
            "snap_index": st["base"].max(axis=1).tolist(),
        }
        # Replica-membership health (engine/host.py joint consensus):
        # per-replica liveness, the voter set (leader's view; row with
        # the widest view when leaderless), joint flag, and whether a
        # reconfig is in flight — the placement controller's dead-voter
        # signal and the wedge watchdog's exemption column.  (Every
        # state of this package carries the membership planes.)
        vo, vn = st["voters_old"], st["voters_new"]
        joint, cfg_idx = st["joint"], st["cfg_idx"]
        P = int(vo.shape[1])
        union = vo | vn
        row = np.where(
            lead.any(axis=1), lead.argmax(axis=1), union.argmax(axis=1)
        )
        bits = union[np.arange(G), row]
        out["replica_alive"] = alive.tolist()
        out["voters"] = [
            [q for q in range(P) if (int(b) >> q) & 1] for b in bits
        ]
        out["joint"] = joint.any(axis=1).tolist()
        out["reconfig"] = (
            joint.any(axis=1) | (cfg_idx.max(axis=1) > np.asarray(commit))
        ).tolist()
        is_sealed = getattr(kv, "is_sealed", None)
        if is_sealed is not None and l2g is not None:
            out["sealed"] = [
                bool(g in l2g and is_sealed(l2g[g])) for g in range(G)
            ]
        return out

    def trace(self, args: Any = None) -> Dict[str, Any]:
        obs = self._node.obs
        events, dropped = obs.tracer.drain()
        return {
            "name": obs.name,
            "pid": os.getpid(),
            "now_us": now_us(),
            "events": events,
            "dropped": dropped,
        }

    def profile(self, args: Any = None) -> Dict[str, Any]:
        """Drain the process's sampling profiler (profile.py) — the
        folded-stack aggregate since the previous scrape, plus the
        sampler's own health/overhead telemetry.  ``{"reset": False}``
        peeks without draining.  ``profile`` is None when the sampler
        is disabled (MRT_PROFILE=0) or never started in this process —
        an explicit marker, so a fleet merge can tell "no CPU burned"
        from "not profiling"."""
        from .profile import get_profiler

        reset = not (isinstance(args, dict) and args.get("reset") is False)
        prof = get_profiler()
        return {
            "name": self._node.obs.name,
            "pid": os.getpid(),
            "now_us": now_us(),
            "profile": (
                None if prof is None
                else (prof.drain() if reset else prof.snapshot())
            ),
        }

    def tail(self, args: Any = None) -> Dict[str, Any]:
        """Drain the process's tail-exemplar store (tail.py) — the
        per-request lifecycle records retained since the previous
        scrape.  ``{"reset": False}`` peeks without draining (bundle
        collection uses this: evidence gathering must not consume the
        evidence).  ``tail`` is None when the plane is off
        (MRT_TAIL=0 / MRT_STAGECLOCK=0) — an explicit marker, so a
        fleet merge can tell "no slow requests" from "not looking"."""
        reset = not (isinstance(args, dict) and args.get("reset") is False)
        store = getattr(self._node, "tail", None)
        return {
            "name": self._node.obs.name,
            "pid": os.getpid(),
            "now_us": now_us(),
            "tail": (
                None if store is None
                else (store.drain() if reset else store.snapshot())
            ),
        }


# The state planes ObsControl.groups reads.
_GROUP_PLANES = (
    "role", "alive", "term", "commit", "applied", "log_len", "base",
    "voters_old", "voters_new", "joint", "cfg_idx",
)


def install_obs(node: Any) -> ObsControl:
    """Register the ``"Obs"`` service on ``node`` (idempotent in effect;
    mirrors chaos.install_chaos)."""
    ctl = ObsControl(node)
    node.add_service("Obs", ctl)
    return ctl
