"""Nemesis: seeded fault schedules against live engine process
clusters.

PyTorch port of ``multiraft_tpu/harness/nemesis.py``.  The default
``load_surge`` driver fires this package's open-loop generator
(``multiraft_tpu_torch/benchmarks/openloop.py``), the counterpart of
the reference's ``benchmarks/openloop.py``.

The sim backend is routinely tested under labrpc-style faults; this
module brings the same discipline to the deployment path.  A
:func:`make_schedule` call turns ``(seed, n_procs)`` into a
deterministic timeline of fault windows — delay storms, drop storms
(requests AND replies), pair partitions, full isolation, mid-stream
connection severs, crash + restart-from-WAL/checkpoint, open-loop
load surges (the admission-control stressor) — and
:class:`Nemesis` executes it against a running cluster through the
servers' ``"Chaos"`` control RPC (distributed/chaos.py), while
:func:`run_clerk_load` applies concurrent blocking-clerk traffic and
collects the porcupine history that proves the fleet stayed
linearizable through it all.

Determinism: the schedule is a pure function of its arguments — the
acceptance bar "the same seed reproduces the same fault schedule" is
``make_schedule(s, n) == make_schedule(s, n)``, and the runner's
``applied`` log records what was actually executed.  (Per-frame coin
flips inside each server draw from the server's own seeded RNG and
depend on traffic order; the *windows* — what faults, where, when —
are exactly reproducible.)

Usage::

    cluster = EngineProcessCluster(..., chaos_seed=7)
    cluster.start()
    sched = make_schedule(seed=7, n_procs=1, duration_s=6.0,
                          include=("delay", "drop", "sever"))
    nem = Nemesis([(cluster.host, cluster.port)])
    t = nem.run_async(sched)
    history = run_clerk_load(cluster.clerk, keys=["a", "b"])
    t.join(); nem.close()
    assert_linearizable(kv_model, history, ...)

Fault windows heal themselves (every storm has a bounded ``dur`` and
the schedule ends with a global heal), so clerk retry loops always
converge — pick per-op timeouts longer than the longest window.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..distributed.chaos import ChaosRule
from ..distributed.observe import now_us
from ..distributed.tcp import RpcNode
from ..sim.scheduler import TIMEOUT
from ..utils.knobs import knob_str

__all__ = [
    "make_schedule",
    "ChaosClient",
    "Nemesis",
    "NemesisVerificationError",
    "run_clerk_load",
]

Addr = Tuple[str, int]
# One schedule entry: (at_seconds, kind, params) — plain data so tests
# can compare whole schedules across runs.
Event = Tuple[float, str, Dict[str, Any]]


def make_schedule(
    seed: int,
    n_procs: int,
    duration_s: float = 8.0,
    include: Sequence[str] = ("delay", "drop", "partition", "sever"),
    crash_procs: Sequence[int] = (),
    crash_down_s: float = 1.0,
    kill_procs: Sequence[int] = (),
    kill_replicas: Sequence[Tuple[int, int]] = (),
    fault_s: Tuple[float, float] = (0.6, 1.8),
    quiet_s: Tuple[float, float] = (0.2, 0.8),
    surge_rate: float = 0.0,
    surge_dur_s: float = 1.5,
    surge_proc: int = 0,
) -> List[Event]:
    """Deterministic fault timeline: alternating fault windows and
    quiet gaps until ``duration_s``, plus one crash+restart per entry
    of ``crash_procs`` (placed in the middle of the run, where traffic
    and chaos overlap it).  Same arguments ⇒ identical schedule.

    ``include`` picks the window kinds: ``delay`` (labrpc's
    unreliable/long-delay mix on a process's inbound frames), ``drop``
    (inbound drops + reply drops — the dedup-exercising case),
    ``partition`` (symmetric pair block, n_procs ≥ 2), ``isolate``
    (one process's inbound fully blocked — the minority case), and
    ``sever`` (cut every live connection once, mid-stream).

    Gray-failure kinds (the faults that wedge fleets without tripping
    fail-stop detectors): ``asym_partition`` (ONE-WAY block a→b —
    b still reaches a; n_procs ≥ 2), ``partial_partition`` (one
    process severed from every OTHER engine process in both
    directions while client traffic still flows — the
    leader-hears-clerks-but-not-quorum case; n_procs ≥ 2),
    ``slow_link`` (deterministic per-frame latency floor on a
    process's inbound frames — degraded-but-alive, not burst jitter),
    and ``fsync_stall`` (every durable write on a process stalls —
    slow-but-alive storage, injected through distributed/disk.py).

    ``surge_rate`` > 0 adds one ``load_surge`` window mid-run: an
    open-loop request burst at that offered rate (ops/s) fired at
    process ``surge_proc`` for ``surge_dur_s`` seconds — the
    admission-control stressor.  The burst rides the nemesis's own
    window ledger, so :meth:`Nemesis.verify_windows` can require that
    the surge demonstrably reached the server (replies came back)
    while the rest of the schedule's faults were live.

    ``kill_procs``: one PERMANENT ``kill_mesh_process`` per entry —
    unlike ``crash``, the process is never restarted; the placement
    controller (distributed/placement.py) is what re-places its groups
    onto survivors.  Keep ``kill_procs`` disjoint from ``crash_procs``
    (a crash's restart would resurrect a process the placement layer
    has already declared dead).

    ``kill_replicas``: one PERMANENT ``kill_replica`` per ``(gid,
    peer)`` entry — the serving process survives but ONE engine
    replica row of group ``gid`` never ticks again.  Recovery is the
    controller's replace-dead-replica policy (learner → catch-up →
    joint entry → promote), not a restart; this is the fault the
    self-healing acceptance runs schedule against clerk load."""
    rng = random.Random(seed)
    _pairwise = ("partition", "asym_partition", "partial_partition")
    kinds = [k for k in include if k not in _pairwise or n_procs > 1]
    events: List[Event] = []
    t = rng.uniform(*quiet_s)
    while t < duration_s and kinds:
        kind = rng.choice(kinds)
        dur = round(rng.uniform(*fault_s), 3)
        i = rng.randrange(n_procs)
        at = round(t, 3)
        if kind == "partition":
            j = rng.choice([x for x in range(n_procs) if x != i])
            events.append((at, "partition", {"a": i, "b": j, "dur": dur}))
        elif kind == "delay":
            events.append((at, "delay_storm", {
                "proc": i, "dur": dur,
                "prob": round(rng.uniform(0.3, 0.9), 3),
                "delay_min": 0.0,
                "delay_max": round(rng.uniform(0.05, 0.4), 3),
            }))
        elif kind == "drop":
            events.append((at, "drop_storm", {
                "proc": i, "dur": dur,
                "prob": round(rng.uniform(0.2, 0.6), 3),
            }))
        elif kind == "isolate":
            events.append((at, "isolate", {"proc": i, "dur": dur}))
        elif kind == "asym_partition":
            j = rng.choice([x for x in range(n_procs) if x != i])
            events.append(
                (at, "asym_partition", {"a": i, "b": j, "dur": dur})
            )
        elif kind == "partial_partition":
            events.append((at, "partial_partition", {"proc": i, "dur": dur}))
        elif kind == "slow_link":
            events.append((at, "slow_link", {
                "proc": i, "dur": dur,
                "floor": round(rng.uniform(0.02, 0.12), 3),
            }))
        elif kind == "fsync_stall":
            events.append((at, "fsync_stall", {
                "proc": i, "dur": dur,
                "stall": round(rng.uniform(0.05, 0.3), 3),
            }))
        elif kind == "sever":
            events.append((at, "sever", {"proc": i}))
        else:
            raise ValueError(f"unknown fault kind {kind!r}")
        t += dur + rng.uniform(*quiet_s)
    for k, proc in enumerate(crash_procs):
        # Mid-run, staggered so two crashes never overlap.
        at = round(duration_s * (0.35 + 0.25 * k / max(1, len(crash_procs))), 3)
        events.append((at, "crash", {"proc": int(proc),
                                     "down": float(crash_down_s)}))
    if surge_rate > 0.0:
        # One open-loop burst, mid-run: overlaps both traffic and any
        # fault windows scheduled around the 40% mark.
        events.append((round(duration_s * 0.4, 3), "load_surge", {
            "proc": int(surge_proc),
            "rate": float(surge_rate),
            "dur": round(float(surge_dur_s), 3),
        }))
    for k, proc in enumerate(kill_procs):
        # Permanent kills land mid-run with traffic and chaos live.
        at = round(
            duration_s * (0.45 + 0.2 * k / max(1, len(kill_procs))), 3
        )
        events.append((at, "kill_mesh_process", {"proc": int(proc)}))
    for k, (gid, peer) in enumerate(kill_replicas):
        # Replica kills land early (~30%) so the whole learner →
        # joint → promote pipeline plays out under the remaining
        # chaos windows and traffic.
        at = round(
            duration_s * (0.3 + 0.2 * k / max(1, len(kill_replicas))), 3
        )
        events.append(
            (at, "kill_replica", {"gid": int(gid), "peer": int(peer)})
        )
    # The global heal comes strictly after every window has closed —
    # it must be the schedule's last executed action.
    end = max(
        [duration_s]
        + [at + p.get("dur", p.get("down", 0.0)) for at, _, p in events]
    )
    events.append((round(end + 0.05, 3), "heal", {}))
    events.sort(key=lambda e: (e[0], e[1]))
    return events


class ChaosClient:
    """Control-plane client: one chaos-free :class:`RpcNode` driving
    every target's ``"Chaos"`` service.  Control frames are exempt
    from the targets' inbound/reply chaos (chaos.py), so this client
    can always reach — and heal — a faulted fleet; a CRASHED target is
    simply unreachable, and calls to it return ``None``."""

    def __init__(self, addrs: Sequence[Addr]) -> None:
        self.node = RpcNode()
        self.sched = self.node.sched
        self.addrs = [tuple(a) for a in addrs]
        self.ends = {a: self.node.client_end(*a) for a in self.addrs}
        self._rng = random.Random(0x0C0A5)

    def call(
        self, addr: Addr, meth: str, args: Any = None,
        timeout: float = 2.0, retries: int = 5,
    ) -> Any:
        for attempt in range(retries):
            reply = self.sched.wait(
                self.ends[addr].call(f"Chaos.{meth}", args), timeout
            )
            if reply is not None and reply is not TIMEOUT:
                return reply
            # Jittered: several ChaosClients retrying against the same
            # recovering target must not re-arrive in lockstep.
            base = 0.05 * (attempt + 1)
            time.sleep(base / 2.0 + self._rng.random() * (base / 2.0))
        return None

    def set_rules(self, addr: Addr, wire: Dict[str, Any]) -> Any:
        return self.call(addr, "set_rules", wire)

    def clear(self, addr: Addr) -> Any:
        return self.call(addr, "clear")

    def clear_all(self) -> None:
        for a in self.addrs:
            self.clear(a)

    def sever(self, addr: Addr, target: Optional[Addr] = None) -> Any:
        return self.call(
            addr, "sever", list(target) if target else None
        )

    def ping(self, addr: Addr) -> bool:
        return self.call(addr, "ping") == "pong"

    def stats(self, addr: Addr) -> Any:
        return self.call(addr, "stats")

    def close(self) -> None:
        self.node.close()


def _rule(**kw) -> Dict[str, Any]:
    return ChaosRule(**kw).to_wire()


def _openloop_surge_fire(
    host: str, port: int, rate: float, dur: float, seed: int,
    service: str = "EngineKV",
) -> int:
    """Default ``load_surge`` driver: one open-loop burst from this
    package's open-loop generator (``benchmarks/openloop.py``) at the
    server's ``<service>.command`` RPC
    (``"EngineShardKV"`` for a ``serve-shardkv`` target).  Returns the
    number of requests that got ANY reply (OK, error, or a shed
    ``ErrBusy``) — the window's proof that the burst actually reached
    the server."""
    from ..benchmarks.openloop import fire_schedule, gen_schedule

    sched = gen_schedule(seed=seed, rate=rate, duration=dur)
    rep = fire_schedule(host, port, sched, duration=dur, service=service,
                        drain_s=1.0)
    return int(rep.get("replied", 0))


class NemesisVerificationError(AssertionError):
    """A scheduled fault window never demonstrably fired — the run was
    a false green (the fleet was never actually under that fault)."""


class Nemesis:
    """Executes a :func:`make_schedule` timeline against live servers.

    ``addrs[i]`` is process ``i``'s ``(host, port)``; ``kill`` /
    ``restart`` are callables taking the process index (the cluster's
    own ``kill``/``start`` methods) and are required only when the
    schedule contains crash events.

    The runner keeps a local model of each target's full rule set and
    pushes complete snapshots on every change — overlapping fault
    windows compose, and a restarted process (which comes back with
    clean rules) is re-pushed its active set.  ``applied`` logs every
    executed action in order, for reproducibility assertions and
    postmortems."""

    def __init__(
        self,
        addrs: Sequence[Addr],
        kill: Optional[Callable[[int], None]] = None,
        restart: Optional[Callable[[int], None]] = None,
        surge_fire: Optional[Callable[..., int]] = None,
        kill_replica: Optional[Callable[[int, int], bool]] = None,
    ) -> None:
        self.addrs = [tuple(a) for a in addrs]
        self.ctl = ChaosClient(self.addrs)
        self._kill = kill
        self._restart = restart
        # kill_replica(gid, peer) -> bool: permanently kill ONE engine
        # replica row (the fleet's kill_replica verb) — required only
        # when the schedule contains kill_replica events.
        self._kill_replica = kill_replica
        # load_surge burst driver: (host, port, rate, dur, seed) ->
        # replied count.  Injectable so fast tests swap in a fake; the
        # default fires this package's open-loop generator.
        self._surge_fire = surge_fire or _openloop_surge_fire
        self._surge_threads: Dict[int, threading.Thread] = {}
        self.applied: List[Tuple[str, str, Dict[str, Any]]] = []
        self._model: Dict[Addr, Dict[str, Any]] = {
            a: {"peers": {}, "all_out": None, "all_in": None, "reply": None}
            for a in self.addrs
        }
        # Window verification ledger (see verify_windows): one record
        # per scheduled fault window, with actual wall times in this
        # process's perf_counter µs domain (so harness/observe.py can
        # overlay them on a merged trace without further alignment).
        self.windows: List[Dict[str, Any]] = []
        self._open: Dict[int, Dict[str, Any]] = {}
        # Procs permanently removed by kill_mesh_process: later windows
        # targeting them are excused instead of pushed into the void.
        self._dead: set = set()
        self.t0_us: Optional[float] = None
        self.error: Optional[BaseException] = None

    # -- model push --------------------------------------------------------

    def _push(self, addr: Addr) -> Optional[Dict[str, Any]]:
        """Push the full rule snapshot; the ack (the target's own
        post-configure snapshot, including its chaos hit ledger) is how
        windows prove they actually landed."""
        return self.ctl.set_rules(addr, self._model[addr])

    def _log(self, phase: str, kind: str, p: Dict[str, Any]) -> None:
        self.applied.append((phase, kind, dict(p)))

    # -- window ledger -----------------------------------------------------

    @staticmethod
    def _hit_count(snap, paths, kinds) -> int:
        hits = (snap or {}).get("hits") or {}
        return sum(
            int((hits.get(path) or {}).get(k, 0))
            for path in paths
            for k in kinds
        )

    def _window(self, kind: str, p: Dict[str, Any], procs) -> Dict[str, Any]:
        w = {
            "kind": kind, "p": dict(p), "procs": list(procs),
            "t_start_us": now_us(), "t_stop_us": None,
            "acked": False, "hits": 0, "baseline": 0, "excused": None,
        }
        self.windows.append(w)
        self._open[id(p)] = w
        return w

    @staticmethod
    def _hit_spec(kind: str, p, addrs) -> List[Tuple[Addr, list, tuple]]:
        """Which (target, hit-ledger paths, fault kinds) prove a window
        of this kind applied at least one fault."""
        if kind == "delay_storm":
            return [(addrs[p["proc"]], ["all_in"], ("delay",))]
        if kind == "drop_storm":
            return [(addrs[p["proc"]], ["all_in", "reply"], ("drop",))]
        if kind == "isolate":
            return [(addrs[p["proc"]], ["all_in"], ("block",))]
        if kind == "partition":
            aa, ab = addrs[p["a"]], addrs[p["b"]]
            return [
                (aa, [f"peer:{ab[0]}:{ab[1]}"], ("block",)),
                (ab, [f"peer:{aa[0]}:{aa[1]}"], ("block",)),
            ]
        if kind == "asym_partition":
            # One-way: only a's outbound edge carries the block rule.
            aa, ab = addrs[p["a"]], addrs[p["b"]]
            return [(aa, [f"peer:{ab[0]}:{ab[1]}"], ("block",))]
        if kind == "partial_partition":
            i = p["proc"]
            a = addrs[i]
            others = p.get("others")
            if others is None:
                others = [x for x in range(len(addrs)) if x != i]
            specs = [(
                a,
                [f"peer:{addrs[x][0]}:{addrs[x][1]}" for x in others],
                ("block",),
            )]
            specs += [
                (addrs[x], [f"peer:{a[0]}:{a[1]}"], ("block",))
                for x in others
            ]
            return specs
        if kind == "slow_link":
            return [(addrs[p["proc"]], ["all_in"], ("floor",))]
        if kind == "fsync_stall":
            return [(addrs[p["proc"]], ["disk"], ("fsync_stall",))]
        return []

    # -- actions -----------------------------------------------------------

    @staticmethod
    def _procs_of(p: Dict[str, Any]) -> List[int]:
        return [p[k] for k in ("proc", "a", "b") if k in p]

    def _start(self, kind: str, p: Dict[str, Any]) -> None:
        self._log("start", kind, p)
        procs = self._procs_of(p)
        if (
            kind not in ("heal", "kill_mesh_process")
            and any(x in self._dead for x in procs)
        ):
            # Target already permanently killed — nothing to fault.
            w = self._window(kind, p, procs)
            w["acked"] = True
            w["excused"] = "target killed (kill_mesh_process)"
            w["t_stop_us"] = now_us()
            self._open.pop(id(p), None)
            return
        if kind == "delay_storm":
            a = self.addrs[p["proc"]]
            w = self._window(kind, p, [p["proc"]])
            self._model[a]["all_in"] = _rule(
                delay=p["prob"], delay_min=p["delay_min"],
                delay_max=p["delay_max"],
            )
            self._ack_start(w, [self._push(a)])
        elif kind == "drop_storm":
            a = self.addrs[p["proc"]]
            w = self._window(kind, p, [p["proc"]])
            self._model[a]["all_in"] = _rule(drop=p["prob"])
            # Reply drops: the op APPLIED but the ack is lost — only
            # session dedup keeps the client's retry exactly-once.
            self._model[a]["reply"] = _rule(drop=p["prob"] / 2.0)
            self._ack_start(w, [self._push(a)])
        elif kind == "isolate":
            a = self.addrs[p["proc"]]
            w = self._window(kind, p, [p["proc"]])
            self._model[a]["all_in"] = _rule(block=True)
            self._ack_start(w, [self._push(a)])
        elif kind == "partition":
            aa, ab = self.addrs[p["a"]], self.addrs[p["b"]]
            w = self._window(kind, p, [p["a"], p["b"]])
            self._model[aa]["peers"][f"{ab[0]}:{ab[1]}"] = _rule(block=True)
            self._model[ab]["peers"][f"{aa[0]}:{aa[1]}"] = _rule(block=True)
            self._ack_start(w, [self._push(aa), self._push(ab)])
        elif kind == "asym_partition":
            # ONE-WAY block: a's frames toward b vanish; b→a flows.
            # Only a carries a rule — the fault class check-quorum must
            # catch (the leader's appends die while everything it hears
            # says the fleet is healthy).
            aa, ab = self.addrs[p["a"]], self.addrs[p["b"]]
            w = self._window(kind, p, [p["a"], p["b"]])
            self._model[aa]["peers"][f"{ab[0]}:{ab[1]}"] = _rule(block=True)
            self._ack_start(w, [self._push(aa)])
        elif kind == "partial_partition":
            # Sever proc i from every OTHER engine process, both
            # directions, via per-peer rules only: client connections
            # match no peer rule, so a leader living on i still hears
            # its clerks while its quorum is gone — the wedge-shaped
            # gray failure the check-quorum stepdown exists for.
            i = p["proc"]
            a = self.addrs[i]
            others = [
                x for x in range(len(self.addrs))
                if x != i and x not in self._dead
            ]
            p["others"] = others  # pinned for _stop/_hit_spec symmetry
            w = self._window(kind, p, [i] + others)
            for x in others:
                b = self.addrs[x]
                self._model[a]["peers"][f"{b[0]}:{b[1]}"] = _rule(block=True)
                self._model[b]["peers"][f"{a[0]}:{a[1]}"] = _rule(block=True)
            self._ack_start(
                w,
                [self._push(a)] + [self._push(self.addrs[x]) for x in others],
            )
        elif kind == "slow_link":
            a = self.addrs[p["proc"]]
            w = self._window(kind, p, [p["proc"]])
            # Latency floor on EVERY inbound frame — degraded-but-alive,
            # where delay_storm is probabilistic burst jitter.
            self._model[a]["all_in"] = _rule(floor=p["floor"])
            self._ack_start(w, [self._push(a)])
        elif kind == "fsync_stall":
            a = self.addrs[p["proc"]]
            w = self._window(kind, p, [p["proc"]])
            ack = self.ctl.call(a, "fsync_stall", [p["stall"]])
            w["acked"] = ack is not None
            # Stall hits land in the target's chaos ledger ("disk"
            # path) as storage traffic syncs; baseline from stats, not
            # from a rule push (the stall is not a wire rule).
            w["baseline"] = self._hit_count(
                self.ctl.stats(a), ["disk"], ("fsync_stall",)
            )
            if not w["acked"]:
                w["excused"] = "fsync_stall push unacknowledged (target down?)"
        elif kind == "load_surge":
            a = self.addrs[p["proc"]]
            w = self._window(kind, p, [p["proc"]])
            w["acked"] = True  # the burst thread is ours to run
            seed = int(p["rate"]) + 1009 * p["proc"]

            def _burst(w=w, a=a, p=p, seed=seed) -> None:
                try:
                    w["hits"] = int(self._surge_fire(
                        a[0], a[1], p["rate"], p["dur"], seed,
                    ))
                except Exception as exc:  # noqa: BLE001 - ledgered
                    w["acked"] = False
                    w["excused"] = f"surge burst failed: {exc!r}"

            t = threading.Thread(
                target=_burst, name="nemesis-surge", daemon=True,
            )
            self._surge_threads[id(p)] = t
            t.start()
        elif kind == "sever":
            w = self._window(kind, p, [p["proc"]])
            cut = self.ctl.sever(self.addrs[p["proc"]])
            w["acked"] = cut is not None
            w["hits"] = int(cut or 0)
            w["t_stop_us"] = now_us()
            self._open.pop(id(p), None)
        elif kind == "crash":
            if self._kill is None:
                raise ValueError("crash event but no kill callback")
            w = self._window(kind, p, [p["proc"]])
            self._kill(p["proc"])
            w["acked"] = True  # the kill callback ran
        elif kind == "kill_mesh_process":
            # Permanent: no paired stop, no restart.  Recovery is the
            # placement controller's job, not the nemesis's.
            if self._kill is None:
                raise ValueError(
                    "kill_mesh_process event but no kill callback"
                )
            w = self._window(kind, p, [p["proc"]])
            self._kill(p["proc"])
            self._dead.add(p["proc"])
            w["acked"] = True
            w["t_stop_us"] = now_us()
            self._open.pop(id(p), None)
        elif kind == "kill_replica":
            # Permanent single-replica death (the process lives):
            # healing is the placement controller's joint-consensus
            # replacement, never a restart.
            if self._kill_replica is None:
                raise ValueError(
                    "kill_replica event but no kill_replica callback"
                )
            w = self._window(kind, p, [])
            w["acked"] = bool(
                self._kill_replica(p["gid"], p["peer"])
            )
            if not w["acked"]:
                w["excused"] = "replica not hosted (already moved?)"
            w["t_stop_us"] = now_us()
            self._open.pop(id(p), None)
        elif kind == "heal":
            self.heal_all()
        else:
            raise ValueError(f"unknown nemesis action {kind!r}")

    def _ack_start(self, w: Dict[str, Any], acks) -> None:
        w["acked"] = all(a is not None for a in acks)
        spec = self._hit_spec(w["kind"], w["p"], self.addrs)
        w["baseline"] = sum(
            self._hit_count(ack, paths, kinds)
            for ack, (_, paths, kinds) in zip(acks, spec)
        )
        if not w["acked"]:
            # The only reachable-in-theory failure: the target is down
            # (an overlapping crash window) — the control plane itself
            # is chaos-exempt, so a live target always acks.
            w["excused"] = "start push unacknowledged (target down?)"

    def _stop(self, kind: str, p: Dict[str, Any]) -> None:
        self._log("stop", kind, p)
        w = self._open.pop(id(p), None)
        if any(x in self._dead for x in self._procs_of(p)):
            # The window's target died permanently mid-window; there is
            # no rule state left to tear down.
            if w is not None:
                w["t_stop_us"] = now_us()
                w["excused"] = (
                    w["excused"] or "target killed (kill_mesh_process)"
                )
            return
        if kind == "load_surge":
            # The burst fires for exactly p["dur"]; the stop action
            # lands right as it ends, so the join is a drain wait.
            t = self._surge_threads.pop(id(p), None)
            if t is not None:
                t.join(timeout=p["dur"] + 15.0)
            if w is not None:
                w["t_stop_us"] = now_us()
                if t is not None and t.is_alive():
                    w["acked"] = False
                    w["excused"] = "surge burst never finished"
        elif kind in ("delay_storm", "drop_storm", "isolate", "partition",
                      "asym_partition", "partial_partition", "slow_link",
                      "fsync_stall"):
            if kind == "partition":
                aa, ab = self.addrs[p["a"]], self.addrs[p["b"]]
                self._model[aa]["peers"].pop(f"{ab[0]}:{ab[1]}", None)
                self._model[ab]["peers"].pop(f"{aa[0]}:{aa[1]}", None)
                acks = [self._push(aa), self._push(ab)]
            elif kind == "asym_partition":
                aa, ab = self.addrs[p["a"]], self.addrs[p["b"]]
                self._model[aa]["peers"].pop(f"{ab[0]}:{ab[1]}", None)
                acks = [self._push(aa)]
            elif kind == "partial_partition":
                i = p["proc"]
                a = self.addrs[i]
                others = [
                    x for x in p.get("others", ())
                    if x not in self._dead
                ]
                for x in others:
                    b = self.addrs[x]
                    self._model[a]["peers"].pop(f"{b[0]}:{b[1]}", None)
                    self._model[b]["peers"].pop(f"{a[0]}:{a[1]}", None)
                acks = [self._push(a)] + [
                    self._push(self.addrs[x]) for x in others
                ]
            elif kind == "fsync_stall":
                a = self.addrs[p["proc"]]
                # Lift the stall, then read the hit delta from stats
                # (the stall is armed by verb, not by a wire rule).
                lifted = self.ctl.call(a, "fsync_stall", [0.0])
                acks = [
                    self.ctl.stats(a) if lifted is not None else None
                ]
            else:
                a = self.addrs[p["proc"]]
                self._model[a]["all_in"] = None
                if kind == "drop_storm":
                    self._model[a]["reply"] = None
                acks = [self._push(a)]
            if w is not None:
                w["t_stop_us"] = now_us()
                spec = self._hit_spec(kind, p, self.addrs)
                if all(a is not None for a in acks):
                    total = sum(
                        self._hit_count(ack, paths, kinds)
                        for ack, (_, paths, kinds) in zip(acks, spec)
                    )
                    w["hits"] = max(0, total - w["baseline"])
                else:
                    w["excused"] = (
                        w["excused"] or "stop push unacknowledged"
                    )
        elif kind == "crash":
            if self._restart is None:
                raise ValueError("crash event but no restart callback")
            self._restart(p["proc"])
            # The reborn process has clean rules; re-push its active
            # set so a crash inside another fault window composes.
            ack = self._push(self.addrs[p["proc"]])
            if w is not None:
                w["t_stop_us"] = now_us()
            if ack is not None:
                # Open windows targeting this proc had their rules
                # re-installed by that push — they are live after all.
                for w2 in self.windows:
                    if (
                        w2["t_stop_us"] is None
                        and p["proc"] in w2["procs"]
                        and not w2["acked"]
                    ):
                        w2["acked"] = True
                        w2["excused"] = "re-acked after crash restart"

    def heal_all(self) -> None:
        for a in self.addrs:
            self._model[a] = {
                "peers": {}, "all_out": None, "all_in": None, "reply": None,
            }
        self.ctl.clear_all()

    # -- verification ------------------------------------------------------

    def verify_windows(self, require_hits: Sequence[str] = ()) -> None:
        """Assert every scheduled fault window demonstrably fired.

        Baseline check (always): each window's rule push was
        acknowledged by the target (the control plane is chaos-exempt,
        so an unacked push means the window silently missed), each
        crash's kill callback ran, each sever got a cut-count reply.
        A window whose target was down for an overlapping crash is
        excused only if the restart re-push re-installed its rules.

        ``require_hits`` names window kinds (e.g. ``("drop_storm",)``)
        that must additionally show ≥ 1 fault actually applied (chaos
        hit-ledger delta over the window) — stricter, but only sound
        when the caller guarantees traffic at the faulted process
        during every window.  Raises :class:`NemesisVerificationError`
        listing every silent miss."""
        bad: List[str] = []
        for n, w in enumerate(self.windows):
            tag = f"window {n}: {w['kind']} {w['p']}"
            if not w["acked"]:
                bad.append(f"{tag} — never acknowledged"
                           f" ({w['excused'] or 'no excuse recorded'})")
            elif (
                w["kind"] in require_hits and w["hits"] < 1
                and not w["excused"]
            ):
                bad.append(f"{tag} — acked but zero faults applied")
        if bad:
            reason = (
                "scheduled fault windows did not fire:\n  "
                + "\n  ".join(bad)
            )
            self._auto_bundle(reason)
            raise NemesisVerificationError(reason)

    def _auto_bundle(self, reason: str) -> Optional[str]:
        """Collect a postmortem bundle when ``MRT_POSTMORTEM_DIR`` is
        set (timestamped subdirectory).  Verification failures are
        exactly the runs worth a black-box readout, and by the time a
        human looks, the fleet is gone — so collection is automatic
        and best-effort (never masks the verification error)."""
        root = knob_str("MRT_POSTMORTEM_DIR")
        if not root:
            return None
        from .bundle import collect_bundle  # local: avoid import cycle

        out = os.path.join(
            root, f"nemesis-{os.getpid()}-{int(time.time() * 1000)}"
        )
        try:
            return collect_bundle(
                out, addrs=self.addrs, reason=reason,
                windows=self.windows, t0_us=self.t0_us,
            )
        except Exception:  # pragma: no cover - best-effort by design
            return None

    # -- execution ---------------------------------------------------------

    def run(self, schedule: Sequence[Event], verify: bool = True) -> None:
        """Execute the timeline in this thread.  Blocking actions
        (restart-from-WAL waits for the readiness line) push later
        actions back; the log records intent order, which is the
        deterministic part.  With ``verify`` (default), raises
        :class:`NemesisVerificationError` at the end if any window
        silently missed (see :meth:`verify_windows`)."""
        actions: List[Tuple[float, int, str, str, Dict[str, Any]]] = []
        for n, (at, kind, p) in enumerate(schedule):
            if kind in ("delay_storm", "drop_storm", "isolate",
                        "partition", "asym_partition", "partial_partition",
                        "slow_link", "fsync_stall", "load_surge"):
                actions.append((at, n, "start", kind, p))
                actions.append((at + p["dur"], n, "stop", kind, p))
            elif kind == "crash":
                actions.append((at, n, "start", kind, p))
                actions.append((at + p["down"], n, "stop", kind, p))
            else:  # sever / heal: instantaneous
                actions.append((at, n, "start", kind, p))
        actions.sort(key=lambda a: (a[0], a[1], a[2] == "start"))
        t0 = time.monotonic()
        # Anchor for timeline overlays: schedule second ``at`` maps to
        # perf_counter µs ``self.t0_us + at*1e6`` in this process.
        self.t0_us = now_us()
        for at, _, phase, kind, p in actions:
            delay = at - (time.monotonic() - t0)
            if delay > 0:
                time.sleep(delay)
            if phase == "start":
                self._start(kind, p)
            else:
                self._stop(kind, p)
        if verify:
            self.verify_windows()

    def run_async(self, schedule: Sequence[Event]) -> threading.Thread:
        """Run the schedule on a daemon thread (the usual shape: the
        nemesis runs WHILE the caller applies clerk load).  Join the
        returned thread, then call :meth:`verify_windows` — a raise
        inside the daemon thread would vanish, so auto-verify is off
        here and any execution error is re-raised from ``self.error``
        by :meth:`verify_windows`'s caller checking it (or just read
        ``nem.error`` after join)."""
        self.error: Optional[BaseException] = None

        def _run() -> None:
            try:
                self.run(list(schedule), verify=False)
            except BaseException as exc:  # noqa: BLE001 - surfaced via .error
                self.error = exc

        t = threading.Thread(target=_run, name="nemesis", daemon=True)
        t.start()
        return t

    def close(self) -> None:
        self.ctl.close()


def run_clerk_load(
    make_clerk: Callable[[], Any],
    keys: Sequence[str],
    n_workers: int = 3,
    ops_per_worker: int = 9,
    op_timeout: float = 90.0,
    trace_sink: Optional[list] = None,
) -> list:
    """Concurrent blocking-clerk load returning a porcupine history.

    Each worker owns one clerk and alternates appends (unique
    ``(worker.op)`` tags — exactly-once is checkable afterwards from
    any Get) with gets.  ``op_timeout`` must exceed the schedule's
    longest fault window: every fault heals itself, so a retrying
    clerk always converges and the history contains no ambiguous
    (timed-out) operations — porcupine then checks completed ops only.

    ``trace_sink``: a list that collects each clerk node's trace
    events (drained just before the clerk closes — clerk-side request
    spans would otherwise die with the node).  Events are already in
    this process's clock domain; harness/observe.py merges them with
    the servers' scraped traces.

    Worker exceptions propagate after all threads join (a hung clerk
    is a test failure, not a deadlock)."""
    from ..porcupine.kv import OP_APPEND, OP_GET, KvInput, KvOutput
    from ..porcupine.model import Operation

    history: list = []
    lock = threading.Lock()
    failures: list = []

    def worker(wid: int) -> None:
        ck = make_clerk()
        try:
            for j in range(ops_per_worker):
                key = keys[(wid + j) % len(keys)]
                t0 = time.monotonic()
                if j % 3 == 2:
                    v = ck.get(key, timeout=op_timeout)
                    inp = KvInput(op=OP_GET, key=key)
                    out = KvOutput(value=v)
                else:
                    tag = f"({wid}.{j})"
                    ck.append(key, tag, timeout=op_timeout)
                    inp = KvInput(op=OP_APPEND, key=key, value=tag)
                    out = KvOutput(value="")
                with lock:
                    history.append(Operation(
                        client_id=ck.client_id, input=inp, call=t0,
                        output=out, ret=time.monotonic(),
                    ))
        except Exception as exc:  # noqa: BLE001 - reported after join
            failures.append((wid, exc))
        finally:
            if trace_sink is not None:
                node = getattr(ck, "node", None)
                obs = getattr(node, "obs", None)
                if obs is not None:
                    events, _dropped = obs.tracer.drain()
                    with lock:
                        trace_sink.extend(events)
            ck.close()

    threads = [
        threading.Thread(target=worker, args=(i,), name=f"clerk-{i}")
        for i in range(n_workers)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failures:
        raise failures[0][1]
    return history
