"""Sim↔engine differential conformance — the golden-parity rig (the
PyTorch port's copy of ``multiraft_tpu/conformance.py``).

SURVEY §7.2 step 5 demands golden parity between the two consensus
backends: the event-driven :class:`~multiraft_tpu_torch.raft.node.RaftNode`
simulator is the correctness oracle, and the batched tensor engine
(:mod:`multiraft_tpu_torch.engine`, on the card or the CPU) must agree
with it.  This module drives
BOTH backends through the *same* seeded scenario script — a timed
schedule of crashes, restarts, partitions, message loss, reordering,
and a serialized client pump — and asserts:

* **Identical committed command streams.**  Clients propose commands
  ``0..N-1`` serially (command *k+1* only after *k* is observed
  committed), so on every backend the committed log, deduplicated by
  first occurrence, must be exactly ``[0, 1, ..., N-1]`` — the same
  sequence, in the same order.  This is the state-machine equivalence
  the services above consume: the applied state is a pure function of
  this stream.  (Terms and absolute indices are NOT compared across
  backends: virtual-seconds futures vs synchronous ticks elect leaders
  at different terms by construction.  Each backend's own
  ``(index, term)`` stream is instead checked for internal safety —
  see below.)
* **Per-tick / per-apply safety.**  The sim runs under the harness's
  cross-server invariant appliers (reference: raft/config.go:144-186);
  the engine runs under :class:`InvariantMonitor`, which asserts
  election safety, committed-term durability, log matching, and
  monotonicity after every tick.
* **Convergence.**  After the script's heal point, both backends must
  commit all N commands within a bounded drain window and converge to
  matching logs.

Timing map: one engine tick = :data:`TICK_S` = 10 ms of sim virtual
time, under which the engine's default timers (HB_TICKS=9,
ELECT_MIN/MAX=30/60) equal the sim's (90 ms heartbeat, 300–600 ms
election window; reference: raft/raft.go:42-50).

Fuzz mode: :func:`random_scenario` generates a seeded random fault
script; tests/test_torch_conformance.py runs a fixed scenario battery
plus fuzz seeds on both backends.

The engine half runs where ``device`` says (``None`` means ``cuda``, and
raises without a card).  Each tick reads the planes it needs to the
host once (``_PLANES``, through ``EngineDriver.np_state``), never once
per group: on the card every read is a device-to-host copy.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

__all__ = [
    "Event",
    "Scenario",
    "ConformanceError",
    "run_sim",
    "run_engine",
    "run_both",
    "random_scenario",
    "SCENARIOS",
    "TICK_S",
]

TICK_S = 0.01  # one engine tick == 10 ms of sim virtual time

# Client pump pacing: a proposed-but-uncommitted command is re-proposed
# after this long (covers leader loss / truncated entries on both
# backends; duplicates are deduplicated by the stream comparison).
RETRY_S = 1.0

# Drain window after heal-all within which every command must commit.
DRAIN_S = 40.0

# Post-heal flush command (filtered from streams): forces commit
# rediscovery after a full restart, where the current-term guard blocks
# commit advance until a fresh entry commits.
SENTINEL = -1

# The planes the engine half reads each tick: the invariant monitor's
# and the committed-stream frontier's.
_PLANES = ("term", "commit", "role", "alive", "base", "log_len", "log_term")
_LEADER_PLANES = ("role", "alive", "term")


class ConformanceError(AssertionError):
    pass


@dataclasses.dataclass(frozen=True)
class Event:
    """One timed fault-script action.

    ``kind`` ∈ {crash, restart, crash_leader, restart_all, cut, heal,
    cut_leader, heal_all, drop, reorder}; ``arg`` is a replica id for
    the targeted kinds, a probability for ``drop`` (0 disables; the sim
    maps any nonzero onto labrpc's unreliable mode), a bool for
    ``reorder``.
    """

    time_s: float
    kind: str
    arg: Any = None


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A backend-agnostic conformance scenario."""

    name: str
    n_cmds: int = 25
    P: int = 3
    events: Tuple[Event, ...] = ()
    heal_at_s: float = 3.0  # when heal-all fires; drain phase follows
    # burst > 1 pipelines proposals; ordering across a burst is not
    # defined (backlog re-queues scramble it), so ordered=False relaxes
    # the stream assert to completeness + per-backend safety.
    burst: int = 1
    ordered: bool = True
    engine_L: int = 48  # ring capacity (small values force compaction)
    sim_snapshot: bool = False  # sim-side service snapshots every 10


# ---------------------------------------------------------------------------
# Sim backend runner
# ---------------------------------------------------------------------------


def _dedup(stream: List[int]) -> List[int]:
    seen: Set[int] = set()
    out = []
    for v in stream:
        if v not in seen:
            seen.add(v)
            out.append(v)
    return out


def run_sim(sc: Scenario, seed: int = 0) -> List[int]:
    """Run ``sc`` on the RaftNode simulator; return the deduplicated
    committed command stream.  Safety is enforced continuously by the
    harness invariant appliers; raises on timeout or violation."""
    from .harness.raft_harness import RaftHarness

    h = RaftHarness(sc.P, unreliable=False, snapshot=sc.sim_snapshot, seed=seed)
    try:
        return _run_sim_inner(h, sc)
    finally:
        h.cleanup()


def _sim_leader(h) -> Optional[int]:
    best, best_term = None, -1
    for i in range(h.n):
        r = h.rafts[i]
        if r is not None and h.connected[i]:
            term, is_leader = r.get_state()
            if is_leader and term > best_term:
                best, best_term = i, term
    return best


def _run_sim_inner(h, sc: Scenario) -> List[int]:
    events = sorted(sc.events, key=lambda e: e.time_s)
    ei = 0
    inflight: Dict[int, float] = {}  # cmd -> last propose time
    next_cmd = 0
    committed: Set[int] = set()
    crashed: Set[int] = set()
    cut: Set[int] = set()
    healed = False
    deadline = sc.heal_at_s + DRAIN_S
    real_cmds = set(range(sc.n_cmds))
    sentinel_at = float("-inf")

    def fire(ev: Event) -> None:
        nonlocal healed
        kind, a = ev.kind, ev.arg
        if kind in ("crash_leader", "cut_leader"):
            a = _sim_leader(h)
            if a is None:
                return
            kind = "crash" if kind == "crash_leader" else "cut"
        if kind == "crash":
            if a not in crashed:
                h.crash1(a)
                crashed.add(a)
                cut.discard(a)
        elif kind == "restart":
            if a in crashed:
                h.start1(a)
                h.connect(a)
                crashed.discard(a)
        elif kind == "restart_all":
            for i in sorted(crashed):
                h.start1(i)
                h.connect(i)
            crashed.clear()
        elif kind == "cut":
            if a not in crashed and a not in cut:
                h.disconnect(a)
                cut.add(a)
        elif kind == "heal":
            if a in cut:
                h.connect(a)
                cut.discard(a)
        elif kind == "heal_all":
            for i in sorted(crashed):
                h.start1(i)
            crashed.clear()
            for i in range(h.n):
                h.connect(i)
            cut.clear()
            h.net.set_reliable(True)
            h.net.set_long_reordering(False)
            healed = True
        elif kind == "drop":
            h.net.set_reliable(not a)
        elif kind == "reorder":
            h.net.set_long_reordering(bool(a))
        else:  # pragma: no cover - scenario author error
            raise ValueError(f"unknown event kind {kind!r}")

    while h.sched.now < deadline:
        now = h.sched.now
        while ei < len(events) and events[ei].time_s <= now:
            fire(events[ei])
            ei += 1
        if not healed and now >= sc.heal_at_s:
            fire(Event(now, "heal_all"))
        # Observe commits (any replica applying a value proves commit).
        visible: Set[int] = set()
        for log in h.logs:
            visible.update(log.values())
        for v in visible:
            if v not in committed:
                committed.add(v)
                inflight.pop(v, None)
        # Done only when the CURRENT logs cover every command: a
        # crash-restart wipes the harness apply record, and commit is
        # only rediscovered once a current-term entry commits (the
        # current-term guard), so after healing we must drive a fresh
        # sentinel until the whole prefix re-applies — the reference's
        # post-heal one() does the same (raft/config.go:569-619).
        if healed and len(visible & real_cmds) == sc.n_cmds:
            break
        if (
            healed
            and next_cmd >= sc.n_cmds
            and now - sentinel_at >= RETRY_S
        ):
            lead = _sim_leader(h)
            if lead is not None:
                _, _, ok = h.rafts[lead].start(SENTINEL)
                if ok:
                    sentinel_at = now
        # Pump: keep up to ``burst`` uncommitted proposals in flight.
        stale = [c for c, t0 in inflight.items() if now - t0 >= RETRY_S]
        want_new = sc.burst - len(inflight)
        for c in stale + [None] * max(0, want_new):
            if c is None:
                if next_cmd >= sc.n_cmds:
                    continue
                c, is_new = next_cmd, True
            else:
                is_new = False
            lead = _sim_leader(h)
            if lead is None:
                break
            _, _, ok = h.rafts[lead].start(c)
            if ok:
                inflight[c] = now
                if is_new:
                    next_cmd += 1
            else:
                break
        h.sched.run_for(2 * TICK_S)

    n_visible = len(
        real_cmds & set().union(*[set(l.values()) for l in h.logs])
    )
    if n_visible != sc.n_cmds:
        raise ConformanceError(
            f"sim[{sc.name}]: only {n_visible}/{sc.n_cmds} commands "
            f"applied by t={h.sched.now:.1f}s "
            f"({len(committed)} ever observed committed)"
        )
    # Let replication quiesce, then extract the stream by index order.
    h.sched.run_for(1.0)
    idx2cmd: Dict[int, int] = {}
    for log in h.logs:
        idx2cmd.update(log)  # cross-server consistency enforced by appliers
    stream = [
        v for v in _dedup([idx2cmd[i] for i in sorted(idx2cmd)]) if v >= 0
    ]
    if h.apply_err:
        raise ConformanceError(f"sim[{sc.name}]: {h.apply_err}")
    return stream


# ---------------------------------------------------------------------------
# Engine backend runner
# ---------------------------------------------------------------------------


def run_engine(
    sc: Scenario,
    seed: int = 0,
    groups: int = 2,
    device: Any = None,
    stats: Optional[Dict[str, Any]] = None,
) -> List[List[int]]:
    """Run ``sc`` on the batched engine with ``groups`` independent
    lanes (each lane experiences the same fault schedule but draws its
    own timer jitter) under the per-tick :class:`InvariantMonitor`, on
    ``device`` (``None``: ``cuda``).  Returns one deduplicated committed
    command stream per group; ``stats``, when given, receives the
    engine's tick count (``ticks``)."""
    from .engine.core import EngineConfig
    from .engine.host import EngineDriver
    from .engine.invariants import InvariantMonitor

    cfg = EngineConfig(
        G=groups,
        P=sc.P,
        L=sc.engine_L,
        E=4,
        INGEST=max(4, sc.burst),
    )
    d = EngineDriver(cfg, seed=seed, device=device)
    mon = InvariantMonitor(d)
    G = groups

    events = sorted(sc.events, key=lambda e: e.time_s)
    ei = 0
    heal_tick = int(round(sc.heal_at_s / TICK_S))
    deadline = heal_tick + int(round(DRAIN_S / TICK_S))
    retry_ticks = int(round(RETRY_S / TICK_S))

    inflight: List[Dict[int, int]] = [dict() for _ in range(G)]
    next_cmd = [0] * G
    committed: List[Set[int]] = [set() for _ in range(G)]
    raw_stream: List[List[int]] = [[] for _ in range(G)]
    read_upto = [0] * G
    crashed: Set[Tuple[int, int]] = set()
    cut: Set[Tuple[int, int]] = set()
    healed = False
    # (g, abs index) -> term of the accepting leader: disambiguates a
    # stale payload binding from the entry that actually committed.
    bind_term: Dict[Tuple[int, int], int] = {}
    # Indices bound more than once at distinct terms: the one case
    # where the payload dict may misreport the committed value when no
    # ring still covers the index (see the frontier read below).
    suspect: Set[Tuple[int, int]] = set()

    def evicted(payload: Any) -> None:
        # The bound entry lost its slot: mark it immediately stale so
        # the pump re-proposes it next tick (unless it committed).
        g, c = payload
        if c not in committed[g] and c in inflight[g]:
            inflight[g][c] = -(10**9)

    d.on_payload_evicted = evicted

    def fire(ev: Event) -> None:
        nonlocal healed
        kind, a = ev.kind, ev.arg
        if kind == "drop":
            d.drop_prob = float(a)
            return
        if kind == "reorder":
            d.set_reorder(2.0 / 3.0 if a else 0.0, 2, 10)
            return
        lead_st = (
            d.np_state(_LEADER_PLANES)
            if kind in ("crash_leader", "cut_leader") else None
        )
        for g in range(G):
            k, p = kind, a
            if k in ("crash_leader", "cut_leader"):
                p = d.leader_of(g, lead_st)
                if p is None:
                    continue
                k = "crash" if k == "crash_leader" else "cut"
            if k == "crash":
                if (g, p) not in crashed:
                    # A crash supersedes a live partition (the sim's
                    # crash1 drops the cut; start1+connect reconnects),
                    # so heal the edges — they're inert while dead.
                    if (g, p) in cut:
                        d.partition_replica(g, p, True)
                        cut.discard((g, p))
                    d.set_alive(g, p, False)
                    crashed.add((g, p))
            elif k == "restart":
                if (g, p) in crashed:
                    d.restart_replica(g, p)
                    mon.note_restart(g, p)
                    crashed.discard((g, p))
            elif k == "restart_all":
                for gg, pp in sorted(crashed):
                    if gg == g:
                        d.restart_replica(gg, pp)
                        mon.note_restart(gg, pp)
                crashed.difference_update({c for c in list(crashed) if c[0] == g})
            elif k == "cut":
                if (g, p) not in cut:
                    d.partition_replica(g, p, False)
                    cut.add((g, p))
            elif k == "heal":
                if (g, p) in cut:
                    d.partition_replica(g, p, True)
                    cut.discard((g, p))
            elif k == "heal_all":
                pass  # handled once below
            else:  # pragma: no cover - scenario author error
                raise ValueError(f"unknown event kind {kind!r}")
        if kind == "heal_all":
            for g, p in sorted(crashed):
                d.restart_replica(g, p)
                mon.note_restart(g, p)
            crashed.clear()
            for g, p in sorted(cut):
                d.partition_replica(g, p, True)
            cut.clear()
            d.drop_prob = 0.0
            d.set_reorder(0.0)
            healed = True

    while d.tick < deadline:
        now_s = d.tick * TICK_S
        while ei < len(events) and events[ei].time_s <= now_s:
            fire(events[ei])
            ei += 1
        if not healed and d.tick >= heal_tick:
            fire(Event(now_s, "heal_all"))
        # Pump each group.
        for g in range(G):
            stale = [
                c for c, t0 in inflight[g].items()
                if d.tick - t0 >= retry_ticks
            ]
            want_new = sc.burst - len(inflight[g])
            for c in stale:
                d.start(g, (g, c))
                inflight[g][c] = d.tick
            for _ in range(max(0, want_new)):
                if next_cmd[g] >= sc.n_cmds:
                    break
                c = next_cmd[g]
                d.start(g, (g, c))
                inflight[g][c] = d.tick
                next_cmd[g] += 1
        metrics = d.step()
        st = d.np_state(_PLANES)
        mon.observe(st)
        # Bind fresh acceptances to the term they carry (stamped
        # device-side by the tick, metrics["accept_term"]); a re-bind
        # at a different term marks the index ambiguous.
        accepted = np.asarray(metrics["accepted"])
        starts = np.asarray(metrics["start_index"])
        accept_terms = np.asarray(metrics["accept_term"])
        for g in np.nonzero(accepted)[0]:
            gi = int(g)
            t_acc = int(accept_terms[g])
            for off in range(int(accepted[g])):
                slot = (gi, int(starts[g]) + 1 + off)
                old_t = bind_term.get(slot)
                if old_t is not None and old_t != t_acc:
                    suspect.add(slot)
                bind_term[slot] = t_acc
        # Advance the committed-stream read frontier.
        commit_max = st["commit"].max(axis=1)
        for g in range(G):
            c = int(commit_max[g])
            for i in range(read_upto[g] + 1, c + 1):
                payload = d.payloads.get((g, i))
                if payload is None:
                    continue  # index never bound (cannot happen in practice)
                # Verify the binding against the committed term where
                # any replica's ring still covers index i; a mismatch
                # means the binding is from a later, uncommitted
                # acceptance at i (revived-branch race) — skip it and
                # let the retry path settle the command.  When no ring
                # covers i (compacted the tick it committed), the
                # binding is still exact unless the index was ever
                # bound at two distinct terms (``suspect``): with a
                # single acceptance, the committed entry can only be
                # that acceptance.
                bt = bind_term.get((g, i))
                ok = True
                if bt is not None:
                    covered = False
                    for p in range(sc.P):
                        base = int(st["base"][g, p])
                        last = base + int(st["log_len"][g, p])
                        if base < i <= last:
                            covered = True
                            ok = int(st["log_term"][g, p][i % cfg.L]) == bt
                            break
                    if not covered and (g, i) in suspect:
                        ok = False
                if not ok:
                    continue
                _, cval = payload
                raw_stream[g].append(cval)
                if cval not in committed[g]:
                    committed[g].add(cval)
                    inflight[g].pop(cval, None)
            read_upto[g] = max(read_upto[g], c)
        if healed and all(len(committed[g]) == sc.n_cmds for g in range(G)):
            break

    for g in range(G):
        if len(committed[g]) != sc.n_cmds:
            raise ConformanceError(
                f"engine[{sc.name}] group {g}: only {len(committed[g])}/"
                f"{sc.n_cmds} commands committed by tick {d.tick}"
            )
        d.check_log_matching(g)
    if stats is not None:
        stats["ticks"] = d.tick
    return [_dedup(s) for s in raw_stream]


# ---------------------------------------------------------------------------
# Differential assertion + scenario battery
# ---------------------------------------------------------------------------


def run_both(
    sc: Scenario,
    seed: int = 0,
    device: Any = None,
    stats: Optional[Dict[str, Any]] = None,
) -> Tuple[List[int], List[List[int]]]:
    """Run ``sc`` on both backends (the engine on ``device``; ``None``:
    ``cuda``) and assert the committed command streams are identical
    (and, for ordered scenarios, in proposal order).  Returns the sim's
    stream and the engine's, one per group, for callers that hold them
    against a third run; ``stats`` goes to :func:`run_engine`."""
    expect = list(range(sc.n_cmds))
    sim_stream = run_sim(sc, seed=seed)
    engine_streams = run_engine(sc, seed=seed, device=device, stats=stats)
    if sc.ordered:
        if sim_stream != expect:
            raise ConformanceError(
                f"sim[{sc.name}]: committed stream {sim_stream} != {expect}"
            )
        for g, s in enumerate(engine_streams):
            if s != expect:
                raise ConformanceError(
                    f"engine[{sc.name}] group {g}: stream {s} != {expect}"
                )
        assert all(s == sim_stream for s in engine_streams)
    else:
        if sorted(sim_stream) != expect:
            raise ConformanceError(
                f"sim[{sc.name}]: committed set {sorted(sim_stream)} != {expect}"
            )
        for g, s in enumerate(engine_streams):
            if sorted(s) != expect:
                raise ConformanceError(
                    f"engine[{sc.name}] group {g}: set {sorted(s)} != {expect}"
                )
    return sim_stream, engine_streams


def random_scenario(seed: int) -> Scenario:
    """Fuzz mode: a seeded random fault script, safe-by-construction
    (faults stop at heal_at_s; the drain phase completes the pump)."""
    rng = random.Random(seed)
    P = rng.choice([3, 3, 5])
    heal_at = rng.uniform(3.0, 5.0)
    events: List[Event] = []
    t = 0.5
    max_down = (P - 1) // 2
    n_down = 0  # crashes + cuts currently outstanding (leader kinds count)
    cut_now: List[int] = []
    while t < heal_at - 0.5:
        roll = rng.random()
        if roll < 0.3 and n_down < max_down:
            kind = rng.choice(["crash", "cut", "crash_leader"])
            p = None if kind == "crash_leader" else rng.randrange(P)
            if p is not None and p in cut_now:
                pass  # already cut; skip this beat
            else:
                events.append(Event(t, kind, p))
                n_down += 1
                if kind == "cut":
                    cut_now.append(p)
        elif roll < 0.5 and n_down:
            # Revive everything at once (restart crashes, heal cuts) —
            # the coarse heal keeps bookkeeping backend-agnostic.
            events.append(Event(t, "restart_all"))
            for p in cut_now:
                events.append(Event(t, "heal", p))
            cut_now.clear()
            n_down = 0
        elif roll < 0.7:
            events.append(Event(t, "drop", rng.choice([0.0, 0.1, 0.2])))
        elif roll < 0.8:
            events.append(Event(t, "reorder", rng.random() < 0.5))
        t += rng.uniform(0.3, 0.8)
    return Scenario(
        name=f"fuzz-{seed}",
        n_cmds=20,
        P=P,
        events=tuple(events),
        heal_at_s=heal_at,
    )


SCENARIOS: Dict[str, Scenario] = {
    s.name: s
    for s in [
        Scenario(name="quiet", n_cmds=30, heal_at_s=0.5),
        Scenario(
            name="leader_crash",
            events=(
                Event(1.0, "crash_leader"),
                Event(2.2, "restart_all"),
            ),
        ),
        Scenario(
            name="follower_crash",
            events=(Event(1.0, "crash", 2), Event(2.2, "restart", 2)),
        ),
        Scenario(
            name="rolling_leader_crashes",
            heal_at_s=5.0,
            events=(
                Event(1.0, "crash_leader"),
                Event(1.8, "restart_all"),
                Event(2.4, "crash_leader"),
                Event(3.2, "restart_all"),
                Event(3.8, "crash_leader"),
                Event(4.6, "restart_all"),
            ),
        ),
        Scenario(
            name="partition_leader",
            events=(Event(1.0, "cut_leader"), Event(2.2, "heal_all")),
        ),
        Scenario(
            name="partition_cycle",
            heal_at_s=4.5,
            events=(
                Event(1.0, "cut", 0),
                Event(1.8, "heal", 0),
                Event(2.0, "cut", 1),
                Event(2.8, "heal", 1),
                Event(3.0, "cut", 2),
                Event(3.8, "heal", 2),
            ),
        ),
        Scenario(
            name="unreliable",
            n_cmds=20,
            heal_at_s=4.0,
            events=(Event(0.0, "drop", 0.1),),
        ),
        Scenario(
            name="reorder",
            n_cmds=20,
            heal_at_s=4.0,
            events=(Event(0.0, "reorder", True),),
        ),
        Scenario(
            name="snapshot_pressure",
            n_cmds=60,
            burst=6,
            ordered=False,
            engine_L=24,
            sim_snapshot=True,
            heal_at_s=4.0,
            events=(Event(1.0, "cut", 1), Event(3.0, "heal", 1)),
        ),
        Scenario(
            name="cocktail",
            n_cmds=20,
            heal_at_s=5.0,
            events=(
                Event(0.0, "drop", 0.1),
                Event(1.0, "cut", 0),
                Event(2.0, "heal", 0),
                Event(2.2, "crash_leader"),
                Event(3.2, "restart_all"),
                Event(3.5, "reorder", True),
            ),
        ),
        Scenario(
            name="total_outage",
            events=(
                Event(1.0, "crash", 0),
                Event(1.05, "crash", 1),
                Event(1.1, "crash", 2),
                Event(2.0, "restart_all"),
            ),
        ),
        Scenario(
            name="five_peers_two_down",
            P=5,
            events=(
                Event(1.0, "crash", 1),
                Event(1.2, "crash", 3),
                Event(2.4, "restart_all"),
            ),
        ),
    ]
}
