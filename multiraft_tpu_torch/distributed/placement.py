"""Fleet placement controller — elastic cross-host group placement.

ARCHITECTURE §7 ends with "cross-host group placement is the transport
layer's job, not the kernel's"; this module is that job.  Three layers:

* :class:`PlacementCtrler` — the placement MAP (raft group → mesh
  process) as its own Raft-replicated state machine, riding the same
  machinery as :class:`~multiraft_tpu_torch.services.shardctrler.ShardCtrler`
  so the map survives its own leader dying.  Migrations are two-phase
  in the map (``Begin`` intent → ``Commit``): a controller that dies
  mid-migration is resumed by its successor from the replicated intent,
  which is what makes the idempotent migration legs safe to retry —
  without the intent, a restarted controller could pull the same sealed
  source a second time and adopt it at a DIFFERENT destination, forking
  the group.

* :func:`plan_moves` — the pure planner: weighted minimal-movement
  rebalance (:func:`~multiraft_tpu_torch.services.shardctrler.
  rebalance_weighted`) over per-group commit rates scraped from
  ``Obs.groups``, wrapped in the anti-thrash policy (hysteresis on
  relative spread gain, per-group cooldown, bounded moves per round).
  Failover moves — groups on a process that stopped answering
  ``Obs.ping`` within the deadline — bypass hysteresis and the cap:
  healing is never rate-limited by politeness knobs.

* :class:`PlacementController` — the real-time loop: scrape → plan →
  execute → push.  Execution rides the group-migration RPCs on
  :class:`~.engine_shard_server.EngineShardKVService` (``pull_group``
  seal+export at the source, ``adopt_group`` into a spare engine slot
  at the destination, ``drop_group`` back at the source), then pushes
  the new placement map fleet-wide (``place``) so servers re-derive
  their peer maps and clerks re-route.

Every knob reads an ``MRT_PLACE_*`` env var (constructor args win):

=====================  =======  ==========================================
MRT_PLACE_SCRAPE_S     0.5      seconds between controller rounds
MRT_PLACE_DEAD_S       3.0      no Obs.ping for this long → process dead
MRT_PLACE_COOLDOWN_S   5.0      a moved group may not move again sooner
MRT_PLACE_MIN_GAIN     0.25     min relative load-spread reduction to act
MRT_PLACE_MAX_MOVES    1        voluntary moves per round (failover exempt)
=====================  =======  ==========================================

Failure-detection semantics: liveness is "answered ``Obs.ping`` within
``dead_s``", judged on the controller's monotonic clock from its LAST
successful ping of that process.  A dead process's groups are adopted
EMPTY at survivors (``blob=None``) and re-pull whatever shards live
owners still hold — in a non-durable fleet the dead process's own
shard data is gone (the documented fleet crash model; durable placed
fleets are future work, see BatchedShardKV.load_state_dict's gid
guard).  A process declared dead must STAY dead: this module never
restarts processes, and a zombie that answers pings again after its
groups were re-placed keeps answering ErrWrongGroup for them (its
placement view is version-gated forward by the next push).

Every decision emits a PLACE flight record (code=gid, a=src, b=dst,
c=version, tag=reason) and ``place.*`` tracer spans sharing the stage
vocabulary (``scripts/trace_summary.py --placements`` renders them).

PyTorch port of ``multiraft_tpu/distributed/placement.py``: the same
map, planner and controller, on this package's Raft, codec and
servers; it touches no device.  Deviations (ROADMAP queue C): a
running controller fences the fleet with leases (``_contact``: each
ping grants a process ``dead_s`` more of client service, renewed from a
thread of its own, and a dead process's groups move only once its last
lease has run out, so a live process declared dead has stopped serving
them); a failover waits for every live standby's probe to answer; a
migration whose source died before its destination adopted the group
is dropped and failed over to the freshest standby; the planner's
cooldown is never shorter than the doctor's thrash window
(``_voluntary_cooldown_s``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..services.shardctrler import rebalance_weighted
from ..utils.knobs import knob_bool, knob_float, knob_int
from ..transport import codec

__all__ = [
    "PlaceArgs",
    "PlaceReply",
    "PlacementCtrler",
    "PlacementClerk",
    "LocalPlacementStore",
    "TcpFleetTransport",
    "PlacementController",
    "plan_moves",
    "place_knobs",
]

OK = "OK"
ERR_WRONG_LEADER = "ErrWrongLeader"
ERR_TIMEOUT = "ErrTimeout"

QUERY = "Query"
SET = "Set"
BEGIN = "Begin"
DISPATCH = "Dispatch"
COMMIT = "Commit"
ABORT = "Abort"
# Replica-replacement (reconfig) intents — same two-phase discipline as
# migrations, but phased: a controller that dies between legs is
# resumed by its successor AT the recorded phase, which is what keeps
# add-learner / begin-joint retries idempotent instead of forking the
# group's membership.
RBEGIN = "RcfgBegin"
RPHASE = "RcfgPhase"
RDONE = "RcfgDone"
RABORT = "RcfgAbort"

# Bounded decision history kept in the replicated state (enough for
# the doctor's thrash window without growing the snapshot unboundedly).
HISTORY_CAP = 256


def place_knobs() -> Dict[str, float]:
    """The MRT_PLACE_* knob set, env-resolved (docs in module header)."""
    return {
        "scrape_s": knob_float("MRT_PLACE_SCRAPE_S"),
        "dead_s": knob_float("MRT_PLACE_DEAD_S"),
        "cooldown_s": knob_float("MRT_PLACE_COOLDOWN_S"),
        "min_gain": knob_float("MRT_PLACE_MIN_GAIN"),
        "max_moves": knob_int("MRT_PLACE_MAX_MOVES"),
        "replace": knob_bool("MRT_PLACE_REPLACE"),
        "replace_deadline_s": knob_float("MRT_PLACE_REPLACE_DEADLINE_S"),
    }


# ---------------------------------------------------------------------------
# The replicated placement map (ShardCtrler pattern)
# ---------------------------------------------------------------------------


@codec.registered
@dataclasses.dataclass
class PlaceArgs:
    """Unified op args (mirrors CtrlerArgs)."""

    op: str = QUERY
    placement: Dict[int, int] = dataclasses.field(default_factory=dict)
    gid: int = 0
    dst: int = 0
    reason: str = ""
    # Reconfig-intent fields (RBEGIN/RPHASE): the dead voter being
    # replaced, the spare slot replacing it, and the recorded phase.
    peer: int = -1
    new_peer: int = -1
    phase: str = ""
    client_id: int = 0
    command_id: int = 0


@codec.registered
@dataclasses.dataclass
class PlaceReply:
    err: str = OK
    version: int = 0
    placement: Dict[int, int] = dataclasses.field(default_factory=dict)
    # gid → (dst, reason, dispatched): ``dispatched`` flips once an
    # adopt RPC may have been sent — from then on the source may only
    # be force-unsealed with the destination provably dead.
    pending: Dict[int, Tuple[int, str, bool]] = dataclasses.field(
        default_factory=dict
    )
    # Recent committed moves: (version, gid, src, dst, reason).
    history: List[Tuple[int, int, int, int, str]] = dataclasses.field(
        default_factory=list
    )
    # gid → (dead_peer, new_peer, phase): in-flight replica-replacement
    # reconfigs, resumable by a successor controller at the phase.
    reconfigs: Dict[int, Tuple[int, int, str]] = dataclasses.field(
        default_factory=dict
    )


class PlacementCtrler:
    """Placement-map RSM server (RPC surface ``Placement.command``) —
    the :class:`~multiraft_tpu_torch.services.shardctrler.ShardCtrler`
    skeleton verbatim: dedup by (client_id, command_id), waiters keyed
    on log index, snapshot/restore through the codec.

    State machine ops:

    * ``Set``    — install a whole map (fleet bootstrap), bumps version;
    * ``Begin``    — record migration INTENT ``gid → dst`` (no version
      bump: the map still answers the old owner until commit);
    * ``Dispatch`` — mark a begun intent's adopt RPC as (possibly)
      sent; a successor controller reading the intent knows it may no
      longer plain-unseal the source;
    * ``Commit``   — apply a begun intent: version += 1, map updated,
      decision appended to the bounded history;
    * ``Abort``    — drop an intent (destination died before adoption);
    * ``Query``    — read version, map, pending intents, history.
    """

    def __init__(
        self,
        sched,
        ends,
        me: int,
        persister,
        maxraftstate: int = -1,
        seed: int = 0,
    ) -> None:
        from ..raft.node import RaftNode
        from ..sim.scheduler import Future
        from ..utils.config import settings as _settings

        self.sched = sched
        self.me = me
        self.maxraftstate = maxraftstate
        self._snapshot_threshold = _settings().service.snapshot_threshold
        self._server_wait = _settings().service.server_wait
        self.version = 0
        self.placement: Dict[int, int] = {}
        self.pending: Dict[int, Tuple[int, str]] = {}
        self.reconfigs: Dict[int, Tuple[int, int, str]] = {}
        self.history: List[Tuple[int, int, int, int, str]] = []
        self.latest: Dict[int, int] = {}
        self._waiters: Dict[tuple, Future] = {}
        self._Future = Future
        self._killed = False
        self.rf = RaftNode(sched, ends, me, persister, self._on_apply,
                           seed=seed)
        self._install_snapshot(persister.read_snapshot())

    # -- RPC ------------------------------------------------------------

    def command(self, args: PlaceArgs):
        from ..sim.scheduler import TIMEOUT

        if self._killed:
            return PlaceReply(err=ERR_WRONG_LEADER)
        if (
            args.op != QUERY
            and self.latest.get(args.client_id, -1) >= args.command_id
        ):
            return self._reply()
        index, term, is_leader = self.rf.start(args)
        if not is_leader:
            return PlaceReply(err=ERR_WRONG_LEADER)
        fut = self._Future()
        key = (args.client_id, args.command_id, index)
        self._waiters[key] = fut
        result = yield self.sched.with_timeout(fut, self._server_wait)
        self._waiters.pop(key, None)
        if result is TIMEOUT:
            return PlaceReply(err=ERR_TIMEOUT)
        return result

    def _reply(self) -> PlaceReply:
        return PlaceReply(
            err=OK,
            version=self.version,
            placement=dict(self.placement),
            pending=dict(self.pending),
            history=list(self.history),
            reconfigs=dict(self.reconfigs),
        )

    # -- apply ----------------------------------------------------------

    def _on_apply(self, msg) -> None:
        if self._killed:
            return
        if msg.snapshot_valid:
            self._install_snapshot(msg.snapshot)
            return
        if not msg.command_valid:
            return
        args: PlaceArgs = msg.command
        is_dup = self.latest.get(args.client_id, -1) >= args.command_id
        if args.op != QUERY and not is_dup:
            if args.op == SET:
                self.placement = {
                    int(g): int(p) for g, p in args.placement.items()
                }
                self.version += 1
            elif args.op == BEGIN:
                self.pending[args.gid] = (args.dst, args.reason, False)
            elif args.op == DISPATCH:
                intent = self.pending.get(args.gid)
                if intent is not None:
                    self.pending[args.gid] = (
                        intent[0], intent[1], True
                    )
            elif args.op == COMMIT:
                intent = self.pending.pop(args.gid, None)
                if intent is not None:
                    dst, reason = intent[0], intent[1]
                    src = self.placement.get(args.gid, -1)
                    self.version += 1
                    self.placement[args.gid] = dst
                    self.history.append(
                        (self.version, args.gid, src, dst, reason)
                    )
                    del self.history[:-HISTORY_CAP]
            elif args.op == ABORT:
                self.pending.pop(args.gid, None)
            elif args.op == RBEGIN:
                self.reconfigs[args.gid] = (
                    int(args.peer), int(args.new_peer), "learner"
                )
            elif args.op == RPHASE:
                intent = self.reconfigs.get(args.gid)
                if intent is not None:
                    self.reconfigs[args.gid] = (
                        intent[0], intent[1], args.phase
                    )
            elif args.op == RDONE:
                intent = self.reconfigs.pop(args.gid, None)
                if intent is not None:
                    # No version bump — the gid→proc map is unchanged;
                    # the decision still lands in the bounded history.
                    self.history.append((
                        self.version, args.gid, intent[0], intent[1],
                        "replace-replica",
                    ))
                    del self.history[:-HISTORY_CAP]
            elif args.op == RABORT:
                self.reconfigs.pop(args.gid, None)
        if not is_dup:
            self.latest[args.client_id] = args.command_id
        waiter = self._waiters.get(
            (args.client_id, args.command_id, msg.command_index)
        )
        if waiter is not None:
            term, is_leader = self.rf.get_state()
            if is_leader and term == msg.command_term:
                waiter.resolve(self._reply())
        self._maybe_snapshot(msg.command_index)

    # -- snapshots -------------------------------------------------------

    def _maybe_snapshot(self, index: int) -> None:
        if self.maxraftstate < 0:
            return
        if self.rf.raft_state_size() >= (
            self._snapshot_threshold * self.maxraftstate
        ):
            blob = codec.encode({
                "version": self.version,
                "placement": dict(self.placement),
                "pending": dict(self.pending),
                "reconfigs": dict(self.reconfigs),
                "history": list(self.history),
                "latest": dict(self.latest),
            })
            self.rf.snapshot(index, blob)

    def _install_snapshot(self, data: bytes) -> None:
        if not data:
            return
        blob = codec.decode(data)
        self.version = blob["version"]
        self.placement = dict(blob["placement"])
        # Snapshots from before dispatch tracking hold 2-tuples:
        # normalize to (dst, reason, dispatched=False).
        self.pending = {
            int(g): (v[0], v[1],
                     bool(v[2]) if len(v) > 2 else False)
            for g, v in blob["pending"].items()
        }
        # Snapshots from before replica replacement hold no reconfigs.
        self.reconfigs = {
            int(g): (int(v[0]), int(v[1]), str(v[2]))
            for g, v in (blob.get("reconfigs") or {}).items()
        }
        self.history = list(blob["history"])
        self.latest = dict(blob["latest"])

    def kill(self) -> None:
        self._killed = True
        self.rf.kill()


class PlacementClerk:
    """Sim-side clerk of the placement RSM (CtrlerClerk pattern:
    leader-cycling retries, nonce-qualified client id)."""

    _next_client_id = 1 << 21  # distinct from CtrlerClerk's range

    def __init__(self, sched, ends) -> None:
        from ..utils.ids import unique_client_id

        self.sched = sched
        self.ends = ends
        self.leader = 0
        PlacementClerk._next_client_id += 1
        self.client_id = unique_client_id(PlacementClerk._next_client_id)
        self.command_id = 0

    def _command(self, args: PlaceArgs):
        from ..sim.scheduler import TIMEOUT

        args.client_id = self.client_id
        self.command_id += 1
        args.command_id = self.command_id
        while True:
            fut = self.ends[self.leader].call("Placement.command", args)
            reply = yield self.sched.with_timeout(fut, 0.1)
            if (
                reply is TIMEOUT
                or reply is None
                or reply.err in (ERR_WRONG_LEADER, ERR_TIMEOUT)
            ):
                self.leader = (self.leader + 1) % len(self.ends)
                continue
            return reply

    def query(self):
        return (yield from self._command(PlaceArgs(op=QUERY)))

    def set_map(self, placement: Dict[int, int]):
        return (yield from self._command(
            PlaceArgs(op=SET, placement=dict(placement))
        ))

    def begin(self, gid: int, dst: int, reason: str):
        return (yield from self._command(
            PlaceArgs(op=BEGIN, gid=gid, dst=dst, reason=reason)
        ))

    def dispatch(self, gid: int):
        return (yield from self._command(
            PlaceArgs(op=DISPATCH, gid=gid)
        ))

    def commit(self, gid: int):
        return (yield from self._command(PlaceArgs(op=COMMIT, gid=gid)))

    def abort(self, gid: int):
        return (yield from self._command(PlaceArgs(op=ABORT, gid=gid)))

    def rbegin(self, gid: int, dead_peer: int, new_peer: int):
        return (yield from self._command(PlaceArgs(
            op=RBEGIN, gid=gid, peer=dead_peer, new_peer=new_peer,
        )))

    def rphase(self, gid: int, phase: str):
        return (yield from self._command(
            PlaceArgs(op=RPHASE, gid=gid, phase=phase)
        ))

    def rdone(self, gid: int):
        return (yield from self._command(PlaceArgs(op=RDONE, gid=gid)))

    def rabort(self, gid: int):
        return (yield from self._command(PlaceArgs(op=RABORT, gid=gid)))


class LocalPlacementStore:
    """Dict-backed stand-in for the replicated map — unit tests of the
    controller loop that don't need RSM fault tolerance.  Same verbs
    as the blocking RSM facade (harness/fleet.py)."""

    def __init__(self, placement: Optional[Dict[int, int]] = None) -> None:
        self.version = 1 if placement else 0
        self.placement = dict(placement or {})
        self.pending: Dict[int, Tuple[int, str, bool]] = {}
        self.reconfigs: Dict[int, Tuple[int, int, str]] = {}
        self.history: List[Tuple[int, int, int, int, str]] = []

    def query(self):
        return (
            self.version, dict(self.placement), dict(self.pending),
            list(self.history),
        )

    def set_map(self, placement: Dict[int, int]) -> int:
        self.placement = dict(placement)
        self.version += 1
        return self.version

    def begin(self, gid: int, dst: int, reason: str) -> None:
        self.pending[gid] = (dst, reason, False)

    def dispatch(self, gid: int) -> None:
        intent = self.pending.get(gid)
        if intent is not None:
            self.pending[gid] = (intent[0], intent[1], True)

    def commit(self, gid: int) -> int:
        intent = self.pending.pop(gid)
        dst, reason = intent[0], intent[1]
        src = self.placement.get(gid, -1)
        self.version += 1
        self.placement[gid] = dst
        self.history.append((self.version, gid, src, dst, reason))
        del self.history[:-HISTORY_CAP]
        return self.version

    def abort(self, gid: int) -> None:
        self.pending.pop(gid, None)

    # -- reconfig intents -----------------------------------------------

    def reconfig_intents(self) -> Dict[int, Tuple[int, int, str]]:
        return dict(self.reconfigs)

    def rbegin(self, gid: int, dead_peer: int, new_peer: int) -> None:
        self.reconfigs[gid] = (int(dead_peer), int(new_peer), "learner")

    def rphase(self, gid: int, phase: str) -> None:
        intent = self.reconfigs.get(gid)
        if intent is not None:
            self.reconfigs[gid] = (intent[0], intent[1], phase)

    def rdone(self, gid: int) -> None:
        intent = self.reconfigs.pop(gid, None)
        if intent is not None:
            self.history.append((
                self.version, gid, intent[0], intent[1],
                "replace-replica",
            ))
            del self.history[:-HISTORY_CAP]

    def rabort(self, gid: int) -> None:
        self.reconfigs.pop(gid, None)


# ---------------------------------------------------------------------------
# The pure planner
# ---------------------------------------------------------------------------


def plan_moves(
    placement: Dict[int, int],
    loads: Dict[int, float],
    alive: List[int],
    *,
    min_gain: float = 0.25,
    cooldown_s: float = 5.0,
    last_moved: Optional[Dict[int, float]] = None,
    now_s: float = 0.0,
    max_moves: int = 1,
    exclude: Optional[set] = None,
) -> List[Tuple[int, Optional[int], int, str]]:
    """Decide this round's migrations.  Returns
    ``[(gid, src_or_None, dst, reason), ...]`` — ``src None`` means the
    source process is dead (adopt empty).

    Policy, in order:

    1. **Failover first, unconditionally**: every group placed on a
       process not in ``alive`` is re-placed (weighted orphan
       assignment).  No hysteresis, no cooldown, no cap — a dark group
       serves nobody.
    2. **Hysteresis**: voluntary rebalance moves happen only if the
       planned assignment reduces the per-process load spread
       (max − min) by at least ``min_gain`` of the current spread.
    3. **Cooldown**: a group moved within ``cooldown_s`` stays put.
    4. **Cap**: at most ``max_moves`` voluntary moves per round —
       bounded concurrent migrations, by construction.

    ``exclude`` gids (migrations already in flight) are pinned where
    they are and planned around."""
    last_moved = last_moved or {}
    exclude = exclude or set()
    alive = sorted(set(alive))
    if not alive or not placement:
        return []
    # Weights: scraped commit rates; a group with no signal yet gets a
    # tiny epsilon so orphan assignment still spreads them out.
    eps = 1e-6
    weights = {g: max(loads.get(g, 0.0), eps) for g in placement}

    assign = {
        g: (p if p in set(alive) else None) for g, p in placement.items()
    }
    movable = {
        g: a for g, a in assign.items() if g not in exclude
    }
    pinned = {g: a for g, a in assign.items() if g in exclude}

    target, raw_moves = rebalance_weighted(movable, weights, alive)

    def spread(a: Dict[int, Optional[int]]) -> float:
        load = {p: 0.0 for p in alive}
        for g, p in a.items():
            if p in load:
                load[p] += weights[g]
        return max(load.values()) - min(load.values())

    failover = []
    voluntary = []
    for gid, src, dst in raw_moves:
        if src is None or src not in set(alive):
            failover.append((gid, None, dst, "failover"))
        else:
            voluntary.append((gid, src, dst, "rebalance"))

    # Hysteresis: judge the voluntary portion of the plan by the spread
    # it would actually achieve (failovers happen regardless).
    if voluntary:
        before = dict(assign)
        for gid, _, dst, _ in failover:
            before[gid] = dst  # failovers land either way
        after = dict(before)
        for gid, _, dst, _ in voluntary:
            after[gid] = dst
        s0, s1 = spread(before), spread(after)
        if s0 <= 0 or (s0 - s1) < min_gain * s0:
            voluntary = []

    # Cooldown + cap on the voluntary moves only.
    voluntary = [
        m for m in voluntary
        if now_s - last_moved.get(m[0], -1e18) >= cooldown_s
    ][:max(0, int(max_moves))]
    # Pinned gids stay pinned (sanity: planner never touches them).
    assert not any(m[0] in pinned for m in failover + voluntary)
    return failover + voluntary


# ---------------------------------------------------------------------------
# Transport (real sockets) + the controller loop
# ---------------------------------------------------------------------------


class TcpFleetTransport:
    """The controller's view of the fleet over real sockets: one
    client end per mesh process, Obs scrapes + group-migration RPCs.
    All calls are synchronous (``sched.wait`` from the controller
    thread) and timeout-bounded."""

    PING_S = 1.0
    SCRAPE_S = 2.0
    MIGRATE_S = 15.0
    PUSH_S = 5.0

    def __init__(self, node, addrs: List[Tuple[str, int]]) -> None:
        self.node = node
        self.sched = node.sched
        self.addrs = [(h, int(p)) for h, p in addrs]
        self._ends = [node.client_end(h, p) for h, p in self.addrs]
        # proc -> whether it answers the lease verb (a port fleet
        # server); learned from its first answer.
        self._fences: Dict[int, bool] = {}

    @property
    def n_procs(self) -> int:
        return len(self.addrs)

    def addr(self, proc: int) -> Tuple[str, int]:
        return self.addrs[proc]

    def _call(self, proc: int, meth: str, args: Any, timeout: float):
        from ..sim.scheduler import TIMEOUT

        reply = self.sched.wait(self._ends[proc].call(meth, args), timeout)
        return None if reply is TIMEOUT else reply

    def ping(self, proc: int) -> bool:
        return self._call(proc, "Obs.ping", None, self.PING_S) == "pong"

    def lease(self, proc: int, kind: str,
              deadline: Optional[float] = None
              ) -> Tuple[bool, Optional[float]]:
        """The fencing lease, carried by ``Obs.ping`` (ObsControl.ping):
        ``kind`` is ``"grant"`` (up to ``deadline``, on this host's
        CLOCK_MONOTONIC), ``"release"`` or ``"query"``.  Returns
        ``(answered, held)``: ``held`` is the deadline the process
        holds, None when it holds none or is not a port fleet server
        (the reference's servers answer a bare ``"pong"``)."""
        r = self._call(
            proc, "Obs.ping", ("lease", kind, deadline), self.PING_S
        )
        if r == "pong":
            self._fences[proc] = False
            return True, None
        if isinstance(r, tuple) and len(r) == 2 and r[0] == "pong":
            self._fences[proc] = True
            return True, r[1]
        return False, None

    def _answers_none_for_nothing(self, proc: int) -> bool:
        """True for a server that answers a bare None when it holds no
        standby state: one that answered the lease verb with a bare
        ``"pong"`` (the reference's).  The port's fleet servers answer
        ``"none"``, so a None from them is a lost answer."""
        if proc not in self._fences:
            self.lease(proc, "query")
        return self._fences.get(proc) is False

    def groups(self, proc: int) -> Optional[Dict[str, Any]]:
        r = self._call(proc, "Obs.groups", None, self.SCRAPE_S)
        return r if isinstance(r, dict) else None

    def pull_group(self, proc: int, gid: int):
        r = self._call(
            proc, "EngineShardKV.pull_group", (gid,), self.MIGRATE_S
        )
        if isinstance(r, tuple) and r and r[0] == OK:
            return r[1]
        return None

    def unseal_group(self, proc: int, gid: int,
                     force: bool = False) -> None:
        self._call(
            proc, "EngineShardKV.unseal_group", (gid, force), self.PUSH_S
        )

    def standby_state(self, proc: int, gid: int) -> Optional[Dict]:
        """Freshness of ``proc``'s shipped standby state for ``gid``
        (stateplane.StandbyStore.freshness), None if it holds none.
        Raises TimeoutError when the probe got no answer (timed out,
        dropped or its connection lost): "no answer" is not "holds
        nothing".  The port's servers answer ``"none"`` for nothing;
        the reference's a bare None, which reads as nothing from a
        server known to be the reference's."""
        r = self._call(
            proc, "EngineShardKV.standby_state", (gid,), self.SCRAPE_S
        )
        if isinstance(r, dict):
            return r
        if r == "none" or (
            r is None and self._answers_none_for_nothing(proc)
        ):
            return None
        raise TimeoutError(f"standby probe of process {proc}")

    def recover_group(self, proc: int, gid: int) -> Optional[str]:
        """Ask ``proc`` to adopt ``gid`` from its OWN standby store
        (snapshot fast-forward + exactly-once tail replay).  Returns
        ``"recovered"``, ``"empty"`` (no shipped state there — caller
        falls back to empty adoption), or None on RPC failure."""
        r = self._call(
            proc, "EngineShardKV.recover_group", (gid,), self.MIGRATE_S
        )
        if isinstance(r, tuple) and len(r) >= 2 and r[0] == OK:
            return r[1]
        return None

    def adopt_group(self, proc: int, gid: int, blob) -> bool:
        r = self._call(
            proc, "EngineShardKV.adopt_group", (gid, blob), self.MIGRATE_S
        )
        return isinstance(r, tuple) and bool(r) and r[0] == OK

    def drop_group(self, proc: int, gid: int) -> bool:
        r = self._call(
            proc, "EngineShardKV.drop_group", (gid,), self.MIGRATE_S
        )
        return isinstance(r, tuple) and bool(r) and r[0] == OK

    def push_placement(
        self, proc: int, version: int, addr_map: Dict[int, Tuple[str, int]]
    ) -> bool:
        r = self._call(
            proc, "EngineShardKV.place", (version, addr_map), self.PUSH_S
        )
        return isinstance(r, tuple) and bool(r) and r[0] == OK

    # -- membership-change verbs (self-healing replica sets) ------------

    def replica_config(self, proc: int, gid: int) -> Optional[Dict]:
        """Leader's config view for ``gid`` (voter sets, joint flag,
        epoch) or None when leaderless / RPC failure."""
        r = self._call(
            proc, "EngineShardKV.replica_config", (gid,), self.SCRAPE_S
        )
        if isinstance(r, tuple) and len(r) >= 2 and r[0] == OK:
            return r[1]
        return None

    def add_learner(self, proc: int, gid: int, peer: int) -> bool:
        r = self._call(
            proc, "EngineShardKV.add_learner", (gid, peer), self.PUSH_S
        )
        return (isinstance(r, tuple) and len(r) >= 2 and r[0] == OK
                and bool(r[1]))

    def learner_match(self, proc: int, gid: int,
                      peer: int) -> Optional[Tuple[int, int]]:
        r = self._call(
            proc, "EngineShardKV.learner_match", (gid, peer), self.SCRAPE_S
        )
        if isinstance(r, tuple) and len(r) >= 2 and r[0] == OK:
            return r[1]
        return None

    def begin_joint(self, proc: int, gid: int, voters) -> bool:
        r = self._call(
            proc, "EngineShardKV.begin_joint", (gid, list(voters)),
            self.PUSH_S,
        )
        return (isinstance(r, tuple) and len(r) >= 2 and r[0] == OK
                and bool(r[1]))

    def kill_replica(self, proc: int, gid: int, peer: int) -> bool:
        r = self._call(
            proc, "EngineShardKV.kill_replica", (gid, peer), self.PUSH_S
        )
        return isinstance(r, tuple) and bool(r) and r[0] == OK


class PlacementController:
    """The scrape → plan → migrate loop (module docstring).  ``store``
    is the replicated map facade (``query/set_map/begin/commit/abort``
    — harness/fleet.py's blocking RSM clerk, or
    :class:`LocalPlacementStore` in unit tests); ``transport`` the
    fleet view (:class:`TcpFleetTransport` or an in-process fake)."""

    def __init__(
        self,
        transport,
        store,
        *,
        scrape_s: Optional[float] = None,
        dead_s: Optional[float] = None,
        cooldown_s: Optional[float] = None,
        min_gain: Optional[float] = None,
        max_moves: Optional[int] = None,
        replace: Optional[bool] = None,
        replace_deadline_s: Optional[float] = None,
        obs=None,
        recorder=None,
        clock=time.monotonic,
    ) -> None:
        k = place_knobs()
        self.transport = transport
        self.store = store
        self.scrape_s = k["scrape_s"] if scrape_s is None else scrape_s
        self.dead_s = k["dead_s"] if dead_s is None else dead_s
        self.cooldown_s = (
            k["cooldown_s"] if cooldown_s is None else cooldown_s
        )
        self.min_gain = k["min_gain"] if min_gain is None else min_gain
        self.max_moves = (
            k["max_moves"] if max_moves is None else int(max_moves)
        )
        self.replace = (
            bool(k["replace"]) if replace is None else bool(replace)
        )
        self.replace_deadline_s = (
            k["replace_deadline_s"] if replace_deadline_s is None
            else float(replace_deadline_s)
        )
        self._clock = clock
        self._obs = obs
        if recorder is None:
            from .flightrec import get_recorder

            recorder = get_recorder("placer")
        self._rec = recorder
        t0 = clock()
        self.last_pong = {p: t0 for p in range(transport.n_procs)}
        self.last_moved: Dict[int, float] = {}
        self.loads: Dict[int, float] = {}
        self.dead: set = set()
        # gid -> latest per-replica view scraped from Obs.groups
        # (proc, alive[], voters[], joint, sealed)
        self._replica_view: Dict[int, Dict[str, Any]] = {}
        # (gid, peer) -> clock when the replica was first seen dead
        self._replica_dead_since: Dict[Tuple[int, int], float] = {}
        # gid -> clock when the heal intent was begun (this controller;
        # a crash-resume successor drives the intent but skips stats)
        self._reconfig_t0: Dict[int, float] = {}
        # Fencing leases (_contact): proc -> the latest deadline this
        # controller sent or a process reported.  Only a running
        # controller (start) grants them, over a transport with a
        # ``lease`` verb.
        self._lease_until: Dict[int, float] = {}
        self._lease_lock = threading.Lock()
        self._leasing = False
        self._lease_thread: Optional[threading.Thread] = None
        # gid -> timing of the last COMPLETED replacement (benches)
        self.replace_stats: Dict[int, Dict[str, float]] = {}
        self.rounds = 0
        self.moves_done = 0
        self._pushed_version = -1
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        assert self._thread is None
        self._leasing = getattr(self.transport, "lease", None) is not None
        self._thread = threading.Thread(
            target=self._loop, name="placement-controller", daemon=True
        )
        self._thread.start()
        if self._leasing:
            self._lease_thread = threading.Thread(
                target=self._lease_loop, name="placement-leases",
                daemon=True,
            )
            self._lease_thread.start()

    def stop(self) -> None:
        self._stop.set()
        for th in (self._thread, self._lease_thread):
            if th is not None:
                th.join(timeout=30.0)
        self._thread = self._lease_thread = None
        if self._leasing:
            # Stopping on purpose: the live processes serve on unfenced
            # (nothing re-places their groups now).  A process declared
            # dead stays fenced for good.
            self._leasing = False
            for p in range(self.transport.n_procs):
                if p not in self.dead:
                    try:
                        self.transport.lease(p, "release")
                    except Exception:
                        pass

    # A failover off a dead process starts this long after the last
    # lease the process may hold has run out.
    LEASE_MARGIN_S = 0.1

    def _contact(self, p: int) -> bool:
        """Liveness probe of process ``p``: the reference's ping, or,
        while the controller runs over a fencing transport, a lease
        grant that runs ``dead_s`` past now.  The deadline is noted
        before it is sent, so no grant outlives what
        :meth:`_lease_ran_out` waits for.  (Leases deviate from the
        reference, which re-places the groups of a process declared
        dead while that process may still serve them; ROADMAP C.)"""
        if not self._leasing:
            return self.transport.ping(p)
        deadline = self._clock() + self.dead_s
        self._note_lease(p, deadline)
        ok, held = self.transport.lease(p, "grant", deadline)
        if held is not None:
            self._note_lease(p, held)  # a predecessor's longer grant
        return ok

    def _note_lease(self, p: int, until: float) -> None:
        with self._lease_lock:
            self._lease_until[p] = max(
                self._lease_until.get(p, float(until)), float(until)
            )

    def _note_pong(self, p: int, t: float) -> None:
        with self._lease_lock:
            self.last_pong[p] = max(self.last_pong[p], t)

    def _lease_ran_out(self, p: Optional[int]) -> bool:
        """True once process ``p`` can answer no client op under a
        lease of this controller: none was granted, or the last has
        ended."""
        until = self._lease_until.get(p) if p is not None else None
        return until is None or self._clock() > until + self.LEASE_MARGIN_S

    def _voluntary_cooldown_s(self) -> float:
        """The cooldown the planner gets: ``cooldown_s``, but never less
        than the doctor's thrash window (analysis/postmortem.py).  A
        group then moves voluntarily at most once in the window, after
        no move at all, so with a failover (never held back: the
        planner's cooldown binds voluntary moves only) it reaches two
        moves there, not the doctor's three.  The reference's cooldown
        alone lets a group be rebalanced twice and failed over inside
        the window (ROADMAP queue C)."""
        from ..analysis.postmortem import THRASH_WINDOW_US

        return max(self.cooldown_s, THRASH_WINDOW_US / 1e6)

    def _hosts(self, p: int, gid: int) -> bool:
        """Whether process ``p`` hosts ``gid`` now (its Obs.groups)."""
        g = self.transport.groups(p)
        return bool(g) and gid in (g.get("gids") or ())

    def _lease_loop(self) -> None:
        """Renew every live process's lease each ``scrape_s``, apart
        from the rounds: a round that re-places hundreds of groups
        lasts far longer than ``dead_s``, and neither the leases nor the
        liveness record may lapse meanwhile."""
        while not self._stop.is_set():
            for p in range(self.transport.n_procs):
                if p in self.dead or self._stop.is_set():
                    continue
                t = self._clock()
                try:
                    ok = self._contact(p)
                except Exception:
                    ok = False
                if ok:
                    self._note_pong(p, t)
            # Deaths are declared here too, so a long round does not
            # delay them (a fresh set: the round thread may be reading
            # the old one).
            now = self._clock()
            with self._lease_lock:
                self.dead = self.dead | {
                    p for p in range(self.transport.n_procs)
                    if now - self.last_pong[p] > self.dead_s
                }
            self._stop.wait(self.scrape_s)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.step()
            except Exception:
                # The controller must outlive transient scrape/RPC
                # failures — the fleet heals by retrying, not by the
                # healer dying.
                if self._obs is not None:
                    self._obs.metrics.inc("place.step_errors")
            self._stop.wait(self.scrape_s)

    # -- observability helpers ------------------------------------------

    def _record(self, gid: int, src: Optional[int], dst: int,
                version: int, reason: str) -> None:
        if self._rec is not None:
            from .flightrec import PLACE

            self._rec.record(
                PLACE, code=gid, a=-1 if src is None else src, b=dst,
                c=version, tag=reason,
            )
        if self._obs is not None:
            self._obs.metrics.inc("place.moves")
            self._obs.metrics.inc(f"place.moves_{reason}")

    # -- one controller round -------------------------------------------

    def scrape(self) -> None:
        """Liveness + load: ping every process; fold per-gid commit
        rates from ``Obs.groups`` of the live ones."""
        now = self._clock()
        for p in range(self.transport.n_procs):
            if p in self.dead:
                continue  # declared dead: stays dead (module docstring)
            if not self._contact(p):
                continue
            self._note_pong(p, now)
            g = self.transport.groups(p)
            if not g or "gids" not in g:
                continue
            rates = g.get("commit_rate") or [0.0] * g["G"]
            r_alive = g.get("replica_alive") or []
            voters = g.get("voters") or []
            joint = g.get("joint") or []
            sealed = g.get("sealed") or []
            for slot, gid in enumerate(g["gids"]):
                if gid <= 0:
                    continue
                self.loads[gid] = float(rates[slot])
                if slot < len(r_alive) and slot < len(voters):
                    self._replica_view[gid] = {
                        "proc": p,
                        "alive": list(r_alive[slot]),
                        "voters": list(voters[slot]),
                        "joint": bool(joint[slot])
                        if slot < len(joint) else False,
                        "sealed": bool(sealed[slot])
                        if slot < len(sealed) else False,
                    }
        # Per-REPLICA death ledger (distinct from per-PROCESS self.dead:
        # here the process serving the group is fine, one engine replica
        # row inside it is permanently down).  First-seen-dead timestamps
        # feed the replace-dead-replica policy (_heal_replicas).
        for gid, view in self._replica_view.items():
            for q, ok in enumerate(view["alive"]):
                if ok:
                    self._replica_dead_since.pop((gid, q), None)
                else:
                    self._replica_dead_since.setdefault((gid, q), now)
        with self._lease_lock:  # the lease thread declares deaths too
            self.dead = self.dead | {
                p for p in range(self.transport.n_procs)
                if now - self.last_pong[p] > self.dead_s
            }

    def step(self) -> int:
        """One scrape→plan→migrate round; returns moves executed."""
        self.rounds += 1
        self.scrape()
        now = self._clock()
        alive = [
            p for p in range(self.transport.n_procs) if p not in self.dead
        ]
        if not alive:
            return 0
        version, placement, pending, _ = self.store.query()
        if not placement:
            return 0  # not bootstrapped yet (harness seeds the map)
        executed = 0
        # Resume replicated intents first — a predecessor controller
        # may have died mid-migration (module docstring).
        for gid, intent in sorted(pending.items()):
            dst, reason = int(intent[0]), intent[1]
            src = placement.get(gid)
            if src in self.dead and reason != "failover":
                if not self._lease_ran_out(src):
                    continue  # the dead source may still serve it: wait
                if dst not in self.dead and not self._hosts(dst, gid):
                    # The source died before the destination adopted
                    # the group: its state lives only in the source's
                    # standbys now, which need not include the
                    # destination.  Drop the intent; the next plan fails
                    # the group over to the freshest of them.  (The
                    # reference recovers at the intent's destination,
                    # empty where it holds no shipped state; ROADMAP C.)
                    self.store.abort(gid)
                    continue
            if dst in self.dead:
                # Destination died before the group committed there.
                # The adopt may or may not have landed — either way that
                # copy is gone with the process, so unsealing the source
                # (if it lives) cannot fork the group.  force=True: the
                # engine refuses a plain unseal once the intent was
                # dispatched, and the dead destination is exactly the
                # proof that makes forcing safe.
                if src is not None and src in set(alive):
                    self.transport.unseal_group(src, gid, force=True)
                self.store.abort(gid)
                continue
            if self._execute(gid, src, dst, reason, alive):
                executed += 1
        # Self-healing replica sets: resume/begin joint-consensus
        # replacements of dead engine replicas before planning any
        # voluntary group moves — a group under reconfig must not also
        # be migrated mid-joint.
        executed += self._heal_replicas(alive)
        version, placement, pending, _ = self.store.query()
        reconfigs = self._reconfig_intents()
        moves = plan_moves(
            placement,
            self.loads,
            alive,
            min_gain=self.min_gain,
            cooldown_s=self._voluntary_cooldown_s(),
            last_moved=self.last_moved,
            now_s=now,
            max_moves=self.max_moves,
            exclude=set(pending) | set(reconfigs),
        )
        for gid, src, dst, reason in moves:
            if src is None and reason == "failover":
                if not self._lease_ran_out(placement.get(gid)):
                    # Declared dead, but it may serve the group until
                    # its lease runs out: re-place it after that.
                    continue
                # Stateful failover: re-target to the standby holding
                # the freshest shipped (snapshot, tail) pair BEFORE the
                # intent is begun, so the replicated intent records the
                # recovery destination.  No shipped state anywhere →
                # the planner's load-balanced pick stands (empty adopt).
                dst = self._freshest_dst(gid, alive, dst)
                if dst is None:
                    continue  # a probe went unanswered: ask next round
            self.store.begin(gid, dst, reason)
            if self._execute(gid, src, dst, reason, alive):
                executed += 1
        self._push(alive)
        return executed

    def _freshest_dst(self, gid: int, alive: List[int],
                      default: int) -> Optional[int]:
        probe = getattr(self.transport, "standby_state", None)
        if probe is None:
            return default
        from .stateplane import pick_freshest

        states = []
        for p in alive:
            try:
                states.append((p, probe(p, gid)))
            except Exception:
                # The freshest shipped state may be the one that did not
                # answer: recovering elsewhere, or adopting empty, would
                # drop its acknowledged writes.  Ask again next round; a
                # process that stays silent is declared dead and leaves
                # ``alive``.  (The reference reads no answer as no
                # state; ROADMAP queue C.)
                return None
        order = pick_freshest(states)
        return order[0] if order else default

    # -- replace-dead-replica policy (joint-consensus healing) ----------

    def _reconfig_intents(self) -> Dict[int, Tuple[int, int, str]]:
        fn = getattr(self.store, "reconfig_intents", None)
        if fn is None:
            return {}
        try:
            r = fn()
        except Exception:
            return {}
        return r if isinstance(r, dict) else {}

    def _config_record(self, gid: int, dead_p: int, new_p: int,
                       epoch: int, phase: str) -> None:
        if self._rec is not None:
            from .flightrec import CONFIG

            self._rec.record(
                CONFIG, code=gid, a=dead_p, b=new_p, c=epoch, tag=phase,
            )
        if self._obs is not None:
            metric = {
                "learner": "reconfig.begun",
                "joint": "reconfig.joint_entered",
                "done": "reconfig.completed",
                "abort": "reconfig.aborted",
            }.get(phase)
            if metric:
                self._obs.metrics.inc(metric)

    def _heal_replicas(self, alive: List[int]) -> int:
        """Replace dead engine replicas via joint consensus.  Every
        intent is a replicated two-phase record on the placement RSM
        (``rbegin``/``rphase``/``rdone``), and every leg is idempotent,
        so a controller crash mid-reconfig RESUMES at the recorded
        phase — it never forks membership.  Returns completed
        replacements this round."""
        if not self.replace:
            return 0
        if getattr(self.transport, "add_learner", None) is None:
            return 0  # transport predates membership verbs
        rbegin = getattr(self.store, "rbegin", None)
        if rbegin is None:
            return 0  # store predates reconfig intents
        now = self._clock()
        alive_set = set(alive)
        done = 0
        # 1. Resume replicated intents (ours or a dead predecessor's).
        for gid, intent in sorted(self._reconfig_intents().items()):
            view = self._replica_view.get(gid)
            if view is None or view["proc"] not in alive_set:
                continue  # group unreachable this round: retry later
            done += self._drive_reconfig(
                gid, view, int(intent[0]), int(intent[1]), str(intent[2]),
                now,
            )
        # 2. Begin new intents for voters dead past the grace period.
        intents = self._reconfig_intents()
        for (gid, q), t0 in sorted(self._replica_dead_since.items()):
            if gid in intents or now - t0 < self.dead_s:
                continue
            view = self._replica_view.get(gid)
            if view is None or view["proc"] not in alive_set:
                continue
            if view.get("sealed"):
                continue  # mid-migration: heal after the move settles
            if q not in view["voters"]:
                # Dead NON-voter (parked spare / demoted casualty):
                # nothing to heal — quorum does not depend on it.
                continue
            new_p = self._pick_spare(view, q)
            if new_p is None:
                if self._obs is not None:
                    self._obs.metrics.inc("reconfig.no_spare")
                continue
            self.store.rbegin(gid, q, new_p)
            self._reconfig_t0[gid] = t0
            self._config_record(gid, q, new_p, 0, "learner")
            done += self._drive_reconfig(
                gid, view, q, new_p, "learner", now
            )
            intents = self._reconfig_intents()
        return done

    def _pick_spare(self, view: Dict[str, Any],
                    dead_q: int) -> Optional[int]:
        """Lowest engine slot that is neither a voter nor the dead
        slot itself — the seat the new incarnation takes.  Voter sets
        are static-slot subsets, so replacement is always a SWAP into a
        spare row; no spare → no heal (reconfig.no_spare)."""
        voters = set(view["voters"])
        for q in range(len(view["alive"])):
            if q != dead_q and q not in voters:
                return q
        return None

    def _drive_reconfig(
        self, gid: int, view: Dict[str, Any], dead_p: int, new_p: int,
        phase: str, now: float,
    ) -> int:
        """Advance one replacement as far as this round allows:
        learner → catchup → joint → done.  Every leg re-checks engine
        state first, so re-running any prefix after a crash is a no-op
        (add_learner_gid answers True for a live learner, begin_joint
        for an already-entered or already-settled target)."""
        tr = self.transport
        store = self.store
        if phase == "learner":
            if not tr.add_learner(view["proc"], gid, new_p):
                return 0  # leaderless or slot still a voter: retry
            # The seated learner is a FRESH incarnation: any death
            # timestamp recorded for the (previously parked) slot
            # belongs to the old tenant, not this one.
            self._replica_dead_since.pop((gid, new_p), None)
            store.rphase(gid, "catchup")
            self._config_record(gid, dead_p, new_p, 0, "catchup")
            phase = "catchup"
        if phase == "catchup":
            # A learner that dies mid-catch-up can never close the gap:
            # abort and let the next round pick a different spare.
            t_dead = self._replica_dead_since.get((gid, new_p))
            if t_dead is not None and now - t_dead >= self.dead_s:
                store.rabort(gid)
                self._config_record(gid, dead_p, new_p, 0, "abort")
                self._reconfig_t0.pop(gid, None)
                return 0
            lm = tr.learner_match(view["proc"], gid, new_p)
            if lm is None:
                return 0
            match, last = int(lm[0]), int(lm[1])
            if match < last:
                return 0  # still catching up: promote next round
            cfg = tr.replica_config(view["proc"], gid)
            if cfg is None:
                return 0
            target = sorted(
                (set(cfg["voters_old"]) - {dead_p}) | {new_p}
            )
            if not tr.begin_joint(view["proc"], gid, target):
                return 0
            store.rphase(gid, "joint")
            self._config_record(
                gid, dead_p, new_p, int(cfg["epoch"]) + 1, "joint"
            )
            phase = "joint"
        if phase == "joint":
            cfg = tr.replica_config(view["proc"], gid)
            if cfg is None:
                return 0
            if cfg["joint"]:
                return 0  # both quorums still settling: engine exits
            if dead_p in cfg["voters_old"]:
                # Not joint AND the dead peer still votes: the leader
                # died after the intent recorded "joint" but before the
                # C_old,new entry replicated — the entry is LOST, not
                # pending.  Re-issue it (begin_joint is idempotent
                # against the already-settled target).
                target = sorted(
                    (set(cfg["voters_old"]) - {dead_p}) | {new_p}
                )
                tr.begin_joint(view["proc"], gid, target)
                return 0
            store.rdone(gid)
            self._config_record(
                gid, dead_p, new_p, int(cfg["epoch"]), "done"
            )
            self._replica_dead_since.pop((gid, dead_p), None)
            t0 = self._reconfig_t0.pop(gid, None)
            if t0 is not None:
                self.replace_stats[gid] = {
                    "replace_replica_s": max(0.0, now - (t0 + self.dead_s)),
                    "degraded_quorum_window_s": now - t0,
                }
            return 1
        return 0

    def _execute(
        self, gid: int, src: Optional[int], dst: int, reason: str,
        alive: List[int],
    ) -> bool:
        """Run one begun migration end-to-end.  Every leg is idempotent
        (seal/export returns the same frozen blob, adopt/drop answer OK
        on retry), so a False return simply leaves the intent pending
        for the next round."""
        from .observe import now_us

        rid = f"mig-{gid}-{self.rounds}"
        t_all = now_us()
        src_live = src is not None and src in set(alive)
        blob = None
        recovered = False
        if src_live:
            t0 = now_us()
            blob = self.transport.pull_group(src, gid)
            self._trace_span("place.pull", t0, rid, gid)
            if blob is None:
                return False  # source not sealable yet: retry next round
        # Mark the intent dispatched BEFORE any adopt/recover RPC can
        # fly: a successor controller reading the replicated intent
        # then knows a plain unseal of the source is no longer safe.
        disp = getattr(self.store, "dispatch", None)
        if disp is not None:
            disp(gid)
        if not src_live:
            # Dead source: durable recovery first — the destination
            # adopts from its own standby store (snapshot+tail replay).
            recover = getattr(self.transport, "recover_group", None)
            if recover is not None:
                t0 = now_us()
                r = recover(dst, gid)
                self._trace_span("place.recover", t0, rid, gid)
                if r == "recovered":
                    recovered = True
                    if self._obs is not None:
                        self._obs.metrics.inc("place.recoveries")
                elif r is None:
                    return False  # transient RPC failure: retry round
                # r == "empty": no shipped state at dst — fall through
                # to the explicit empty-adoption fallback below.
        if not recovered:
            t0 = now_us()
            adopted = self.transport.adopt_group(dst, gid, blob)
            self._trace_span("place.adopt", t0, rid, gid)
            if not adopted:
                # The adopt RPC may have landed despite the lost reply —
                # NEVER unseal the source now.  The intent stays pending
                # and the next round retries the (idempotent) adopt.
                return False
        reply_version = self.store.commit(gid)
        version = (
            reply_version if isinstance(reply_version, int)
            else self.store.query()[0]
        )
        if src_live:
            t0 = now_us()
            self.transport.drop_group(src, gid)  # idempotent; best effort
            self._trace_span("place.drop", t0, rid, gid)
        self.last_moved[gid] = self._clock()
        self.moves_done += 1
        self._record(gid, src if src_live else None, dst, version, reason)
        self._trace_span("place.total", t_all, rid, gid)
        if self._obs is not None:
            self._obs.tracer.instant(
                "place", now_us(), track="place", req=rid, group=gid,
                src=-1 if not src_live else src, dst=dst, reason=reason,
            )
        return True

    def _trace_span(self, name: str, t0_us: float, rid: str,
                    gid: int) -> None:
        if self._obs is None:
            return
        from .observe import now_us

        self._obs.tracer.span(
            name, t0_us, now_us() - t0_us, track="place", req=rid,
            group=gid,
        )

    def _push(self, alive: List[int]) -> None:
        """Push the committed placement view to every live process so
        servers re-derive peer maps and clerks can re-route.  Repushed
        after membership changes even when the version didn't move —
        a process that missed the last push needs it."""
        version, placement, _, _ = self.store.query()
        if version <= 0:
            return
        addr_map = {
            g: self.transport.addr(p) for g, p in placement.items()
        }
        for p in alive:
            self.transport.push_placement(p, version, addr_map)
        self._pushed_version = version
