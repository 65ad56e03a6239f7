"""Shard controller — the replicated configuration service
(reference: src/shardctrler).

A second Raft-backed state machine mapping ``NSHARDS`` shards to replica
groups.  JOIN/LEAVE trigger the minimal-movement rebalancer; MOVE pins a
shard; QUERY reads any historical config (configs are never mutated in
place, so history is queryable forever —
reference: shardctrler/common.go:27-31, shardctrler/server.go:48-162).

The rebalancer is a pure, deterministic function: it runs inside the
replicated apply path, so every replica MUST compute the identical
assignment (reference: shardctrler/common.go:87-132 sorts map keys for
exactly this reason).

This is the PyTorch port's copy of ``multiraft_tpu/services/
shardctrler.py``: the configuration record and both rebalancers, which
the sharded engine (``engine/shardkv.py``) applies too, and the
simulated controller server and clerk over ``raft.node.RaftNode``.

Documented divergence (SURVEY §7.5 #9): replies carry an explicit
``OK`` instead of the reference's zero-value success string, and QUERY
reads happen inside the apply path rather than after the wait-channel
fires.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

from ..raft.messages import ApplyMsg
from ..raft.node import RaftNode
from ..raft.persister import Persister
from ..sim.scheduler import Future, Scheduler, TIMEOUT
from ..transport import codec
from ..transport.network import ClientEnd
from ..utils.config import settings as _settings

__all__ = [
    "NSHARDS",
    "Config",
    "ShardCtrler",
    "CtrlerClerk",
    "rebalance",
    "rebalance_weighted",
    "QUERY",
    "JOIN",
    "LEAVE",
    "MOVE",
]


def _nshards() -> int:
    """``MULTIRAFT_NSHARDS`` read as the reference reads it: a set,
    non-empty value is parsed as a float and truncated, else 10
    (reference: shardctrler/common.go:23)."""
    raw = os.environ.get("MULTIRAFT_NSHARDS")
    return int(float(raw)) if raw else 10


NSHARDS = _nshards()

QUERY = "Query"
JOIN = "Join"
LEAVE = "Leave"
MOVE = "Move"

OK = "OK"
ERR_WRONG_LEADER = "ErrWrongLeader"
ERR_TIMEOUT = "ErrTimeout"

SERVER_WAIT = _settings().service.server_wait  # (reference: shardctrler/server.go:19)


@codec.registered
@dataclasses.dataclass
class Config:
    """(reference: shardctrler/common.go:27-31)"""

    num: int = 0
    shards: List[int] = dataclasses.field(
        default_factory=lambda: [0] * NSHARDS
    )
    groups: Dict[int, List[str]] = dataclasses.field(default_factory=dict)

    def clone(self) -> "Config":
        return Config(
            num=self.num,
            shards=list(self.shards),
            groups={g: list(s) for g, s in self.groups.items()},
        )


def rebalance(shards: List[int], groups: Dict[int, List[str]]) -> List[int]:
    """Minimal-movement shard rebalance
    (reference: shardctrler/common.go:53-132).

    1. Shards owned by departed/unknown groups go to the least-loaded
       group.
    2. While the load spread exceeds 1, move one shard from the most-
       to the least-loaded group.

    Deterministic tie-breaks (sorted gids) because this runs inside the
    replicated apply path on every replica."""
    if not groups:
        return [0] * NSHARDS
    counts = {gid: 0 for gid in sorted(groups)}
    out = list(shards)
    for s, g in enumerate(out):
        if g in counts:
            counts[g] += 1
        else:
            out[s] = 0

    def min_gid() -> int:
        return min(counts, key=lambda g: (counts[g], g))

    def max_gid() -> int:
        return max(counts, key=lambda g: (counts[g], -g))

    for s in range(NSHARDS):
        if out[s] == 0:
            g = min_gid()
            out[s] = g
            counts[g] += 1
    while True:
        mx, mn = max_gid(), min_gid()
        if counts[mx] - counts[mn] <= 1:
            break
        for s in range(NSHARDS):
            if out[s] == mx:
                out[s] = mn
                counts[mx] -= 1
                counts[mn] += 1
                break
    return out

def rebalance_weighted(
    assign: Dict[int, Optional[int]],
    weights: Dict[int, float],
    bins: List[int],
):
    """Weighted generalization of :func:`rebalance` for the fleet
    placement controller: ``assign`` maps item (raft group id) to its
    current bin (mesh process index, or ``None``/a departed bin for
    orphans), ``weights`` gives each item's load, ``bins`` is the live
    bin set.  Returns ``(new_assign, moves)`` with ``moves`` a list of
    ``(item, src_bin, dst_bin)``.

    Same shape as the unweighted rebalancer, so the minimal-movement
    character carries over:

    1. every item stays where it is if its bin is still live;
    2. orphans go to the lightest bin;
    3. while it strictly helps, move the heaviest movable item from the
       heaviest to the lightest bin — "movable" means ``w < max - min``,
       which keeps both bins inside the old (min, max) interval, so the
       potential ``sum(load**2)`` strictly decreases and the loop
       terminates.

    With uniform weights the movable condition degenerates to
    ``max - min >= 2`` — exactly the unweighted loop — so the move
    count never exceeds the unweighted minimal-movement bound (the
    property test in tests/test_placement.py pins this).

    Deterministic (sorted tie-breaks throughout): it runs inside the
    controller's replicated apply path, where every replica must plan
    the identical move set."""
    bins = sorted(set(bins))
    if not bins:
        return dict(assign), []
    live = set(bins)
    load = {b: 0.0 for b in bins}
    out: Dict[int, int] = {}
    moves = []
    orphans = []
    for item in sorted(assign):
        b = assign[item]
        if b in live:
            out[item] = b
            load[b] += weights.get(item, 0.0)
        else:
            orphans.append(item)

    def lightest() -> int:
        return min(bins, key=lambda b: (load[b], b))

    def heaviest() -> int:
        return max(bins, key=lambda b: (load[b], -b))

    for item in orphans:
        b = lightest()
        out[item] = b
        load[b] += weights.get(item, 0.0)
        moves.append((item, assign[item], b))

    # Each move strictly shrinks sum(load**2); the cap is a defensive
    # bound, not the expected exit.
    for _ in range(4 * len(out) + 16):
        hi, lo = heaviest(), lightest()
        gap = load[hi] - load[lo]
        best = None
        for item in sorted(out):
            if out[item] != hi:
                continue
            w = weights.get(item, 0.0)
            # w > 0: moving a zero-weight item changes no load — churn.
            if 0 < w < gap and (best is None or w > weights.get(best, 0.0)):
                best = item
        if best is None:
            break
        out[best] = lo
        w = weights.get(best, 0.0)
        load[hi] -= w
        load[lo] += w
        moves.append((best, hi, lo))
    return out, moves


@codec.registered
@dataclasses.dataclass
class CtrlerArgs:
    """Unified op args (reference: shardctrler/server.go Command)."""

    op: str = QUERY
    servers: Dict[int, List[str]] = dataclasses.field(default_factory=dict)
    gids: List[int] = dataclasses.field(default_factory=list)
    shard: int = 0
    gid: int = 0
    num: int = -1
    client_id: int = 0
    command_id: int = 0


@codec.registered
@dataclasses.dataclass
class CtrlerReply:
    err: str = OK
    config: Optional[Config] = None


class ShardCtrler:
    """Controller server (reference: shardctrler/server.go:164-182).
    RPC surface: ``ShardCtrler.command``."""

    def __init__(
        self,
        sched: Scheduler,
        ends: List[ClientEnd],
        me: int,
        persister: Persister,
        maxraftstate: int = -1,
        seed: int = 0,
    ) -> None:
        self.sched = sched
        self.me = me
        self.maxraftstate = maxraftstate
        self.configs: List[Config] = [Config()]  # config 0: all shards -> gid 0
        self.latest: Dict[int, int] = {}
        self._waiters: Dict[tuple, Future] = {}
        self._killed = False
        self.rf = RaftNode(sched, ends, me, persister, self._on_apply, seed=seed)
        self._install_snapshot(persister.read_snapshot())

    # -- RPC (reference: shardctrler/server.go:48-100) -------------------

    def command(self, args: CtrlerArgs):
        if self._killed:
            return CtrlerReply(err=ERR_WRONG_LEADER)
        if args.op != QUERY and self.latest.get(args.client_id, -1) >= args.command_id:
            return CtrlerReply(err=OK)
        index, term, is_leader = self.rf.start(args)
        if not is_leader:
            return CtrlerReply(err=ERR_WRONG_LEADER)
        fut = Future()
        key = (args.client_id, args.command_id, index)
        self._waiters[key] = fut
        result = yield self.sched.with_timeout(fut, SERVER_WAIT)
        self._waiters.pop(key, None)
        if result is TIMEOUT:
            return CtrlerReply(err=ERR_TIMEOUT)
        return result

    # -- apply (reference: shardctrler/server.go:124-162) ----------------

    def _on_apply(self, msg: ApplyMsg) -> None:
        if self._killed:
            return
        if msg.snapshot_valid:
            self._install_snapshot(msg.snapshot)
            return
        if not msg.command_valid:
            return
        args: CtrlerArgs = msg.command
        reply = CtrlerReply(err=OK)
        is_dup = self.latest.get(args.client_id, -1) >= args.command_id
        if args.op == QUERY:
            reply.config = self._query(args.num)
        elif not is_dup:
            if args.op == JOIN:
                self._join(args.servers)
            elif args.op == LEAVE:
                self._leave(args.gids)
            elif args.op == MOVE:
                self._move(args.shard, args.gid)
        if not is_dup:
            self.latest[args.client_id] = args.command_id
        waiter = self._waiters.get(
            (args.client_id, args.command_id, msg.command_index)
        )
        if waiter is not None:
            term, is_leader = self.rf.get_state()
            if is_leader and term == msg.command_term:
                waiter.resolve(reply)
        self._maybe_snapshot(msg.command_index)

    def _query(self, num: int) -> Config:
        if num < 0 or num >= len(self.configs):
            return self.configs[-1].clone()
        return self.configs[num].clone()

    def _join(self, servers: Dict[int, List[str]]) -> None:
        """(reference: shardctrler/server.go JOIN + ReAllocGID)"""
        cfg = self.configs[-1].clone()
        cfg.num += 1
        cfg.groups.update({g: list(s) for g, s in servers.items()})
        cfg.shards = rebalance(cfg.shards, cfg.groups)
        self.configs.append(cfg)

    def _leave(self, gids: List[int]) -> None:
        cfg = self.configs[-1].clone()
        cfg.num += 1
        for g in gids:
            cfg.groups.pop(g, None)
        cfg.shards = rebalance(cfg.shards, cfg.groups)
        self.configs.append(cfg)

    def _move(self, shard: int, gid: int) -> None:
        cfg = self.configs[-1].clone()
        cfg.num += 1
        cfg.shards[shard] = gid
        self.configs.append(cfg)

    # -- snapshots --------------------------------------------------------

    def _maybe_snapshot(self, index: int) -> None:
        if self.maxraftstate < 0:
            return
        if self.rf.raft_state_size() >= (
            _settings().service.snapshot_threshold * self.maxraftstate
        ):
            blob = codec.encode(
                {"configs": self.configs, "latest": dict(self.latest)}
            )
            self.rf.snapshot(index, blob)

    def _install_snapshot(self, data: bytes) -> None:
        if not data:
            return
        blob = codec.decode(data)
        self.configs = blob["configs"]
        self.latest = dict(blob["latest"])

    def kill(self) -> None:
        self._killed = True
        self.rf.kill()


class CtrlerClerk:
    """Controller client (reference: shardctrler/client.go:41-79)."""

    _next_client_id = 1 << 20  # distinct from KV clerks

    def __init__(self, sched: Scheduler, ends: List[ClientEnd]) -> None:
        self.sched = sched
        self.ends = ends
        self.leader = 0
        from ..utils.ids import unique_client_id

        CtrlerClerk._next_client_id += 1
        # Nonce-qualified for cross-process uniqueness (see utils/ids.py).
        self.client_id = unique_client_id(CtrlerClerk._next_client_id)
        self.command_id = 0

    def _command(self, args: CtrlerArgs):
        args.client_id = self.client_id
        self.command_id += 1
        args.command_id = self.command_id
        while True:
            fut = self.ends[self.leader].call("ShardCtrler.command", args)
            reply = yield self.sched.with_timeout(fut, 0.1)
            if (
                reply is TIMEOUT
                or reply is None
                or reply.err in (ERR_WRONG_LEADER, ERR_TIMEOUT)
            ):
                self.leader = (self.leader + 1) % len(self.ends)
                continue
            return reply

    def query(self, num: int = -1):
        reply = yield from self._command(CtrlerArgs(op=QUERY, num=num))
        return reply.config

    def join(self, servers: Dict[int, List[str]]):
        yield from self._command(CtrlerArgs(op=JOIN, servers=servers))

    def leave(self, gids: List[int]):
        yield from self._command(CtrlerArgs(op=LEAVE, gids=gids))

    def move(self, shard: int, gid: int):
        yield from self._command(CtrlerArgs(op=MOVE, shard=shard, gid=gid))
