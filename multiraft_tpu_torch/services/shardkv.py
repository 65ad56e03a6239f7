"""Sharded multi-group KV service.

The reference ships only a skeleton server (shardkv/server.go:30-36 —
empty Get/PutAppend bodies); the behavior implemented here is the one
its test suite demands (SURVEY §4.4, shardkv/test_test.go), including
both challenges: shard deletion with bounded storage (Challenge 1,
shardkv/test_test.go:738-817) and serving unaffected / partially-
migrated shards during config changes (Challenge 2,
shardkv/test_test.go:824-948).

Design — per-shard state machines with a pull-based migration pipeline,
all transitions replicated through the group's own Raft log:

* Shard states: SERVING → (config change) → PULLING (new owner fetching)
  / BEPULLING (old owner, frozen until fetched) → GCING (new owner
  serving, old copy not yet deleted) → SERVING.
* A leader config ticker polls the controller for config num+1 and
  proposes it only when no migration is in flight, so configs apply in
  order, exactly one transition outstanding per group.
* A pull ticker fetches PULLING shards (data + per-shard dup table)
  from the previous owner and proposes InsertShard; the shard serves as
  soon as that applies — before sibling shards finish (Challenge 2).
* A GC ticker asks the previous owner to delete BEPULLING shards
  (bounding storage, Challenge 1) and then confirms GCING → SERVING.
* Client ops are gated per shard: ErrWrongGroup unless this group owns
  the shard in the current config AND its state is SERVING/GCING
  (reference: shardkv/common.go:12-18 error contract).

Dup tables are per-shard so exactly-once survives migration.

This is the PyTorch port's copy of ``multiraft_tpu/services/shardkv.py``:
the simulated server and clerk over ``raft.node.RaftNode``, and the
error strings, per-shard states and ``key2shard`` that the sharded
engine (``engine/shardkv.py``) shares with them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from ..raft.messages import ApplyMsg
from ..raft.node import RaftNode
from ..raft.persister import Persister
from ..sim.scheduler import Future, Scheduler, TIMEOUT
from ..transport import codec
from ..transport.network import ClientEnd
from .shardctrler import NSHARDS, Config, CtrlerClerk

__all__ = [
    "ShardKVServer",
    "ShardClerk",
    "key2shard",
    "OK",
    "ERR_NO_KEY",
    "ERR_WRONG_GROUP",
    "ERR_WRONG_LEADER",
    "ERR_TIMEOUT",
    "ERR_NOT_READY",
    "GET",
    "PUT",
    "APPEND",
    "SERVING",
    "PULLING",
    "BEPULLING",
    "GCING",
]

OK = "OK"
ERR_NO_KEY = "ErrNoKey"
ERR_WRONG_GROUP = "ErrWrongGroup"  # (reference: shardkv/common.go:12-18)
ERR_WRONG_LEADER = "ErrWrongLeader"
ERR_TIMEOUT = "ErrTimeout"
ERR_NOT_READY = "ErrNotReady"

GET = "Get"
PUT = "Put"
APPEND = "Append"

from ..utils.config import settings as _settings

SERVER_WAIT = _settings().service.server_wait
# Leader ticker cadences (reference polls the controller every 100 ms,
# shardkv hint; staggered to avoid lockstep).  CONFIG_POLL comes from
# the config system (MULTIRAFT_CONFIG_POLL).
CONFIG_POLL = _settings().service.config_poll
PULL_INTERVAL = 0.06
GC_INTERVAL = 0.07

# Shard states.
SERVING = 0
PULLING = 1
BEPULLING = 2
GCING = 3


def key2shard(key: str) -> int:
    """(reference: shardkv/client.go:22-29 — first byte mod NSHARDS)"""
    return (ord(key[0]) if key else 0) % NSHARDS


@codec.registered
@dataclasses.dataclass
class Shard:
    state: int = SERVING
    data: Dict[str, str] = dataclasses.field(default_factory=dict)
    latest: Dict[int, int] = dataclasses.field(default_factory=dict)


@codec.registered
@dataclasses.dataclass
class ShardArgs:
    key: str = ""
    value: str = ""
    op: str = GET
    client_id: int = 0
    command_id: int = 0


@codec.registered
@dataclasses.dataclass
class ShardReply:
    err: str = OK
    value: str = ""


@codec.registered
@dataclasses.dataclass
class ClientOp:
    key: str = ""
    value: str = ""
    op: str = GET
    client_id: int = 0
    command_id: int = 0


@codec.registered
@dataclasses.dataclass
class ConfigOp:
    config: Config = None


@codec.registered
@dataclasses.dataclass
class InsertShardOp:
    config_num: int = 0
    shard: int = 0
    data: Dict[str, str] = dataclasses.field(default_factory=dict)
    latest: Dict[int, int] = dataclasses.field(default_factory=dict)


@codec.registered
@dataclasses.dataclass
class DeleteShardOp:
    config_num: int = 0
    shard: int = 0


@codec.registered
@dataclasses.dataclass
class ConfirmGCOp:
    config_num: int = 0
    shard: int = 0


@codec.registered
@dataclasses.dataclass
class PullArgs:
    config_num: int = 0
    shard: int = 0


@codec.registered
@dataclasses.dataclass
class PullReply:
    err: str = OK
    data: Dict[str, str] = dataclasses.field(default_factory=dict)
    latest: Dict[int, int] = dataclasses.field(default_factory=dict)


@codec.registered
@dataclasses.dataclass
class DeleteArgs:
    config_num: int = 0
    shard: int = 0


@codec.registered
@dataclasses.dataclass
class DeleteReply:
    err: str = OK


class ShardKVServer:
    """One replica of one group (reference: shardkv/server.go:77-98
    StartServer wiring: raft + controller clerk + make_end).

    RPC surface: ``ShardKV.command``, ``ShardKV.pull_shard``,
    ``ShardKV.delete_shard``."""

    def __init__(
        self,
        sched: Scheduler,
        ends: List[ClientEnd],
        me: int,
        persister: Persister,
        gid: int,
        ctrler_ends: List[ClientEnd],
        make_end: Callable[[Any], ClientEnd],
        maxraftstate: int = -1,
        seed: int = 0,
    ) -> None:
        self.sched = sched
        self.me = me
        self.gid = gid
        self.maxraftstate = maxraftstate
        self.make_end = make_end
        self._peer_ends: Dict[Any, ClientEnd] = {}
        self.ctrler = CtrlerClerk(sched, ctrler_ends)
        self.cur = Config()  # current config
        self.prev = Config()  # previous config (migration source map)
        self.shards: Dict[int, Shard] = {s: Shard() for s in range(NSHARDS)}
        self._waiters: Dict[tuple, Future] = {}
        # In-flight guards: one outstanding pull/GC exchange per shard,
        # so ticker overlap can't propose duplicate full-payload
        # InsertShard entries into the log (storage-bound hygiene).
        self._pulling_now: set = set()
        self._gcing_now: set = set()
        self._killed = False
        self.rf = RaftNode(sched, ends, me, persister, self._on_apply, seed=seed)
        self._install_snapshot(persister.read_snapshot())
        sched.spawn(self._config_ticker())
        sched.spawn(self._pull_ticker())
        sched.spawn(self._gc_ticker())

    # ------------------------------------------------------------------
    # Client ops
    # ------------------------------------------------------------------

    def _can_serve(self, shard: int) -> bool:
        """Challenge 2: GCING shards serve while their old copy awaits
        deletion; PULLING shards don't serve yet; unaffected shards are
        SERVING throughout a migration."""
        return self.cur.shards[shard] == self.gid and self.shards[shard].state in (
            SERVING,
            GCING,
        )

    def command(self, args: ShardArgs):
        if self._killed:
            return ShardReply(err=ERR_WRONG_LEADER)
        shard = key2shard(args.key)
        if not self._can_serve(shard):
            return ShardReply(err=ERR_WRONG_GROUP)
        sh = self.shards[shard]
        if args.op != GET and sh.latest.get(args.client_id, -1) >= args.command_id:
            return ShardReply(err=OK)
        op = ClientOp(
            key=args.key,
            value=args.value,
            op=args.op,
            client_id=args.client_id,
            command_id=args.command_id,
        )
        index, term, is_leader = self.rf.start(op)
        if not is_leader:
            return ShardReply(err=ERR_WRONG_LEADER)
        fut = Future()
        key = (args.client_id, args.command_id, index)
        self._waiters[key] = fut
        result = yield self.sched.with_timeout(fut, SERVER_WAIT)
        self._waiters.pop(key, None)
        if result is TIMEOUT:
            return ShardReply(err=ERR_TIMEOUT)
        return result

    # ------------------------------------------------------------------
    # Migration RPCs (served leader-side on the *source* group)
    # ------------------------------------------------------------------

    def pull_shard(self, args: PullArgs) -> PullReply:
        """New owner fetches a shard's data + dup table."""
        _, is_leader = self.rf.get_state()
        if self._killed or not is_leader:
            return PullReply(err=ERR_WRONG_LEADER)
        if self.cur.num < args.config_num:
            # We haven't seen the config that moves this shard yet.
            return PullReply(err=ERR_NOT_READY)
        sh = self.shards[args.shard]
        return PullReply(
            err=OK, data=dict(sh.data), latest=dict(sh.latest)
        )

    def delete_shard(self, args: DeleteArgs):
        """New owner confirms receipt; we may delete our frozen copy
        (Challenge 1)."""
        _, is_leader = self.rf.get_state()
        if self._killed or not is_leader:
            return DeleteReply(err=ERR_WRONG_LEADER)
        if self.cur.num > args.config_num:
            # Already deleted and moved on: idempotent success.
            return DeleteReply(err=OK)
        index, term, is_leader = self.rf.start(
            DeleteShardOp(config_num=args.config_num, shard=args.shard)
        )
        if not is_leader:
            return DeleteReply(err=ERR_WRONG_LEADER)
        fut = Future()
        key = ("del", args.config_num, args.shard, index)
        self._waiters[key] = fut
        result = yield self.sched.with_timeout(fut, SERVER_WAIT)
        self._waiters.pop(key, None)
        if result is TIMEOUT:
            return DeleteReply(err=ERR_TIMEOUT)
        return result

    # ------------------------------------------------------------------
    # Leader tickers
    # ------------------------------------------------------------------

    def _is_leader(self) -> bool:
        _, is_leader = self.rf.get_state()
        return is_leader

    def _config_ticker(self):
        """Poll for the next config; propose it when no migration is in
        flight so configs apply strictly in order."""
        while not self._killed:
            yield CONFIG_POLL
            if self._killed or not self._is_leader():
                continue
            if any(
                sh.state != SERVING for sh in self.shards.values()
            ):
                continue  # migration in flight; finish it first
            nxt = yield from self.ctrler.query(self.cur.num + 1)
            if nxt is not None and nxt.num == self.cur.num + 1:
                self.rf.start(ConfigOp(config=nxt))

    def _pull_ticker(self):
        while not self._killed:
            yield PULL_INTERVAL
            if self._killed or not self._is_leader():
                continue
            for s in range(NSHARDS):
                if self.shards[s].state == PULLING and s not in self._pulling_now:
                    # In-flight dedup set: ≤ NSHARDS entries, discarded
                    # when _pull_one completes.
                    self._pulling_now.add(s)  # graftlint: disable=unbounded-queue
                    self.sched.spawn(self._pull_one(s, self.cur.num))

    def _pull_one(self, shard: int, config_num: int):
        try:
            src_gid = self.prev.shards[shard]
            servers = self.prev.groups.get(src_gid, [])
            args = PullArgs(config_num=config_num, shard=shard)
            for name in servers:
                if self._killed or self.cur.num != config_num:
                    return
                if self.shards[shard].state != PULLING:
                    return
                end = self._end_to(name)
                reply = yield self.sched.with_timeout(
                    end.call("ShardKV.pull_shard", args), 0.1
                )
                if reply is TIMEOUT or reply is None or reply.err != OK:
                    continue
                if self.shards[shard].state != PULLING or self.cur.num != config_num:
                    return
                self.rf.start(
                    InsertShardOp(
                        config_num=config_num,
                        shard=shard,
                        data=reply.data,
                        latest=reply.latest,
                    )
                )
                return
        finally:
            self._pulling_now.discard(shard)

    def _gc_ticker(self):
        while not self._killed:
            yield GC_INTERVAL
            if self._killed or not self._is_leader():
                continue
            for s in range(NSHARDS):
                if self.shards[s].state == GCING and s not in self._gcing_now:
                    # In-flight dedup set: ≤ NSHARDS entries, discarded
                    # when _gc_one completes.
                    self._gcing_now.add(s)  # graftlint: disable=unbounded-queue
                    self.sched.spawn(self._gc_one(s, self.cur.num))

    def _gc_one(self, shard: int, config_num: int):
        try:
            src_gid = self.prev.shards[shard]
            servers = self.prev.groups.get(src_gid, [])
            args = DeleteArgs(config_num=config_num, shard=shard)
            for name in servers:
                if self._killed or self.cur.num != config_num:
                    return
                if self.shards[shard].state != GCING:
                    return
                end = self._end_to(name)
                reply = yield self.sched.with_timeout(
                    end.call("ShardKV.delete_shard", args), 0.1
                )
                if reply is TIMEOUT or reply is None or reply.err != OK:
                    continue
                if self.shards[shard].state == GCING and self.cur.num == config_num:
                    self.rf.start(
                        ConfirmGCOp(config_num=config_num, shard=shard)
                    )
                return
        finally:
            self._gcing_now.discard(shard)

    def _end_to(self, servername: Any) -> ClientEnd:
        if servername not in self._peer_ends:
            self._peer_ends[servername] = self.make_end(servername)
        return self._peer_ends[servername]

    # ------------------------------------------------------------------
    # Replicated apply path
    # ------------------------------------------------------------------

    def _on_apply(self, msg: ApplyMsg) -> None:
        if self._killed:
            return
        if msg.snapshot_valid:
            self._install_snapshot(msg.snapshot)
            return
        if not msg.command_valid:
            return
        op = msg.command
        reply: Any = None
        if isinstance(op, ClientOp):
            reply = self._apply_client_op(op, msg)
        elif isinstance(op, ConfigOp):
            self._apply_config(op.config)
        elif isinstance(op, InsertShardOp):
            self._apply_insert(op)
        elif isinstance(op, DeleteShardOp):
            reply = self._apply_delete(op, msg)
        elif isinstance(op, ConfirmGCOp):
            self._apply_confirm_gc(op)
        self._maybe_snapshot(msg.command_index)

    def _apply_client_op(self, op: ClientOp, msg: ApplyMsg) -> None:
        shard_id = key2shard(op.key)
        sh = self.shards[shard_id]
        # Re-check ownership at apply time: the config may have changed
        # between Start() and commit.
        if not self._can_serve(shard_id):
            reply = ShardReply(err=ERR_WRONG_GROUP)
        elif op.op != GET and sh.latest.get(op.client_id, -1) >= op.command_id:
            reply = ShardReply(err=OK)
        else:
            if op.op == GET:
                if op.key in sh.data:
                    reply = ShardReply(err=OK, value=sh.data[op.key])
                else:
                    reply = ShardReply(err=ERR_NO_KEY)
            elif op.op == PUT:
                sh.data[op.key] = op.value
                reply = ShardReply(err=OK)
            else:
                sh.data[op.key] = sh.data.get(op.key, "") + op.value
                reply = ShardReply(err=OK)
            if op.op != GET:
                sh.latest[op.client_id] = op.command_id
        waiter = self._waiters.get((op.client_id, op.command_id, msg.command_index))
        if waiter is not None:
            term, is_leader = self.rf.get_state()
            if is_leader and term == msg.command_term:
                waiter.resolve(reply)

    def _apply_config(self, cfg: Config) -> None:
        """One config step: set per-shard migration states."""
        if cfg.num != self.cur.num + 1:
            return  # stale or out-of-order proposal
        if any(sh.state != SERVING for sh in self.shards.values()):
            return  # defensive: never start a new migration mid-flight
        self.prev = self.cur
        self.cur = cfg
        for s in range(NSHARDS):
            was_mine = self.prev.shards[s] == self.gid
            is_mine = cfg.shards[s] == self.gid
            if is_mine and not was_mine:
                if self.prev.shards[s] == 0:
                    self.shards[s].state = SERVING  # fresh shard, no data
                else:
                    self.shards[s].state = PULLING
            elif was_mine and not is_mine:
                self.shards[s].state = BEPULLING

    def _apply_insert(self, op: InsertShardOp) -> None:
        if op.config_num != self.cur.num:
            return
        sh = self.shards[op.shard]
        if sh.state != PULLING:
            return  # duplicate insert
        sh.data = dict(op.data)
        sh.latest = dict(op.latest)
        sh.state = GCING  # serve immediately; old copy not yet deleted

    def _apply_delete(self, op: DeleteShardOp, msg: ApplyMsg):
        reply = DeleteReply(err=OK)
        if op.config_num == self.cur.num:
            sh = self.shards[op.shard]
            if sh.state == BEPULLING:
                self.shards[op.shard] = Shard(state=SERVING)
        # config_num < cur.num: already gone — idempotent OK.
        waiter = self._waiters.get(
            ("del", op.config_num, op.shard, msg.command_index)
        )
        if waiter is not None:
            term, is_leader = self.rf.get_state()
            if is_leader and term == msg.command_term:
                waiter.resolve(reply)
        return reply

    def _apply_confirm_gc(self, op: ConfirmGCOp) -> None:
        if op.config_num != self.cur.num:
            return
        sh = self.shards[op.shard]
        if sh.state == GCING:
            sh.state = SERVING

    # ------------------------------------------------------------------
    # Snapshots
    # ------------------------------------------------------------------

    def _maybe_snapshot(self, index: int) -> None:
        if self.maxraftstate < 0:
            return
        if self.rf.raft_state_size() >= (
            _settings().service.snapshot_threshold * self.maxraftstate
        ):
            blob = codec.encode(
                {
                    "cur": self.cur,
                    "prev": self.prev,
                    "shards": self.shards,
                }
            )
            self.rf.snapshot(index, blob)

    def _install_snapshot(self, data: bytes) -> None:
        if not data:
            return
        blob = codec.decode(data)
        self.cur = blob["cur"]
        self.prev = blob["prev"]
        self.shards = blob["shards"]

    def kill(self) -> None:
        self._killed = True
        self.rf.kill()


class ShardClerk:
    """Sharded KV client (reference: shardkv/client.go:68-129).

    Routes by ``key2shard`` through the latest known config; re-queries
    the controller on ErrWrongGroup or exhausted retries."""

    _next_client_id = 1 << 22  # distinct range from KV/ctrler clerks

    def __init__(
        self,
        sched: Scheduler,
        ctrler_ends: List[ClientEnd],
        make_end: Callable[[Any], ClientEnd],
    ) -> None:
        self.sched = sched
        self.ctrler = CtrlerClerk(sched, ctrler_ends)
        self.make_end = make_end
        self._ends: Dict[Any, ClientEnd] = {}
        self.config = Config()
        from ..utils.ids import unique_client_id

        ShardClerk._next_client_id += 1
        # Nonce-qualified for cross-process uniqueness (see utils/ids.py).
        self.client_id = unique_client_id(ShardClerk._next_client_id)
        self.command_id = 0

    def _end_to(self, servername: Any) -> ClientEnd:
        if servername not in self._ends:
            self._ends[servername] = self.make_end(servername)
        return self._ends[servername]

    def _command(self, op: str, key: str, value: str):
        self.command_id += 1
        args = ShardArgs(
            key=key,
            value=value,
            op=op,
            client_id=self.client_id,
            command_id=self.command_id,
        )
        shard = key2shard(key)
        while True:
            gid = self.config.shards[shard]
            servers = self.config.groups.get(gid, [])
            for name in servers:
                reply = yield self.sched.with_timeout(
                    self._end_to(name).call("ShardKV.command", args), 0.1
                )
                if reply is TIMEOUT or reply is None:
                    continue
                if reply.err in (OK, ERR_NO_KEY):
                    return reply.value if reply.err == OK else ""
                if reply.err == ERR_WRONG_GROUP:
                    break  # re-query config
                # ErrWrongLeader / ErrTimeout: try next server.
            yield 0.1  # (reference: shardkv/client.go 100 ms between sweeps)
            self.config = yield from self.ctrler.query(-1)

    def get(self, key: str):
        return self._command(GET, key, "")

    def put(self, key: str, value: str):
        return self._command(PUT, key, value)

    def append(self, key: str, value: str):
        return self._command(APPEND, key, value)
