"""Linearizable replicated KV service (reference: src/kvraft).

Architecture mirrors the reference: a unified ``Command`` RPC feeds ops
through the Raft log; a per-client dup table gives at-most-once apply;
per-request wait continuations match apply-loop completions back to
blocked RPC handlers; the service snapshots its state machine when the
raft state grows (reference: kvraft/server.go:40-183).

Event-driven differences from the Go original: the RPC handler is a
generator coroutine suspended on a future instead of a goroutine on a
channel, and the apply "loop" is the Raft node's apply callback.

Documented divergences (SURVEY §7.5): the snapshot trigger really fires
at 0.8×maxraftstate (the reference's integer division makes its 0.8
threshold effectively 1.0, kvraft/server.go:151); ``ErrTimeout`` has no
leading space (kvraft/rpc.go:7); the legacy unused Get/PutAppend RPC
types are not reproduced.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..raft.messages import ApplyMsg
from ..raft.node import RaftNode
from ..raft.persister import Persister
from ..sim.scheduler import Future, Scheduler, TIMEOUT
from ..transport import codec
from ..transport.network import ClientEnd

__all__ = [
    "OK",
    "ERR_NO_KEY",
    "ERR_WRONG_LEADER",
    "ERR_TIMEOUT",
    "GET",
    "PUT",
    "APPEND",
    "CommandArgs",
    "CommandReply",
    "MemoryKV",
    "KVServer",
    "Clerk",
]

# Error strings (reference: kvraft/rpc.go:3-12).
OK = "OK"
ERR_NO_KEY = "ErrNoKey"
ERR_WRONG_LEADER = "ErrWrongLeader"
ERR_TIMEOUT = "ErrTimeout"

GET = "Get"
PUT = "Put"
APPEND = "Append"

# Server-side wait before giving up on a started op
# (reference: kvraft/server.go:80 — 99 ms) and clerk per-attempt
# timeout before rotating servers (reference: kvraft/client.go:57 —
# 100 ms), both from the config system (MULTIRAFT_SERVER_WAIT /
# MULTIRAFT_CLERK_RETRY).
from ..utils.config import settings as _settings

SERVER_WAIT = _settings().service.server_wait
CLERK_RETRY = _settings().service.clerk_retry

# Pause after a full failed sweep of all servers before retrying
# (reference analog: shardctrler/client.go:52-62's 100 ms inter-sweep
# sleep); kept short so post-election client latency stays low.
SWEEP_BACKOFF = 0.02


@codec.registered
@dataclasses.dataclass
class CommandArgs:
    """(reference: kvraft/rpc.go CommandArgs)"""

    key: str = ""
    value: str = ""
    op: str = GET
    client_id: int = 0
    command_id: int = 0


@codec.registered
@dataclasses.dataclass
class CommandReply:
    err: str = OK
    value: str = ""


@codec.registered
@dataclasses.dataclass
class Op:
    """The entry actually replicated through Raft."""

    key: str = ""
    value: str = ""
    op: str = GET
    client_id: int = 0
    command_id: int = 0


class MemoryKV:
    """(reference: kvraft/memoryKV.go:3-36)"""

    def __init__(self) -> None:
        self.data: Dict[str, str] = {}

    def get(self, key: str) -> tuple[str, str]:
        if key in self.data:
            return self.data[key], OK
        return "", ERR_NO_KEY

    def put(self, key: str, value: str) -> str:
        self.data[key] = value
        return OK

    def append(self, key: str, value: str) -> str:
        self.data[key] = self.data.get(key, "") + value
        return OK


class KVServer:
    """Replicated KV server (reference: kvraft/server.go).

    RPC surface: ``KVServer.command``.  Construct one per peer; it owns
    its RaftNode."""

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
        self.kv = MemoryKV()
        # client_id -> highest applied command_id (dup table,
        # reference: kvraft/server.go:145-148).
        self.latest: Dict[int, int] = {}
        # (client_id, command_id) -> Future resolved by the apply loop
        # (wait-channel pattern, reference: kvraft/server.go:130-143;
        # keyed deterministically instead of by random Seq).
        self._waiters: Dict[tuple, Future] = {}
        self._killed = False
        self.rf = RaftNode(
            sched, ends, me, persister, self._on_apply, seed=seed
        )
        self._install_snapshot(persister.read_snapshot())

    # -- RPC handler (reference: kvraft/server.go:56-96) -----------------

    def command(self, args: CommandArgs):
        if self._killed:
            return CommandReply(err=ERR_WRONG_LEADER)
        # Duplicate write: already applied, answer immediately
        # (reference: kvraft/server.go:66-69; reads go through the log
        # for linearizability — no lease/read-index shortcut).
        if args.op != GET and self.latest.get(args.client_id, -1) >= args.command_id:
            return CommandReply(err=OK)
        op = Op(
            key=args.key,
            value=args.value,
            op=args.op,
            client_id=args.client_id,
            command_id=args.command_id,
        )
        index, term, is_leader = self.rf.start(op)
        if not is_leader:
            return CommandReply(err=ERR_WRONG_LEADER)
        fut = Future()
        key = (args.client_id, args.command_id, index)
        self._waiters[key] = fut
        result = yield self.sched.with_timeout(fut, SERVER_WAIT)
        self._waiters.pop(key, None)
        if result is TIMEOUT:
            return CommandReply(err=ERR_TIMEOUT)
        return result

    # -- apply loop (reference: kvraft/server.go:98-128) -----------------

    def _on_apply(self, msg: ApplyMsg) -> None:
        if self._killed:
            return
        if msg.snapshot_valid:
            self._install_snapshot(msg.snapshot)
            return
        if not msg.command_valid:
            return
        op: Op = msg.command
        if self.latest.get(op.client_id, -1) >= op.command_id:
            # Duplicate already applied; a re-proposed Get answers with a
            # fresh read, a re-proposed write just acks (SURVEY §7.5 #8).
            reply = self._read_reply(op) if op.op == GET else CommandReply(err=OK)
        else:
            reply = self._apply_op(op)
            self.latest[op.client_id] = op.command_id
        waiter = self._waiters.get((op.client_id, op.command_id, msg.command_index))
        if waiter is not None:
            term, is_leader = self.rf.get_state()
            if is_leader and term == msg.command_term:
                waiter.resolve(reply)
        self._maybe_snapshot(msg.command_index)

    def _apply_op(self, op: Op) -> CommandReply:
        if op.op == GET:
            return self._read_reply(op)
        if op.op == PUT:
            return CommandReply(err=self.kv.put(op.key, op.value))
        return CommandReply(err=self.kv.append(op.key, op.value))

    def _read_reply(self, op: Op) -> CommandReply:
        value, err = self.kv.get(op.key)
        return CommandReply(err=err, value=value)

    # -- snapshots (reference: kvraft/server.go:150-183) -----------------

    def _maybe_snapshot(self, index: int) -> None:
        if self.maxraftstate < 0:
            return
        # Trigger at the documented 0.8 threshold (divergence: the
        # reference's integer division makes its check effectively 1.0×,
        # kvraft/server.go:151).
        if self.rf.raft_state_size() >= (
            _settings().service.snapshot_threshold * self.maxraftstate
        ):
            blob = codec.encode(
                {"data": dict(self.kv.data), "latest": dict(self.latest)}
            )
            self.rf.snapshot(index, blob)

    def _install_snapshot(self, data: bytes) -> None:
        if not data:
            return
        blob = codec.decode(data)
        self.kv.data = dict(blob["data"])
        self.latest = dict(blob["latest"])

    # -- lifecycle -------------------------------------------------------

    def kill(self) -> None:
        self._killed = True
        self.rf.kill()


class Clerk:
    """KV client (reference: kvraft/client.go).

    Caches the last known leader, stamps ops with (client_id,
    monotonically increasing command_id), retries with a per-attempt
    timeout, rotating servers on failure."""

    _next_client_id = 0

    def __init__(self, sched: Scheduler, ends: List[ClientEnd]) -> None:
        from ..utils.ids import unique_client_id

        self.sched = sched
        self.ends = ends
        self.leader = 0
        Clerk._next_client_id += 1
        # Nonce-qualified: the class counter is only unique within one
        # process, but the distributed deployment runs clerks in many
        # (every server process owns internal clerks) — a collision
        # makes dedup tables swallow another client's commands.
        self.client_id = unique_client_id(Clerk._next_client_id)
        self.command_id = 0

    def _command(self, op: str, key: str, value: str):
        """Generator coroutine (reference: kvraft/client.go:47-71)."""
        self.command_id += 1
        args = CommandArgs(
            key=key,
            value=value,
            op=op,
            client_id=self.client_id,
            command_id=self.command_id,
        )
        failures = 0
        while True:
            fut = self.ends[self.leader].call("KVServer.command", args)
            reply = yield self.sched.with_timeout(fut, CLERK_RETRY)
            if (
                reply is TIMEOUT
                or reply is None
                or reply.err in (ERR_WRONG_LEADER, ERR_TIMEOUT)
            ):
                self.leader = (self.leader + 1) % len(self.ends)
                failures += 1
                if failures % len(self.ends) == 0:
                    # A full sweep failed (leaderless / partitioned): pause
                    # before sweeping again so fast-failing RPCs (real TCP
                    # connection-refused) don't busy-spin the loop — the
                    # reference paces the same way between sweeps
                    # (reference: shardctrler/client.go:52-62).
                    yield self.sched.sleep(SWEEP_BACKOFF)
                continue
            return reply.value if reply.err != ERR_NO_KEY else ""

    def get(self, key: str):
        return self._command(GET, key, "")

    def put(self, key: str, value: str):
        return self._command(PUT, key, value)

    def append(self, key: str, value: str):
        return self._command(APPEND, key, value)
