"""Clerk-side clients of the engine serving stack (split out of
engine_server.py round 4): the single-server retry clerk, the
pipelined multi-op frame clerk, and the fleet clerks that route
key→shard→gid→process from the replicated config (reference loops:
kvraft/client.go:47-71, shardkv/client.go:68-129).
"""

from __future__ import annotations

import itertools
import time

from ..sim.scheduler import TIMEOUT, Future
from ..utils.ids import unique_client_id
from .engine_wire import (
    ERR_BUSY,
    OK,
    EngineCmdArgs,
    EngineCmdReply,
    retry_after_of,
)
from .realtime import Backoff


def _busy_delay(backoff: Backoff, reply) -> float:
    """Delay before retrying a shed (ErrBusy) request: the server's
    ``retry_after_s`` hint, jittered.  The server hands the SAME hint
    to every clerk it sheds in a burst — honored verbatim, those
    clerks would re-offer in one synchronized wave and shed again;
    equal jitter spreads the wave.  No hint (legacy peer whose reply
    predates the field) → the ordinary doubling backoff."""
    hint = retry_after_of(reply)
    if hint <= 0.0:
        return backoff.next_delay()
    return backoff.jittered(hint)


def _end_obs(end):
    """The observability plane of the node behind a TcpClientEnd (the
    clerk's own process), or a private stand-in for exotic ends."""
    node = getattr(end, "_node", None)
    if node is not None and getattr(node, "obs", None) is not None:
        return node.obs
    from .observe import Observability

    return Observability()

__all__ = [
    "EngineClerk",
    "FirehoseClerk",
    "ShardFirehoseClerk",
    "PipelinedClerk",
    "EngineShardNetClerk",
    "EngineFleetClerk",
    "PipelinedFleetClerk",
]


class EngineClerk:
    """Generator-coroutine client of an engine KV/shard server —
    retry-until-answer with session dedup, mirroring the reference
    clerk loop (kvraft/client.go:47-71) against the single front door."""

    # Clerks are created from concurrent threads (one per blocking
    # client); the counter allocation must be atomic or two clerks
    # share a client_id and dedup silently drops one's writes.
    _next = itertools.count(1)

    def __init__(
        self, sched, end, service: str = "EngineKV", lane: str = "",
    ) -> None:
        self.sched = sched
        self.end = end
        self.service = service
        self.client_id = unique_client_id(next(EngineClerk._next))
        self.command_id = 0
        # Priority lane: a non-empty lane prefixes every rid, and the
        # server's admission layer (admission.py) exempts recognized
        # lanes — the porcupine sampler passes "verify" so the
        # linearizability witness keeps flowing while user traffic
        # sheds.
        self.lane = lane
        # Failed calls that fail FAST (connection refused while the
        # server restarts, a partitioned minority) must not turn the
        # retry loop into a hot spin against the recovering process.
        self._backoff = Backoff()
        # Observability: per-call latency/retry counters + a span per
        # logical command, all tagged with a compact request id that
        # also rides the wire (every retry reuses it, so the clerk span
        # here and the server's dispatch spans correlate by one id).
        self.obs = _end_obs(end)
        self._rid_seq = itertools.count(1)

    def _rid(self) -> str:
        rid = f"{self.client_id & 0xFFFFFF:06x}.{next(self._rid_seq)}"
        return f"{self.lane}.{rid}" if self.lane else rid

    def _command(self, op: str, key: str, value: str = ""):
        if op != "Get":
            self.command_id += 1
        args = EngineCmdArgs(
            op=op, key=key, value=value,
            client_id=self.client_id, command_id=self.command_id,
        )
        rid = self._rid()
        m = self.obs.metrics
        m.inc("clerk.calls")
        t0 = time.perf_counter()
        attempts = 0
        while True:
            attempts += 1
            fut: Future = self.end.call(
                f"{self.service}.command", args, trace=rid
            )
            reply = yield self.sched.with_timeout(fut, 3.5)
            if (
                reply is None
                or reply is TIMEOUT
                or reply.err != OK
            ):
                # lost/timed out/old leader/shed: retry (dedup-safe)
                m.inc("clerk.retries")
                if (
                    reply is not None and reply is not TIMEOUT
                    and reply.err == ERR_BUSY
                ):
                    # Admission shed: the server told us when to come
                    # back — honor it (jittered) instead of doubling.
                    m.inc("clerk.busy")
                    delay = _busy_delay(self._backoff, reply)
                else:
                    delay = self._backoff.next_delay()
                m.observe("clerk.backoff_s", delay)
                yield delay
                continue
            self._backoff.reset()
            dur = time.perf_counter() - t0
            m.observe("clerk.call_s", dur)
            self.obs.tracer.span(
                f"clerk.{op}", t0 * 1e6, dur * 1e6, track="clerk",
                req=rid, attempts=attempts,
            )
            return reply.value

    def get(self, key: str):
        return self._command("Get", key)

    def put(self, key: str, value: str):
        return self._command("Put", key, value)

    def append(self, key: str, value: str):
        return self._command("Append", key, value)


class PipelinedClerk(EngineClerk):
    """Clerk that ships a whole batch of ops as ONE ``batch`` frame —
    the reference clerk's serial loop (kvraft/client.go:47-71) widened
    for the engine's coalescing front door: the server applies the
    frame in one pump, so per-op RPC overhead amortizes ~frame-fold.
    Whole-frame retry is dedup-safe (same client/command ids)."""

    # Mirror of EngineKVService.MAX_BATCH: oversized op lists split
    # into compliant frames client-side (the server's rejection is
    # permanent, so retrying an oversized frame would spin forever).
    MAX_FRAME = 1024

    def run_batch(self, ops):
        """ops = [(op, key, value), ...] → list of values (Gets) in
        order.  Generator (spawn on the scheduler)."""
        out = []
        for s in range(0, len(ops), self.MAX_FRAME):
            part = yield from self._one_frame(ops[s:s + self.MAX_FRAME])
            out.extend(part)
        return out

    def _one_frame(self, ops):
        frame = []
        for op, key, value in ops:
            if op != "Get":
                self.command_id += 1
            frame.append(
                EngineCmdArgs(
                    op=op, key=key, value=value,
                    client_id=self.client_id,
                    command_id=self.command_id,
                )
            )
        rid = self._rid()
        self.obs.metrics.inc("clerk.batch_frames")
        while True:
            fut: Future = self.end.call(
                f"{self.service}.batch", frame, trace=rid
            )
            reply = yield self.sched.with_timeout(fut, 10.0)
            if isinstance(reply, EngineCmdReply):
                # The dispatch layer shed the whole frame (ErrBusy)
                # before the handler saw it — a single reply, not the
                # per-op list.  Honor the hint and re-ship (dedup-safe).
                self.obs.metrics.inc("clerk.busy")
                yield _busy_delay(self._backoff, reply)
                continue
            if reply is not None and reply is not TIMEOUT and any(
                r.err.startswith("ErrBatchTooLarge") for r in reply
            ):
                # Permanent: the server's cap shrank below ours.
                raise ValueError(reply[0].err)
            if (
                reply is None
                or reply is TIMEOUT
                or any(r.err != OK for r in reply)
            ):
                # lost/partial frame: retry whole (dedup-safe)
                yield self._backoff.next_delay()
                continue
            self._backoff.reset()
            return [r.value for r in reply]


class FirehoseClerk(EngineClerk):
    """Columnar clerk: packs a whole op batch into ONE firehose blob
    (engine/firehose.py) and retries only the rows the server failed —
    per-row RETRY errs come back in the reply columns, and the retry
    frame reuses the same command ids, so session dedup keeps the
    at-least-once wire exactly-once.

    This is the client half of the columnar serving path: no per-op
    dataclasses, no per-op codec — numpy columns end to end."""

    # The server's wire-level cap, from the shared wire module:
    # oversized batches split into compliant frames client-side (the
    # server's rejection is permanent, so retrying an oversized frame
    # would spin forever).
    from ..engine.firehose import MAX_FIREHOSE_ROWS as MAX_FRAME

    def __init__(
        self, sched, end, service: str = "EngineKV", lane: str = "",
    ) -> None:
        super().__init__(sched, end, service, lane=lane)
        self._G = None

    def _topology(self, deadline):
        while self._G is None:
            if self.sched.now >= deadline:
                raise TimeoutError("topology fetch exceeded deadline")
            fut: Future = self.end.call(f"{self.service}.info", None)
            reply = yield self.sched.with_timeout(fut, 3.5)
            if reply is not None and reply is not TIMEOUT:
                self._G = int(reply["G"])
            else:
                yield self._backoff.next_delay()
        self._backoff.reset()
        return self._G

    def run_batch(self, ops, deadline_s: float = 30.0):
        """ops = [(op, key, value), ...] → list of values (Gets) in
        order.  Generator (spawn on the scheduler)."""
        out = []
        for s in range(0, len(ops), self.MAX_FRAME):
            part = yield from self._one_frame(
                ops[s: s + self.MAX_FRAME], deadline_s
            )
            out.extend(part)
        return out

    def _one_frame(self, ops, deadline_s: float):
        import numpy as np

        from ..engine.firehose import (
            FH_OK,
            pack_request,
            unpack_reply,
        )
        from .engine_wire import _OPCODE, route_group

        deadline = self.sched.now + deadline_s
        G = yield from self._topology(deadline)
        n = len(ops)
        op_col = np.zeros(n, np.uint8)
        group_col = np.zeros(n, np.uint32)
        cmd_col = np.zeros(n, np.uint64)
        keys = [b""] * n
        vals = [b""] * n
        for i, (op, key, value) in enumerate(ops):
            op_col[i] = _OPCODE[op]
            group_col[i] = route_group(key, G)
            if op != "Get":
                self.command_id += 1
                cmd_col[i] = self.command_id
            keys[i] = key.encode()
            vals[i] = value.encode()
        client_col = np.full(n, self.client_id, np.uint64)

        values = [""] * n
        todo = np.arange(n)
        while len(todo) and self.sched.now < deadline:
            blob = pack_request(
                op_col[todo], group_col[todo], client_col[todo],
                cmd_col[todo],
                [keys[i] for i in todo.tolist()],
                [vals[i] for i in todo.tolist()],
            )
            fut: Future = self.end.call(f"{self.service}.firehose", blob)
            reply = yield self.sched.with_timeout(fut, 10.0)
            if reply is None or reply is TIMEOUT:
                # whole frame lost: retry whole (dedup-safe)
                yield self._backoff.next_delay()
                continue
            if isinstance(reply, EngineCmdReply):
                # Shed at dispatch (ErrBusy) — the firehose blob never
                # reached the handler.  Honor the hint, retry whole.
                self.obs.metrics.inc("clerk.busy")
                yield _busy_delay(self._backoff, reply)
                continue
            if isinstance(reply, tuple) and reply and reply[0] == "err":
                raise ValueError(reply[1])
            self._backoff.reset()
            err, row_vals = unpack_reply(reply)
            ok = err == FH_OK
            for j in np.nonzero(ok)[0].tolist():
                values[int(todo[j])] = row_vals[j]
            todo = todo[~ok]
        if len(todo):
            raise TimeoutError(
                f"{len(todo)} rows unresolved after {deadline_s}s"
            )
        return values


class ShardFirehoseClerk:
    """Columnar clerk for the SHARDED fleet: each round partitions its
    rows by owning gid (key→shard→gid from the replicated config) and
    ships ONE firehose blob per process; WRONG_GROUP rows refresh the
    config and re-route; RETRY rows resubmit under the same command
    ids (per-shard dedup travels with the shard, so the retry stays
    exactly-once across migrations).

    Order safety: within a round at most ONE write per shard is in
    flight from this clerk, and a shard's ops never reorder (a
    deferred op defers everything after it on that shard).  A
    pipelined same-shard chain could otherwise invert across an
    away-and-back migration — op N bounces WRONG_GROUP while N+1
    applies, and N's retry dedup-swallows into a false OK (the hazard
    the per-op fleet clerk's serial chains guard, engine_shard_server.
    batch).  Cross-shard rows keep full columnar parallelism."""

    from ..engine.firehose import MAX_FIREHOSE_ROWS as MAX_FRAME

    def __init__(self, sched, ends_by_gid: dict) -> None:
        self.sched = sched
        self.ends = dict(ends_by_gid)
        self._all = list(dict.fromkeys(self.ends.values()))
        self.client_id = unique_client_id(next(EngineClerk._next))
        self.command_id = 0
        self._cfg = None
        self._backoff = Backoff()

    def _refresh_config(self, deadline):
        while True:
            if self.sched.now >= deadline:
                raise TimeoutError("config fetch exceeded deadline")
            for end in self._all:
                fut: Future = end.call("EngineShardKV.config", None)
                reply = yield self.sched.with_timeout(fut, 3.5)
                if reply is not None and reply is not TIMEOUT:
                    self._cfg = reply
                    self._backoff.reset()
                    return reply
            yield self._backoff.next_delay()

    def run_batch(self, ops, deadline_s: float = 60.0):
        """ops = [(op, key, value), ...] → list of values in order.
        Generator (spawn on the scheduler)."""
        import numpy as np

        from ..engine.firehose import (
            FH_NO_KEY,
            FH_OK,
            FH_WRONG_GROUP,
            pack_request,
            unpack_reply,
        )
        from ..services.shardkv import key2shard
        from .engine_wire import _OPCODE

        n = len(ops)
        rows = []
        for op, key, value in ops:
            cmd = 0
            if op != "Get":
                self.command_id += 1
                cmd = self.command_id
            rows.append((op, key, value, cmd))
        shards = [key2shard(key) for _, key, _, _ in rows]
        results = [""] * n
        done = [False] * n
        deadline = self.sched.now + deadline_s
        remaining = list(range(n))
        while remaining:
            if self.sched.now >= deadline:
                raise TimeoutError(
                    f"{len(remaining)} rows unresolved after {deadline_s}s"
                )
            # ROUND: program-order prefix per shard — one in-flight
            # write per shard; a deferred op defers everything after
            # it on that shard.
            taken = []
            write_taken: set = set()
            deferred: set = set()
            for i in remaining:
                sh = shards[i]
                if sh in deferred:
                    continue
                if rows[i][0] != "Get":
                    if sh in write_taken:
                        deferred.add(sh)
                        continue
                    write_taken.add(sh)
                taken.append(i)
                if len(taken) >= self.MAX_FRAME:
                    break
            todo = list(taken)
            while todo and self.sched.now < deadline:
                cfg = self._cfg
                if cfg is None:
                    cfg = yield from self._refresh_config(deadline)
                by_end: dict = {}
                retry = []
                unrouted = 0
                for i in todo:
                    gid = cfg[1][shards[i]]
                    end = self.ends.get(gid)
                    if end is None:
                        # Shard unassigned (gid 0) or owned by a
                        # process we have no end for: wait for the
                        # config to move — re-query, don't spin.
                        unrouted += 1
                        retry.append(i)
                    else:
                        by_end.setdefault(end, []).append((i, gid))
                if unrouted:
                    self._cfg = None
                    yield self.sched.sleep(self._backoff.jittered(0.03))
                flights = []
                busy = None
                for end, members in by_end.items():
                    idxs = [i for i, _ in members]
                    blob = pack_request(
                        np.array([_OPCODE[rows[i][0]] for i in idxs],
                                 np.uint8),
                        np.array([g for _, g in members], np.uint32),
                        np.full(len(idxs), self.client_id, np.uint64),
                        np.array([rows[i][3] for i in idxs], np.uint64),
                        [rows[i][1].encode() for i in idxs],
                        [rows[i][2].encode() for i in idxs],
                    )
                    flights.append(
                        (idxs, end.call("EngineShardKV.firehose", blob))
                    )
                for idxs, fut in flights:
                    reply = yield self.sched.with_timeout(fut, 10.0)
                    if reply is None or reply is TIMEOUT:
                        retry.extend(idxs)
                        continue
                    if isinstance(reply, EngineCmdReply):
                        # Shed at dispatch (ErrBusy): requeue the
                        # rows; the hint is honored once, after the
                        # round's other flights resolve.
                        retry.extend(idxs)
                        busy = reply
                        continue
                    if (
                        isinstance(reply, tuple)
                        and reply
                        and reply[0] == "err"
                    ):
                        raise ValueError(reply[1])
                    err, vals = unpack_reply(reply)
                    for j, i in enumerate(idxs):
                        if err[j] == FH_OK:
                            done[i] = True
                            results[i] = vals[j]
                        elif err[j] == FH_NO_KEY:
                            done[i] = True
                            results[i] = ""
                        else:
                            if err[j] == FH_WRONG_GROUP:
                                self._cfg = None  # routing moved
                            retry.append(i)
                if busy is not None:
                    yield _busy_delay(self._backoff, busy)
                elif retry and self._cfg is None:
                    yield self.sched.sleep(self._backoff.jittered(0.03))
                todo = sorted(retry)
            remaining = [i for i in remaining if not done[i]]
        return results


class EngineShardNetClerk(EngineClerk):
    def __init__(self, sched, end) -> None:
        super().__init__(sched, end, service="EngineShardKV")


class EngineFleetClerk:
    """Clerk for a fleet of engine shard servers: route key→shard→gid→
    process from the replicated config, re-query and re-route on
    ErrWrongGroup — the reference clerk loop (shardkv/client.go:68-129)
    where each "group" is a chip-owning process."""

    # Per-fetch budget: one config fetch attempt (cycling every known
    # process with backoff) is bounded; a caller's retry loop decides
    # whether to try again.  A fully partitioned clerk then cycles
    # fetch → backoff → fetch instead of pinning its coroutine inside
    # an unbounded inner loop.
    CONFIG_DEADLINE_S = 30.0

    def __init__(self, sched, ends_by_gid: dict, make_end=None) -> None:
        self.sched = sched
        self.ends = dict(ends_by_gid)  # gid -> TcpClientEnd
        self._all = list(dict.fromkeys(self.ends.values()))
        self.client_id = unique_client_id(next(EngineClerk._next))
        self.command_id = 0
        self._cfg = None  # cached (num, shards, groups)
        self._backoff = Backoff()
        # Placement awareness (distributed/placement.py): with a
        # ``make_end`` factory the clerk re-derives its gid→end map from
        # the fleet's placement view after ErrWrongGroup — a config
        # re-query alone cannot re-route a gid the controller MOVED to
        # another process.  Without the factory the static map stands.
        self._make_end = make_end
        self._place_ver = 0
        self._place_stale = False
        self._ends_by_addr: dict = {}
        # Observability (see EngineClerk): every end shares the
        # process's one node, so any end's plane is THE plane.
        self.obs = _end_obs(self._all[0]) if self._all else _end_obs(None)
        self._rid_seq = itertools.count(1)

    def _rid(self) -> str:
        return f"{self.client_id & 0xFFFFFF:06x}.{next(self._rid_seq)}"

    def _refresh_config(self, deadline=None):
        if deadline is None:
            deadline = self.sched.now + self.CONFIG_DEADLINE_S
        if self._place_stale:
            yield from self._refresh_placement()
        while True:
            if self.sched.now >= deadline:
                raise TimeoutError("config fetch exceeded deadline")
            for end in self._all:
                fut = end.call("EngineShardKV.config", ())
                reply = yield self.sched.with_timeout(fut, 2.0)
                if reply is not None and reply is not TIMEOUT:
                    self._cfg = reply
                    self._backoff.reset()
                    return reply
            yield self._backoff.next_delay()

    def _refresh_placement(self):
        """Rebuild the gid→end map from any process's placement view
        (``EngineShardKV.placement``).  Version-gated: only a strictly
        newer view replaces the map, so a process holding a stale view
        cannot roll the clerk back mid-migration."""
        self._place_stale = False
        if self._make_end is None:
            return
        for end in list(self._all):
            fut = end.call("EngineShardKV.placement", ())
            reply = yield self.sched.with_timeout(fut, 2.0)
            if (
                reply is None or reply is TIMEOUT
                or not isinstance(reply, tuple) or len(reply) != 2
            ):
                continue
            ver, pmap = reply
            if ver > self._place_ver and pmap:
                self._place_ver = ver
                ends = {}
                for g, addr in pmap.items():
                    addr = (addr[0], int(addr[1]))
                    e = self._ends_by_addr.get(addr)
                    if e is None:
                        e = self._make_end(addr[0], addr[1])
                        self._ends_by_addr[addr] = e
                    ends[int(g)] = e
                self.ends = ends
                self._all = list(dict.fromkeys(self.ends.values()))
            return

    def _command(self, op: str, key: str, value: str = ""):
        from ..engine.shardkv import ERR_WRONG_GROUP
        from ..services.shardkv import key2shard

        if op != "Get":
            self.command_id += 1
        args = EngineCmdArgs(
            op=op, key=key, value=value,
            client_id=self.client_id, command_id=self.command_id,
        )
        rid = self._rid()
        m = self.obs.metrics
        m.inc("clerk.calls")
        t0 = time.perf_counter()
        attempts = 0
        while True:
            cfg = self._cfg
            if cfg is None:
                try:
                    cfg = yield from self._refresh_config()
                except TimeoutError:
                    # Whole fleet unreachable for a full fetch budget:
                    # back off and re-enter (the blocking facade's own
                    # deadline bounds the caller).
                    m.inc("clerk.retries")
                    yield self._backoff.next_delay()
                    continue
            gid = cfg[1][key2shard(key)]
            end = self.ends.get(gid)
            if end is None:  # unassigned shard / unknown gid: re-query
                yield self._backoff.next_delay()
                self._cfg = None
                continue
            attempts += 1
            fut = end.call("EngineShardKV.command", args, trace=rid)
            reply = yield self.sched.with_timeout(fut, 3.5)
            if reply is None or reply is TIMEOUT:
                self._cfg = None
                self._place_stale = True  # the process may be gone
                m.inc("clerk.retries")
                delay = self._backoff.next_delay()
                m.observe("clerk.backoff_s", delay)
                yield delay
                continue  # dropped / wedged: re-route and retry
            if reply.err == OK:
                self._backoff.reset()
                dur = time.perf_counter() - t0
                m.observe("clerk.call_s", dur)
                self.obs.tracer.span(
                    f"clerk.{op}", t0 * 1e6, dur * 1e6, track="clerk",
                    req=rid, attempts=attempts,
                )
                return reply.value
            if reply.err == ERR_WRONG_GROUP:
                self._cfg = None  # stale routing: re-query the config
                self._place_stale = True  # ...or the gid itself moved
            m.inc("clerk.retries")
            if reply.err == ERR_BUSY:
                # Shed at dispatch: routing is fine, the process is
                # overloaded — honor its jittered hint and retry there.
                m.inc("clerk.busy")
                yield _busy_delay(self._backoff, reply)
            else:
                yield self._backoff.next_delay()

    def get(self, key: str):
        return self._command("Get", key)

    def put(self, key: str, value: str):
        return self._command("Put", key, value)

    def append(self, key: str, value: str):
        return self._command("Append", key, value)


class PipelinedFleetClerk(EngineFleetClerk):
    """Multi-op frames over a sharded fleet: each round partitions the
    remaining ops by owning process (key→shard→gid→end from the
    replicated config) and ships one ``batch`` frame per process; ops
    answered ErrWrongGroup (shard mid-migration / stale routing)
    re-frame to the new owner next round.  Order safety: a frame's
    chains fully resolve server-side before it answers, so re-framed
    retries can never interleave with in-flight ops."""

    # Ops per sequential WINDOW.  An oversized batch must NOT split
    # into concurrently-in-flight frames: a (client, shard) chain
    # spanning two live frames breaks the serial-chain discipline the
    # server's dedup safety rests on (op N+1 applying while op N is
    # unresolved lets N's retry dedup-swallow into a false OK).  Each
    # window fully resolves before the next ships.
    MAX_FRAME = 1024

    def run_batch(self, ops):
        """ops = [(op, key, value), ...] → list of values in order."""
        out = []
        for s in range(0, len(ops), self.MAX_FRAME):
            part = yield from self._one_window(ops[s:s + self.MAX_FRAME])
            out.extend(part)
        return out

    def _one_window(self, ops):
        from ..services.shardkv import key2shard

        frame_args = []
        for op, key, value in ops:
            if op != "Get":
                self.command_id += 1
            frame_args.append(
                EngineCmdArgs(
                    op=op, key=key, value=value,
                    client_id=self.client_id,
                    command_id=self.command_id,
                )
            )
        rid = self._rid()
        self.obs.metrics.inc("clerk.batch_frames")
        results = [None] * len(ops)
        todo = list(range(len(ops)))
        while todo:
            cfg = self._cfg
            if cfg is None:
                try:
                    cfg = yield from self._refresh_config()
                except TimeoutError:
                    yield self._backoff.next_delay()
                    continue
            by_end: dict = {}
            unrouted = []
            for i in todo:
                gid = cfg[1][key2shard(frame_args[i].key)]
                end = self.ends.get(gid)
                if end is None:
                    unrouted.append(i)
                else:
                    by_end.setdefault(end, []).append(i)
            retry = list(unrouted)
            busy = None
            # Dispatch every process's frame FIRST, then collect:
            # wall-clock is the slowest frame, not the sum.  (Frames
            # are per-process partitions of one ≤MAX_FRAME window, so
            # none can exceed the server's cap.)
            flights = [
                (idxs, end.call(
                    "EngineShardKV.batch",
                    [frame_args[i] for i in idxs],
                    trace=rid,
                ))
                for end, idxs in by_end.items()
            ]
            for part, fut in flights:
                reply = yield self.sched.with_timeout(fut, 10.0)
                if reply is None or reply is TIMEOUT:
                    retry.extend(part)
                    continue
                if isinstance(reply, EngineCmdReply):
                    # Shed at dispatch (ErrBusy): one reply for the
                    # whole frame, not the per-op list.
                    retry.extend(part)
                    busy = reply
                    continue
                if any(
                    r.err.startswith("ErrBatchTooLarge") for r in reply
                ):
                    # Permanent: the server's cap shrank below ours.
                    raise ValueError(reply[0].err)
                for i, r in zip(part, reply):
                    if r.err == OK:
                        results[i] = r.value
                    else:
                        retry.append(i)
            todo = sorted(retry)
            if todo:
                if busy is not None:
                    # Overload, not stale routing: honor the jittered
                    # hint without burning a config re-query.
                    self.obs.metrics.inc("clerk.busy")
                    yield _busy_delay(self._backoff, busy)
                else:
                    self._cfg = None  # routing moved: re-query
                    self._place_stale = True  # ...maybe to a new process
                    yield self.sched.sleep(self._backoff.jittered(0.03))
        return results
