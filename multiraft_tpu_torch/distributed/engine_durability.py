"""Durability + recovery for the engine serving stack: the
checkpoint/WAL lifecycle (:class:`EngineDurability`), the shared
durable frame-ack gate, and both WAL replay paths (plain-KV re-submit
and the sharded two-pass redo, :class:`ShardWalReplay`).  Split out of
engine_server.py (round 4): the replay logic is the subtlest code in
the serving stack and deserves its own module boundary; the services
delegate to it unchanged.

See distributed/wal.py for the on-disk format and the torn-tail
contract; reference analog: the Persister carryover crash model
(raft/config.go:113-142) at engine granularity.
"""

from __future__ import annotations

import os
import time

from ..engine.kv import KVOp
from ..transport import codec
from .engine_wire import _OPCODE, route_group

__all__ = [
    "EngineDurability",
    "await_frame_synced",
    "replay_kv_wal",
    "ShardWalReplay",
]


class EngineDurability:
    """Checkpoint + WAL lifecycle for one engine server process.

    The engine's durability contract (see distributed/wal.py): periodic
    atomic whole-engine checkpoints + a WAL of ops since the last one;
    write acks gate on the WAL record being fsynced (group commit at
    pump cadence, so the fsync amortizes over every op in the ~2 ms
    window).  Recovery restores the checkpoint and re-submits WAL
    records through consensus — session dedup makes it exactly-once."""

    def __init__(
        self,
        data_dir: str,
        driver,
        state_owner,  # has state_dict() (BatchedKV / BatchedShardKV)
        checkpoint_every_s: float = 30.0,
        fsync: bool = True,
        metrics=None,
    ) -> None:
        from ..utils.metrics import Metrics
        from .wal import WriteAheadLog

        os.makedirs(data_dir, exist_ok=True)
        self.ckpt_path = os.path.join(data_dir, "engine.ckpt")
        # The server passes its per-process registry so WAL fsync
        # latency / rotate counts surface in Obs.snapshot scrapes.
        self.metrics = metrics if metrics is not None else Metrics()
        self.wal = WriteAheadLog(os.path.join(data_dir, "ops.wal"),
                                 fsync=fsync, metrics=self.metrics)
        self.driver = driver
        self.state_owner = state_owner
        self.every = checkpoint_every_s
        self._last_ckpt = time.monotonic()
        # Optional composite ack gate (stateplane.py sync shipping):
        # when set, an ack additionally waits for the record to be
        # covered remotely — ``synced`` becomes "fsynced locally AND
        # shipped to a standby", so a SIGKILL after the ack can never
        # lose the write even with the local disk gone.
        self.extra_sync_gate = None  # Callable[[int], bool] | None

    def log(self, record) -> int:
        """Append one op record; returns its ack-gate seq."""
        return self.wal.append(codec.encode(record))

    def synced(self, seq: int) -> bool:
        if self.wal.synced < seq:
            return False
        gate = self.extra_sync_gate
        return gate is None or gate(seq)

    def tail_records(self, from_seq: int):
        """Decoded ``(seq, record)`` pairs past ``from_seq`` from the
        WAL's bounded retention — the state plane's shipping tail."""
        return [
            (s, codec.decode(b)) for s, b in self.wal.tail(from_seq)
        ]

    def replay_records(self):
        for body in self.wal.replay():
            yield codec.decode(body)

    def after_pump(self) -> None:
        """Group fsync + periodic checkpoint, called once per pump."""
        self.wal.sync()
        if self.every > 0 and (
            time.monotonic() - self._last_ckpt >= self.every
        ):
            self.checkpoint()

    def checkpoint(self) -> None:
        """Atomic engine+service snapshot, then WAL rotation.  A crash
        between the two merely makes the next replay redundant."""
        t0 = time.perf_counter()
        self.driver.save(
            self.ckpt_path,
            extra={"service": self.state_owner.state_dict()},
        )
        self.wal.rotate()
        self.metrics.inc("ckpt.saves")
        self.metrics.observe("ckpt.save_s", time.perf_counter() - t0)
        self._last_ckpt = time.monotonic()


def await_frame_synced(sched, dur, write_seqs, ok, args_list, deadline):
    """Durable frame-ack gate shared by the services' ``batch``
    handlers (yield-from inside the handler generator): every write in
    ``ok`` must have its apply-time WAL record fsynced before it may
    ack OK; at the deadline, unsynced writes are DROPPED from ``ok``
    (they answer ErrTimeout — never a false durable ack)."""
    while dur is not None:
        pend = [
            i for i in ok
            if (s := write_seqs.get(
                (args_list[i].client_id, args_list[i].command_id)
            )) is not None and not dur.synced(s)
        ]
        if not pend:
            break
        if sched.now >= deadline:
            ok -= set(pend)
            break
        yield 0.002


def demote_unsynced_rows(sched, dur, write_seqs, frame, err, deadline):
    """Firehose form of the frame-ack gate (yield-from inside the
    handler generator): wait for every OK write ROW's apply-time WAL
    record to fsync; at the deadline, unsynced rows demote to RETRY in
    ``err`` — never a false durable ack.  Shared by the plain and
    sharded firehose handlers so the protocol lives once."""
    import types as _types

    ok_rows = {int(r) for r in frame.write_rows.tolist() if err[r] == 0}
    rows_view = [
        _types.SimpleNamespace(client_id=c, command_id=m)
        for c, m in zip(frame.clients_l, frame.commands_l)
    ]
    yield from await_frame_synced(
        sched, dur, write_seqs, ok_rows, rows_view, deadline
    )
    from ..engine.firehose import FH_RETRY

    for r in frame.write_rows.tolist():
        if err[r] == 0 and r not in ok_rows:
            err[r] = FH_RETRY


def replay_kv_wal(kv, dur, G: int) -> int:
    """Re-submit every plain-KV WAL record through consensus (recovery
    path; runs to completion before the server starts answering).
    Dedup tables make records already in the checkpoint no-ops.

    STRICTLY one record at a time PER GROUP: the WAL is commit-ordered,
    and both order guarantees that replay must reproduce are
    group-local — a client's cmd N vs N+1 (an eviction committing N+1
    first would dedup-swallow the resubmitted N) and cross-client order
    on a shared key (an acked A-then-B pair replayed B-then-A would
    recover the wrong value).  A key routes to exactly one group, so
    serial-per-group preserves both while groups pipeline through each
    pump wave: recovery wall-clock scales with the deepest single-group
    backlog, not the WAL length.  With the default 30 s checkpoint
    interval the WAL bounds to ~30 s of acked writes, so expected RTO ≈
    that backlog's longest per-group chain at one commit per ~2 pump
    rounds."""
    if dur is None:
        return 0
    recs = [rec for rec in dur.replay_records() if rec[0] == "kv"]
    queues: dict = {}
    for rec in recs:
        queues.setdefault(route_group(rec[2], G), []).append(rec)

    def submit(rec):
        _, op, key, value, cid, cmd = rec
        return kv.submit(
            route_group(key, G),
            KVOp(op=_OPCODE[op], key=key, value=value,
                 client_id=cid, command_id=cmd),
        )

    depth = max((len(q) for q in queues.values()), default=0)
    max_rounds = 4000 + 200 * depth
    pending: dict = {}  # group -> [ticket, attempts_left, submit_round]
    rounds = 0
    while queues:
        for g in queues:
            if g not in pending:
                pending[g] = [submit(queues[g][0]), 50, rounds]
        kv.pump(2)
        rounds += 1
        for g, (t, left, since) in list(pending.items()):
            resubmit = False
            if t.done and not t.failed:
                queues[g].pop(0)
                del pending[g]
                if not queues[g]:
                    del queues[g]
            elif t.done and t.failed:
                resubmit = True  # evicted: same ids, dedup-safe
            elif rounds - since >= 600:
                resubmit = True  # wedged ticket (binding lost)
            if resubmit:
                if left <= 1:
                    rec = queues[g][0]
                    raise RuntimeError(
                        f"WAL replay of {rec[1]}({rec[2]!r}) did not "
                        "converge"
                    )
                pending[g] = [submit(queues[g][0]), left - 1, rounds]
        if rounds > max_rounds:
            raise RuntimeError("WAL replay did not converge")
    return len(recs)


class ShardWalReplay:
    """Recovery replay for the SHARDED engine service, in two passes
    over the (commit-ordered) WAL:

    1. admin records rebuild the config history, in order, each retried
       until it actually commits (an eviction during recovery must not
       silently skip a config — the fleet's histories would diverge);
    2. insert/delete/confirm/client records re-ride the local logs in
       WAL order, with their apply-time gates making anything already
       in the checkpoint a no-op.

    PULLS and the live GC/confirm handshake are paused for the duration
    via ``skv.migration_paused`` — a pull completing mid-replay would
    copy a slot before its redo records landed, and a GC handshake
    whose old owner is a REMOTE peer can never resolve here (replay
    runs synchronously on the scheduler loop, so peer RPC replies are
    not serviced until it returns).  Committed GCING→SERVING
    transitions are instead re-applied from the WAL's "confirm" records
    — the pre-crash handshake already ran its delete leg, so replaying
    the confirm alone is sound — which keeps config advance (needs
    all-SERVING) purely local.  A slot whose confirm had not committed
    pre-crash stays GCING through replay; the post-replay pump loop
    re-runs its handshake live (idempotent at the peer)."""

    def __init__(self, skv, dur) -> None:
        self.skv = skv
        self.dur = dur

    def run(self) -> int:
        if self.dur is None:
            return 0
        recs = list(self.dur.replay_records())
        self.skv.migration_paused = True
        try:
            for rec in recs:
                if rec[0] == "admin":
                    self._replay_admin(rec[1], rec[2], rec[3])
            for rec in recs:
                kind = rec[0]
                if kind == "insert":
                    self._replay_insert(*rec[1:])
                elif kind == "delete":
                    _, gid, shard, num = rec
                    if gid in self.skv.reps:
                        # The apply gate answers ErrNotReady while the
                        # source rep is behind `num` — wait like the
                        # insert replay does, or the record would
                        # "succeed" as a no-op and the stale BEPULLING
                        # slot would wedge config advance forever.
                        self._await_config(gid, num, "a delete record")
                        self._retry_until_ok(
                            lambda: self.skv.delete_shard(gid, shard, num)
                        )
                elif kind == "confirm":
                    _, gid, shard, num = rec
                    if gid in self.skv.reps:
                        # Re-apply the committed GCING→SERVING flip
                        # locally (never the cross-process handshake —
                        # see the class docstring).  Gated on the rep
                        # having reached config `num` like
                        # insert/delete.
                        self._await_config(gid, num, "a confirm record")
                        self._retry_until_ok(
                            lambda: self.skv.confirm_shard(gid, shard, num)
                        )
                elif kind == "skv":
                    if len(rec) != 7:
                        # Records from the pre-gid WAL format cannot be
                        # routed safely — refuse loudly rather than
                        # misparse (shifted fields) or silently drop.
                        raise RuntimeError(
                            "WAL 'skv' record has legacy format "
                            f"({len(rec)} fields); cannot replay"
                        )
                    _, gid, op, key, value, cid, cmd = rec
                    self._redo_client_op(gid, op, key, value, cid, cmd)
            # Drain: let every replayed proposal commit before serving.
            self._pump_until(lambda: False, max_rounds=50)
        finally:
            self.skv.migration_paused = False
        return len(recs)

    def _pump_until(self, cond, max_rounds: int = 4000) -> bool:
        for _ in range(max_rounds):
            if cond():
                return True
            self.skv.pump(2)
        return cond()

    def _await_config(self, gid: int, num: int, what: str) -> None:
        """Pump until rep ``gid`` has applied config ``num`` (replay
        gate shared by insert and delete records); a timeout is a real
        recovery failure, raised loudly."""
        rep = self.skv.reps[gid]
        if not self._pump_until(lambda: rep.cur.num >= num):
            raise RuntimeError(
                f"replay: rep {gid} never reached config {num} for "
                f"{what} (stuck at {rep.cur.num})"
            )

    def _retry_until_ok(self, propose, attempts: int = 50):
        """Propose-and-wait with eviction retry (leader churn during
        recovery must not drop a record).  A resolved-but-not-OK ticket
        (e.g. ErrNotReady) retries too — callers gate config catch-up
        beforehand, so non-OK can only be transient."""
        from ..engine.shardkv import OK as SK_OK

        for _ in range(attempts):
            t = propose()
            self._pump_until(lambda: t.done)
            if t.done and not t.failed and t.err == SK_OK:
                return t
        raise RuntimeError("WAL replay proposal did not commit")

    def _replay_admin(self, kind, payload, cmd) -> None:
        def propose():
            if kind == "move":
                return self.skv.move(*payload, command_id=cmd)
            return getattr(self.skv, kind)(payload, command_id=cmd)

        self._retry_until_ok(propose)

    def _replay_insert(self, gid, shard, num, data, latest) -> None:
        if gid not in self.skv.reps:
            return
        from ..engine.shardkv import ShardTicket, _InsertOp
        from ..services.shardkv import PULLING

        rep = self.skv.reps[gid]
        # The apply gate needs the rep AT config `num` and PULLING —
        # wait for orchestration to advance it there (earlier inserts/
        # configs already replayed), else the insert would silently
        # no-op and a later remote re-fetch could find the peer's copy
        # already GC'd.
        self._await_config(gid, num, "an insert record")
        if rep.cur.num != num or rep.shards[shard].state != PULLING:
            return  # checkpoint already contains this insert's effects

        def propose():
            t = ShardTicket(group=gid)
            self.skv.driver.start(
                self.skv._g2l[gid],
                _InsertOp(config_num=num, shard=shard, data=dict(data),
                          latest=dict(latest), ticket=t),
            )
            return t

        self._retry_until_ok(propose)

    def _redo_client_op(self, gid, op, key, value, cid, cmd) -> None:
        """REDO one acknowledged write into the slot of the gid that
        committed it, directly on the host state — the standard
        redo-log discipline.  Routing/ownership gates don't apply to
        redo: the op already linearized pre-crash; in particular a
        write acked just before its shard went BEPULLING must land in
        that (now non-serving) slot so a peer's later pull sees it, and
        a subsequent WAL delete record clears it in order."""
        from ..services.shardkv import key2shard

        rep = self.skv.reps.get(gid)
        if rep is None:
            return  # record from a gid this process no longer hosts
        sh = rep.shards[key2shard(key)]
        if sh.latest.get(cid, -1) >= cmd:
            return  # already in the checkpoint / an earlier redo
        if op == "Put":
            sh.data[key] = value
        elif op == "Append":
            sh.data[key] = sh.data.get(key, "") + value
        sh.latest[cid] = cmd
