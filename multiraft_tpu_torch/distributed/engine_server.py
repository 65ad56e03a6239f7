"""The batched engine served over the real network — one process owns
the card; clerk RPCs come in over TCP and are coalesced into engine
ticks (PyTorch port of ``multiraft_tpu/distributed/engine_server.py``:
"clients talk to a thin RPC front; commands coalesce into the device
firehose").

* ``EngineKVService`` wraps a :class:`BatchedKV` on an
  :class:`EngineDriver`.  A pump timer on the process's
  ``RealtimeScheduler`` advances the device tick loop every couple of
  milliseconds; every RPC that arrived since the last pump has already
  queued its command into the per-group backlog, so one device step
  carries *all* concurrent client traffic — the batching that makes a
  single card serve thousands of groups.
* Writes ride the log with kvraft session dedup (``KVOp.client_id`` /
  ``command_id``) so the at-least-once transport (client retries on
  timeout) stays exactly-once.  Reads use the ReadIndex fast path
  (zero device work, linearizable at the applied frontier).
* The pipelined pump: the loop thread enqueues a fused tick batch
  (``EngineDriver.dispatch_ticks``, every launch of the batch issued
  from the loop thread onto the current stream) and the
  ``multiraft-pump`` thread blocks on its readback
  (``PendingTicks.fetch``, which copies the stacked metrics to the host
  from that same stream, so it sees every launch of the batch).

The server builds its engine with the kernels off, as the reference
builds its own with ``use_pallas`` off: the served path is the plain
tick in both packages.

Wire protocol: ``EngineKV.command`` / ``batch`` / ``firehose`` over
:class:`~multiraft_tpu_torch.distributed.tcp.RpcNode` frames, byte-
compatible with the reference package's servers and clerks.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Optional, Sequence, Union

import torch

from ..engine.core import EngineConfig
from ..engine.firehose import MAX_FIREHOSE_ROWS
from ..engine.host import EngineDriver, resolve_device
from ..engine.kv import BatchedKV, KVOp
from ..porcupine.types import OP_GET
from .engine_durability import (
    EngineDurability,
    await_frame_synced,
    demote_unsynced_rows,
    replay_kv_wal,
)
from . import flightrec
from .engine_wire import (
    _OPCODE,
    _OPNAME,
    ERR_TIMEOUT,
    OK,
    EngineCmdArgs,
    EngineCmdReply,
    make_mesh,
    route_group,
)
from ..utils.knobs import knob_bool, knob_float, knob_int
from .admission import install_admission
from .engine_pump import PUMP_THREAD_PREFIX, EnginePump, LoopOccupancy
from .overload import install_overload_watch
from .wedge import install_wedge_watch
from .realtime import (
    PumpCadence,
    RealtimeScheduler,
    service_busy,
)
from .tcp import RpcNode

__all__ = [
    "EngineCmdArgs",
    "EngineCmdReply",
    "EngineKVService",
    "EngineShardKVService",
    "EngineClerk",
    "FirehoseClerk",
    "ShardFirehoseClerk",
    "PipelinedClerk",
    "PipelinedFleetClerk",
    "EngineShardNetClerk",
    "EngineFleetClerk",
    "serve_engine_kv",
    "serve_engine_shardkv",
]


class EngineKVService:
    """``EngineKV.command`` RPC front for a :class:`BatchedKV`.

    All device work happens on the scheduler loop: the pump timer and
    the RPC handlers interleave there, so commands queued by handlers
    between pumps coalesce into the next device step."""

    # Handler-side patience before giving up on one submission and
    # resubmitting (dedup makes the duplicate harmless) — covers
    # tickets lost to leader changes.
    RESUBMIT_S = 0.25
    # Total per-RPC budget; the client retries after its own timeout.
    DEADLINE_S = 3.0

    def __init__(
        self,
        sched: RealtimeScheduler,
        kv: BatchedKV,
        pump_interval: float = 0.002,
        ticks_per_pump: int = 2,
        durability: Optional[EngineDurability] = None,
        obs=None,
    ) -> None:
        self.sched = sched
        self.kv = kv
        self.G = kv.driver.cfg.G
        self._cadence = PumpCadence(
            knob_float("MRT_PUMP_IDLE_S", default=pump_interval)
        )
        self._ticks = ticks_per_pump
        self._stopped = False
        self._dur = durability
        # The owning node's observability plane (tick/pump latency,
        # frame sizes, commit instants tagged with the caller's request
        # id).  Lazily defaulted via the `obs` property, so partially
        # constructed stubs (tests build handlers via __new__) work too.
        self._obs = obs
        # (client_id, command_id) -> WAL seq of the op's apply-time
        # record; handlers gate their ack on it being fsynced.  Pruned
        # once synced (absence = already durable).
        self._write_seqs: dict = {}
        # Black box: tick boundaries + consensus frontier transitions
        # land in the crash-surviving ring (flightrec.py).  The
        # frontier triple is only recorded when it CHANGES — a quiet
        # pump loop writes one TICK record per pump and nothing else.
        self._frec = flightrec.get_recorder()
        self._pumps = 0
        self._pump_t_dispatch = 0.0
        self._last_frontier = (-1, -1, -1)
        # Asynchronous engine pipeline (engine_pump.py): the loop
        # dispatches fused tick batches and completes them when the
        # dedicated pump thread has fetched the stacked metrics; the
        # legacy synchronous pump stays selectable per pump (kill
        # switch, mesh drivers, reorder chaos).  Durable servers pin
        # the depth to 1 so each checkpoint sees a drained pipeline
        # (EngineDriver.save refuses otherwise).
        self._pipe = None
        self._depth = 1
        self._pump_timer = None
        self._occ = LoopOccupancy(self.m)
        if knob_bool("MRT_ENGINE_PIPELINE"):
            loop_name = getattr(getattr(sched, "_thread", None), "name", "")
            suffix = (
                loop_name[len("multiraft-loop"):]
                if loop_name.startswith("multiraft-loop") else ""
            )
            self._pipe = EnginePump(sched, name=PUMP_THREAD_PREFIX + suffix)
            self._depth = (
                1 if durability is not None
                else max(1, knob_int("MRT_PIPELINE_DEPTH"))
            )
            pump_ticks = knob_int("MRT_PUMP_TICKS")
            if pump_ticks > 0:
                self._ticks = pump_ticks
        if durability is not None:
            # WAL at APPLY time (commit order): evict-and-resubmit can
            # commit ops in a different order than submission, and
            # replay must reproduce the order reads actually saw.
            kv.on_write = lambda g, op: self._write_seqs.__setitem__(
                (op.client_id, op.command_id),
                durability.log(("kv", _OPNAME[op.op], op.key, op.value,
                                op.client_id, op.command_id)),
            )
        if self._pipe is not None and kv.driver.fused_eligible():
            # Warm the fused n-tick program NOW, before the first
            # client byte: its first invocation pays the jit compile on
            # this (loop) thread, and paying it mid-serving stalls the
            # first rate step's tail (measured ~100 ms on the r04
            # sweep's opening step).  The backlog is empty at
            # construction, so this is two liveness ticks.
            self.kv.pump(self._ticks)
        sched.call_soon(self._pump_loop)

    @property
    def obs(self):
        o = getattr(self, "_obs", None)
        if o is None:
            from .observe import Observability

            o = self._obs = Observability()
        return o

    @property
    def m(self):
        return self.obs.metrics

    def stop(self) -> None:
        self._stopped = True
        pipe = getattr(self, "_pipe", None)
        if pipe is not None:
            pipe.stop()

    def final_checkpoint(self) -> bool:
        """Graceful-shutdown hook (CLI SIGTERM): fold everything into
        one last checkpoint so the next start skips WAL replay.  False
        when the server is not durable."""
        if self._dur is None:
            return False
        self._drain_pipeline()  # driver.save refuses in-flight batches
        self._dur.checkpoint()
        return True

    def _arm_pump(self, delay: float) -> None:
        """Single-timer discipline: exactly one pending _pump_loop
        timer, re-armed earlier when a completion says there is work."""
        t = self._pump_timer
        if t is not None:
            t.cancel()
        self._pump_timer = self.sched.call_after(delay, self._pump_loop)

    def _pump_loop(self) -> None:
        self._pump_timer = None
        if self._stopped:
            return
        d = self.kv.driver
        if self._pipe is not None and d.fused_eligible():
            # Pipelined path: dispatch a fused batch WITHOUT waiting —
            # the engine-pump thread blocks on the readback and posts
            # _pump_done back here.  The loop is free for wire work
            # while the device computes.
            if len(d._inflight) < self._depth:
                # Push queued replies first (see the sync path below).
                flush = getattr(self.sched, "flush_io", None)
                if flush is not None:
                    flush()
                cp0 = time.thread_time()
                pending = d.dispatch_ticks(self._ticks)
                pending.t_loop_cpu = time.thread_time() - cp0
                self._occ.add(time.perf_counter() - pending.t_dispatch)
                self._pipe.submit(
                    pending.fetch,
                    functools.partial(self._pump_done, pending),
                )
            self._arm_pump(self._cadence.next_delay(service_busy(self.kv)))
            return
        self._pump_sync()

    def _pump_sync(self) -> None:
        """Legacy synchronous pump (MRT_ENGINE_PIPELINE=0, mesh
        drivers, reorder chaos in flight): the whole device step runs
        on the loop thread."""
        # About to grind for up to several milliseconds: push any
        # queued replies onto the wire first, or a client whose op
        # resolved last tick waits out this whole one before it can
        # pipeline its next frame.  (No-op off the IoScheduler: sim
        # tests drive handlers with the virtual-time Scheduler.)
        flush = getattr(self.sched, "flush_io", None)
        if flush is not None:
            flush()
        t0 = time.perf_counter()
        cp0 = time.thread_time()
        self.kv.pump(self._ticks)
        dt = time.perf_counter() - t0
        cdt = time.thread_time() - cp0
        self._occ.add(dt)
        self._record_pump(dt, cdt)
        self._after_pump_durability()
        self._arm_pump(self._cadence.next_delay(service_busy(self.kv)))

    def _pump_done(self, pending, rec) -> None:
        """Loop-side completion of a dispatched batch (posted by the
        engine-pump thread with the fetched stacked metrics): fold the
        bookkeeping, sweep the frontier, observe, re-arm."""
        if isinstance(rec, BaseException):
            raise rec  # device failure: surface on the owning loop
        d = self.kv.driver
        if pending not in d._inflight:
            return  # already drained (final_checkpoint) or torn down
        t0 = time.perf_counter()
        cp0 = time.thread_time()
        d.complete_ticks(pending, rec)
        self.kv.after_step(pending.n)
        now = time.perf_counter()
        # Wall covers dispatch→completion (the client-visible pump
        # latency); CPU counts only the LOOP-side share — the split the
        # profiler uses to show the loop is no longer device-blocked.
        dt = now - pending.t_dispatch
        cdt = (time.thread_time() - cp0) + pending.t_loop_cpu
        self._occ.add(now - t0)
        self._record_pump(dt, cdt)
        self._after_pump_durability()
        if self._stopped:
            return
        self._arm_pump(self._cadence.next_delay(service_busy(self.kv)))

    def _record_pump(self, dt: float, cdt: float) -> None:
        self.m.inc("pump.count")
        self.m.observe("pump.wall_s", dt)
        # Wall-vs-CPU split: a tick whose wall ≫ CPU is device-bound
        # (the host blocked on the accelerator); wall ≈ CPU is
        # host-bound (binding/resolution burning the loop).  The CPU
        # side doubles as the engine stage's cost-accounting counter —
        # the pump IS the engine stage's CPU (observe.py vocabulary).
        self.m.observe("pump.cpu_s", cdt)
        self.m.observe("cpu.engine_s", cdt)
        # Pump sequencing for the tail plane: tick id + dispatch stamp
        # (now − wall) let a committing request attribute its parked
        # time to the fused tick that carried it.  Unconditional — the
        # flight-ring gate below must not decide whether requests know
        # their tick.
        self._pumps += 1
        self._pump_t_dispatch = time.perf_counter() - dt
        fr = self._frec
        if fr is not None:
            # Tick boundary + (on change only) the consensus frontier.
            # Everything here is host-side bookkeeping the pump already
            # computed — no device readback is added.
            d = self.kv.driver
            commits = int(d.commits_total)
            fr.record(
                flightrec.TICK, a=self._pumps, b=int(dt * 1e6), c=commits
            )
            lm = getattr(d, "last_metrics", None) or {}
            frontier = (
                commits,
                int(lm.get("leaders", -1)),
                int(lm.get("max_term", -1)),
            )
            if frontier != self._last_frontier:
                self._last_frontier = frontier
                fr.record(
                    flightrec.STATE, a=frontier[0], b=frontier[1],
                    c=frontier[2],
                )

    def _after_pump_durability(self) -> None:
        if self._dur is not None:
            self._dur.after_pump()  # group fsync + periodic checkpoint
            if self._write_seqs:
                self._write_seqs = {
                    k: v for k, v in self._write_seqs.items()
                    if not self._dur.synced(v)
                }

    def _drain_pipeline(self) -> None:
        """Complete every in-flight batch synchronously (checkpoint /
        shutdown path): blocks the loop, which is the point — nothing
        else may observe a half-accounted engine."""
        d = self.kv.driver
        while d._inflight:
            p = d._inflight[0]
            d.complete_ticks(p, p.fetch())
            self.kv.after_step(p.n)

    def replay_wal(self) -> int:
        """Recovery replay — delegated to
        :func:`~.engine_durability.replay_kv_wal` (strictly one record
        in flight per group; see its docstring for the full
        contract)."""
        n = replay_kv_wal(self.kv, self._dur, self.G)
        self.m.inc("wal.replays")
        self.m.inc("wal.replayed_records", n)
        return n

    # Largest multi-op frame one RPC may carry (bounds the per-pump
    # submit burst a single frame can impose).
    MAX_BATCH = 1024

    def batch(self, args_list):
        """Multi-op frame: one codec envelope carries a clerk's whole
        pipelined batch, applied in one pump (BENCHMARKS' named fix for
        the per-op RPC overhead dominating the serving path).  Writes
        are all submitted up front — they coalesce into the next device
        step together; Gets answer from the applied frontier after the
        frame's writes resolve, so a pipelined read sees its own
        frame's preceding writes.  Per-client order within the frame is
        preserved on resubmit (failures retry as an order-preserving
        subset; sessions are per group, so cross-group interleaving
        cannot trip dedup)."""
        if len(args_list) > self.MAX_BATCH:
            return [
                EngineCmdReply(err=f"ErrBatchTooLarge:{self.MAX_BATCH}")
            ] * len(args_list)
        self.m.inc("batch.frames")
        self.m.observe("batch.ops", float(len(args_list)))

        def run():
            deadline = self.sched.now + self.DEADLINE_S
            replies = [None] * len(args_list)
            # Chains: a client's writes to ONE group must apply in
            # order (same-client dedup + same-key cross-op order).
            # FIFO backlog makes the whole chain safe to pipeline AT
            # ONCE: bindings land in submission order, and a leader-
            # change truncation can only fail a contiguous SUFFIX of
            # the chain.  The one hazard is resubmitting a failed
            # member while later members are still in flight (an
            # orphan sweep can fail out of order, and an inverted
            # rebinding lets the session table swallow the earlier
            # cmd) — so a chain with failures WAITS until every member
            # resolves, then resubmits from the first failure onward,
            # in order.  Chains to different groups pipeline freely.
            chains: dict = {}
            for i, a in enumerate(args_list):
                if a.op != "Get":
                    key = (a.client_id, route_group(a.key, self.G))
                    chains.setdefault(key, []).append((i, a))

            def submit(a):
                return self.kv.submit(
                    route_group(a.key, self.G),
                    KVOp(op=_OPCODE[a.op], key=a.key, value=a.value,
                         client_id=a.client_id, command_id=a.command_id),
                )

            tickets: dict = {}  # frame index -> latest ticket
            for members in chains.values():
                for i, a in members:
                    tickets[i] = submit(a)
            pending = set(chains)
            while pending and self.sched.now < deadline:
                progressed = False
                for qk in list(pending):
                    members = chains[qk]
                    if not all(tickets[i].done for i, _ in members):
                        continue
                    first_bad = next(
                        (k for k, (i, _) in enumerate(members)
                         if tickets[i].failed),
                        None,
                    )
                    if first_bad is None:
                        pending.discard(qk)
                        progressed = True
                        continue
                    # Resubmit the suffix in order (dedup makes any
                    # already-applied member a no-op resolve).
                    for i, a in members[first_bad:]:
                        tickets[i] = submit(a)
                if pending and not progressed:
                    yield 0.002
            tickets = {
                i: t for i, t in tickets.items()
                if t.done and not t.failed
            }
            # Durable mode: one group fsync covers the whole frame
            # (shared gate — see _await_frame_synced).
            synced_ok = set(tickets)
            yield from await_frame_synced(
                self.sched, self._dur, self._write_seqs, synced_ok,
                args_list, deadline,
            )
            for i, a in enumerate(args_list):
                if a.op == "Get":
                    replies[i] = EngineCmdReply(
                        err=OK,
                        value=self.kv.get(
                            route_group(a.key, self.G), a.key
                        ).value,
                    )
                else:
                    ok = i in synced_ok
                    replies[i] = EngineCmdReply(
                        err=OK if ok else ERR_TIMEOUT,
                        value=tickets[i].value if ok else "",
                    )
            return replies

        return run()

    # Largest columnar frame one firehose RPC may carry (the shared
    # wire-level limit — clerks split on the same constant).
    MAX_FIREHOSE = MAX_FIREHOSE_ROWS

    def info(self, _args=None) -> dict:
        """Topology the columnar clerks need for client-side routing."""
        return {"G": self.G}

    def firehose(self, blob):
        """Columnar frame (engine/firehose.py): ONE bytes blob in, one
        out — no per-op objects anywhere on the server path.  Rows that
        lose their log slot to a leader change come back as per-row
        RETRY errors; the CLIENT retries them under the same command
        ids (dedup keeps that exactly-once), which takes retry
        bookkeeping off this hot loop entirely."""
        import numpy as np

        from ..engine.firehose import FH_RETRY, pack_reply

        def run():
            # Buffer payloads pass straight through: the OOB codec
            # delivers blobs as bytes-likes and every consumer below
            # (np.frombuffer, memoryview slicing) speaks the buffer
            # protocol, so only exotic types pay a copy.
            raw = (
                blob if isinstance(blob, (bytes, bytearray, memoryview))
                else bytes(blob)
            )
            if len(raw) < 4:
                return ("err", "ErrMalformedFrame")
            n = int(np.frombuffer(raw, np.dtype("<u4"), 1, 0)[0])
            if n > self.MAX_FIREHOSE:
                return ("err", f"ErrFrameTooLarge:{self.MAX_FIREHOSE}")
            try:
                f = self.kv.submit_frame(raw)
            except ValueError as e:
                return ("err", str(e))
            self.m.inc("firehose.frames")
            self.m.inc("firehose.rows", n)
            t0 = self.sched.now
            deadline = t0 + self.DEADLINE_S
            while not f.done and self.sched.now < deadline:
                yield 0.002
            # Firehose lag: submit → frame resolution (device-side wait).
            self.m.observe("firehose.lag_s", self.sched.now - t0)
            err = f.err.copy()
            # Durable mode FIRST: the shared firehose ack gate (never
            # a false durable ack; unsynced rows demote to RETRY).
            # Must run before the Get gate below — a write that
            # applied but missed its fsync deadline is RETRY, and a
            # Get answering past it would observe state a crash could
            # still un-happen (the sharded handler orders it the same
            # way).
            if self._dur is not None:
                yield from demote_unsynced_rows(
                    self.sched, self._dur, self._write_seqs, f, err,
                    deadline,
                )
            if not f.done or (err[f.write_rows] != 0).any():
                # Writes unresolved, failed, OR demoted: Gets must NOT
                # answer (they would read before the frame's own
                # durable writes) — fail them so the client's retry
                # frame carries the gets together with the retried
                # writes.
                err[f.ops == 0] = FH_RETRY
            # Gets answer at frame completion from the applied state
            # (read-after-own-frame-writes, like the batch path).
            values = [b""] * len(f)
            for r in np.nonzero(f.ops == 0)[0].tolist():
                if err[r] == 0:
                    t = self.kv.get(int(f.groups[r]), f.keys[r])
                    values[r] = t.value.encode()
            return pack_reply(err, values)

        return run()

    def command(self, args: EngineCmdArgs):
        g = route_group(args.key, self.G)
        if args.op == "Get":
            # ReadIndex fast read: linearizable at the applied
            # frontier, no log entry, immediate reply.
            self.m.inc("kv.gets")
            t = self.kv.get(g, args.key)
            return EngineCmdReply(err=OK, value=t.value)

        # The caller's request id + stage clock, captured NOW (handler
        # entry runs on the dispatch breadcrumb; the generator body
        # runs later, when _cur_trace belongs to someone else).
        rid = self.obs.current_trace()
        stages = self.obs.current_stages()
        self.m.inc("kv.writes")

        # Write path: generator handler — yields let the pump advance.
        def run():
            t_start = self.sched.now
            deadline = t_start + self.DEADLINE_S
            t_parked = 0.0
            while self.sched.now < deadline:
                cs0 = time.thread_time() if stages is not None else 0.0
                t = self.kv.submit(
                    g,
                    KVOp(
                        op=_OPCODE[args.op],
                        key=args.key,
                        value=args.value,
                        client_id=args.client_id,
                        command_id=args.command_id,
                    ),
                )
                if stages is not None:
                    # The submit's binding cost runs in a coroutine
                    # step the dispatcher's synchronous cpu.handler_s
                    # segment can't see — fold it here (segment
                    # accounting: this CPU lands nowhere else).
                    self.m.observe(
                        "cpu.handler_s", time.thread_time() - cs0
                    )
                    # Parked from here until a pump carries the
                    # proposal (re-stamped per resubmit — churn waits
                    # are engine latency, not pump-queue latency).
                    t_parked = time.perf_counter()
                if stages is not None and not stages.engine:
                    # First submit closes the handler leg; resubmits
                    # stay inside the engine leg (they ARE the engine's
                    # latency under leader churn).
                    stages.engine = True
                    stages.fold(self.m, "handler")
                sub_deadline = min(
                    self.sched.now + self.RESUBMIT_S, deadline
                )
                while not t.done and self.sched.now < sub_deadline:
                    yield 0.002
                if t.done and not t.failed:
                    if stages is not None:
                        # Commit observed: submit → raft quorum +
                        # apply.  The durability gate below lands in
                        # the ack leg (folded at dispatch completion).
                        stages.fold(self.m, "engine")
                        # Tail attribution: which fused tick carried
                        # the commit, and how long the proposal sat
                        # parked before that tick was dispatched (the
                        # rest of the engine leg is device work).
                        # getattr: stub handlers built via __new__
                        # (tests) carry no pump state.
                        stages.tick = getattr(self, "_pumps", -1)
                        stages.pump_wait_s = max(
                            0.0,
                            getattr(self, "_pump_t_dispatch", 0.0)
                            - t_parked,
                        )
                    # Ack only once the apply-time WAL record is
                    # fsynced (absent = pruned = already durable, or
                    # a duplicate applied before this incarnation).
                    while self._dur is not None:
                        seq = self._write_seqs.get(
                            (args.client_id, args.command_id)
                        )
                        if seq is None or self._dur.synced(seq):
                            break
                        yield 0.002
                    self.m.observe(
                        "kv.command_s", self.sched.now - t_start
                    )
                    # getattr: stub handlers built via __new__ (tests)
                    # carry no recorder.
                    _fr = getattr(self, "_frec", None)
                    if _fr is not None:
                        # Last-committed evidence for the postmortem:
                        # survives a SIGKILL that the tracer's commit
                        # instant (below) would die with.
                        _fr.record(
                            flightrec.COMMIT, code=g,
                            a=args.client_id, b=args.command_id,
                            tag=rid or "",
                        )
                    if rid is not None:
                        # The engine-side leg of the request's journey:
                        # commit instant under the same id the clerk
                        # and RPC spans carry.
                        self.obs.tracer.instant(
                            "commit",
                            time.perf_counter() * 1e6,
                            track="engine",
                            req=rid,
                            group=g,
                        )
                    return EngineCmdReply(err=OK, value=t.value)
                # failed (evicted/orphaned) or wedged: resubmit under
                # the same (client_id, command_id) — dedup-safe.
                self.m.inc("kv.resubmits")
            return EngineCmdReply(err=ERR_TIMEOUT)

        return run()


def serve_engine_kv(
    port: int,
    G: int = 64,
    host: str = "127.0.0.1",
    seed: int = 0,
    record_groups: Optional[Sequence[int]] = None,
    data_dir: Optional[str] = None,
    checkpoint_every_s: float = 30.0,
    mesh_devices: int = 0,
    device: Union[None, str, torch.device] = None,
) -> RpcNode:
    """Bring up the card-owning engine KV server process: one
    EngineDriver (G groups), a BatchedKV, the pump loop, and a
    listening RpcNode.  Returns the node (caller keeps the process
    alive).

    The engine lives on ``device``: ``None`` means the card, and
    without one the server refuses to start (before it listens);
    ``"cpu"`` is for tests.

    With ``data_dir``, the server is DURABLE: periodic atomic
    checkpoints + a write-ahead log of acked ops (see EngineDurability)
    — a kill -9'd process restarted on the same dir recovers every
    acknowledged write.

    With ``mesh_devices`` > 0, the engine splits its groups over that
    many shards (:func:`~.engine_wire.make_mesh`: local cards, or CPU
    shards with ``device="cpu"``; G must divide evenly); checkpoints
    restore back onto the same-size mesh."""
    dev = resolve_device(device)  # no card: refuse before listening
    # Too many cards: refused before listening, never served elsewhere.
    mesh = make_mesh(mesh_devices, dev) if mesh_devices else None
    node = RpcNode(listen=True, host=host, port=port)
    sched = node.sched

    def build():
        driver = None
        if data_dir:
            ckpt = os.path.join(data_dir, "engine.ckpt")
            if os.path.exists(ckpt):
                driver = EngineDriver.restore(
                    ckpt, device=None if mesh else dev, mesh=mesh
                )
        if driver is not None:
            node.obs.metrics.inc("engine.restores")
            kv = BatchedKV(driver, record_groups=list(record_groups or []))
            blob = driver.restored_extra.get("service")
            if blob:
                kv.load_state_dict(blob)
        else:
            # Shape knobs for throughput deployments (the firehose
            # bench serves G=256 at INGEST=24; defaults match the
            # round-2 serving shape).
            cfg = EngineConfig(
                G=G, P=3,
                L=int(os.environ.get("MULTIRAFT_SERVE_L", "64")),
                E=int(os.environ.get("MULTIRAFT_SERVE_E", "8")),
                INGEST=int(os.environ.get("MULTIRAFT_SERVE_INGEST", "8")),
            )
            driver = EngineDriver(
                cfg, seed=seed, device=None if mesh else dev, mesh=mesh
            )
            kv = BatchedKV(driver, record_groups=list(record_groups or []))
            driver.run_until_quiet_leaders(2000)
        # Warm-up BEFORE the readiness line, the same pumps as the
        # reference's (which compiles its tick here): nothing is
        # compiled in this package, but the ticks stay the reference's,
        # and the first launches (allocator, stream) are paid before
        # the first client byte.
        driver.start(0, (KVOp(op=OP_GET, key=""), None))
        for _ in range(8):
            kv.pump(1)
        # This service routes by key hash; reject firehose frames
        # whose group column disagrees with it, server-side.
        kv.route_check = route_group
        dur = (
            EngineDurability(data_dir, driver, kv,
                             checkpoint_every_s=checkpoint_every_s,
                             metrics=node.obs.metrics)
            if data_dir else None
        )
        # Fold the driver's tick counter into the scrapeable registry
        # (tick SPANS stay gated on the diagnostic tracer below — they
        # force a device sync per tick).
        driver.metrics = node.obs.metrics
        if node.tracer is not None:
            driver.tracer = node.tracer  # ticks + RPCs on one timeline
        svc = EngineKVService(
            sched, kv, durability=dur, obs=node.obs,
            ticks_per_pump=int(
                os.environ.get("MULTIRAFT_SERVE_TICKS_PER_PUMP", "2")
            ),
        )
        if dur is not None:
            svc.replay_wal()  # recovery completes before readiness
            # Fold the replayed state into a fresh checkpoint and
            # rotate: bounds the next recovery, and discards the
            # duplicate records the replay's own apply hooks appended.
            dur.checkpoint()
        return svc

    svc = sched.run_call(build, timeout=600.0)
    node.add_service("EngineKV", svc)
    node.engine_service = svc  # keep reachable for introspection
    # Overload watch (overload.py): windowed stage-p99 + queue-gauge
    # bounds → OVERLOAD flight records, while the collapse is live.
    # Admission (admission.py): the watch's brownout state drives it,
    # turning those signals into shed/bounded behavior at dispatch.
    install_admission(node)
    install_overload_watch(node)
    # Wedge watchdog (wedge.py): per-group commit-frontier stall with
    # proposals pending -> WEDGE flight records + gauge.wedged_groups,
    # the gray-failure signal the up/down detectors above cannot see.
    install_wedge_watch(node)
    return node

# The clerks lived in this module before the serving stack was split;
# callers import them from here.
from .engine_clerks import (  # noqa: E402,F401
    EngineClerk,
    EngineFleetClerk,
    FirehoseClerk,
    ShardFirehoseClerk,
    EngineShardNetClerk,
    PipelinedClerk,
    PipelinedFleetClerk,
)
from .engine_shard_server import (  # noqa: E402,F401
    EngineShardKVService,
    serve_engine_shardkv,
)
