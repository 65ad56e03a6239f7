"""The SHARDED engine service behind the TCP front door (PyTorch port
of ``multiraft_tpu/distributed/engine_shard_server.py``; the wire
layer lives in engine_wire.py, durability/replay in
engine_durability.py, clerks in engine_clerks.py).

``EngineShardKVService`` wraps a :class:`~multiraft_tpu_torch.engine.
shardkv.BatchedShardKV`: server-side key→shard routing against the replicated
config, the reference clerk retry semantics (ErrWrongGroup →
re-route, shardkv/client.go:68-129), multi-op frames, fleet-mode
migration RPCs (pull_shard/delete_shard — Challenge 1 across
processes), and durable serving (checkpoint + WAL + recovery via
:class:`~.engine_durability.ShardWalReplay`).

The engine runs on the card unless the caller asks for the CPU, with
the reference's serving shape and the kernels off (the reference builds
it without ``use_pallas``).  At shutdown the caller stops the pump
before the final checkpoint (``__main__``'s SIGTERM handler).
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
from ..sim.scheduler import TIMEOUT
from .engine_durability import (
    EngineDurability,
    ShardWalReplay,
    await_frame_synced,
    demote_unsynced_rows,
)
from .engine_wire import (
    ERR_TIMEOUT,
    OK,
    EngineCmdArgs,
    EngineCmdReply,
    make_mesh,
)
from ..utils.knobs import knob_bool, knob_float, knob_int
from .engine_pump import PUMP_THREAD_PREFIX, EnginePump, LoopOccupancy
from .realtime import (
    PumpCadence,
    RealtimeScheduler,
    service_busy,
)
from .tcp import RpcNode

__all__ = ["EngineShardKVService", "serve_engine_shardkv"]


class EngineShardKVService:
    """``EngineShardKV.command``: the sharded engine service behind the
    same TCP front door.  Key→shard routing happens server-side against
    the replicated config; WRONG_GROUP during migration re-routes like
    the reference clerk (shardkv/client.go:68-129).

    **Fleet mode** (``peers`` given): this process hosts a subset of
    the global gid space and its ``BatchedShardKV`` migrates shards
    to/from peer processes over the network — ``remote_fetch`` becomes
    a ``pull_shard`` RPC to the owning peer, ``remote_delete`` a
    ``delete_shard`` RPC riding the peer's log (Challenge 1 across
    processes).  Ops for a gid hosted elsewhere answer ErrWrongGroup so
    the fleet clerk re-routes, exactly like a reference group answering
    for a shard it no longer owns."""

    RESUBMIT_S = 0.25
    DEADLINE_S = 5.0
    # Per-RPC bound on one migration fetch/delete attempt; the
    # orchestration sweep re-issues after a timeout.
    MIGRATE_RPC_S = 2.0

    def __init__(
        self,
        sched: RealtimeScheduler,
        skv,  # BatchedShardKV
        pump_interval: float = 0.002,
        ticks_per_pump: int = 2,
        peers: Optional[dict] = None,  # gid -> TcpClientEnd (remote owners)
        durability: Optional[EngineDurability] = None,
        obs=None,
        fleet: Optional[bool] = None,
        make_end=None,  # (host, port) -> TcpClientEnd, for placement pushes
        placement0: Optional[dict] = None,  # gid -> (host, port), version 0
        fleet_addrs: Optional[dict] = None,  # proc -> (host, port): the
        # whole fleet, state-plane ship targets (distributed/stateplane)
        me: Optional[int] = None,  # this process's index in fleet_addrs
        ship_rules=None,  # [(regex, ShipSpec)] declarative standby rules
        ship_sync: Optional[bool] = None,  # acks gate on shipment
        ship_window_s: Optional[float] = None,
    ) -> None:
        self.sched = sched
        self.skv = skv
        self._cadence = PumpCadence(
            knob_float("MRT_PUMP_IDLE_S", default=pump_interval)
        )
        self._ticks = ticks_per_pump
        self._stopped = False
        # Asynchronous engine pipeline — see EngineKVService; same
        # dispatch/complete split, same durable depth pin.
        self._pipe = None
        self._depth = 1
        self._pump_timer = None
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
        self.peers = dict(peers or {})
        # A fleet process whose peer map is momentarily empty (all gids
        # local, or rebuilt by a placement push) must KEEP answering
        # ErrWrongGroup for foreign gids — hence the explicit flag.
        self._fleet = bool(self.peers) if fleet is None else fleet
        self._make_end = make_end
        self._ends_by_addr: dict = {}
        # (version, {gid: (host, port)}) — advanced only by `place`
        # pushes with a strictly newer version (controller restarts and
        # reordered pushes are harmless).
        self._placement = (0, dict(placement0 or {}))
        self._dur = durability
        # Observability plane (see EngineKVService): the owning node's,
        # lazily defaulted via the `obs` property for stub construction.
        self._obs = obs
        self._occ = LoopOccupancy(self.m)
        # Pump sequencing for the tail plane (see _record_pump).
        self._pumps = 0
        self._pump_t_dispatch = 0.0
        # seq of the WAL record covering each applied insert — the GC
        # gate below refuses to ask the old owner to delete until the
        # inserted blob (possibly the last copy) is fsynced here.
        self._insert_seqs: dict = {}
        # (client_id, command_id) -> WAL seq, apply-time (commit order)
        # — see EngineKVService; pruned once synced.
        self._write_seqs: dict = {}
        self._admin_seqs: dict = {}  # command_id -> WAL seq
        # seq of the WAL record covering each applied delete — the
        # delete_shard RPC reply gates on it being fsynced: the puller
        # confirms (and never re-asks) the moment we answer OK, so an
        # OK that could be lost to a crash would leave a BEPULLING slot
        # here that nothing ever clears, wedging config advance.
        self._delete_seqs: dict = {}
        if self._dur is not None:
            skv.on_insert = self._on_insert_applied
            skv.on_delete = self._on_delete_applied
            skv.on_confirm = self._on_confirm_applied
            # The committing gid travels in the record: recovery REDOES
            # the write into that gid's slot directly (see
            # _redo_client_op) — re-routing by the latest config would
            # drop a write acked at an old owner just before a config
            # change, and a peer that never pulled pre-crash would then
            # pull an empty slot.
            skv.on_write = lambda gid, op: self._write_seqs.__setitem__(
                (op.client_id, op.command_id),
                durability.log(("skv", gid, op.op, op.key, op.value,
                                op.client_id, op.command_id)),
            )
            skv.on_ctrl = lambda op: self._admin_seqs.__setitem__(
                op.command_id,
                durability.log(("admin", op.kind, op.arg, op.command_id)),
            )
        if self._fleet:
            self._fetches: dict = {}  # (gid, shard, num) -> Future
            self._deletes: dict = {}
            skv.remote_fetch = self._remote_fetch
            skv.remote_delete = self._remote_delete
        # Durable state plane (distributed/stateplane.py): ship each
        # hosted group's snapshot+tail to rule-chosen standbys, and
        # receive other owners' shipments into a StandbyStore.  Wired
        # only in fleet mode with the fleet roster known.
        self._plane = None
        # gids adopted by recover_group whose shipped tail is still
        # replaying: their clients are told ErrWrongGroup until the
        # replay ends (_recovering_key).  The reference serves them
        # from the snapshot meanwhile (ROADMAP queue C).
        self._recovering: set = set()
        # The placement controller's fencing lease (grant_lease): None
        # until a controller grants one, then the CLOCK_MONOTONIC
        # deadline past which this process answers no client op.  A
        # process the controller declares dead gets no more grants, so
        # it has stopped acking and reading before any of its groups is
        # re-placed (PlacementController._lease_ran_out).  The reference
        # has no fence (ROADMAP queue C).
        self._lease_until: Optional[float] = None
        self._standby = None
        self._ship_futs: dict = {}  # proc -> in-flight ship Future
        self._ship_ends: dict = {}
        self._fleet_addrs = dict(fleet_addrs or {})
        if self._fleet_addrs and me is not None:
            from . import flightrec
            from .stateplane import StandbyStore, StatePlane

            self._standby = StandbyStore(obs=self._obs)
            self._plane = StatePlane(
                skv, me=int(me), n_procs=len(self._fleet_addrs),
                send=self._ship_send, rules=ship_rules,
                window_s=ship_window_s, sync=ship_sync,
                wal_seq_fn=(
                    (lambda: durability.wal.appended)
                    if durability is not None else None
                ),
                obs=self._obs, recorder=flightrec.get_recorder(),
                poll=self._ship_poll,
            )
            # Attach AFTER the durability on_write hook above, so the
            # WAL record exists (wal.appended names it) when the plane
            # captures the write.
            self._plane.attach()
            if self._plane.sync and self._dur is not None:
                # Acks additionally gate on at least one standby having
                # acked the shipment covering the record (the zero-
                # acknowledged-write-loss mode of the chaos gate).
                self._dur.extra_sync_gate = self._plane.covered
        if self._pipe is not None and skv.driver.fused_eligible():
            # Warm the fused n-tick path before serving, as the
            # reference does (its first invocation pays the jit compile
            # there; here the first launches of the fused batch) — on
            # this (loop) thread, before readiness.  No orchestration
            # during construction; the backlog is empty, so this is two
            # liveness ticks.
            self.skv.pump(self._ticks, orchestrate=False)
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

    # -- durability hooks (apply-time, loop thread) -----------------------

    def _on_insert_applied(self, gid, shard, num, data, latest):
        self._insert_seqs[(gid, shard, num)] = self._dur.log(
            ("insert", gid, shard, num, dict(data), dict(latest))
        )

    def _on_delete_applied(self, gid, shard, num):
        # Replayed on restore so a stale BEPULLING slot can't survive an
        # older checkpoint and wedge config advance.
        self._delete_seqs[(gid, shard, num)] = self._dur.log(
            ("delete", gid, shard, num)
        )

    def _on_confirm_applied(self, gid, shard, num):
        # Replayed on restore so recovery re-applies GCING→SERVING
        # locally instead of re-running the GC handshake — during
        # replay the loop thread is busy replaying, so an RPC to a
        # remote old owner could never resolve and recovery would
        # wedge (the confirm only ever committed because the delete
        # leg already succeeded pre-crash).
        self._dur.log(("confirm", gid, shard, num))

    # -- fleet migration hooks (run on the loop thread, inside pump) ------

    def _remote_fetch(self, src_gid: int, shard: int, num: int):
        from ..engine.shardkv import OK as SK_OK

        key = (src_gid, shard, num)
        fut = self._fetches.get(key)
        if fut is None:
            end = self.peers.get(src_gid)
            if end is None:
                return None  # unroutable: keep retrying (config may fix)
            self._fetches[key] = self.sched.with_timeout(
                end.call("EngineShardKV.pull_shard", (src_gid, shard, num)),
                self.MIGRATE_RPC_S,
            )
            return None
        if not fut.done:
            return None
        del self._fetches[key]  # resolved: consume or retry next sweep
        reply = fut.value
        if (
            reply is None or reply is TIMEOUT
            or not isinstance(reply, tuple) or reply[0] != SK_OK
        ):
            return None  # dropped / not ready: the sweep re-issues
        return reply[1], reply[2]

    def _remote_delete(self, src_gid: int, shard: int, num: int):
        from ..engine.shardkv import OK as SK_OK

        # Durability gate: never tell the old owner to delete a shard
        # whose inserted copy isn't fsynced locally yet — between its
        # delete and our next checkpoint/WAL-sync, a crash would lose
        # the only copy.  One pump's group fsync clears this.
        if self._dur is not None:
            for (g, s, n), seq in self._insert_seqs.items():
                if s == shard and n == num and not self._dur.synced(seq):
                    return None
        key = (src_gid, shard, num)
        fut = self._deletes.get(key)
        if fut is None:
            end = self.peers.get(src_gid)
            if end is None:
                return True  # owner unknown everywhere: nothing to delete
            self._deletes[key] = self.sched.with_timeout(
                end.call("EngineShardKV.delete_shard", (src_gid, shard, num)),
                self.MIGRATE_RPC_S,
            )
            return None
        if not fut.done:
            return None
        del self._deletes[key]
        reply = fut.value
        if reply is None or reply is TIMEOUT or not isinstance(reply, tuple):
            return None  # dropped: re-issue next sweep
        return reply[0] == SK_OK  # False = ErrNotReady, re-asked later

    # -- fleet migration RPC handlers (the serving side of the hooks) -----

    def pull_shard(self, args):
        """Return ``(OK, data, latest)`` for a shard this process's old
        owner holds, once it has applied the puller's config number —
        the cross-process form of the in-process applied-state read
        (engine/shardkv.py _orchestrate step (b))."""
        from ..engine.shardkv import ERR_NOT_READY, ERR_WRONG_GROUP
        from ..engine.shardkv import OK as SK_OK

        src_gid, shard, num = args
        self.m.inc("migrate.pulls_served")
        if src_gid not in self.skv.reps:
            return (ERR_WRONG_GROUP,)

        def run():
            deadline = self.sched.now + self.DEADLINE_S
            while self.sched.now < deadline:
                rep = self.skv.reps[src_gid]
                if rep.cur.num >= num:
                    sh = rep.shards[shard]
                    return (SK_OK, dict(sh.data), dict(sh.latest))
                yield 0.01  # config catching up (the ErrNotReady gate)
            return (ERR_NOT_READY,)

        return run()

    def delete_shard(self, args):
        """Challenge-1 deletion on behalf of a remote puller: ride the
        local old owner's log (BatchedShardKV.delete_shard) and report
        the outcome."""
        from ..engine.shardkv import ERR_WRONG_GROUP
        from ..engine.shardkv import OK as SK_OK

        src_gid, shard, num = args
        self.m.inc("migrate.deletes_served")
        if src_gid not in self.skv.reps:
            return (ERR_WRONG_GROUP,)

        def run():
            t = self.skv.delete_shard(src_gid, shard, num)
            deadline = self.sched.now + self.DEADLINE_S
            while self.sched.now < deadline:
                if t.done:
                    if t.failed:
                        return (ERR_TIMEOUT,)
                    if t.err != SK_OK:
                        return (t.err,)
                    # Gate the OK on the delete's WAL record being
                    # fsynced: the puller confirms on our OK and never
                    # re-asks, so losing the record to a crash would
                    # strand a BEPULLING slot here forever.  (Absent =
                    # pruned = already durable, or the slot was already
                    # clear and no record was written — also durable.)
                    # Deadline-bounded: a stalled fsync must surface as
                    # a timeout the puller retries, not a pinned
                    # generator.
                    while self._dur is not None:
                        seq = self._delete_seqs.get((src_gid, shard, num))
                        if seq is None or self._dur.synced(seq):
                            break
                        if self.sched.now >= deadline:
                            return (ERR_TIMEOUT,)
                        yield 0.002
                    return (SK_OK,)
                yield 0.005
            return (ERR_TIMEOUT,)

        return run()

    # -- group placement RPCs (distributed/placement.py drives these) -----
    #
    # Whole-group migration between fleet processes: the controller
    # calls pull_group at the source (seal + export), adopt_group at
    # the destination (spare engine slot), drop_group back at the
    # source, then pushes the new placement map fleet-wide with
    # `place`.  All handlers are idempotent so the controller can
    # retry any leg after a timeout.

    ERR_NO_SLOT = "ErrNoSlot"

    def pull_group(self, args):
        """Seal ``gid`` and return ``(OK, blob)`` — its frozen applied
        state (BatchedShardKV.export_group).  Retries return the same
        blob: the seal stops every mutation."""
        from ..engine.shardkv import ERR_NOT_READY, ERR_WRONG_GROUP
        from ..engine.shardkv import OK as SK_OK

        gid = args[0] if isinstance(args, (tuple, list)) else args
        self.m.inc("place.pulls_served")

        def run():
            deadline = self.sched.now + self.DEADLINE_S
            while self.sched.now < deadline:
                if gid not in self.skv.reps:
                    return (ERR_WRONG_GROUP,)
                blob = self.skv.export_group(gid)
                if blob is not None:
                    return (SK_OK, blob)
                yield 0.01  # mid-migration / config in flight: settle
            return (ERR_NOT_READY,)

        return run()

    def unseal_group(self, args):
        """Abort leg: only safe while the blob was never dispatched to
        any destination (see BatchedShardKV.unseal_group).  ``force``
        (second arg) overrides the post-dispatch refusal — the
        controller sends it only with the destination provably dead."""
        from ..engine.shardkv import OK as SK_OK

        if isinstance(args, (tuple, list)):
            gid = args[0]
            force = bool(args[1]) if len(args) > 1 else False
        else:
            gid, force = args, False
        try:
            self.skv.unseal_group(gid, force)
        except RuntimeError:
            return ("ErrDispatched",)
        return (SK_OK,)

    def adopt_group(self, args):
        """Host ``gid`` in a spare engine slot.  ``blob=None`` adopts
        empty (dead-source failover: the fresh replica re-pulls from
        whatever live owners remain).  Idempotent: a retried adopt of
        an already-hosted gid answers OK."""
        from ..engine.shardkv import OK as SK_OK

        gid, blob = args[0], args[1]
        if gid in self.skv.reps:
            return (SK_OK,)
        if self.skv.free_slots() <= 0:
            return (self.ERR_NO_SLOT,)
        self.skv.adopt_gid(gid, blob)
        self.peers.pop(gid, None)  # it's local now
        self.m.inc("place.adoptions")
        return (SK_OK,)

    def drop_group(self, args):
        """Free ``gid``'s slot after the destination adopted it.  Waits
        for the slot to quiesce (tail applies resolve as WRONG_GROUP
        no-ops) so slot reuse is safe.  Idempotent: already-dropped
        answers OK."""
        from ..engine.shardkv import OK as SK_OK

        gid = args[0] if isinstance(args, (tuple, list)) else args

        def run():
            deadline = self.sched.now + self.DEADLINE_S
            while self.sched.now < deadline:
                if gid not in self.skv.reps:
                    return (SK_OK,)
                if self.skv.group_quiesced(gid):
                    self.skv.drop_gid(gid)
                    if self._plane is not None:
                        # Its capture state goes too, as the in-process
                        # fleet does it (LocalFleetTransport.drop_group):
                        # the export blob carried its writes, and a
                        # write still awaiting coverage would otherwise
                        # hold every later ack here behind the sync gate.
                        self._plane.forget_group(gid)
                    self._rebuild_peers()  # route it to its new owner
                    self.m.inc("place.drops")
                    return (SK_OK,)
                yield 0.005
            return (ERR_TIMEOUT,)

        return run()

    # -- state-plane RPCs (distributed/stateplane.py) ---------------------

    def ship(self, args):
        """Ingest one framed shipment into the local StandbyStore;
        returns the store's ack ``{"ok", "have", "gid"}`` (the shipper
        treats ``have`` as the authoritative resend frontier)."""
        payload = args[0] if isinstance(args, (tuple, list)) else args
        if self._standby is None:
            return {"ok": False, "have": -1}
        return self._standby.receive(payload)

    def standby_state(self, args):
        """Freshness of the local standby state for ``gid`` (``"none"``
        when holding nothing) — the controller's recovery-destination
        probe.  The reference answers None for nothing, which a dropped
        or timed-out probe also reads as; the port's controller tells
        the two apart (``TcpFleetTransport.standby_state``), and the
        reference's reads any non-dict as nothing."""
        gid = args[0] if isinstance(args, (tuple, list)) else args
        f = self._standby.freshness(gid) if self._standby is not None else None
        return "none" if f is None else f

    def recover_group(self, args):
        """Stateful failover: adopt ``gid`` from the LOCAL standby store
        (snapshot fast-forward + exactly-once tail replay through the
        group's own log), answering ``(OK, "recovered")``.  With no
        shipped state here, ``(OK, "empty")`` tells the controller to
        fall back to explicit empty adoption."""
        from ..engine.shardkv import OK as SK_OK

        gid = args[0] if isinstance(args, (tuple, list)) else args

        def run():
            from .stateplane import iter_replay_tail, recovery_blob

            held = (
                self._standby.get(gid)
                if self._standby is not None else None
            )
            if held is None:
                return (SK_OK, "empty")
            snap, tail = held
            if gid not in self.skv.reps:
                blob = recovery_blob(snap, self.skv.query_latest())
                if blob is None and not tail:
                    return (SK_OK, "empty")
                if self.skv.free_slots() <= 0:
                    return (self.ERR_NO_SLOT,)
                self._recovering.add(gid)
                self.skv.adopt_gid(gid, blob)
                self.peers.pop(gid, None)  # it's local now
                self.m.inc("place.adoptions")
            if tail:
                # A replay that raises leaves the gid fenced: the
                # controller's retry replays the tail again (dedup makes
                # that exactly-once) and lifts the fence then.
                yield from iter_replay_tail(self.skv, gid, tail)
            self._recovering.discard(gid)
            self._standby.drop(gid)
            self.m.inc("ship.recoveries")
            return (SK_OK, "recovered")

        return run()

    def grant_lease(self, kind: str, deadline: Optional[float]):
        """The controller's fencing lease (``Obs.ping`` carries it; see
        ObsControl.ping): ``"grant"`` extends the deadline to
        ``deadline`` (never shortens it), ``"release"`` lifts the fence
        (a controller stopping on purpose), ``"query"`` changes
        nothing.  Returns the deadline held, or None when unfenced; a
        server outside a fleet holds none and answers None."""
        if not self._fleet:
            return None
        if kind == "grant" and deadline is not None:
            held = self._lease_until
            self._lease_until = (
                float(deadline) if held is None
                else max(held, float(deadline))
            )
        elif kind == "release":
            self._lease_until = None
        return self._lease_until

    def _fenced(self) -> bool:
        """True once a granted lease has run out: every client op is
        then answered ErrWrongGroup (and no placement view is served),
        so the clerks re-route to the groups' new owners."""
        if self._lease_until is None or time.monotonic() < self._lease_until:
            return False
        self.m.inc("place.fenced_ops")
        return True

    def _recovering_key(self, key: str) -> bool:
        """True while ``key``'s group replays its shipped tail here: a
        read or a new write then would see or land before the acked
        writes of the tail."""
        if not self._recovering:
            return False
        from ..services.shardkv import key2shard

        return self.skv.query_latest().shards[key2shard(key)] in self._recovering

    def _ship_poll(self, proc: int):
        """StatePlane poll hook: ``(in_flight, reply)`` of the ship RPC
        to ``proc``; a completed reply is handed over once."""
        fut = self._ship_futs.get(proc)
        if fut is None:
            return False, None
        if not fut.done:
            return True, None
        del self._ship_futs[proc]
        v = fut.value
        return False, (v if isinstance(v, dict) else None)

    def _ship_send(self, proc: int, payload: bytes):
        """StatePlane delivery hook: ONE in-flight ship RPC per standby,
        resolved by polling — the pump loop must never block on the
        network.  Returns the PREVIOUS completed reply (None while one
        is still flying); correctness rides on the reply's ``have``
        frontier being authoritative and gid-tagged, not on pairing a
        reply with the payload it answered."""
        prev = self._ship_futs.get(proc)
        reply = None
        if prev is not None:
            if not prev.done:
                return None
            del self._ship_futs[proc]
            v = prev.value
            if isinstance(v, dict):
                reply = v
        addr = self._fleet_addrs.get(proc)
        if addr is None or self._make_end is None:
            return reply
        end = self._ship_ends.get(proc)
        if end is None:
            end = self._ship_ends[proc] = self._make_end(
                addr[0], int(addr[1])
            )
        self._ship_futs[proc] = self.sched.with_timeout(
            end.call("EngineShardKV.ship", (payload,)),
            self.MIGRATE_RPC_S,
        )
        return reply

    def place(self, args):
        """Placement push from the controller: ``(version, {gid:
        (host, port)})``.  Only a strictly newer version applies —
        reordered or replayed pushes are no-ops."""
        from ..engine.shardkv import OK as SK_OK

        version, pmap = args
        cur_ver, _ = self._placement
        if version > cur_ver:
            self._placement = (
                int(version),
                {int(g): (a[0], int(a[1])) for g, a in pmap.items()},
            )
            self._rebuild_peers()
            if self._plane is not None:
                # A fleet process that hosts no gid in the committed
                # map is gone (the controller re-placed all it held):
                # stop shipping to it (StatePlane.set_live).
                hosts = set(self._placement[1].values())
                self._plane.set_live(
                    p for p, a in self._fleet_addrs.items()
                    if (a[0], int(a[1])) in hosts
                )
            self.m.inc("place.pushes")
        return (SK_OK, self._placement[0])

    def placement(self, args=None):
        """Current placement view ``(version, {gid: (host, port)})`` —
        the fleet clerk's re-route source after ErrWrongGroup."""
        if self._fenced():
            return None  # a fenced view may be stale: ask another
        ver, pmap = self._placement
        return (ver, {g: tuple(a) for g, a in pmap.items()})

    # -- membership-change RPCs (self-healing replica sets) ---------------
    #
    # The placement controller's replace-dead-replica policy drives
    # these: add_learner seats a fresh non-voting incarnation in a
    # spare engine slot, learner_match gauges its catch-up, begin_joint
    # appends the C_old,new entry at the leader (the engine auto-exits
    # to C_new once it commits under BOTH quorums).  All handlers are
    # idempotent — BatchedShardKV's *_gid wrappers answer True when
    # the engine is already at or past the requested state — so the
    # controller can replay any leg after a crash or lost reply.

    def replica_config(self, args):
        """``(OK, cfg)`` — the leader's config view for ``gid``
        (voter sets, joint flag, epoch), ``cfg=None`` when leaderless
        or the gid is not hosted here."""
        from ..engine.shardkv import OK as SK_OK

        gid = args[0] if isinstance(args, (tuple, list)) else args
        return (SK_OK, self.skv.config_of_gid(gid))

    def add_learner(self, args):
        """Seat engine slot ``peer`` as a non-voting learner of
        ``gid``; ``(OK, bool)``."""
        from ..engine.shardkv import OK as SK_OK

        gid, peer = args[0], args[1]
        ok = self.skv.add_learner_gid(gid, int(peer))
        if ok:
            self.m.inc("reconfig.learners_seated")
        return (SK_OK, bool(ok))

    def learner_match(self, args):
        """``(OK, (leader's match for peer, leader's last index))`` —
        the catch-up gauge; ``(OK, None)`` when leaderless."""
        from ..engine.shardkv import OK as SK_OK

        gid, peer = args[0], args[1]
        return (SK_OK, self.skv.learner_match_gid(gid, int(peer)))

    def begin_joint(self, args):
        """Append the C_old,new entry making ``voters`` the target
        config of ``gid``; ``(OK, bool)``."""
        from ..engine.shardkv import OK as SK_OK

        gid, voters = args[0], args[1]
        ok = self.skv.begin_joint_gid(gid, [int(q) for q in voters])
        if ok:
            self.m.inc("reconfig.joints_entered")
        return (SK_OK, bool(ok))

    def kill_replica(self, args):
        """Chaos verb: permanently mark engine replica ``(gid, peer)``
        dead (nemesis / acceptance harnesses only); ``(OK, bool)``."""
        from ..engine.shardkv import OK as SK_OK

        gid, peer = args[0], args[1]
        ok = self.skv.kill_replica_gid(gid, int(peer))
        if ok:
            self.m.inc("reconfig.replicas_killed")
        return (SK_OK, bool(ok))

    def _rebuild_peers(self) -> None:
        """Re-derive the gid→end peer map from the placement view,
        skipping locally hosted gids.  Ends are cached per address."""
        if self._make_end is None:
            return
        _, pmap = self._placement
        peers = {}
        for g, addr in pmap.items():
            if g in self.skv.reps:
                continue
            addr = (addr[0], int(addr[1]))
            end = self._ends_by_addr.get(addr)
            if end is None:
                end = self._make_end(addr[0], addr[1])
                self._ends_by_addr[addr] = end
            peers[g] = end
        self.peers = peers

    def config(self, args):
        """Latest committed config as ``(num, shards, groups)`` — the
        fleet clerk's routing source (shardctrler Query analog)."""
        cfg = self.skv.query_latest()
        return (
            cfg.num,
            list(cfg.shards),
            {g: list(v) for g, v in cfg.groups.items()},
        )

    # Shared wire-level frame cap (clerks split on the same constant).
    MAX_FIREHOSE = MAX_FIREHOSE_ROWS

    def firehose(self, blob):
        """Columnar frame for the sharded service (engine/firehose.py):
        the group column carries GLOBAL gids; ownership re-checks at
        apply produce per-row WRONG_GROUP outcomes the client re-routes
        after a config refresh.  Gets answer from the applied frontier
        (get_fast's ownership-gated ReadIndex) at frame completion —
        but a get whose shard had a NON-OK write row in this frame
        mirrors that row's outcome instead, preserving
        read-after-own-frame-writes under migration."""
        import numpy as np

        from ..engine.firehose import (
            FH_NO_KEY,
            FH_OK,
            FH_RETRY,
            FH_WRONG_GROUP,
            pack_reply,
        )
        from ..engine.shardkv import ERR_NO_KEY, ERR_WRONG_GROUP, OK
        from ..services.shardkv import key2shard

        def run():
            raw = bytes(blob)
            if len(raw) < 4:
                return ("err", "ErrMalformedFrame")
            n = int(np.frombuffer(raw, np.dtype("<u4"), 1, 0)[0])
            if n > self.MAX_FIREHOSE:
                return ("err", f"ErrFrameTooLarge:{self.MAX_FIREHOSE}")
            try:
                f = self.skv.submit_frame(raw)
            except ValueError as e:
                return ("err", str(e))
            deadline = self.sched.now + self.DEADLINE_S
            while not f.done and self.sched.now < deadline:
                yield 0.002
            err = f.err.copy()
            # Durable mode: the shared firehose ack gate.
            if self._dur is not None:
                yield from demote_unsynced_rows(
                    self.sched, self._dur, self._write_seqs, f, err,
                    deadline,
                )
            if self._fenced():
                # Past the controller's lease: no row is acknowledged
                # or read here; the client re-routes every one.
                err[:] = FH_WRONG_GROUP
                return pack_reply(err, [b""] * len(f))
            # Shards whose write rows did not land OK: gets there mirror
            # the write outcome so the client re-frames them together.
            bad_shard_err: dict = {}
            for r in f.write_rows.tolist():
                if err[r] != FH_OK:
                    bad_shard_err[key2shard(f.keys[r])] = int(err[r])
            values = [b""] * len(f)
            for r in np.nonzero(f.ops == 0)[0].tolist():
                shard = key2shard(f.keys[r])
                if shard in bad_shard_err:
                    err[r] = bad_shard_err[shard]
                    continue
                t = self.skv.get_fast(f.keys[r])
                if t.err == ERR_WRONG_GROUP:
                    err[r] = FH_WRONG_GROUP
                elif t.err == ERR_NO_KEY:
                    err[r] = FH_NO_KEY
                else:
                    err[r] = FH_OK
                    values[r] = t.value.encode()
            return pack_reply(err, values)

        return run()

    def stop(self) -> None:
        self._stopped = True
        pipe = getattr(self, "_pipe", None)
        if pipe is not None:
            pipe.stop()

    def final_checkpoint(self) -> bool:
        """Graceful-shutdown hook — see EngineKVService."""
        if self._dur is None:
            return False
        self._drain_pipeline()  # driver.save refuses in-flight batches
        self._dur.checkpoint()
        return True

    def _arm_pump(self, delay: float) -> None:
        """Single-timer discipline — see EngineKVService."""
        t = self._pump_timer
        if t is not None:
            t.cancel()
        self._pump_timer = self.sched.call_after(delay, self._pump_loop)

    def _pump_loop(self) -> None:
        self._pump_timer = None
        if self._stopped:
            return
        d = self.skv.driver
        if self._pipe is not None and d.fused_eligible():
            # Pipelined path — see EngineKVService._pump_loop.
            if len(d._inflight) < self._depth:
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
            self._arm_pump(self._cadence.next_delay(service_busy(self.skv)))
            return
        self._pump_sync()

    def _pump_sync(self) -> None:
        """Legacy synchronous pump (MRT_ENGINE_PIPELINE=0, mesh
        drivers, reorder chaos in flight)."""
        t0 = time.perf_counter()
        cp0 = time.thread_time()
        self.skv.pump(self._ticks)
        dt = time.perf_counter() - t0
        self._occ.add(dt)
        self._record_pump(dt, time.thread_time() - cp0)
        self._after_pump_durability()
        self._arm_pump(self._cadence.next_delay(service_busy(self.skv)))

    def _pump_done(self, pending, rec) -> None:
        """Loop-side completion of a dispatched batch — see
        EngineKVService._pump_done."""
        if isinstance(rec, BaseException):
            raise rec
        d = self.skv.driver
        if pending not in d._inflight:
            return  # already drained (final_checkpoint) or torn down
        t0 = time.perf_counter()
        cp0 = time.thread_time()
        d.complete_ticks(pending, rec)
        self.skv.after_step(pending.n, orchestrate=True)
        now = time.perf_counter()
        self._occ.add(now - t0)
        self._record_pump(
            now - pending.t_dispatch,
            (time.thread_time() - cp0) + pending.t_loop_cpu,
        )
        self._after_pump_durability()
        if self._stopped:
            return
        self._arm_pump(self._cadence.next_delay(service_busy(self.skv)))

    def _record_pump(self, dt: float, cdt: float) -> None:
        self.m.inc("pump.count")
        self.m.observe("pump.wall_s", dt)
        self.m.observe("pump.cpu_s", cdt)
        self.m.observe("cpu.engine_s", cdt)
        # Pump sequencing for the tail plane (twin of the flat engine
        # server's): tick id + dispatch stamp so a committing request
        # can attribute its parked time to the fused tick that
        # carried it.
        self._pumps += 1
        self._pump_t_dispatch = time.perf_counter() - dt

    def _after_pump_durability(self) -> None:
        if self._dur is not None:
            self._dur.after_pump()  # group fsync + periodic checkpoint
            for attr in ("_insert_seqs", "_write_seqs", "_admin_seqs",
                         "_delete_seqs"):
                seqs = getattr(self, attr)
                if seqs:
                    setattr(self, attr, {
                        k: v for k, v in seqs.items()
                        if not self._dur.synced(v)
                    })
        if self._plane is not None:
            self._plane.ship_round()

    def _drain_pipeline(self) -> None:
        """Complete every in-flight batch synchronously (checkpoint /
        shutdown path) — see EngineKVService."""
        d = self.skv.driver
        while d._inflight:
            p = d._inflight[0]
            d.complete_ticks(p, p.fetch())
            self.skv.after_step(p.n, orchestrate=True)

    def replay_wal(self) -> int:
        """Recovery replay — delegated to
        :class:`~.engine_durability.ShardWalReplay` (two-pass redo with
        migration paused; see its docstring for the full contract)."""
        n = ShardWalReplay(self.skv, self._dur).run()
        self.m.inc("wal.replays")
        self.m.inc("wal.replayed_records", n)
        return n

    # Largest multi-op frame one RPC may carry (see EngineKVService).
    MAX_BATCH = 1024

    def batch(self, args_list):
        """Multi-op frame for the SHARDED service.  Chains key on
        (client, shard) — a shard's dedup table travels with it and
        same-key ops share a shard — and run STRICTLY one op in flight
        each, the reference clerk's serial discipline
        (shardkv/client.go:68-129): pipelining within a chain is
        unsafe here because an away-and-back shard migration can let a
        later op apply while an earlier one bounced ErrWrongGroup, and
        the earlier op's retry then dedup-swallows into a false OK.
        The frame's parallelism comes from chains to DIFFERENT shards
        pipelining freely.  In fleet mode, ops whose shard a peer
        process owns answer ErrWrongGroup per-op so the fleet clerk
        re-frames them to the owner."""
        from ..engine.shardkv import ERR_WRONG_GROUP
        from ..services.shardkv import key2shard

        if len(args_list) > self.MAX_BATCH:
            return [
                EngineCmdReply(err=f"ErrBatchTooLarge:{self.MAX_BATCH}")
            ] * len(args_list)

        def run():
            deadline = self.sched.now + self.DEADLINE_S
            replies = [None] * len(args_list)
            chains: dict = {}
            for i, a in enumerate(args_list):
                if a.op == "Get":
                    continue
                chains.setdefault(
                    (a.client_id, key2shard(a.key)), []
                ).append(i)

            def submit(a):
                cfg = self.skv.query_latest()
                gid = cfg.shards[key2shard(a.key)]
                if gid not in self.skv.reps:
                    return None  # peer-owned (or unassigned) shard
                if self._fleet and (self.skv.is_sealed(gid)
                                    or gid in self._recovering
                                    or self._fenced()):
                    # Mid-migration or -recovery, or past the lease:
                    # re-route.
                    return None
                return self.skv.submit(
                    gid, a.op, a.key, a.value,
                    client_id=a.client_id, command_id=a.command_id,
                )

            tickets: dict = {}   # frame idx -> resolved-OK ticket
            wrong: set = set()   # frame idx -> answer ErrWrongGroup
            heads: dict = {}     # chain -> (frame idx, live ticket)
            cursor = {qk: 0 for qk in chains}
            pending = set(chains)
            while pending and self.sched.now < deadline:
                progressed = False
                for qk in list(pending):
                    members = chains[qk]
                    if qk not in heads:
                        i = members[cursor[qk]]
                        t = submit(args_list[i])
                        if t is None:
                            if self._fleet:
                                # Peer-owned: the whole remaining chain
                                # belongs to that peer — punt it.
                                for j in members[cursor[qk]:]:
                                    wrong.add(j)
                                pending.discard(qk)
                                progressed = True
                            continue  # non-fleet: config moving; wait
                        heads[qk] = (i, t)
                        continue
                    i, t = heads[qk]
                    if not t.done:
                        continue
                    del heads[qk]
                    if t.failed or t.err == ERR_WRONG_GROUP:
                        continue  # resubmit next round (dedup-safe)
                    tickets[i] = t
                    cursor[qk] += 1
                    progressed = True
                    if cursor[qk] >= len(members):
                        pending.discard(qk)
                if pending and not progressed:
                    yield 0.002
            # Durable frame ack (shared gate — see _await_frame_synced).
            ok = {
                i for i, t in tickets.items()
                if t.done and not t.failed and t.err == OK
            }
            yield from await_frame_synced(
                self.sched, self._dur, self._write_seqs, ok,
                args_list, deadline,
            )
            fenced = self._fenced()
            for i, a in enumerate(args_list):
                if a.op != "Get" and fenced and i in ok:
                    # Committed, but past the lease: not acknowledged
                    # here (the clerk's retry at the new owner dedups).
                    replies[i] = EngineCmdReply(err=ERR_WRONG_GROUP)
                elif a.op == "Get":
                    if fenced or self._recovering_key(a.key):
                        replies[i] = EngineCmdReply(err=ERR_WRONG_GROUP)
                        continue
                    t = self.skv.get_fast(a.key)
                    if t.err == ERR_WRONG_GROUP:
                        replies[i] = EngineCmdReply(err=ERR_WRONG_GROUP)
                    else:
                        replies[i] = EngineCmdReply(
                            err=OK, value=t.value if t.err == OK else ""
                        )
                elif i in wrong:
                    replies[i] = EngineCmdReply(err=ERR_WRONG_GROUP)
                elif i in ok:
                    replies[i] = EngineCmdReply(
                        err=OK, value=tickets[i].value
                    )
                else:
                    replies[i] = EngineCmdReply(err=ERR_TIMEOUT)
            return replies

        return run()

    def command(self, args: EngineCmdArgs):
        from ..engine.shardkv import ERR_WRONG_GROUP
        from ..services.shardkv import key2shard

        if args.op == "Get":
            self.m.inc("kv.gets")

            # ReadIndex fast read (BatchedShardKV.get_fast): no log
            # entry, gated on serving-shard ownership exactly like the
            # logged path; ErrWrongGroup during migration pumps and
            # retries like any clerk op.
            def run_get():
                deadline = self.sched.now + self.DEADLINE_S
                while self.sched.now < deadline:
                    if self._fenced() or self._recovering_key(args.key):
                        return EngineCmdReply(err=ERR_WRONG_GROUP)
                    t = self.skv.get_fast(args.key)
                    if t.err == ERR_WRONG_GROUP:
                        # Fleet: the owner is (probably) another
                        # process — answer so the clerk re-routes.
                        if self._fleet:
                            return EngineCmdReply(err=ERR_WRONG_GROUP)
                        yield 0.01  # config moving; shard not serving here
                        continue
                    value = t.value if t.err == OK else ""
                    return EngineCmdReply(err=OK, value=value)
                return EngineCmdReply(err=ERR_TIMEOUT)

            return run_get()

        # Request id + stage clock captured at handler entry (dispatch
        # breadcrumb — see EngineKVService.command).
        rid = self.obs.current_trace()
        stages = self.obs.current_stages()
        self.m.inc("kv.writes")

        def run():
            t_start = self.sched.now
            deadline = t_start + self.DEADLINE_S
            t_parked = 0.0
            while self.sched.now < deadline:
                cfg = self.skv.query_latest()
                gid = cfg.shards[key2shard(args.key)]
                if gid not in self.skv.reps:
                    if self._fleet:
                        # Hosted by a peer process: tell the clerk.
                        return EngineCmdReply(err=ERR_WRONG_GROUP)
                    yield 0.01  # shard unassigned; config still moving
                    continue
                if self._fleet and (self.skv.is_sealed(gid)
                                    or gid in self._recovering
                                    or self._fenced()):
                    # Mid-placement-migration: every apply would be a
                    # WRONG_GROUP no-op — tell the clerk NOW so it
                    # refreshes placement and retries at the adopter.
                    # Mid-recovery: the tail has not replayed yet.
                    # Fenced: the lease ran out.
                    return EngineCmdReply(err=ERR_WRONG_GROUP)
                t = self.skv.submit(
                    gid, args.op, args.key, args.value,
                    client_id=args.client_id, command_id=args.command_id,
                )
                if stages is not None:
                    if not stages.engine:
                        # First submit closes the handler leg (routing
                        # + config queries); re-routes stay in the
                        # engine leg.
                        stages.engine = True
                        stages.fold(self.m, "handler")
                    # Parked from here until a pump carries the
                    # proposal (re-stamped per re-route).
                    t_parked = time.perf_counter()
                sub_deadline = min(
                    self.sched.now + self.RESUBMIT_S, deadline
                )
                while not t.done and self.sched.now < sub_deadline:
                    yield 0.002
                if not t.done or t.failed or t.err == ERR_WRONG_GROUP:
                    continue  # resubmit / re-route; dedup-safe
                if stages is not None:
                    # Commit observed; the fsync gate below lands in
                    # the ack leg (folded at dispatch completion).
                    stages.fold(self.m, "engine")
                    # Tail attribution: carrying tick + parked time
                    # (getattr: stub handlers built via __new__ in
                    # tests carry no pump state).
                    stages.tick = getattr(self, "_pumps", -1)
                    stages.pump_wait_s = max(
                        0.0,
                        getattr(self, "_pump_t_dispatch", 0.0)
                        - t_parked,
                    )
                # Ack gates on the apply-time WAL record being fsynced
                # (absent = pruned/duplicate = already durable).
                while self._dur is not None:
                    seq = self._write_seqs.get(
                        (args.client_id, args.command_id)
                    )
                    if seq is None or self._dur.synced(seq):
                        break
                    yield 0.002
                if self._fenced():
                    # Committed, but the lease ran out before the ack:
                    # the group may already serve elsewhere, without
                    # this write; the clerk's retry there applies it.
                    return EngineCmdReply(err=ERR_WRONG_GROUP)
                self.m.observe("kv.command_s", self.sched.now - t_start)
                if rid is not None:
                    self.obs.tracer.instant(
                        "commit",
                        time.perf_counter() * 1e6,
                        track="engine",
                        req=rid,
                        group=gid,
                    )
                return EngineCmdReply(err=OK, value=t.value)
            return EngineCmdReply(err=ERR_TIMEOUT)

        return run()

    ADMIN_OPS = ("join", "leave", "move")

    def admin(self, args):
        """Config administration: args = (kind, payload[, command_id])
        with kind in ADMIN_OPS — a network-supplied string must never
        getattr into arbitrary methods.  The optional command_id makes
        retries exactly-once through the ctrler dedup table; a FLEET
        admin MUST pass one (a duplicate apply would fork the config
        histories' numbering across processes and wedge migration)."""
        kind, payload = args[0], args[1]
        cmd = args[2] if len(args) > 2 else None
        if kind not in self.ADMIN_OPS:
            return EngineCmdReply(err=f"ErrBadAdminOp:{kind}")

        def run():
            # join/leave take their payload whole (a gid list / mapping);
            # move takes (shard, gid) as two positionals.
            if kind == "move":
                t = self.skv.move(*payload, command_id=cmd)
            else:
                t = getattr(self.skv, kind)(payload, command_id=cmd)
            deadline = self.sched.now + self.DEADLINE_S
            while self.sched.now < deadline:
                if t.done:
                    if t.failed:
                        return EngineCmdReply(err=ERR_TIMEOUT)
                    # Ack gates on the apply-time ("admin", ...) WAL
                    # record (logged by the on_ctrl hook in commit
                    # order) being fsynced.
                    while self._dur is not None:
                        seq = self._admin_seqs.get(t.command_id)
                        if seq is None or self._dur.synced(seq):
                            break
                        yield 0.002
                    return EngineCmdReply(err=OK)
                yield 0.005
            return EngineCmdReply(err=ERR_TIMEOUT)

        return run()


def serve_engine_shardkv(
    port: int,
    G: int = 4,
    host: str = "127.0.0.1",
    seed: int = 0,
    join_gids: Optional[Sequence[int]] = None,
    gids: Optional[Sequence[int]] = None,
    peer_addrs: Optional[dict] = None,  # gid -> (host, port) of the owner
    data_dir: Optional[str] = None,
    checkpoint_every_s: float = 30.0,
    mesh_devices: int = 0,
    spare_slots: int = 0,
    replicas: int = 3,
    voters: Optional[Sequence[int]] = None,
    fleet_addrs: Optional[dict] = None,  # proc -> (host, port), all procs
    me: Optional[int] = None,  # this process's index in fleet_addrs
    ship_rules=None,
    ship_sync: Optional[bool] = None,
    ship_window_s: Optional[float] = None,
    device: Union[None, str, torch.device] = None,
) -> RpcNode:
    """The sharded engine behind TCP: BatchedShardKV (replicated config
    + per-shard migration pipeline) on one card-owning process.

    The engine lives on ``device``: ``None`` means the card, and
    without one the server refuses to start (before it listens);
    ``"cpu"`` is for tests.  With ``mesh_devices`` > 0 the engine
    splits its groups over that many shards
    (:func:`~.engine_wire.make_mesh`; the engine's G must divide
    evenly), and a checkpoint restores back onto the same-size mesh.

    Fleet mode: pass ``gids`` (the global gids THIS process hosts; the
    local engine is sized ``len(gids)+1``) and ``peer_addrs`` (owner
    address for every remotely hosted gid) — shard migration then rides
    ``pull_shard``/``delete_shard`` RPCs between processes.

    With ``data_dir`` the process is DURABLE (checkpoint + WAL of
    client writes, admin ops, and migration inserts/deletes); a
    restarted process recovers every acknowledged op, and in a fleet
    the GC handshake is gated so a migrated-in blob is never the only
    un-fsynced copy."""
    from ..engine.shardkv import BatchedShardKV

    dev = resolve_device(device)  # no card: refuse before listening
    # Too many cards: refused before listening, never served elsewhere.
    mesh = make_mesh(mesh_devices, dev) if mesh_devices else None
    node = RpcNode(listen=True, host=host, port=port)
    sched = node.sched
    local_gids = list(gids) if gids is not None else None
    # spare_slots: extra idle engine groups the placement controller
    # can adopt migrated gids into (distributed/placement.py).
    G_local = (
        (len(local_gids) + 1 + max(0, spare_slots))
        if local_gids is not None else G
    )
    peers = {
        g: node.client_end(h, p)
        for g, (h, p) in (peer_addrs or {}).items()
        if local_gids is None or g not in local_gids
    }
    # Version-0 placement view: the static spec (peer addrs + own gids).
    placement0 = None
    if local_gids is not None:
        placement0 = {
            int(g): (h, int(p)) for g, (h, p) in (peer_addrs or {}).items()
        }
        for g in local_gids:
            placement0[int(g)] = (host, int(port))

    def build():
        driver = None
        if data_dir:
            ckpt = os.path.join(data_dir, "engine.ckpt")
            if os.path.exists(ckpt):
                driver = EngineDriver.restore(
                    ckpt, device=None if mesh else dev, mesh=mesh
                )
        restored = driver is not None
        if restored:
            node.obs.metrics.inc("engine.restores")
        if not restored:
            cfg = EngineConfig(
                G=G_local, P=max(3, int(replicas)), L=64, E=8, INGEST=8
            )
            driver = EngineDriver(
                cfg, seed=seed, device=None if mesh else dev, mesh=mesh
            )
            if voters is not None and len(set(voters)) < cfg.P:
                # Spare ENGINE REPLICA slots: only ``voters`` vote; the
                # remaining rows park dead until the placement
                # controller's replace-dead-replica policy seats a
                # learner in one (self-healing replica sets).  A
                # RESTORED process skips this — its config (voter
                # masks included) comes from the checkpoint.
                driver.seed_config(voters)
            # Warm-up before readiness (see serve_engine_kv): elections
            # happen here, not under client traffic.
            ok = driver.run_until_quiet_leaders(2000)
            assert ok, "engine groups failed to elect"
        skv = BatchedShardKV(driver, gids=local_gids)
        if restored:
            blob = driver.restored_extra.get("service")
            if blob:
                skv.load_state_dict(blob)
        # Warm the LOADED tick variant before the readiness line, the
        # reference's pumps (its jit compile lands here; here the first
        # loaded launches), not under the first admin/client RPC.  A
        # None payload is the "binding lost" no-op: it exercises the
        # ingest path without touching config history — essential in
        # fleet mode, where every process's history must stay aligned.
        skv.driver.start(0, None)
        skv.pump(8)
        if not restored:
            # A restored process's config history lives in its
            # checkpoint + WAL — re-running the bootstrap joins would
            # allocate fresh ctrler ids the dedup table can't absorb
            # and append a spurious config per restart.
            for gid in join_gids or []:
                skv.admin_sync("join", [gid])
        dur = (
            EngineDurability(data_dir, driver, skv,
                             checkpoint_every_s=checkpoint_every_s,
                             metrics=node.obs.metrics)
            if data_dir else None
        )
        driver.metrics = node.obs.metrics  # scrapeable tick counter
        if node.tracer is not None:
            driver.tracer = node.tracer  # ticks + RPCs on one timeline
        svc = EngineShardKVService(sched, skv, peers=peers, durability=dur,
                                   obs=node.obs,
                                   fleet=local_gids is not None,
                                   make_end=node.client_end,
                                   placement0=placement0,
                                   fleet_addrs=fleet_addrs, me=me,
                                   ship_rules=ship_rules,
                                   ship_sync=ship_sync,
                                   ship_window_s=ship_window_s)
        if dur is not None:
            svc.replay_wal()  # recovery completes before readiness
            dur.checkpoint()  # fold replay into a fresh checkpoint
        return svc

    svc = sched.run_call(build, timeout=600.0)
    node.add_service("EngineShardKV", svc)
    node.engine_service = svc
    # Overload watch: stage-p99/queue-gauge bounds → OVERLOAD records.
    # Admission: the watch's brownout state drives shedding at dispatch.
    from .admission import install_admission
    from .overload import install_overload_watch
    from .wedge import install_wedge_watch

    install_admission(node)
    install_overload_watch(node)
    # Wedge watchdog: commit-frontier stall with proposals pending →
    # WEDGE records + gauge.wedged_groups (gray-failure liveness).
    install_wedge_watch(node)
    return node
