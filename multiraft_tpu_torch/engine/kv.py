"""KV service on the batched engine — thousands of replicated KV state
machines advanced by the device tick loop (PyTorch port of
``multiraft_tpu/engine/kv.py``).

This is the service layer's "tpu backend" (SURVEY §7.1's
ConsensusEngine interface; BASELINE configs 4/5): the engine consensus-
orders (term, index) pairs on device; command payloads stay host-side
keyed ``(group, index)``; this module applies the committed frontier to
per-group KV maps, resolves submission tickets, and records porcupine
operations (in tick time) so linearizability is verifiable on sampled
groups exactly as the north star demands.

Client-visible semantics match kvraft's apply path
(reference: kvraft/server.go:98-128): Get reads the applied state at
its log position; Put/Append are exactly-once per (group, index).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from ..porcupine.types import OP_GET, OP_PUT, KvInput, KvOutput, Operation
from .firehose import FirehoseFrame
from .frontier import FrontierService
from .host import EngineDriver, PayloadSlice

__all__ = ["KVOp", "Ticket", "BatchedKV", "apply_kv_op"]


@dataclasses.dataclass
class KVOp:
    op: int = OP_GET  # porcupine op codes
    key: str = ""
    value: str = ""
    # Session dedup (kvraft semantics, reference: kvraft/server.go
    # lastApplied map): command_id > 0 makes a Put/Append exactly-once
    # per client even when the caller resubmits after a lost leader —
    # required by any at-least-once transport (the TCP serving path).
    # 0 = no dedup (trusted single-submit callers, e.g. the bench
    # firehose and in-process tests).
    client_id: int = 0
    command_id: int = 0


def apply_kv_op(kv: Dict[str, str], sessions: Dict[int, int], op: KVOp):
    """The kvraft apply semantics (dup-check + mutate + session
    update) as one shared function — the live apply path and the
    split-persistence recovery replay both use it, so the two can
    never drift (reference: kvraft/server.go:98-128).  Returns
    ``(output, dup)``."""
    dup = (
        op.op != OP_GET
        and op.command_id > 0
        and sessions.get(op.client_id, 0) >= op.command_id
    )
    if op.op == OP_GET:
        out = kv.get(op.key, "")
    elif dup:
        out = ""  # duplicate write: resolve, skip the apply
    elif op.op == OP_PUT:
        kv[op.key] = op.value
        out = ""
    else:
        kv[op.key] = kv.get(op.key, "") + op.value
        out = ""
    if op.op != OP_GET and op.command_id > 0 and not dup:
        sessions[op.client_id] = op.command_id
    return out, dup


@dataclasses.dataclass
class Ticket:
    group: int
    done: bool = False
    failed: bool = False  # lost to a leader change; caller resubmits
    value: str = ""
    index: int = -1
    submit_tick: int = 0
    done_tick: int = 0


class BatchedKV(FrontierService):
    """Many independent KV groups on one :class:`EngineDriver`."""

    def __init__(
        self,
        driver: EngineDriver,
        record_groups: Optional[List[int]] = None,
    ) -> None:
        super().__init__(driver)
        G = driver.cfg.G
        self.data: List[Dict[str, str]] = [dict() for _ in range(G)]
        # Per-group client sessions: client_id -> (last command_id).
        # Writes at or below it are duplicates and must not re-apply.
        self.sessions: List[Dict[int, int]] = [dict() for _ in range(G)]
        self._record = set(record_groups or [])
        self.histories: Dict[int, List[Operation]] = {
            g: [] for g in self._record
        }
        self._next_client = 0
        # Durability hook (distributed/engine_server.py): fired for
        # every NON-DUPLICATE applied write, in apply (= commit) order
        # — the WAL must be a commit-ordered redo log or replay can
        # disagree with reads the old incarnation acknowledged.
        self.on_write = None  # (group, KVOp)
        # Optional route validator (key: str, G: int) -> group.  When
        # set (the plain-KV server installs route_group), submit_frame
        # rejects frames whose group column disagrees with the
        # canonical hash — a misrouted write would land in the wrong
        # group's sessions and break dedup silently.  Left None for
        # the sharded service, whose group column carries
        # config-assigned gids re-checked at apply time instead.
        self.route_check = None

    # -- submission (DeferredConsensus.submit) ---------------------------

    def submit(self, group: int, op: KVOp) -> Ticket:
        t = Ticket(group=group, submit_tick=self._now())
        self.driver.start(group, (op, t))
        return t

    def get(self, group: int, key: str) -> Ticket:
        """Linearizable read served WITHOUT a log entry — the batched
        form of the ReadIndex optimization the reference never built
        (SURVEY §3.4: "Gets go through the log too ... no
        lease/read-index optimization anywhere").

        Classic ReadIndex records the leader's commit index and
        confirms leadership with a quorum round before serving.  Here
        both steps collapse: this service is the *sole acker* of every
        write in the group (acks happen only at :meth:`pump`'s applied
        frontier), so ``applied_upto[g]`` already covers every
        acknowledged write — the read index is satisfied by
        construction, and no concurrent acker exists for a stale leader
        to race.  The read linearizes at its submit tick.  Reads
        therefore cost zero device work; Gets submitted via
        :meth:`submit` still take the log path (useful for the
        cross-host runtime, where per-replica ackers make the quorum
        round real again).
        """
        now = self._now()
        out = self.data[group].get(key, "")
        t = Ticket(
            group=group, done=True, value=out,
            submit_tick=now, done_tick=now,
        )
        self._record_op(group, KvInput(op=OP_GET, key=key), out, now, now)
        return t

    def _record_op(
        self, g: int, inp: KvInput, out: str, call: int, ret: int
    ) -> None:
        """Append a porcupine operation for a recorded group.  ``ret``
        is padded by 0.5 so intervals are non-degenerate in tick time."""
        if g in self._record:
            # Porcupine history capture: only for groups the TEST
            # harness opted into recording; production serves with
            # _record empty.
            self.histories[g].append(  # graftlint: disable=unbounded-queue
                Operation(
                    client_id=0,
                    input=inp,
                    call=float(call),
                    output=KvOutput(value=out),
                    ret=float(ret) + 0.5,
                )
            )

    def _now(self) -> int:
        # Host-side tick mirror: avoids a device readback per submit.
        return self.driver.tick

    def _on_evicted(self, payload: Any) -> None:
        """A (group, index) binding was overwritten: the old command lost
        its log slot to a leader change and will never commit there —
        fail its ticket so the caller can resubmit (the batched analog of
        kvraft's ErrWrongLeader wait-channel resolution,
        reference: kvraft/server.go:98-128).  Firehose slices fail all
        their rows at once — the CLIENT resubmits those (row-level
        RETRY errs in the reply; dedup keeps the retry exactly-once)."""
        if isinstance(payload, PayloadSlice):
            payload.frame.rows_failed(payload.rows)
            return
        _, ticket = payload
        if ticket is not None and not ticket.done:
            ticket.done = True
            ticket.failed = True

    # -- columnar firehose (engine/firehose.py) --------------------------

    def submit_frame(self, blob: bytes) -> FirehoseFrame:
        """Enqueue one columnar frame: write rows are grouped into
        contiguous per-group RUNS (one pending entry + one backlog bump
        per run — no per-op Python on the submit path).  Stable sort
        preserves each client's submission order within a group, which
        session dedup requires.  Gets do not ride the log; they answer
        at frame completion (read-after-own-frame-writes, like the
        framed batch path)."""
        f = FirehoseFrame(blob, self._now())
        if len(f.groups) and int(f.groups.max()) >= self.driver.cfg.G:
            raise ValueError(
                f"frame routes to group {int(f.groups.max())} >= G="
                f"{self.driver.cfg.G}"
            )
        if self.route_check is not None:
            G = self.driver.cfg.G
            for r, key in enumerate(f.keys):
                want = self.route_check(key, G)
                if int(f.groups[r]) != want:
                    raise ValueError(
                        f"frame row {r} key {key!r} routed to group "
                        f"{int(f.groups[r])}, expected {want}"
                    )
        wr = f.write_rows
        if len(wr):
            g = f.groups[wr]
            order = np.argsort(g, kind="stable")
            rows_sorted = wr[order]
            gs = g[order]
            bounds = np.nonzero(np.diff(gs))[0] + 1
            starts = np.concatenate([[0], bounds])
            ends = np.concatenate([bounds, [len(gs)]])
            for s, e in zip(starts.tolist(), ends.tolist()):
                self.driver.start_run(int(gs[s]), f, rows_sorted[s:e])
        return f

    def _apply_slice(self, g: int, idx: int, sl: PayloadSlice, now: int) -> None:
        """Bulk apply of one committed firehose slice: the per-row work
        is exactly the state machine (dup check + dict mutate + session
        update — apply_kv_op semantics, reference: kvraft/server.go:
        98-128); everything around it resolved per-slice."""
        f = sl.frame
        data = self.data[g]
        sess = self.sessions[g]
        ops_l = f.ops_l
        clients_l = f.clients_l
        commands_l = f.commands_l
        keys = f.keys
        vals = f.vals
        record = g in self._record
        on_write = self.on_write
        for r in sl.rows.tolist():
            cid = clients_l[r]
            cmd = commands_l[r]
            if cmd > 0 and sess.get(cid, 0) >= cmd:
                continue  # duplicate write: already applied
            k = keys[r]
            if ops_l[r] == OP_PUT:
                data[k] = vals[r]
            else:
                data[k] = data.get(k, "") + vals[r]
            if cmd > 0:
                sess[cid] = cmd
            if on_write is not None:
                on_write(g, KVOp(op=ops_l[r], key=k, value=vals[r],
                                 client_id=cid, command_id=cmd))
            if record:
                self._record_op(
                    g, KvInput(op=ops_l[r], key=k, value=vals[r]),
                    "", f.submit_tick, now,
                )
        f.rows_applied(sl.rows)

    # -- pumping/sweeping inherited from FrontierService -----------------

    def _apply(self, g: int, idx: int, payload: Any, now: int) -> None:
        if payload is None:
            return  # command lost to a leader change before binding
        op, ticket = payload
        out, dup = apply_kv_op(self.data[g], self.sessions[g], op)
        if op.op != OP_GET and op.command_id > 0 and not dup:
            if self.on_write is not None:
                self.on_write(g, op)
        if ticket is not None and not ticket.done:
            ticket.done = True
            ticket.value = out
            ticket.index = idx
            ticket.done_tick = now
            # Tickets resolve at the apply readback.  A dup-suppressed
            # write is NOT recorded: the logical op was already recorded
            # when its first incarnation applied, and a second Operation
            # for one state change would make porcupine reject a correct
            # history (resubmit-under-same-command_id path).
            if not dup:
                self._record_op(
                    g,
                    KvInput(op=op.op, key=op.key, value=op.value),
                    out,
                    ticket.submit_tick,
                    now,
                )

    # -- checkpoint -------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        blob = super().state_dict()
        blob["data"] = [dict(m) for m in self.data]
        blob["sessions"] = [dict(m) for m in self.sessions]
        blob["histories"] = {g: list(h) for g, h in self.histories.items()}
        return blob

    def load_state_dict(self, blob: Dict[str, Any]) -> None:
        super().load_state_dict(blob)
        self.data = [dict(m) for m in blob["data"]]
        self.sessions = [dict(m) for m in blob.get("sessions", [])] or [
            dict() for _ in self.data
        ]
        self.histories = {g: list(h) for g, h in blob["histories"].items()}
        self._record = set(self.histories.keys())
