"""Durable state plane: snapshot shipping, WAL tailing, and stateful
cross-host failover (ARCHITECTURE §15).

The placement controller (placement.py) heals a dead process by
re-adopting its groups — but until this module, it adopted them EMPTY
(`adopt_gid(blob=None)`, the non-durable crash model): acknowledged
writes died with the host.  The state plane closes that hole without
sealing anything:

* Each hosted group's applied state is exported on a cadence via the
  non-sealing :meth:`BatchedShardKV.snapshot_group` (the
  ``export_group`` blob shape) and **shipped** to one or more standby
  processes chosen by declarative placement rules — an ordered list of
  ``(regex, ShipSpec)`` pairs matched against ``gid-<n>`` (and an
  optional operator label), first match wins, SNIPPETS.md [2]'s
  ``match_partition_rules`` style.  Specs express pin (only these
  procs), anti-affinity (never these procs), and spread (N copies
  rotated across distinct candidates).
* Every client write the group applies after the snapshot is **tailed**
  to the same standbys as a per-group redo record carrying its original
  ``(client_id, command_id)``, so data loss is bounded to the shipping
  window (``MRT_SHIP_WINDOW_S``) rather than "everything since boot".
* On ``kill_mesh_process`` the controller consults the standbys, picks
  the one with the freshest ``(snapshot, tail)`` pair
  (:func:`pick_freshest`), and recovers through the EXISTING adopt
  path: ``adopt_gid(blob=recovery_blob(...))`` then re-submit the tail
  through the group's own log with the original session ids — the
  per-shard dedup tables travel inside the blob, so replay is
  exactly-once (the engine_durability.py recovery contract).  Empty
  adoption remains the explicit fallback only when no shipped state
  exists.

Shipped payloads reuse the WAL's ``magic ‖ crc32 ‖ len ‖ body``
torn-tail framing (:func:`frame_blob` / :func:`unframe_blob`, magic
``MRSP``): a half-received or bit-flipped shipment fails the CRC at the
standby and is discarded — never stored, never adopted.

Freshness ordering across ownership changes: every
:class:`StatePlane` incarnation mints a unique owner token, each
shipment carries it, and standbys adopt a new token by resetting the
group's shipped state.  At recovery time :func:`pick_freshest` first
picks the most recently fed token (the latest incarnation), then the
highest ``(tail_seq, snap_seq)`` within it — a standby holding a long
tail from a PREVIOUS owner never outranks a short tail from the owner
that actually died.
"""

from __future__ import annotations

import dataclasses
import heapq
import os
import re
import struct
import time
import zlib
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..services.shardkv import SERVING, key2shard
from ..utils.knobs import knob_bool, knob_float, knob_int
from ..transport import codec

__all__ = [
    "ShipSpec",
    "match_ship_rules",
    "choose_standbys",
    "frame_blob",
    "unframe_blob",
    "ship_knobs",
    "StatePlane",
    "StandbyStore",
    "pick_freshest",
    "recovery_blob",
    "redo_record",
    "replay_tail",
    "iter_replay_tail",
]


# ---------------------------------------------------------------------------
# Declarative shipping rules (SNIPPETS.md [2] match_partition_rules style)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShipSpec:
    """Where a group's shipped state may live.

    * ``copies`` — how many distinct standbys receive it (spread).
    * ``pin`` — restrict standbys to these procs (empty = any).
    * ``avoid`` — anti-affinity: never these procs.
    """

    copies: int = 1
    pin: Tuple[int, ...] = ()
    avoid: Tuple[int, ...] = ()


#: The no-rule fallback: one copy, anywhere but the owner.
DEFAULT_SPEC = ShipSpec()


def match_ship_rules(
    rules: List[Tuple[str, ShipSpec]], name: str
) -> ShipSpec:
    """First ``re.search`` match wins; no match falls back to
    :data:`DEFAULT_SPEC` (shipping is on by default — an unmatched
    group still gets one standby, it is never silently unprotected)."""
    for rule, spec in rules or ():
        if re.search(rule, name) is not None:
            return spec
    return DEFAULT_SPEC


def choose_standbys(
    gid: int,
    owner: int,
    procs: List[int],
    rules: Optional[List[Tuple[str, ShipSpec]]] = None,
    label: str = "",
) -> List[int]:
    """Resolve ``gid``'s standby set: match the rules against
    ``gid-<n>`` (plus the operator label, so rules can target either),
    filter candidates by pin/anti-affinity, and rotate the starting
    candidate by gid so different groups spread across different
    standbys deterministically."""
    name = f"gid-{gid}" if not label else f"gid-{gid} {label}"
    spec = match_ship_rules(rules or [], name)
    cands = [p for p in procs if p != owner and p not in spec.avoid]
    if spec.pin:
        cands = [p for p in cands if p in spec.pin]
    if not cands:
        return []
    start = gid % len(cands)
    order = cands[start:] + cands[:start]
    return order[: max(1, spec.copies)]


# ---------------------------------------------------------------------------
# Shipment framing — the WAL's torn-tail contract (wal.py)
# ---------------------------------------------------------------------------

_MAGIC = b"MRSP"
_HEADER = struct.Struct("<4sIQ")  # magic, crc32, body-len (wal.py shape)
_LEN = struct.Struct("<Q")


def frame_blob(body: bytes) -> bytes:
    """``magic ‖ crc32 ‖ len ‖ body`` — crc covers len+body, so a
    truncated length field can never validate (wal.py's contract)."""
    crc = zlib.crc32(body, zlib.crc32(_LEN.pack(len(body))))
    return _HEADER.pack(_MAGIC, crc, len(body)) + body


def unframe_blob(buf: bytes) -> Optional[bytes]:
    """Inverse of :func:`frame_blob`; ``None`` on ANY damage — wrong
    magic, torn tail, truncation, bit flip.  Never raises: a corrupt
    shipment is discarded, not adopted."""
    if not isinstance(buf, (bytes, bytearray, memoryview)):
        return None
    buf = bytes(buf)
    if len(buf) < _HEADER.size:
        return None
    try:
        magic, crc, n = _HEADER.unpack_from(buf, 0)
    except struct.error:
        return None
    if magic != _MAGIC:
        return None
    if len(buf) != _HEADER.size + n:
        return None
    body = buf[_HEADER.size:]
    if zlib.crc32(body, zlib.crc32(_LEN.pack(n))) != crc:
        return None
    return body


# ---------------------------------------------------------------------------
# Knobs
# ---------------------------------------------------------------------------


def ship_knobs() -> Dict[str, float]:
    """Env-resolved shipping knobs (placement.py's place_knobs shape).

    * ``MRT_SHIP_WINDOW_S`` — snapshot cadence; the bound on data loss
      when async shipping races a death (default 5.0 s).
    * ``MRT_SHIP_TAIL_CAP`` — re-snapshot early once the unshipped tail
      exceeds this many records (bounds standby replay time).
    * ``MRT_SHIP_SYNC`` — 1 = acks gate on shipment (zero acknowledged-
      write loss; the durable chaos gate runs with this on).
    """
    return {
        "window_s": knob_float("MRT_SHIP_WINDOW_S"),
        "tail_cap": float(knob_int("MRT_SHIP_TAIL_CAP")),
        "sync": 1.0 if knob_bool("MRT_SHIP_SYNC") else 0.0,
    }


# ---------------------------------------------------------------------------
# Owner side: StatePlane
# ---------------------------------------------------------------------------


class StatePlane:
    """Per-process shipper: captures each hosted group's applied writes
    (chained onto ``skv.on_write``), snapshots on a cadence, and ships
    snapshot+tail to rule-chosen standbys through a caller-provided
    ``send(proc, payload_bytes) -> Optional[dict]`` delivery hook (a
    direct function call in the in-process fleet, an RPC in the socket
    fleet).

    The standby's reply reports its contiguous frontier
    (``{"ok": bool, "have": tail_seq}``); the shipper resends from
    ``have + 1``.  The ``have`` frontier is AUTHORITATIVE — the shipper
    believes it regardless of which payload the reply answered, so an
    async delivery hook (the socket server keeps one in-flight ship RPC
    per standby and hands back last round's reply) composes without any
    payload↔reply pairing.  The full tail since the last shipped
    snapshot is retained owner-side, so any standby can always be
    caught up or re-based on a fresh snapshot.

    With an async hook the port also takes ``poll(proc) -> (in_flight,
    reply)``: each round first folds every standby's completed reply
    under the gid it names, ships first the groups whose writes await
    coverage, and builds no payload for a standby whose RPC still
    flies.  The reference folds a reply only when it happens to name
    the group shipped next, so with many groups most acks waited for a
    resend (ROADMAP queue C).
    """

    def __init__(
        self,
        skv,
        *,
        me: int,
        n_procs: int,
        send: Callable[[int, bytes], Optional[dict]],
        rules: Optional[List[Tuple[str, ShipSpec]]] = None,
        labels: Optional[Dict[int, str]] = None,
        window_s: Optional[float] = None,
        tail_cap: Optional[int] = None,
        sync: Optional[bool] = None,
        wal_seq_fn: Optional[Callable[[], int]] = None,
        obs=None,
        recorder=None,
        clock=time.monotonic,
        poll: Optional[
            Callable[[int], Tuple[bool, Optional[dict]]]
        ] = None,
    ) -> None:
        k = ship_knobs()
        self.skv = skv
        self.me = me
        self.n_procs = n_procs
        self.send = send
        self.poll = poll
        # Poll mode: standbys whose ship RPC flies this round, and
        # what each in-flight payload carried (gid, kind, records,
        # bytes), counted when its reply comes back.
        self._busy: set = set()
        self._flying: Dict[int, tuple] = {}
        self.rules = list(rules or [])
        self.labels = dict(labels or {})
        self.window_s = k["window_s"] if window_s is None else window_s
        self.tail_cap = int(
            k["tail_cap"] if tail_cap is None else tail_cap
        )
        self.sync = bool(k["sync"]) if sync is None else bool(sync)
        self._wal_seq_fn = wal_seq_fn
        self._obs = obs
        self._rec = recorder
        self._clock = clock
        # Unique per incarnation: standbys key freshness on it so a
        # previous owner's stale tail never outranks the live owner's.
        self.token = f"{me}.{os.urandom(6).hex()}"
        # gid -> how many times this process stopped hosting it
        # (forget_group).  A group hosted here again ships under a new
        # token (_token), so no standby mixes its fresh sequence numbers
        # with those of an earlier stay: a frontier acked then would
        # otherwise cover writes never shipped.
        self._stays: Dict[int, int] = {}
        # Per-gid capture state.
        self._tail_seq: Dict[int, int] = {}       # last captured seq
        self._tail: Dict[int, deque] = {}         # (seq, record, wal_seq)
        self._snap: Dict[int, Dict[str, Any]] = {}  # framed-ready snapshot
        self._snap_seq: Dict[int, int] = {}       # tail seq at snapshot
        self._snap_ts: Dict[int, float] = {}
        # Per-(gid, standby) acked tail frontier — the standby's own
        # "have" reply, believed verbatim.
        self._acked_tail: Dict[Tuple[int, int], int] = {}
        # (tail_seq, wal_seq) pairs not yet covered by ANY standby —
        # drained by _apply_reply, the source of the sync gate and the
        # lag metric.  Bounded in async mode (coverage is advisory
        # there); unbounded in sync mode by necessity (dropping an
        # entry would ack a write that was never shipped).
        self._unacked: Dict[int, deque] = {}
        # Sync-ship gate: wal seqs of writes not yet acked by ANY
        # standby (lazy-deletion min-heap — see covered()).
        self._unshipped: List[int] = []
        self._shipped_wal: set = set()
        # now() of the last moment each gid was fully shipped — the
        # doctor's "data loss window" is measured against this.
        self._covered_ts: Dict[int, float] = {}
        self._t0 = self._clock()
        self._prev_on_write = None
        self.rounds = 0
        # Processes still in the fleet (None: all n_procs).  The
        # placement push narrows it once a dead process hosts nothing
        # (set_live), so no group keeps a dead standby — under sync
        # shipping one such group would hold every later ack of this
        # process behind the global gate.  The reference has no such
        # narrowing (ROADMAP queue C).
        self.live_procs: Optional[set] = None

    # -- capture ---------------------------------------------------------

    def attach(self) -> None:
        """Chain onto ``skv.on_write`` AFTER any existing hook (the
        durability hook logs to the WAL first, so ``wal_seq_fn`` read
        here names the record that covers this write)."""
        self._prev_on_write = self.skv.on_write
        prev = self._prev_on_write

        def hook(gid: int, op) -> None:
            if prev is not None:
                prev(gid, op)
            self.note_write(gid, op)

        self.skv.on_write = hook

    def detach(self) -> None:
        self.skv.on_write = self._prev_on_write
        self._prev_on_write = None

    def note_write(self, gid: int, op) -> None:
        """Capture one applied client write into ``gid``'s tail."""
        if op.op not in ("Put", "Append"):
            return
        seq = self._tail_seq.get(gid, 0) + 1
        self._tail_seq[gid] = seq
        wal_seq = self._wal_seq_fn() if self._wal_seq_fn else 0
        rec = (op.op, op.key, op.value, op.client_id, op.command_id)
        # Bounded by maybe_snapshot: a tail past MRT_SHIP_TAIL_CAP
        # forces an early re-snapshot that prunes seqs <= snap_seq (and
        # a snapshot refusal only happens mid-migration, when the
        # sealed group takes no writes).
        self._tail.setdefault(gid, deque()).append(  # graftlint: disable=unbounded-queue
            (seq, rec, wal_seq)
        )
        un = self._unacked.get(gid)
        if un is None:
            # Sync mode may never drop an entry (each is an unshipped
            # acked-write obligation); async coverage is advisory.
            un = self._unacked[gid] = deque(
                maxlen=None if self.sync else 65536
            )
        # Async: deque maxlen above bounds it.  Sync: each entry is an
        # unshipped acked-write obligation and the ack gate stalls
        # writers until standbys ack — backpressure, not growth.
        un.append((seq, wal_seq))  # graftlint: disable=unbounded-queue
        if self.sync and wal_seq:
            heapq.heappush(self._unshipped, wal_seq)

    def forget_group(self, gid: int) -> None:
        """Drop capture state after the group migrates away.  Its
        unshipped wal seqs are released (the sealed export blob carried
        the data) so they never wedge the global sync gate."""
        if self.sync:
            for _seq, w in self._unacked.get(gid, ()):
                if w:
                    # Lazy-deletion twin of the _unshipped heap, as in
                    # ship acks: covered() discards each seq as it pops
                    # the heap, and these seqs are already in the heap.
                    self._shipped_wal.add(w)  # graftlint: disable=unbounded-queue
        for d in (self._tail_seq, self._tail, self._snap,
                  self._snap_seq, self._snap_ts, self._unacked,
                  self._covered_ts):
            d.pop(gid, None)
        for key in [k for k in self._acked_tail if k[0] == gid]:
            self._acked_tail.pop(key, None)
        self._stays[gid] = self._stays.get(gid, 0) + 1

    def _token(self, gid: int) -> str:
        n = self._stays.get(gid, 0)
        return self.token if not n else f"{self.token}.{n}"

    # -- sync-ship ack gate ---------------------------------------------

    def covered(self, wal_seq: int) -> bool:
        """True once the write logged at ``wal_seq`` has been shipped to
        (and acked by) at least one standby.  The EngineDurability
        composite sync gate (``extra_sync_gate``) calls this so acks
        wait for remote coverage, making acknowledged-write loss
        structurally impossible under SIGKILL."""
        if not self.sync:
            return True
        h = self._unshipped
        while h and h[0] in self._shipped_wal:
            self._shipped_wal.discard(heapq.heappop(h))
        return not h or h[0] > wal_seq

    # -- snapshots -------------------------------------------------------

    def maybe_snapshot(self, gid: int, now: Optional[float] = None) -> bool:
        """Refresh ``gid``'s snapshot when the cadence expires or the
        retained tail exceeds the cap.  A ``snapshot_group`` refusal
        (mid-migration) keeps the old snapshot and keeps tailing — the
        plane degrades to a longer replay, never to a gap."""
        now = self._clock() if now is None else now
        last = self._snap_ts.get(gid)
        tail_len = len(self._tail.get(gid, ()))
        due = (
            last is None
            or now - last >= self.window_s
            or tail_len > self.tail_cap
        )
        if not due:
            return False
        blob = self.skv.snapshot_group(gid)
        if blob is None:
            return False
        seq = self._tail_seq.get(gid, 0)
        self._snap[gid] = blob
        self._snap_seq[gid] = seq
        self._snap_ts[gid] = now
        # Tail records at or below the snapshot seq are inside the
        # snapshot; retain only the suffix.  (Coverage bookkeeping
        # lives in _unacked and is driven by standby acks, not by
        # snapshot folding — a standby acks these seqs either via the
        # snapshot or via tail batches it already holds.)
        tail = self._tail.get(gid)
        if tail:
            while tail and tail[0][0] <= seq:
                tail.popleft()
        if self._obs is not None:
            self._obs.metrics.inc("ship.snapshots")
        return True

    # -- shipping --------------------------------------------------------

    def hosted_gids(self) -> List[int]:
        return [g for g in self.skv.gids if g != 0]

    def set_live(self, procs) -> None:
        """Choose standbys among ``procs`` (this process included) from
        now on; a group whose standby left re-bases onto its next
        candidate with a snapshot, which releases its unshipped writes
        from the sync gate once acked."""
        self.live_procs = set(int(p) for p in procs) | {self.me}

    def ship_round(self, now: Optional[float] = None) -> int:
        """One shipping sweep over every hosted group; returns payloads
        delivered.  Safe to call every pump — per-standby frontiers make
        it a no-op when nothing changed."""
        now = self._clock() if now is None else now
        self.rounds += 1
        sent = 0
        procs = [
            p for p in range(self.n_procs)
            if self.live_procs is None or p in self.live_procs
        ]
        if self.poll is None:
            order = list(self.hosted_gids())
        else:
            self._busy = set()
            for p in procs:
                flying, reply = self.poll(p)
                if reply is not None:
                    meta = self._flying.pop(p, None) or (None, "", 0, 0)
                    sent += self._apply_reply(meta[0], p, reply, *meta[1:])
                if flying:
                    # A set of process indices, rebuilt every round:
                    # at most n_procs entries.
                    self._busy.add(p)  # graftlint: disable=unbounded-queue
            order = self._ship_order()
        for gid in order:
            standbys = choose_standbys(
                gid, self.me, procs, self.rules,
                self.labels.get(gid, ""),
            )
            if self.poll is not None:
                standbys = [sb for sb in standbys if sb not in self._busy]
                if not standbys:
                    continue  # every channel it needs is in flight
            self.maybe_snapshot(gid, now)
            for sb in standbys:
                sent += self._ship_to(gid, sb, now)
        if self._obs is not None:
            lag = self.max_lag_s(now)
            self._obs.metrics.set("ship.lag_s", lag)
        return sent

    def _ship_order(self) -> List[int]:
        """Poll mode's sweep order: groups with writes awaiting coverage
        first (they hold acks under sync shipping), the rest after;
        each class starts at a point that rotates every round, so no
        group waits behind the same ones every time."""
        hosted = self.hosted_gids()
        k = self.rounds % max(1, len(hosted))
        rot = hosted[k:] + hosted[:k]
        return sorted(rot, key=lambda g: 0 if self._unacked.get(g) else 1)

    def _deliver(self, sb: int, payload: bytes, meta: tuple):
        if self.poll is not None:
            # One entry per standby process, at most n_procs.
            self._busy.add(sb)  # graftlint: disable=unbounded-queue
            self._flying[sb] = meta
        return self.send(sb, payload)

    def _ship_to(self, gid: int, sb: int, now: float) -> int:
        have = self._acked_tail.get((gid, sb), -1)
        snap_seq = self._snap_seq.get(gid)
        if snap_seq is not None and have < snap_seq:
            # The standby is behind the current snapshot epoch: records
            # at or below snap_seq were folded out of the retained
            # tail, so only the snapshot can bridge it forward.
            payload = self._frame(gid, "snap", snap_seq,
                                  snap=self._snap[gid], now=now)
            reply = self._deliver(sb, payload, (gid, "snap", 1, len(payload)))
            return self._apply_reply(gid, sb, reply, "snap", 1,
                                     len(payload))
        # Tail leg: records past the standby's acked frontier (all
        # still retained — retention only drops seqs <= snap_seq).
        base = max(have, 0)
        batch = [
            (seq, rec) for seq, rec, _w in self._tail.get(gid, ())
            if seq > base
        ]
        if not batch:
            return 0
        payload = self._frame(gid, "tail", snap_seq or 0,
                              records=batch, now=now)
        reply = self._deliver(
            sb, payload, (gid, "tail", len(batch), len(payload))
        )
        return self._apply_reply(gid, sb, reply, "tail", len(batch),
                                 len(payload))

    def _apply_reply(self, gid: int, sb: int, reply, kind: str,
                     n_records: int, n_bytes: int) -> int:
        """Fold one standby reply in.  ``have`` is authoritative (the
        standby's contiguous frontier under our token) even when the
        reply answered an earlier payload — see the class docstring."""
        if not isinstance(reply, dict):
            return 0
        rg = reply.get("gid")
        if rg is None:
            return 0  # a framing-level reject names no group
        rg = int(rg)
        if self.poll is not None:
            # Poll mode: fold the frontier under the gid the reply names
            # while this process still hosts it; count the payload when
            # the reply answers it.
            if rg not in self.hosted_gids():
                return 0
            self._fold_have(rg, sb, reply)
            if not reply.get("ok"):
                return 0
            if rg == gid:
                self._record(gid, kind, n_records, n_bytes,
                             int(reply.get("have", -1)))
            return 1
        if rg != gid:
            # A reply answering some OTHER group's payload (the async
            # hook hands back last round's reply) — never fold a
            # foreign frontier in.
            return 0
        self._fold_have(gid, sb, reply)
        if reply.get("ok"):
            self._record(gid, kind, n_records, n_bytes,
                         int(reply.get("have", -1)))
            return 1
        return 0

    def _fold_have(self, gid: int, sb: int, reply: dict) -> None:
        h = int(reply.get("have", -1))
        cur = self._acked_tail.get((gid, sb), -1)
        if h > cur:
            self._acked_tail[(gid, sb)] = h
            self._prune_unacked(gid)
        elif not reply.get("ok") and h < cur:
            # The standby regressed (restarted, or rejects under a new
            # token) — believe it, so the next round re-bases: a
            # frontier below snap_seq routes back to the snapshot leg.
            self._acked_tail[(gid, sb)] = h

    def _prune_unacked(self, gid: int) -> None:
        best = max(
            (v for (g, _sb), v in self._acked_tail.items() if g == gid),
            default=-1,
        )
        un = self._unacked.get(gid)
        while un and un[0][0] <= best:
            _seq, w = un.popleft()
            if self.sync and w:
                # Lazy-deletion twin of the _unshipped heap: covered()
                # discards each entry as it pops the matching heap
                # element, so the set tracks only the in-flight window
                # (which sync backpressure bounds).
                self._shipped_wal.add(w)  # graftlint: disable=unbounded-queue
        if un is not None and not un:
            self._covered_ts[gid] = self._clock()

    def _frame(self, gid: int, kind: str, snap_seq: int, *,
               snap: Optional[Dict[str, Any]] = None,
               records: Optional[List[Tuple[int, tuple]]] = None,
               now: float = 0.0) -> bytes:
        msg = {
            "gid": gid,
            "token": self._token(gid),
            "kind": kind,
            "snap_seq": snap_seq,
            "snap": snap,
            "records": records or [],
            "ts": now,
        }
        return frame_blob(codec.encode(msg))

    def max_lag_s(self, now: Optional[float] = None) -> float:
        """Worst-case shipping lag across hosted groups: how long the
        most-behind group has had captured writes unacked by every
        standby (0 when everything shipped).  This is the live estimate
        of the data-loss window a death right now would open."""
        now = self._clock() if now is None else now
        worst = 0.0
        for gid in self.hosted_gids():
            un = self._unacked.get(gid)
            if not un:
                self._covered_ts[gid] = now
                continue
            since = self._covered_ts.get(gid, self._t0)
            worst = max(worst, now - since)
        return worst

    def _record(self, gid: int, kind: str, n_records: int,
                n_bytes: int, frontier: int) -> None:
        if self._rec is not None:
            from .flightrec import SHIP

            self._rec.record(
                SHIP, code=gid, a=n_records, b=n_bytes, c=frontier,
                tag=kind,
            )
        if self._obs is not None:
            self._obs.metrics.inc("ship.bytes", n_bytes)
            if kind == "tail":
                self._obs.metrics.inc("ship.tail_records", n_records)


# ---------------------------------------------------------------------------
# Standby side: StandbyStore
# ---------------------------------------------------------------------------


class StandbyStore:
    """Per-process receiver: validated shipments keyed by gid.  All
    validation happens at receive time — framing CRC, codec decode,
    tail contiguity — so recovery never has to distrust stored state."""

    def __init__(self, obs=None) -> None:
        self._state: Dict[int, Dict[str, Any]] = {}
        self.rejects = 0
        self._obs = obs

    def receive(self, payload: bytes) -> dict:
        """Ingest one framed shipment.  Returns the shipper's ack
        (``{"ok": True, "have": frontier}``) or a rejection carrying
        the frontier we DO have so the shipper can resync."""
        body = unframe_blob(payload)
        if body is None:
            self.rejects += 1
            if self._obs is not None:
                self._obs.metrics.inc("ship.rejects")
            return {"ok": False, "have": -1}
        try:
            msg = codec.decode(body)
        except Exception:
            self.rejects += 1
            if self._obs is not None:
                self._obs.metrics.inc("ship.rejects")
            return {"ok": False, "have": -1}
        gid = int(msg["gid"])
        st = self._state.get(gid)
        token = msg["token"]
        if st is None or st["token"] != token:
            # New owner incarnation.  Only a SNAPSHOT (or a tail that
            # starts at seq 1, replayable onto an empty adopt) may
            # establish the new token — a mid-stream tail under an
            # unknown token is rejected WITHOUT clobbering the previous
            # incarnation's state, which is still the freshest
            # recoverable copy until the new owner ships a base.
            base_ok = msg["kind"] == "snap" or (
                msg["records"] and int(msg["records"][0][0]) == 1
            )
            if not base_ok:
                return {"ok": False, "have": -1, "gid": gid}
            st = self._state[gid] = {
                "token": token, "snap": None, "snap_seq": -1,
                "tail": [], "tail_seq": -1, "ts": 0.0,
            }
            if msg["kind"] != "snap":
                st["snap_seq"] = 0
                st["tail_seq"] = 0
        if msg["kind"] == "snap":
            st["snap"] = msg["snap"]
            st["snap_seq"] = int(msg["snap_seq"])
            st["tail"] = [
                (s, r) for s, r in st["tail"] if s > st["snap_seq"]
            ]
            st["tail_seq"] = max(st["snap_seq"], st["tail_seq"])
            st["ts"] = float(msg["ts"])
            return {"ok": True, "have": st["tail_seq"], "gid": gid}
        # Tail batch: accept only a contiguous extension of our
        # frontier; anything else asks the shipper to resync.
        frontier = st["tail_seq"]
        if frontier < 0:
            # Same token but no base yet (snap handler always sets one,
            # so this only guards a tail racing ahead of its snapshot).
            if msg["records"] and int(msg["records"][0][0]) == 1:
                st["snap_seq"] = 0
                st["tail_seq"] = frontier = 0
            else:
                return {"ok": False, "have": -1, "gid": gid}
        fresh = [
            (int(s), tuple(r)) for s, r in msg["records"]
            if int(s) > frontier
        ]
        expect = frontier + 1
        if fresh and fresh[0][0] != expect:
            return {"ok": False, "have": frontier, "gid": gid}
        for s, r in fresh:
            if s != expect:
                return {"ok": False, "have": st["tail_seq"], "gid": gid}
            st["tail"].append((s, r))
            st["tail_seq"] = s
            expect += 1
        st["ts"] = float(msg["ts"])
        return {"ok": True, "have": st["tail_seq"], "gid": gid}

    def keep(self, gid: int, snap: Dict[str, Any], token: str, seq: int,
             ts: float) -> None:
        """Hold a departing owner's own final copy of ``gid``: its
        sealed export, taken at ``ts``, as if shipped here under
        ``token`` at tail ``seq`` — unless a shipment at least as recent
        already holds the group.  A group that moved to a process that
        was its standby has no other copy until its new owner's first
        shipment lands, so this copy keeps the writes the old owner
        acknowledged (the reference keeps none; ROADMAP queue C)."""
        st = self._state.get(gid)
        if st is not None and st["ts"] >= ts:
            return
        self._state[gid] = {
            "token": token, "snap": snap, "snap_seq": int(seq),
            "tail": [], "tail_seq": int(seq), "ts": float(ts),
        }

    def freshness(self, gid: int) -> Optional[Dict[str, Any]]:
        st = self._state.get(gid)
        if st is None:
            return None
        return {
            "token": st["token"],
            "snap_seq": st["snap_seq"],
            "tail_seq": st["tail_seq"],
            "ts": st["ts"],
            "has_snap": st["snap"] is not None,
        }

    def get(self, gid: int) -> Optional[
        Tuple[Optional[Dict[str, Any]], List[tuple]]
    ]:
        """The recoverable state: ``(snapshot-or-None, tail records)``.
        Tail records are ``(op, key, value, client_id, command_id)``
        tuples in capture (= apply) order."""
        st = self._state.get(gid)
        if st is None:
            return None
        return st["snap"], [r for _s, r in st["tail"]]

    def drop(self, gid: int) -> None:
        self._state.pop(gid, None)

    def gids(self) -> List[int]:
        return sorted(self._state)


def pick_freshest(
    states: List[Tuple[int, Optional[Dict[str, Any]]]]
) -> List[int]:
    """Order candidate standbys, freshest first.

    ``states`` is ``[(proc, freshness-dict-or-None), ...]``.  The
    winning owner token is the one whose standbys were fed most
    recently (the latest incarnation of the group); within it, standbys
    rank by ``(tail_seq, snap_seq, ts)`` descending.  Standbys holding
    other tokens follow (stale incarnations — better than empty), and
    procs with nothing are excluded."""
    known = [(p, f) for p, f in states if f is not None]
    if not known:
        return []
    latest_by_token: Dict[str, float] = {}
    for _p, f in known:
        tok = f["token"]
        latest_by_token[tok] = max(
            latest_by_token.get(tok, 0.0), float(f["ts"])
        )
    winner = max(latest_by_token.items(), key=lambda kv: kv[1])[0]

    def rank(item):
        p, f = item
        primary = 1 if f["token"] == winner else 0
        return (primary, f["tail_seq"], f["snap_seq"], f["ts"], -p)

    return [p for p, _f in sorted(known, key=rank, reverse=True)]


# ---------------------------------------------------------------------------
# Recovery: snapshot fast-forward + exactly-once tail replay
# ---------------------------------------------------------------------------


def recovery_blob(
    snap: Optional[Dict[str, Any]], latest_cfg
) -> Optional[Dict[str, Any]]:
    """Prepare a shipped snapshot for ``adopt_gid``.

    If the snapshot's config matches the latest committed config it
    adopts as-is.  If the config moved on while the group was down, the
    blob is fast-forwarded: re-stamped at the LATEST config (shard data
    and dedup tables preserved, every slot SERVING) rather than
    replayed through config history — replaying would wedge leaving
    shards in BEPULLING forever, the exact hazard ``adopt_gid``'s
    docstring describes for empty adoption.  Shards the latest config
    assigns elsewhere sit inert (``can_serve`` is false for them), and
    the preserved dedup tables keep the subsequent tail replay
    exactly-once.  Caveat (documented in ARCHITECTURE §15): a shard
    handoff that completed inside the shipping window before the death
    is bounded by the same ``MRT_SHIP_WINDOW_S`` loss window."""
    if snap is None:
        return None
    cur = snap["cur"]
    if cur.num >= latest_cfg.num:
        return snap
    return {
        "gid": snap["gid"],
        "cur": latest_cfg.clone(),
        "prev": cur.clone(),
        "shards": {
            int(s): (SERVING, dict(data), dict(latest))
            for s, (_state, data, latest) in snap["shards"].items()
        },
    }


def redo_record(skv, gid: int, rec: tuple) -> None:
    """Direct host redo of one tail record — the fallback when the
    logged re-submit cannot serve (ownership moved mid-replay).
    Mirrors ``ShardWalReplay._redo_client_op``: dedup on the shard's
    session table, then mutate, so it composes with the logged path."""
    op, key, value, cid, cmd = rec
    rep = skv.reps.get(gid)
    if rep is None:
        return
    sh = rep.shards[key2shard(key)]
    if sh.latest.get(cid, -1) >= cmd:
        return
    if op == "Put":
        sh.data[key] = value
    elif op == "Append":
        sh.data[key] = sh.data.get(key, "") + value
    sh.latest[cid] = cmd


def iter_replay_tail(skv, gid: int, records: List[tuple]):
    """Generator form of tail replay for the scheduler-driven server:
    re-submit each record through ``gid``'s OWN log with its original
    ``(client_id, command_id)`` — the shard's dedup table (restored
    from the snapshot) drops any record the snapshot already covers,
    so replay is exactly-once.  Yields poll delays while a ticket is in
    flight; falls back to :func:`redo_record` when the log path cannot
    serve the record (e.g. the config moved the shard away — the data
    still has to land for a later handoff)."""
    for rec in records:
        op, key, value, cid, cmd = rec
        t = skv.submit(gid, op, key, value, client_id=cid,
                       command_id=cmd)
        waited = 0.0
        while not t.done and waited < 5.0:
            delay = yield 0.002
            waited += 0.002 if delay is None else 0.002
        if (not t.done) or t.failed or t.err:
            redo_record(skv, gid, rec)


def replay_tail(skv, gid: int, records: List[tuple],
                pump: Optional[Callable[[], None]] = None) -> int:
    """Blocking tail replay for in-process fleets: drive
    :func:`iter_replay_tail` with ``pump`` (defaults to
    ``skv.pump``).  Returns the number of records replayed."""
    if pump is None:
        pump = lambda: skv.pump(2)  # noqa: E731
    it = iter_replay_tail(skv, gid, records)
    try:
        next(it)
        while True:
            pump()
            it.send(None)
    except StopIteration:
        pass
    return len(records)
