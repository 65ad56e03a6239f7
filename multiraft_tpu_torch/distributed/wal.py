"""Write-ahead log for the durable engine server.

The reference persists every raft-state mutation through its Persister
(reference quirk #6, raft/raft.go:205-216) — affordable when state is
one group's log.  The batched engine cannot re-serialize ``[G, P, L]``
tensors per op, so durability splits in two:

* periodic whole-engine checkpoints (:meth:`EngineDriver.save`, atomic
  at a tick boundary, service state in ``extra``), and
* this WAL of acknowledged client/admin ops since the last checkpoint.

Recovery = restore the checkpoint, then RE-SUBMIT every WAL record
through consensus with its original ``(client_id, command_id)`` — the
session dedup tables make replay exactly-once, the same machinery that
absorbs duplicate RPCs (reference: kvraft/server.go:66-69).  Records
already reflected in the checkpoint dedup to no-ops; records past it
commit now.  A crash between checkpoint and rotation only makes replay
redundant, never wrong.

Framing mirrors ``DiskPersister``: per record ``magic ‖ crc32(len ‖
body) ‖ len ‖ body``.  A torn tail record fails its checksum and is
dropped — safe because acks gate on :meth:`sync` having covered the
record (group fsync at pump cadence), so a torn record was never
acknowledged.

Write batching: :meth:`append` only stages ``header ‖ body`` in memory;
:meth:`sync` lands the whole batch as ONE ``write()`` before the group
fsync.  Semantics are unchanged — acks already gate on :meth:`sync`, so
a record that never reached the file was never acknowledged, exactly
like a torn tail.  Startup reads the file ONCE: a single streamed scan
both finds the valid prefix (truncating any torn tail before this
incarnation appends) and retains the record bodies for :meth:`replay`.
"""

from __future__ import annotations

import os
import struct
import time
import zlib
from collections import deque
from typing import Iterator, List, Optional, Tuple

from ..utils.metrics import Metrics
from . import disk, flightrec

__all__ = ["WriteAheadLog"]

_MAGIC = b"MRWL"
_HEADER = struct.Struct("<4sIQ")  # magic, crc32(len ‖ body), len(body)
_LEN = struct.Struct("<Q")
_SCAN_CHUNK = 1 << 20


class WriteAheadLog:
    """Append-only record log with group fsync and atomic rotation.

    Single-writer: the owning service appends/syncs from its loop
    thread only.  ``seq`` numbers are per-incarnation (they gate acks,
    they are not stored).
    """

    #: Bounded retention for :meth:`tail` — the state plane's shipping
    #: window is seconds, so a few thousand recent records is plenty;
    #: older records are covered by shipped snapshots.
    TAIL_RETAIN = 4096

    def __init__(
        self,
        path: str,
        fsync: bool = True,
        metrics: Optional[Metrics] = None,
    ) -> None:
        self.path = path
        self._fsync = fsync
        # Observability: appends/fsyncs/rotates as counters, fsync
        # latency as samples.  A private registry when the owner passes
        # none — the instrumentation below never branches on None.
        self.metrics = metrics if metrics is not None else Metrics()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # ONE streamed pass over the file: find the valid prefix AND
        # keep the intact bodies for replay().  Truncate any torn tail
        # BEFORE appending: records written after leftover garbage
        # would be unreachable to every future replay (it stops at the
        # first bad record) — silently losing the next incarnation's
        # acked writes.
        valid, bodies = self._scan()
        if valid is not None:
            os.truncate(path, valid)
        self._startup: Optional[List[bytes]] = bodies
        self._f = open(path, "ab")
        self._pend: List[bytes] = []  # staged records since last sync
        # Seqs are MONOTONIC for the whole incarnation — rotation must
        # not reset them, because ack gates and the fleet GC gate hold
        # seqs across it (a reset would turn synced(seq) false again
        # and wedge a quiet server's ack waits forever).
        self.appended = 0  # records appended by this incarnation
        self.synced = 0    # records known durable
        # Recent (seq, body) pairs for the state plane's WAL tailing —
        # bounded, survives rotation (seqs are monotonic across it).
        self._tail: deque = deque(maxlen=self.TAIL_RETAIN)
        # Black-box evidence of durability progress: append seq and
        # fsync frontier land in the crash-surviving ring, so a
        # SIGKILL'd process still shows how far its acks were covered
        # (the doctor's fsync-gap analysis).  None when disabled.
        self._frec = flightrec.get_recorder()

    def _scan(self) -> Tuple[Optional[int], List[bytes]]:
        """One streamed pass: byte length of the intact record prefix
        (None if the file is missing or already fully valid) plus every
        intact body in append order."""
        bodies: List[bytes] = []
        try:
            f = open(self.path, "rb")
        except FileNotFoundError:
            return None, bodies
        hdr = _HEADER.size
        with f:
            window = bytearray()
            valid = 0   # bytes consumed as intact records
            torn = False
            while True:
                chunk = f.read(_SCAN_CHUNK)
                if chunk:
                    window.extend(chunk)
                at_eof = not chunk
                off = 0
                while len(window) - off >= hdr:
                    magic, crc, n = _HEADER.unpack_from(window, off)
                    if magic != _MAGIC:
                        torn = True
                        break
                    if len(window) - off - hdr < n:
                        if at_eof:
                            torn = True  # record torn mid-body
                        break  # need more bytes
                    body = bytes(window[off + hdr: off + hdr + n])
                    if zlib.crc32(body, zlib.crc32(_LEN.pack(n))) != crc:
                        torn = True
                        break
                    bodies.append(body)
                    off += hdr + n
                    valid += hdr + n
                del window[:off]
                if torn:
                    break
                if at_eof:
                    if window:  # trailing partial header
                        torn = True
                    break
        return (valid if torn else None), bodies

    # -- recovery ---------------------------------------------------------

    def replay(self) -> Iterator[bytes]:
        """Yield every intact record body in append order, stopping at
        the first torn/corrupt record (an unacknowledged tail).  Call
        before appending.  Served from the constructor's single scan;
        a second call (or a contract-breaking replay-after-append)
        falls back to re-scanning the file."""
        if self._startup is not None:
            bodies, self._startup = self._startup, None
            yield from bodies
            return
        try:  # make staged/buffered appends visible to the re-scan
            self._write_pending()
            self._f.flush()
        except Exception:
            pass
        _, bodies = self._scan()
        yield from bodies

    # -- append path ------------------------------------------------------

    def append(self, body: bytes) -> int:
        """Stage one record; returns its seq (ack-gate with
        ``synced >= seq`` after a :meth:`sync`)."""
        crc = zlib.crc32(body, zlib.crc32(_LEN.pack(len(body))))
        # Drained by _write_pending on every sync(): bounded by the
        # records staged within one pump (group-commit batching).
        self._pend.append(  # graftlint: disable=unbounded-queue
            _HEADER.pack(_MAGIC, crc, len(body)) + body
        )
        self.appended += 1
        # deque(maxlen=TAIL_RETAIN) from __init__ — old entries fall
        # off as new ones land.
        self._tail.append((self.appended, body))  # graftlint: disable=unbounded-queue
        m = self.metrics
        m.inc("wal.appends")
        m.inc("wal.bytes", _HEADER.size + len(body))
        if self._frec is not None:
            self._frec.record(
                flightrec.WAL_APPEND, a=self.appended, b=len(body)
            )
        return self.appended

    def _write_pending(self) -> None:
        """Land every staged record as one ``write()``."""
        if not self._pend:
            return
        nrec = len(self._pend)
        batch = self._pend[0] if nrec == 1 else b"".join(self._pend)
        self._pend.clear()
        self._f.write(batch)
        m = self.metrics
        m.inc("wal.write_batches")
        m.observe("wal.batch_records", float(nrec))

    def sync(self) -> None:
        """Group commit: make everything appended so far durable."""
        if self.synced >= self.appended:
            return
        t0 = time.perf_counter()
        self._write_pending()
        self._f.flush()
        if self._fsync:
            # Gray-disk chaos: slow-but-alive storage stalls here (the
            # stall lands inside wal.fsync_s, where the postmortem
            # doctor's fsync-gap scan will see it).
            disk.fsync_stall_point()
            os.fsync(self._f.fileno())
        dt = time.perf_counter() - t0
        m = self.metrics
        m.inc("wal.fsyncs")
        m.observe("wal.fsync_s", dt)
        self.synced = self.appended
        if self._frec is not None:
            self._frec.record(
                flightrec.WAL_FSYNC, a=self.synced, b=int(dt * 1e6)
            )

    # -- tailing (state-plane shipping) -----------------------------------

    def tail(self, from_seq: int) -> List[Tuple[int, bytes]]:
        """Retained ``(seq, body)`` records with ``seq > from_seq``, in
        append order — the per-incarnation segment iteration the state
        plane ships between snapshots.  Retention is bounded
        (:data:`TAIL_RETAIN`); a caller that has fallen behind the
        retained window gets a gap (the first returned seq is not
        ``from_seq + 1``) and must re-base on a snapshot."""
        return [(s, b) for s, b in self._tail if s > from_seq]

    # -- rotation (after a successful checkpoint) -------------------------

    def rotate(self) -> None:
        """Truncate to empty, atomically.  Call only after the covering
        checkpoint is durable — a crash in between merely makes the
        next replay redundant (dedup absorbs it)."""
        # Staged records are covered by the checkpoint being rotated
        # behind (rotate runs right after sync/checkpoint on the loop
        # thread) — discard them the same way the truncate discards
        # written-but-rotated bytes.
        self._pend.clear()
        self._startup = None
        self._f.close()
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.flush()
            if self._fsync:
                os.fsync(f.fileno())
        os.replace(tmp, self.path)
        if self._fsync:
            dfd = os.open(os.path.dirname(self.path) or ".", os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        self._f = open(self.path, "ab")
        self.metrics.inc("wal.rotates")
        # appended/synced deliberately NOT reset — see __init__.

    def close(self) -> None:
        try:
            self._write_pending()
        except Exception:
            pass
        try:
            self._f.close()
        except Exception:
            pass
