"""Columnar firehose frames — the high-throughput serving wire format.

The round-4 breakdown (BENCHMARKS.md "serving") proved the framed
path's binding constraint was not decode or dispatch but the PER-OP
Python object path: one dataclass + one submit + one ticket + one
apply dispatch per op caps the in-process ceiling at ~45k ops/s on
this host.  The firehose removes the per-op path entirely:

* ONE ``bytes`` blob per frame, columnar (struct-of-arrays): opcode /
  group / client / command-id / length columns as packed little-endian
  numpy arrays, key/value bytes concatenated.  Encode and decode are a
  handful of vectorized array ops + one string-materialization pass —
  no per-op codec objects on either side.
* The engine binds a frame's rows to log slots as contiguous RUNS
  (engine/host.py ``start_run``): one payload entry per (group, accept
  batch), not per op.
* Apply happens per committed SLICE (engine/kv.py
  ``BatchedKV._apply_slice``): the dict mutations remain per-row (the
  state machine is the state machine) but every cost around them —
  binding, frontier bookkeeping, ticket resolution, reply assembly —
  is per-slice or per-frame.
* Failures (leader-change truncation) surface as per-ROW error codes
  in the reply; the CLIENT retries failed rows under the same
  (client_id, command_id) — session dedup makes the retry
  exactly-once.  This moves retry off the server's hot loop (the
  per-op ``batch`` path keeps its server-side resubmit semantics).

Layout (little-endian)::

    request:  u32 n | u8 op[n] | u32 group[n] | u64 client[n]
              | u64 command[n] | u16 key_len[n] | u32 val_len[n]
              | key bytes (concat) | value bytes (concat)
    reply:    u32 n | u8 err[n] | u32 val_len[n] | value bytes

Err codes: 0 = OK, 1 = RETRY (binding lost to a leader change —
resubmit), 2 = TIMEOUT (frame deadline expired before resolve).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

__all__ = [
    "FH_OK",
    "FH_RETRY",
    "FH_TIMEOUT",
    "FH_WRONG_GROUP",
    "FH_NO_KEY",
    "MAX_FIREHOSE_ROWS",
    "pack_request",
    "unpack_request",
    "pack_reply",
    "unpack_reply",
    "FirehoseFrame",
]

FH_OK = 0
FH_RETRY = 1
FH_TIMEOUT = 2
# Sharded service only: the row's shard is not served by the addressed
# replica group under the config its apply saw — the client re-queries
# the config and re-routes (reference semantics: shardkv ErrWrongGroup,
# shardkv/common.go:12-18).
FH_WRONG_GROUP = 3
# Sharded Get of an absent key (reference: ErrNoKey) — distinct from
# the plain-KV convention of empty-string reads.
FH_NO_KEY = 4

# Largest row count one firehose frame may carry — the ONE limit both
# the server (EngineKVService.MAX_FIREHOSE) and the clerks
# (FirehoseClerk.MAX_FRAME) enforce; a clerk-side split bound above
# the server's cap would make every oversized batch permanently
# rejected.
MAX_FIREHOSE_ROWS = 65536

_U32 = np.dtype("<u4")
_U64 = np.dtype("<u8")
_U16 = np.dtype("<u2")


def pack_request(
    ops: np.ndarray,
    groups: np.ndarray,
    clients: np.ndarray,
    commands: np.ndarray,
    keys: Sequence[bytes],
    values: Sequence[bytes],
) -> bytes:
    """Pack columns into one request blob.  ``keys``/``values`` are
    per-row byte strings (empty for ops without one)."""
    n = len(ops)
    if n > MAX_FIREHOSE_ROWS:
        # The row count travels as u32, but the server rejects frames
        # above MAX_FIREHOSE_ROWS anyway — fail on the clerk side
        # before paying the pack + network round trip.
        raise ValueError(
            f"firehose frame has {n} rows; the server caps frames at "
            f"{MAX_FIREHOSE_ROWS}"
        )
    for r, k in enumerate(keys):
        if len(k) >= 2 ** 16:
            # The wire key-length column is u16; packing a longer key
            # would silently truncate the length and desync every
            # later row's key offset.
            raise ValueError(
                f"firehose key at row {r} is {len(k)} bytes; the wire "
                f"format caps keys below {2 ** 16} bytes"
            )
        if len(values[r]) >= 2 ** 32:
            # Value lengths are u32: a longer value wraps the length
            # column and desyncs every later row's value offset.
            raise ValueError(
                f"firehose value at row {r} is {len(values[r])} bytes; "
                f"the wire format caps values below {2 ** 32} bytes"
            )
    key_blob = b"".join(keys)
    val_blob = b"".join(values)
    parts = [
        np.uint32(n).tobytes(),
        np.asarray(ops, np.uint8).tobytes(),
        np.asarray(groups, _U32).tobytes(),
        np.asarray(clients, _U64).tobytes(),
        np.asarray(commands, _U64).tobytes(),
        np.asarray([len(k) for k in keys], _U16).tobytes(),
        np.asarray([len(v) for v in values], _U32).tobytes(),
        key_blob,
        val_blob,
    ]
    return b"".join(parts)


def unpack_request(
    blob: bytes,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, List[str], List[str]]:
    """Decode a request blob into columns + materialized key/value
    strings (one pass; the only per-row Python work on the hot path)."""
    n = int(np.frombuffer(blob, _U32, 1, 0)[0])
    off = 4
    ops = np.frombuffer(blob, np.uint8, n, off); off += n
    groups = np.frombuffer(blob, _U32, n, off); off += 4 * n
    clients = np.frombuffer(blob, _U64, n, off); off += 8 * n
    commands = np.frombuffer(blob, _U64, n, off); off += 8 * n
    key_len = np.frombuffer(blob, _U16, n, off); off += 2 * n
    val_len = np.frombuffer(blob, _U32, n, off); off += 4 * n
    keys: List[str] = []
    vals: List[str] = []
    mv = memoryview(blob)
    ko = off
    for ln in key_len.tolist():
        keys.append(str(mv[ko: ko + ln], "utf-8"))
        ko += ln
    vo = ko
    for ln in val_len.tolist():
        vals.append(str(mv[vo: vo + ln], "utf-8"))
        vo += ln
    if vo != len(blob):
        raise ValueError("malformed firehose frame: length mismatch")
    return ops, groups, clients, commands, keys, vals


def pack_reply(err: np.ndarray, values: Sequence[bytes]) -> bytes:
    n = len(err)
    if n > MAX_FIREHOSE_ROWS:
        # Replies mirror request frames row-for-row, so a validated
        # request can never get here; guard anyway — the u32 row count
        # would wrap silently.
        raise ValueError(
            f"firehose reply has {n} rows; frames cap at "
            f"{MAX_FIREHOSE_ROWS}"
        )
    for r, v in enumerate(values):
        if len(v) >= 2 ** 32:
            # u32 value-length column: a longer value wraps the length
            # and desyncs every later row's value offset.
            raise ValueError(
                f"firehose reply value at row {r} is {len(v)} bytes; "
                f"the wire format caps values below {2 ** 32} bytes"
            )
    return b"".join([
        np.uint32(n).tobytes(),
        np.asarray(err, np.uint8).tobytes(),
        np.asarray([len(v) for v in values], _U32).tobytes(),
        b"".join(values),
    ])


def unpack_reply(blob: bytes) -> Tuple[np.ndarray, List[str]]:
    n = int(np.frombuffer(blob, _U32, 1, 0)[0])
    off = 4
    err = np.frombuffer(blob, np.uint8, n, off); off += n
    val_len = np.frombuffer(blob, _U32, n, off); off += 4 * n
    vals: List[str] = []
    mv = memoryview(blob)
    for ln in val_len.tolist():
        vals.append(str(mv[off: off + ln], "utf-8"))
        off += ln
    return err, vals


class FirehoseFrame:
    """Server-side state of one in-flight firehose frame.

    Holds the decoded columns, the per-row outcome array, and the
    count of unresolved WRITE rows; the engine's slice apply/evict
    paths mutate rows in bulk through :meth:`rows_applied` /
    :meth:`rows_failed`.  Gets are answered at completion time (after
    the frame's writes resolve), mirroring the framed batch path's
    read-after-own-writes ordering."""

    __slots__ = (
        "ops", "groups", "clients", "commands", "keys", "vals",
        "ops_l", "clients_l", "commands_l",
        "err", "pending_writes", "submit_tick", "write_rows",
    )

    def __init__(self, blob: bytes, submit_tick: int) -> None:
        (self.ops, self.groups, self.clients, self.commands,
         self.keys, self.vals) = unpack_request(blob)
        n = len(self.ops)
        # List mirrors for the apply loop: per-row list indexing is
        # ~3x cheaper than per-row ndarray indexing, and .tolist() is
        # one C pass per frame.
        self.ops_l = self.ops.tolist()
        self.clients_l = self.clients.tolist()
        self.commands_l = self.commands.tolist()
        self.err = np.full(n, FH_TIMEOUT, np.uint8)
        self.write_rows = np.nonzero(self.ops != 0)[0]
        # Gets resolve at completion; only writes ride the log.
        self.err[self.ops == 0] = FH_OK
        self.pending_writes = int(len(self.write_rows))
        self.submit_tick = submit_tick

    def __len__(self) -> int:
        return len(self.ops)

    @property
    def done(self) -> bool:
        return self.pending_writes == 0

    def rows_applied(self, rows: np.ndarray) -> None:
        """``rows`` are ORIGINAL frame row indices (a slice of the
        group-sorted order array a run carries)."""
        self.err[rows] = FH_OK
        self.pending_writes -= len(rows)

    def rows_failed(self, rows: np.ndarray) -> None:
        self.err[rows] = FH_RETRY
        self.pending_writes -= len(rows)

    def rows_done(self, rows: np.ndarray, errs: np.ndarray) -> None:
        """Resolve rows with MIXED outcomes (the sharded apply path:
        some rows OK, some ErrWrongGroup under the config their apply
        saw)."""
        self.err[rows] = errs
        self.pending_writes -= len(rows)
