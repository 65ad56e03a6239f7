"""Crash-atomic on-disk Persister.

The reference's Persister is in-memory byte slices with an atomic
(state, snapshot) pair save (reference: raft/persister.go:57-64); crash
realism comes from the test fixture copying it into the reborn server
(reference: raft/config.go:113-142).  A real deployment needs the same
contract from the filesystem.

Layout: two rename-atomic files, ``state.bin`` (term/vote/log) and
``snap.bin`` (service snapshot), each length-prefixed and checksummed
(the CRC covers the length too, so a corrupted header can't silently
mis-frame the blob).  Splitting them keeps the hot path cheap: raft
state is re-persisted on every vote/term/log mutation (reference quirk
#6, raft/raft.go:205-216), and must not drag a multi-megabyte snapshot
plus its fsync along each time.

Crash-ordering invariant: the snapshot is made durable *before* any
raft state whose log was compacted against it.  The dangerous crash is
(new state, old snapshot): the trimmed log no longer covers the gap
above the old snapshot, so entries are lost forever.  The reverse —
(old state, new snapshot) — is safe: on restart the service boots from
the newer snapshot and the re-applied older entries are filtered by the
per-client dup table (same at-most-once machinery that absorbs
duplicate RPCs).  ``save_state_and_snapshot`` therefore fsyncs
``snap.bin`` to disk before touching ``state.bin``.

A torn write can only lose the *new* blob, never corrupt the old one
(POSIX rename atomicity); a checksum mismatch falls back to empty state
(fresh server), which Raft's protocol tolerates by design.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib

__all__ = ["DiskPersister", "set_fsync_stall", "fsync_stall_point"]

# -- gray-disk fault injection ----------------------------------------------
#
# A slow-but-alive disk is the storage analog of a slow link: fsync
# still succeeds, just late — the fault class that wedges WAL-gated
# acks without tripping any liveness detector built on "is it up".
# ChaosControl.fsync_stall arms this process-wide stall; every sync
# point (DiskPersister._write below, WriteAheadLog.sync) runs through
# fsync_stall_point() so a single verb grays out ALL durable writes on
# the node.  Each applied stall is recorded in the arming ChaosState's
# hit ledger ("disk" path, kind "fsync_stall") so nemesis fault-window
# verification and the postmortem doctor see it.

_stall_lock = threading.Lock()
_stall_s = 0.0
_stall_chaos = None


def set_fsync_stall(seconds: float, chaos=None) -> None:
    """Arm (or, with 0, clear) the process-wide fsync stall."""
    global _stall_s, _stall_chaos
    with _stall_lock:
        _stall_s = max(0.0, float(seconds))
        _stall_chaos = chaos if _stall_s > 0 else None


def fsync_stall_point() -> None:
    """Run by every durable-write sync path before its os.fsync."""
    with _stall_lock:
        s, chaos = _stall_s, _stall_chaos
    if s <= 0.0:
        return
    time.sleep(s)
    if chaos is not None:
        chaos.note_fault("disk", "fsync_stall")

_MAGIC = b"MRF2"
_HEADER = struct.Struct("<4sIQ")  # magic, crc32(len ‖ body), len(body)
_LEN = struct.Struct("<Q")


class DiskPersister:
    """File-backed drop-in for :class:`multiraft_tpu_torch.raft.persister.Persister`.

    One instance owns one directory.  Reads are served from an in-memory
    mirror; every save rewrites the corresponding file atomically.
    """

    def __init__(self, directory: str, fsync: bool = True) -> None:
        self.dir = directory
        self._state_path = os.path.join(directory, "state.bin")
        self._snap_path = os.path.join(directory, "snap.bin")
        self._fsync = fsync
        os.makedirs(directory, exist_ok=True)
        self._raft_state = self._load(self._state_path)
        self._snapshot = self._load(self._snap_path)

    # -- Persister API -----------------------------------------------------

    def copy(self) -> "DiskPersister":
        return DiskPersister(self.dir, fsync=self._fsync)

    def save_raft_state(self, state: bytes) -> None:
        self._write(self._state_path, state)
        self._raft_state = state

    def read_raft_state(self) -> bytes:
        return self._raft_state

    def raft_state_size(self) -> int:
        return len(self._raft_state)

    def save_state_and_snapshot(self, state: bytes, snapshot: bytes) -> None:
        # Snapshot first — see the crash-ordering invariant above.
        self._write(self._snap_path, snapshot)
        self._write(self._state_path, state)
        self._raft_state, self._snapshot = state, snapshot

    def read_snapshot(self) -> bytes:
        return self._snapshot

    def snapshot_size(self) -> int:
        return len(self._snapshot)

    # -- internals ---------------------------------------------------------

    def _write(self, path: str, body: bytes) -> None:
        # Running CRC over (length ‖ body) without concatenating — the
        # body can be a multi-megabyte snapshot on the hot persist path.
        crc = zlib.crc32(body, zlib.crc32(_LEN.pack(len(body))))
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_HEADER.pack(_MAGIC, crc, len(body)))
            f.write(body)
            f.flush()
            if self._fsync:
                fsync_stall_point()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if self._fsync:
            # The rename itself is only durable once the directory entry
            # is — without this, a power cut can resurrect the *previous*
            # blob, un-persisting a vote/term and allowing two leaders in
            # one term.
            dfd = os.open(self.dir, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)

    @staticmethod
    def _load(path: str) -> bytes:
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return b""
        if len(raw) < _HEADER.size:
            return b""
        magic, crc, n = _HEADER.unpack_from(raw)
        body = raw[_HEADER.size:]
        if (
            magic != _MAGIC
            or len(body) != n
            or zlib.crc32(body, zlib.crc32(_LEN.pack(n))) != crc
        ):
            return b""
        return body
