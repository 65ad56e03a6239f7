"""Crash-safe flight recorder: a bounded, mmap-backed ring of recent
structured events that survives ``kill -9``.

The observability plane (observe.py) is scrape/drain-on-read: a
process that dies surrenders every span and counter it held — and the
nemesis harness's whole job is killing processes.  This module is the
black box: every process keeps the last ``slots`` events (RPC frame
metadata, WAL append/fsync, engine state frontiers, chaos decisions,
scheduler tick boundaries) in a fixed-width binary ring file that the
postmortem doctor (:mod:`multiraft_tpu_torch.analysis.postmortem`) can read
back no matter how the process died.

Crash-safety model (the torn-write recovery invariant):

* Records are FIXED WIDTH (``REC_SIZE`` bytes) and slot-aligned —
  record ``seq`` lives in slot ``(seq - 1) % slots`` — so no record
  ever straddles another and a reader never needs to resynchronize a
  byte stream.
* Each record is self-delimiting: ``magic ‖ crc32(payload) ‖ payload``
  where the payload carries its own monotonically increasing ``seq``.
  A SIGKILL can tear at most the slot being written at that instant;
  the torn slot fails its checksum and is skipped, every other slot
  replays.  The reader orders surviving records by ``seq`` — the
  oldest intact record onward, exactly the WAL's torn-tail discipline
  (wal.py) transplanted to a ring.
* The header page is written once at creation and never touched again
  (no write cursor to tear); the cursor is derived at read time from
  the max intact ``seq``.

Hot-path cost: one ``struct.pack_into`` into the mmap plus a crc32
over ``REC_SIZE - 8`` bytes, under a lock (outbound RPCs record from
arbitrary caller threads).  No serialization, no allocation beyond the
tag bytes, no syscall — the OS flushes dirty pages even when the
process dies uncleanly, which is the whole point.

Enablement: ``MRT_FLIGHTREC_DIR=<dir>`` (inherited by every server
child via launch.py's environment copy).  :func:`get_recorder` hands
every caller in a process the same ring (``flight-<pid>.ring``), so a
harness host's many clerk nodes share one file while each server
process keeps its own.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

from ..utils.knobs import knob_int, knob_str
from .observe import now_us

__all__ = [
    "FlightRecorder",
    "get_recorder",
    "read_ring",
    "type_name",
    "REC_SIZE",
    "HDR_SIZE",
]

# Record layout: magic u32 ‖ crc32(bytes 8..REC_SIZE) u32 ‖ seq u64 ‖
# ts f64 (perf_counter µs — the plane's universal trace clock) ‖
# etype u16 ‖ code u16 ‖ a,b,c i64 ‖ tag char[20] (NUL-padded ASCII).
_REC = struct.Struct("<IIQdHHqqq20s")
REC_SIZE = _REC.size  # 72
_REC_MAGIC = 0x464C5452  # "RTLF"
_CRC = struct.Struct("<I")

# Header page: magic ‖ version ‖ slots ‖ rec_size ‖ pid ‖ wall-clock
# epoch (time.time() at creation, for human-readable report headers) ‖
# process name.  One page, written once — nothing in it can tear after
# creation.
_HDR = struct.Struct("<8sIIIId64s")
_HDR_MAGIC = b"FRECRING"
_HDR_VERSION = 1
HDR_SIZE = 4096

# Event types.  ``code`` / ``a`` / ``b`` / ``c`` / ``tag`` semantics
# per type are documented where each is recorded; the doctor treats
# them generically (typed points on a timeline) plus a few targeted
# analyses (WAL fsync gap, last commit, chaos bursts).
RPC_OUT = 1      # a=req_id b=bytes           tag=svc_meth
RPC_HANDLE = 2   # a=dur_us b=ok              tag=svc_meth
RPC_CLIENT = 3   # a=dur_us b=ok              tag=svc_meth
WAL_APPEND = 4   # a=seq    b=bytes
WAL_FSYNC = 5    # a=synced_seq b=dur_us
STATE = 6        # a=commits_total b=leaders c=max_term
TICK = 7         # a=pump_index b=wall_us c=commits_total
COMMIT = 8       # code=group a=client_id b=command_id  tag=rid
CHAOS = 9        # code=kind_code a=1         tag=path
ROLE = 10        # code=peer_id a=role b=term c=commit_index
NODE_CLOSE = 11  # clean shutdown marker      tag=name
MARK = 12        # free-form harness marker   tag=text
SANITIZE = 13    # code=kind a=value b=limit  tag=label (sanitize.py)
OVERLOAD = 14    # code=kind a=value(µs/depth) b=bound c=window_count
#                  tag=stage-or-gauge name (overload.py watch)
PLACE = 15       # code=gid a=src_proc b=dst_proc c=placement_version
#                  tag=reason (placement.py controller decisions)
SHIP = 16        # code=gid a=n_records b=n_bytes c=acked_frontier
#                  tag="snap"|"tail" (stateplane.py shipments)
WEDGE = 17       # code=group a=stall_ticks b=commit_index c=backlog
#                  tag=leader ("p<peer>@t<term>"; wedge.py watchdog)
CONFIG = 18      # code=gid a=dead_peer b=new_peer c=config_epoch
#                  tag=phase ("learner"|"catchup"|"joint"|"done"|
#                  "abort"; placement.py replace-dead-replica legs)
PROF = 19        # code=cpu_busy_permille a=samples b=distinct_stacks
#                  c=overflow / tag=hottest leaf function (profile.py
#                  sampler breadcrumb, ~1/s: a SIGKILL'd process still
#                  names what it was burning CPU on; code is process
#                  CPU over wall for the window ×1000 — the doctor's
#                  cpu_saturation vs queueing_collapse evidence)
TAIL = 20        # code=dominant-wait code (TAIL_WAIT_CODES) a=total_us
#                  b=dominant_wait_us c=engine_tick_id / tag=rid
#                  (tail.py exemplar breadcrumb, written for over-SLO
#                  and new-slowest completions: a SIGKILL'd process
#                  still names its slowest request and where it waited)

_TYPE_NAMES = {
    RPC_OUT: "rpc_out",
    RPC_HANDLE: "rpc_handle",
    RPC_CLIENT: "rpc_client",
    WAL_APPEND: "wal_append",
    WAL_FSYNC: "wal_fsync",
    STATE: "state",
    TICK: "tick",
    COMMIT: "commit",
    CHAOS: "chaos",
    ROLE: "role",
    NODE_CLOSE: "node_close",
    MARK: "mark",
    SANITIZE: "sanitize",
    OVERLOAD: "overload",
    PLACE: "place",
    SHIP: "ship",
    WEDGE: "wedge",
    CONFIG: "config",
    PROF: "prof",
    TAIL: "tail",
}

# ChaosState fault kinds → compact codes for CHAOS records.
# floor: slow_link per-frame latency floor (every frame pays it);
# fsync_stall: gray-disk stall applied at a disk.py/wal.py sync point.
CHAOS_KIND_CODES = {"drop": 1, "delay": 2, "block": 3, "floor": 4,
                    "fsync_stall": 5}

# Runtime-sanitizer violation kinds → compact codes for SANITIZE
# records (sanitize.py; the postmortem doctor names them back).
SANITIZE_KIND_CODES = {"lock_order": 1, "queue_bound": 2, "callback_budget": 3}

# Overload-watch trip kinds → compact codes for OVERLOAD records
# (overload.py; the doctor folds them into "queueing collapse").
# stage_p99: a windowed stage histogram's p99 crossed its bound
#            (a=p99_us b=bound_us c=window_count tag=stage name).
# gauge:     a queue-depth gauge crossed its bound
#            (a=depth b=bound tag=gauge name).
# gauge_ctx: the deepest gauge at the moment a stage tripped — context
#            for the doctor's "first saturated stage + its queue gauge"
#            naming, recorded even when that gauge is under its own
#            bound (a=depth b=bound tag=gauge name).
# brownout:  the brownout state machine changed state — recorded on
#            transitions only (a=new_state b=old_state c=trip_count
#            tag="brownout"); the doctor reports these as "shedding
#            engaged", distinct from queueing collapse.
OVERLOAD_KIND_CODES = {"stage_p99": 1, "gauge": 2, "gauge_ctx": 3,
                       "brownout": 4}

# Queue-wait vocabulary → compact codes for TAIL records (tail.py).
# The four WAITS a request can park in, distinct from the work stages
# (handler/engine CPU): wire = send→socket-readable→decode (chaos
# delay/floor reschedules land here), dispatch = decode→dispatch,
# pump = proposal submitted→its fused tick batch dispatched,
# flush = reply queued→flushed to the socket.  The doctor names the
# dominant wait back from the code.
TAIL_WAIT_CODES = {"wire": 1, "dispatch": 2, "pump": 3, "flush": 4,
                   "work": 5}


def type_name(etype: int) -> str:
    return _TYPE_NAMES.get(etype, f"type{etype}")


def _i64(v: Any) -> int:
    """Clamp any int into the record's signed-64 payload columns by
    keeping the low 64 bits (two's complement).  Client ids are full
    64-bit unsigned values (utils/ids.py: 40-bit nonce << 24), and a
    black box that raises ``struct.error`` on the hot path takes its
    process down with it — the exact opposite of its job.  Readers
    needing the unsigned view apply ``& 0xFFFFFFFFFFFFFFFF``."""
    v = int(v) & 0xFFFFFFFFFFFFFFFF
    return v - 0x10000000000000000 if v >= 0x8000000000000000 else v


class FlightRecorder:
    """One process's black box: a fixed-slot mmap ring of events.

    Thread-safe (one lock around seq allocation + the slot write —
    outbound RPC hooks record from arbitrary caller threads).  Never
    closed on node shutdown: the ring must outlive every clean exit
    path so an almost-dead process still leaves evidence; ``close``
    exists for tests that create standalone recorders."""

    def __init__(self, path: str, slots: int = 8192, name: str = "") -> None:
        import mmap

        if slots < 2:
            raise ValueError("flight ring needs at least 2 slots")
        self.path = path
        self.slots = slots
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        size = HDR_SIZE + slots * REC_SIZE
        fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            os.ftruncate(fd, size)
            self._mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self._mv = memoryview(self._mm)
        _HDR.pack_into(
            self._mm, 0, _HDR_MAGIC, _HDR_VERSION, slots, REC_SIZE,
            os.getpid(), time.time(),
            name.encode("utf-8", "replace")[:64],
        )
        self._lock = threading.Lock()
        self._seq = 0
        self.closed = False

    def record(
        self,
        etype: int,
        code: int = 0,
        a: int = 0,
        b: int = 0,
        c: int = 0,
        tag: Any = b"",
    ) -> None:
        """Append one fixed-width record (cheap; safe from any thread).

        ``tag`` longer than 20 bytes is truncated — tags are labels
        (svc_meth, rid, chaos path), not payloads."""
        if self.closed:
            return
        if isinstance(tag, str):
            tag = tag.encode("utf-8", "replace")
        with self._lock:
            self._seq += 1
            seq = self._seq
            off = HDR_SIZE + ((seq - 1) % self.slots) * REC_SIZE
            # Payload first, checksum last: a record is only claimed
            # intact once every payload byte it covers is in place.
            try:
                _REC.pack_into(
                    self._mm, off, _REC_MAGIC, 0, seq, now_us(),
                    int(etype) & 0xFFFF, int(code) & 0xFFFF,
                    _i64(a), _i64(b), _i64(c), bytes(tag)[:20],
                )
            except (struct.error, TypeError, ValueError):
                # A half-packed slot reads as torn — already the safe
                # outcome.  The recorder absorbing a bad value beats
                # an RPC handler dying for a telemetry write.
                return
            crc = zlib.crc32(self._mv[off + 8: off + REC_SIZE])
            _CRC.pack_into(self._mm, off + 4, crc)

    def mark(self, text: str) -> None:
        """Free-form harness marker (test phase boundaries etc.)."""
        self.record(MARK, tag=text)

    def flush(self) -> None:
        """Push dirty pages to disk now (tests; normal operation relies
        on the OS doing this even after SIGKILL)."""
        try:
            self._mm.flush()
        except (ValueError, OSError):
            pass

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        # Release the exported memoryview before the mmap (mmap.close
        # raises BufferError while exports are live).
        self._mv.release()
        try:
            self._mm.flush()
        except (ValueError, OSError):
            pass
        self._mm.close()


# Process-wide shared recorder (one ring per process, all nodes and
# subsystems write into it); created lazily on first use when
# MRT_FLIGHTREC_DIR is set.
_proc_rec: Optional[FlightRecorder] = None
_proc_lock = threading.Lock()


def get_recorder(name: str = "") -> Optional[FlightRecorder]:
    """The process-wide recorder, or ``None`` when flight recording is
    disabled (``MRT_FLIGHTREC_DIR`` unset).  The first caller creates
    ``flight-<pid>.ring`` and names it; later callers share it."""
    global _proc_rec
    d = knob_str("MRT_FLIGHTREC_DIR")
    if not d:
        return None
    with _proc_lock:
        if _proc_rec is None or _proc_rec.closed:
            _proc_rec = FlightRecorder(
                os.path.join(d, f"flight-{os.getpid()}.ring"),
                slots=knob_int("MRT_FLIGHTREC_SLOTS"),
                name=name or f"pid{os.getpid()}",
            )
    return _proc_rec


# -- reader ---------------------------------------------------------------


def read_ring(path: str) -> Dict[str, Any]:
    """Read a ring file back, dead process or live.

    Returns ``{"pid", "name", "wall_t0", "slots", "records", "torn",
    "clean_close"}`` where ``records`` is every intact record as a
    dict, ordered by ``seq`` (oldest intact first), and ``torn`` counts
    non-empty slots that failed validation (at most a handful: the
    slot(s) mid-write at the kill).  Raises ``ValueError`` on a file
    that was never a flight ring; tolerates truncation anywhere (the
    readable prefix of slots is scanned)."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < _HDR.size:
        raise ValueError(f"{path}: too short for a flight-ring header")
    magic, version, slots, rec_size, pid, wall_t0, name = _HDR.unpack_from(
        raw, 0
    )
    if magic != _HDR_MAGIC:
        raise ValueError(f"{path}: not a flight ring (bad header magic)")
    if version != _HDR_VERSION or rec_size != REC_SIZE:
        raise ValueError(
            f"{path}: unsupported ring version {version} / record size "
            f"{rec_size}"
        )
    records: List[Dict[str, Any]] = []
    torn = 0
    for s in range(slots):
        off = HDR_SIZE + s * REC_SIZE
        if off + REC_SIZE > len(raw):
            break  # truncated file: the remaining slots never existed
        rec = raw[off: off + REC_SIZE]
        (rmagic, crc, seq, ts, etype, code, a, b, c, tag) = _REC.unpack(rec)
        if rmagic == 0 and seq == 0:
            continue  # never-written slot
        if rmagic != _REC_MAGIC or zlib.crc32(rec[8:]) != crc:
            torn += 1  # torn mid-write by the kill — skip, keep going
            continue
        records.append({
            "seq": seq,
            "ts": ts,
            "type": etype,
            "type_name": type_name(etype),
            "code": code,
            "a": a,
            "b": b,
            "c": c,
            "tag": tag.rstrip(b"\x00").decode("utf-8", "replace"),
        })
    records.sort(key=lambda r: r["seq"])
    clean = bool(records) and records[-1]["type"] == NODE_CLOSE
    return {
        "pid": pid,
        "name": name.rstrip(b"\x00").decode("utf-8", "replace"),
        "wall_t0": wall_t0,
        "slots": slots,
        "records": records,
        "torn": torn,
        "clean_close": clean,
    }
