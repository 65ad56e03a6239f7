"""RPC endpoints over the native TCP transport.

Exposes the same contract the simulated network gives the framework —
``ClientEnd.call(svc_meth, args) → Future`` with ``None`` meaning "RPC
failed" (labrpc's boolean ``ok``, reference: labrpc/labrpc.go:87-126) —
but across real processes.  One :class:`RpcNode` per process owns one
epoll transport and one :class:`IoScheduler` whose loop thread IS the
IO dispatcher: the transport's read reactor runs inline as the loop's
idle wait, and every handler and future resolution runs on that same
thread — so RaftNode/KVServer/clerk code is byte-identical between sim
and deployment, and an inbound frame reaches its handler with zero
futex handoffs (kernel wakes the loop, the loop decodes and
dispatches).  Replies write inline from the loop thread (the
transport's idle-connection fast path), so a serial RPC round trip
costs two socket wakeups total.

Frames are codec-encoded tuples:

    ("req", req_id, svc_meth, args)             caller → callee
    ("req", req_id, svc_meth, args, trace_id)   …with a request id
    ("rep", req_id, value)                      callee → caller
    ("repb", [(req_id, value), ...])            coalesced multi-reply
    ("hello", caps)                             capability negotiation
    ("busy", req_id, retry_after_s)             admission shed (negotiated)

The optional fifth element is a compact trace/request id (Dapper-style)
appended only when the caller supplies one, so untagged traffic and old
peers keep the 4-tuple wire shape.  The dispatcher stows it in
``_cur_trace`` (loop-thread breadcrumb) and tags the handler span with
it — one clerk request is followable clerk → server → engine commit
across processes by grepping one id.

Wire fast path (negotiated, old peers unaffected): a connecting node
sends ``("hello", caps)`` as its first frame and the acceptor answers
with its own.  Unknown tags fall through ``_handle_msg`` silently, so
an old peer simply never upgrades.  Once a connection's peer caps are
known, two upgrades engage: **reply coalescing** — replies are queued
per connection and flushed once per scheduler-loop iteration (the
``io_flush`` hook fires after every timer burst, before the loop
blocks), so the N replies one pump produces leave as one vectored
write, packed into a single ``repb`` frame when the peer speaks it —
and **out-of-band encoding** (``codec.encode_oob``), which ships numpy
columns and large blobs as raw buffer segments instead of copying them
through the pickle stream.  Requests are NOT queued: they may originate
off the loop thread and their latency is the caller's; only replies
(loop-thread-only by construction) coalesce.

Handlers returning generator coroutines (the wait-channel pattern,
reference: kvraft/server.go:56-96) are spawned; the reply ships when
their future resolves.  A dropped connection resolves all its pending
calls with ``None`` and the next call reconnects — the client-side
retry loops (reference: kvraft/client.go:47-71) handle the rest.

Fault injection: when ``self.chaos`` is set (see chaos.py), outbound
requests, inbound frames, and outbound replies each consult it —
dropped requests leave the caller's future unresolved (labrpc's lost
RPC; the caller's own timeout fires), delays reschedule the frame on
the loop, and ``sever`` cuts live connections mid-stream.  The hot
path pays one ``is None`` check per frame when chaos is off.
"""

from __future__ import annotations

import itertools
import os
import struct
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..sim.scheduler import Future
from ..transport import codec
from ..utils.knobs import knob_bool, knob_int, knob_str
from . import flightrec
from .admission import lane_of
from .engine_wire import busy_reply
from .native import EV_ACCEPT, EV_CLOSED, EV_FRAME, NativeTransport
from .observe import (
    Observability,
    StageClock,
    install_obs,
    is_control,
    stageclock_enabled,
)
from .profile import maybe_start_profiler
from .realtime import IoScheduler
from .sanitize import get_sanitizer
from .tail import TailStore, exemplar_from_clock, tail_enabled

__all__ = ["RpcNode", "TcpClientEnd"]

# Wire capabilities this build understands (hello payload).  "oob" =
# protocol-5 out-of-band codec segments; "repb" = coalesced multi-reply
# frames; "busy" = the peer decodes ("busy", req_id, retry_after_s)
# admission-shed frames (admission.py) — without it a shed degrades to
# a silent drop and the caller's own timeout.  Caps only ever UPGRADE
# encoding — a dropped/severed hello (chaos may eat it) just leaves the
# connection on the legacy shapes.
_WIRE_CAPS = ("oob", "repb", "busy")
# Oldest a queued reply may get before a soft flush (the after-timer
# call) sends it.  Well above a ticket-resolution burst (microseconds,
# keeps batching) and below an engine pump tick (milliseconds, must not
# wait out another one).
_FLUSH_MAX_AGE_S = 500e-6
# A blob reply at least this large flushes immediately instead of
# queueing: bulk results gate the (serial) sender's next frame, and the
# payload dwarfs any per-syscall saving batching could add.
_BULK_REPLY_BYTES = 2048

# Per-connection reply-queue cap (MRT_REPLY_Q_CAP overrides).  A client
# that stops draining its socket must not grow this node's memory: once
# a connection's queue hits the cap the OLDEST undelivered reply is
# shed (counted as rpc.reply_shed).  Shedding old over new is the right
# polarity for an RPC server — the caller of a shed reply has already
# timed out and retried, while the newest replies still have a waiting
# caller; session dedup keeps the retry exactly-once, the same
# machinery that already covers chaos-dropped replies.
_REPLY_Q_CAP = knob_int("MRT_REPLY_Q_CAP")
# Frame length prefix (big-endian u32) — must match transport.cpp's
# framing; send_parts writes raw so Python adds it per frame.
_U32 = struct.Struct(">I")


def _seg_len(seg: Any) -> int:
    return len(seg) if isinstance(seg, (bytes, bytearray)) else seg.nbytes


def _frame_header(nbytes: int) -> bytes:
    """Length prefix for one raw-written frame; the prefix is u32, so
    an oversized payload must fail loudly rather than wrap and desync
    the peer's frame parser."""
    if nbytes >= 2 ** 32:
        raise ValueError(
            f"frame payload of {nbytes} bytes overflows the u32 length "
            "prefix"
        )
    return _U32.pack(nbytes)


class TcpClientEnd:
    """ClientEnd bound to a ``(host, port)`` server address."""

    def __init__(self, node: "RpcNode", host: str, port: int) -> None:
        self._node = node
        self.addr = (host, port)

    def call(self, svc_meth: str, args: Any, trace: Optional[str] = None) -> Future:
        return self._node._call(self.addr, svc_meth, args, trace)


class RpcNode:
    """One process's RPC endpoint: optional listener + outbound calls."""

    _trace_seq = itertools.count()  # unique trace filenames per process

    def __init__(
        self,
        listen: bool = False,
        host: str = "127.0.0.1",
        port: int = 0,
    ) -> None:
        self._tr = NativeTransport()
        self.host, self.port = host, 0
        if listen:
            self.port = self._tr.listen(host, port)
        self._services: Dict[str, Any] = {}
        self._handlers: Dict[str, Any] = {}  # "Svc.Meth" → bound method
        self._req_ids = itertools.count(1)
        self._lock = threading.Lock()
        # req_id → (conn, fut, svc_meth, t0, trace_id)
        self._pending: Dict[int, Tuple] = {}
        self._conns: Dict[Tuple[str, int], int] = {}  # addr → conn id
        self._accepted: set = set()  # inbound conn ids (for sever)
        self._closed = False
        # Wire fast path state.  _peer_caps: conn → negotiated caps
        # (written on the loop thread, read anywhere — dict ops are
        # atomic under the GIL).  _outq: conn → [(req_id, value), ...]
        # replies awaiting the per-iteration flush; LOOP THREAD ONLY.
        self._peer_caps: Dict[int, frozenset] = {}
        self._hello_sent: set = set()
        self._outq: Dict[int, List[Tuple[int, Any]]] = {}
        self._outq_since: float = 0.0  # when _outq went non-empty
        # Fault injection (chaos.py ChaosState); None = clean network.
        self.chaos = None
        # Admission control (admission.py install_admission); None =
        # every request dispatches.  The hot path pays one `is None`
        # check per inbound request when admission is off.
        self.admission = None
        # MRT_WIRE_LEGACY=1: operational kill-switch for the wire fast
        # path — no hello (so peers never negotiate oob/repb) and
        # replies ship immediately per frame instead of through the
        # per-iteration flush.  A/B lever and escape hatch.
        self._legacy_wire = knob_bool("MRT_WIRE_LEGACY")
        # MRT_DEBUG_RPC=1 traces every frame to stderr (wire-level debug).
        self._dbg = knob_bool("MRT_DEBUG_RPC")
        # The per-process observability plane: counters + bounded span
        # buffer, always on (a dict bump and one dict append per RPC),
        # scrapeable over the node's own socket via the "Obs" service.
        name = f"pid{os.getpid()}:{self.port}" if listen else None
        self.obs = Observability(name=name)
        self.obs.node = self
        self._cur_trace: Optional[str] = None
        # Stage-clock plane (observe.py): tagged requests carry their
        # send stamp in the rid wire element and every hop folds a
        # delta into a per-stage histogram.  MRT_STAGECLOCK=0 compiles
        # it out — no stamp, no StageClock, no folds (the A/B lever
        # for the overhead budget).
        self._stageclock = stageclock_enabled()
        self._cur_stages: Optional[StageClock] = None
        # conn → (reply-enqueue perf_counter stamp, StageClock|None)
        # pairs, strictly parallel to _outq (appended/shed/flushed/
        # closed together), so the flush fold knows how long each reply
        # coalesced and can finalize the request's tail exemplar with
        # its reply-queue age included.  LOOP THREAD ONLY, bounded by
        # _REPLY_Q_CAP like its twin.
        self._outq_stamps: Dict[int, List[Tuple[float, Optional[StageClock]]]] = {}
        # Loop-thread breadcrumb carrying the finished request's
        # StageClock from _done's reply() call into _reply's stamp
        # append (reply() is synchronous on the loop thread; a chaos
        # reply delay drops the breadcrumb, losing only that
        # exemplar).
        self._reply_st: Optional[StageClock] = None
        install_obs(self)
        # Continuous sampling profiler (profile.py): one per-process
        # daemon sampler shared by every node, default-on (MRT_PROFILE
        # gates), drained over this node's socket via Obs.profile.
        maybe_start_profiler()
        # Crash-surviving black box (flightrec.py): fixed-width event
        # records in an mmap ring, shared process-wide, env-gated
        # (MRT_FLIGHTREC_DIR).  None = disabled = zero hot-path cost
        # beyond one `is None` check per frame.
        self._frec = flightrec.get_recorder(name=name or "")
        # Tail microscope (tail.py): bounded per-request lifecycle
        # exemplar store, drained fleet-wide via Obs.tail.  Rides on
        # the stage-clock plane (no stamps → no lifecycle vector), so
        # both MRT_STAGECLOCK=0 and MRT_TAIL=0 compile it out; None =
        # off = no per-request dict, no offer.
        self.tail: Optional[TailStore] = (
            TailStore(frec=self._frec)
            if (self._stageclock and tail_enabled()) else None
        )
        # Runtime sanitizer (MRT_SANITIZE=1, sanitize.py): wraps this
        # node's and its transport's locks in order-recording proxies
        # (acyclicity asserted on every new edge) and checks the reply
        # queue's cap at every growth site.  None = off = zero cost.
        self._san = get_sanitizer()
        if self._san is not None:
            self._san.install_locks(self, {"_lock": "RpcNode._lock"})
            self._san.install_locks(
                self._tr, {"_lock": "NativeTransport._lock"}
            )
            self._san.register_metrics(self.obs.metrics)
        # MRT_TRACE_DIR=<dir>: save the span buffer on close().  Engine
        # servers additionally point their driver's tick spans at the
        # same tracer (via ``self.tracer``), so one timeline shows RPC
        # handling interleaved with device ticks.  Listening nodes only
        # — pure clients handle no RPCs and would litter the dir with
        # empty files.
        self.tracer = None
        self._trace_path = None
        trace_dir = knob_str("MRT_TRACE_DIR")
        if trace_dir and listen:
            os.makedirs(trace_dir, exist_ok=True)
            self.tracer = self.obs.tracer
            # Process-local counter, not id(self): CPython recycles ids,
            # and a recycled id would overwrite an earlier node's trace.
            seq = next(RpcNode._trace_seq)
            self._trace_path = os.path.join(
                trace_dir, f"rpc-{os.getpid()}-{seq}.json"
            )
        # Adaptive busy-poll: a serial RPC's next event lands tens of
        # µs out, so spinning that long before blocking removes the
        # futex wake from the round trip.  Pointless (and harmful —
        # the spinner starves the peer) on a single-CPU box, so the
        # default is gated on the AFFINITY-aware cpu count (a process
        # pinned to one core of a big host is a single-CPU box for
        # this purpose).  MRT_SPIN_US overrides.
        from ..utils.cpus import usable_cpus

        default_spin = 40 if usable_cpus() > 1 else 0
        self._tr.set_spin(knob_int("MRT_SPIN_US", default=default_spin))
        # Span construction is gated off the untraced hot path: only
        # tagged requests (trace_id present) or a trace-dir run build
        # span dicts; everything else is a counter bump (see _dispatch).
        self._trace_all = self.tracer is not None
        # The loop thread doubles as the transport's read reactor; it
        # owns all handler execution and future resolution.  io_flush
        # drains the reply queue once per loop iteration.
        # Loop thread named per node (listeners by port, clients by a
        # process-local seq) — profiler attribution and postmortem
        # lines stay readable when one process hosts several nodes.
        self.sched = IoScheduler(
            self._tr.poll, self._on_event, self._tr.wake,
            io_flush=self._flush_replies,
            name=(f"multiraft-loop/{self.port}" if listen
                  else f"multiraft-loop/client{next(RpcNode._trace_seq)}"),
        )

    # -- service side ------------------------------------------------------

    def add_service(self, name: str, obj: Any) -> None:
        """Register ``obj`` under ``name``; ``name.method`` dispatches to
        ``obj.method`` (CamelCase RPC names map via lowercase_underscore,
        mirroring the sim network's Service dispatch)."""
        self._services[name] = obj
        # Drop cached handlers bound to a previously registered object.
        self._handlers = {
            k: v for k, v in self._handlers.items()
            if not k.startswith(name + ".")
        }

    def client_end(self, host: str, port: int) -> TcpClientEnd:
        return TcpClientEnd(self, host, port)

    # -- internals ---------------------------------------------------------

    def _conn_for(self, addr: Tuple[str, int]) -> Optional[int]:
        # The addr→cid store must happen under the same lock section as
        # the connect itself: a failed non-blocking handshake can emit
        # EV_CLOSED before this thread stores the mapping, and
        # ``_on_closed`` (poller thread) must block on the lock until the
        # entry exists — otherwise the dead cid is cached forever and the
        # address goes permanently dark.
        with self._lock:
            cid = self._conns.get(addr)
            if cid is not None:
                return cid
            try:
                cid = self._tr.connect(*addr)
            except ConnectionError:
                return None
            self._conns[addr] = cid
            # First frame out: offer our wire caps.  The transport
            # queues it until the handshake completes, so it always
            # precedes every request on this connection.
            if not self._legacy_wire:
                # Bounded by open connections (discarded on close).
                self._hello_sent.add(cid)  # graftlint: disable=unbounded-queue
                try:
                    self._tr.send(cid, codec.encode(("hello", _WIRE_CAPS)))
                except Exception:
                    pass  # negotiation is best-effort; legacy shapes remain
        return cid

    def _call(
        self,
        addr: Tuple[str, int],
        svc_meth: str,
        args: Any,
        trace_id: Optional[str] = None,
    ) -> Future:
        fut = Future()
        m = self.obs.metrics
        m.inc("rpc.calls")
        if trace_id is not None and self._stageclock:
            # The clerk-send stamp: the rid element becomes
            # (rid, t_send).  CLOCK_MONOTONIC is machine-wide, so the
            # server can fold the wire leg directly on one box; the
            # fleet aggregator's clock alignment covers the rest.
            trace_id = (trace_id, time.perf_counter())
        chaos = self.chaos
        if chaos is not None and not is_control(svc_meth):
            act = chaos.decide_out(addr)
            if act == "drop":
                # Lost request: the future never resolves — the
                # caller's with_timeout fires and its retry loop takes
                # over (labrpc's "server never heard it").
                m.inc("rpc.chaos_out_dropped")
                return fut
            if act != "pass":  # a delay in seconds
                m.inc("rpc.chaos_out_delayed")
                self.sched.call_after(
                    act, self._send_request, addr, svc_meth, args, fut, trace_id
                )
                return fut
        self._send_request(addr, svc_meth, args, fut, trace_id)
        return fut

    def _send_request(
        self,
        addr: Tuple[str, int],
        svc_meth: str,
        args: Any,
        fut: Future,
        trace_id: Optional[str] = None,
    ) -> None:
        m = self.obs.metrics
        cid = self._conn_for(addr)
        if cid is None:
            # Resolve asynchronously so callers may attach callbacks first.
            m.inc("rpc.conn_fail")
            self.sched.call_soon(fut.resolve, None)
            return
        req_id = next(self._req_ids)
        with self._lock:
            self._pending[req_id] = (
                cid, fut, svc_meth, time.perf_counter(), trace_id
            )
        if trace_id is None:
            frame = ("req", req_id, svc_meth, args)
        else:
            frame = ("req", req_id, svc_meth, args, trace_id)
        caps = self._peer_caps.get(cid)
        if caps is not None and "oob" in caps:
            segs = codec.encode_oob(frame)
            nbytes = sum(_seg_len(s) for s in segs)
            if len(segs) > 1:
                m.inc("rpc.oob_buffers", len(segs) - 1)
                ok = self._tr.send_parts(cid, [_frame_header(nbytes), *segs])
            else:
                ok = self._tr.send(cid, segs[0])
        else:
            buf = codec.encode(frame)
            nbytes = len(buf)
            ok = self._tr.send(cid, buf)
        if not ok:
            # The transport no longer knows this conn (torn down between
            # our lookup and the send) — drop the stale cache entry so the
            # next call reconnects instead of failing fast forever.
            with self._lock:
                self._pending.pop(req_id, None)
                if self._conns.get(addr) == cid:
                    del self._conns[addr]
            m.inc("rpc.conn_fail")
            self.sched.call_soon(fut.resolve, None)
            return
        m.inc("rpc.frames_out")
        m.inc("rpc.bytes_out", nbytes)
        fr = self._frec
        if fr is not None and not is_control(svc_meth):
            fr.record(
                flightrec.RPC_OUT, a=req_id, b=nbytes, tag=svc_meth
            )

    def _on_event(self, ev: Tuple[int, int, bytes]) -> None:
        # Runs on the scheduler loop (the IO reactor thread).
        conn, typ, payload = ev
        if typ == EV_FRAME:
            # One malformed frame must never kill the loop — the node
            # would go permanently dark.  Shape errors (IndexError on
            # msg[...]) are as fatal as decode errors.
            t_read = time.perf_counter() if self._stageclock else None
            m = self.obs.metrics
            m.inc("rpc.frames_in")
            m.inc("rpc.bytes_in", len(payload))
            try:
                # cpu.wire_s: ingress decode's CPU cost (thread-CPU
                # delta around the decode — the profiling plane's
                # cost-accounting twin of the wall stage clock).
                c0 = time.thread_time() if t_read is not None else 0.0
                msg = codec.decode(payload)
                if t_read is not None:
                    m.observe("cpu.wire_s", time.thread_time() - c0)
                if self._dbg:
                    # Tracing must never affect delivery: a repr or
                    # stderr failure here is swallowed, not treated
                    # as a bad frame.
                    try:
                        head = f"{msg[0]} conn={conn} " + (
                            f"{msg[2]} {msg[3]!r}" if msg[0] == "req" else f"{msg[2]!r}"
                        )
                        print(f"[rpc] {head}"[:220], file=sys.stderr, flush=True)
                    except Exception:
                        pass
                chaos = self.chaos
                if chaos is not None and not (
                    msg[0] == "req" and is_control(msg[2])
                ):
                    # Control frames (Chaos./Obs.) are exempt: a chaos
                    # layer that can partition away its own antidote —
                    # or blind the observer watching it — wedges the run.
                    act = chaos.decide_in()
                    if act == "drop":
                        m.inc("rpc.chaos_in_dropped")
                        return
                    if act != "pass":  # delayed delivery (may reorder)
                        m.inc("rpc.chaos_in_delayed")
                        self.sched.call_after(
                            act, self._handle_msg, conn, msg
                        )
                        return
                self._handle_msg(conn, msg, t_read)
            except Exception as exc:
                m.inc("rpc.bad_frames")
                if self._dbg:
                    print(f"[rpc] bad frame dropped: {exc!r}",
                          file=sys.stderr, flush=True)
        elif typ == EV_ACCEPT:
            self._accepted.add(conn)
        elif typ == EV_CLOSED:
            self.obs.metrics.inc("rpc.conns_closed")
            self._accepted.discard(conn)
            self._on_closed(conn)

    def _handle_msg(
        self, conn: int, msg: Any, t_read: Optional[float] = None
    ) -> None:
        if msg[0] == "req":
            # 4-tuple = untagged (old wire shape); 5th element = trace id.
            trace_id = msg[4] if len(msg) > 4 else None
            self._dispatch(conn, msg[1], msg[2], msg[3], trace_id, t_read)
        elif msg[0] == "rep":
            _, req_id, value = msg
            self._complete(req_id, value)
        elif msg[0] == "repb":
            # Coalesced multi-reply (negotiated; we asked for it via
            # hello, so the peer knows we decode it).
            for req_id, value in msg[1]:
                self._complete(req_id, value)
        elif msg[0] == "busy":
            # Admission shed at the peer (negotiated "busy" cap):
            # resolve the pending call NOW with an ErrBusy reply
            # carrying the retry hint, instead of letting the caller
            # burn its full timeout on a request the server refused.
            hint = float(msg[2]) if len(msg) > 2 else 0.0
            self.obs.metrics.inc("rpc.busy_in")
            self._complete(msg[1], busy_reply(hint))
        elif msg[0] == "hello":
            # Peer capability offer.  Answer once per connection with
            # ours (the acceptor side of the handshake); the initiator
            # already sent its hello at connect time.  A legacy-wire
            # node stays silent: never answering keeps the peer on the
            # legacy shapes in BOTH directions.
            if self._legacy_wire:
                return
            self._peer_caps[conn] = frozenset(msg[1])
            if conn not in self._hello_sent:
                # Bounded by open connections (discarded on close).
                self._hello_sent.add(conn)  # graftlint: disable=unbounded-queue
                try:
                    self._tr.send(conn, codec.encode(("hello", _WIRE_CAPS)))
                except Exception:
                    pass

    def _complete(self, req_id: int, value: Any) -> None:
        with self._lock:
            entry = self._pending.pop(req_id, None)
        if entry is not None:
            _, fut, svc_meth, t0, trace_id = entry
            dt = time.perf_counter() - t0
            self.obs.metrics.observe("rpc.client.call_s", dt)
            if type(trace_id) is tuple:
                # Stage-clocked call: rid element is (rid, t_send).
                # Fold the end-to-end leg on the CLIENT's registry —
                # the number the load curve plots against the
                # server-side decomposition.
                trace_id = trace_id[0]
                self.obs.metrics.observe("stage.total_s", dt)
            fr = self._frec
            if fr is not None and not is_control(svc_meth):
                fr.record(
                    flightrec.RPC_CLIENT, a=int(dt * 1e6),
                    b=int(value is not None), tag=svc_meth,
                )
            if trace_id is not None:
                # Caller-side leg of the cross-process span pair.
                self.obs.tracer.span(
                    svc_meth, t0 * 1e6, dt * 1e6, track="rpc-out",
                    req=trace_id,
                )
            fut.resolve(value)

    def _on_closed(self, conn: int) -> None:
        # Mid-stream loss drops queued-but-unflushed replies with the
        # connection — same contract as bytes lost in the kernel buffer.
        self._outq.pop(conn, None)
        self._outq_stamps.pop(conn, None)
        self._peer_caps.pop(conn, None)
        self._hello_sent.discard(conn)
        if self.admission is not None:
            self.admission.conn_closed(conn)
        with self._lock:
            for addr, cid in list(self._conns.items()):
                if cid == conn:
                    del self._conns[addr]
            dead = [
                (rid, entry[1])
                for rid, entry in self._pending.items()
                if entry[0] == conn
            ]
            for rid, _ in dead:
                del self._pending[rid]
        if dead:
            self.obs.metrics.inc("rpc.pending_failed", len(dead))
        for _, fut in dead:
            fut.resolve(None)

    def _dispatch(
        self,
        conn: int,
        req_id: int,
        svc_meth: str,
        args: Any,
        trace_id: Optional[str] = None,
        t_read: Optional[float] = None,
    ) -> None:
        # Runs on the scheduler loop.  Admission first: a shed request
        # must cost decode + one small frame, nothing downstream of
        # here (no handler, no stage clock, no span).
        adm = self.admission
        lane = None
        if adm is not None:
            lane = lane_of(svc_meth, trace_id)
            hint = adm.admit(conn, lane)
            if hint is not None:
                tl = self.tail
                if tl is not None and type(trace_id) is tuple:
                    # Shed requests bypass the stage clocks (nothing
                    # downstream runs) but still belong in the tail
                    # story: the exemplar records the admission outcome
                    # and the two waits the request DID accrue before
                    # being refused.  Stat histograms stay untouched —
                    # sheds must not skew the stage percentiles.
                    s_rid, s_t_send = trace_id
                    now = time.perf_counter()
                    tr = t_read if t_read is not None else now
                    wire = max(0.0, tr - s_t_send)
                    disp = max(0.0, now - tr)
                    tl.offer({
                        "rid": s_rid, "outcome": "shed", "tick": -1,
                        "total_s": round(wire + disp, 6),
                        "stages": {"wire": round(wire, 6),
                                   "dispatch": round(disp, 6)},
                        "waits": {"wire": round(wire, 6),
                                  "dispatch": round(disp, 6),
                                  "pump": 0.0, "flush": 0.0},
                    })
                self._shed(conn, req_id, hint)
                return
        # Control replies bypass reply chaos (same exemption as the
        # inbound path).
        reply = self._reply if is_control(svc_meth) else self._reply_chaos
        obs = self.obs
        obs.metrics.inc("rpc.handled")
        t0 = time.perf_counter()
        c0 = time.thread_time() if self._stageclock else None

        # Stage clock: a tuple rid element is (rid, t_send) from a
        # stage-clocked caller.  Fold the wire leg (send → socket read)
        # and the dispatch leg (read → here: decode, chaos delay, loop
        # backlog), then hand the clock to the handler via the
        # loop-thread breadcrumb.
        st = None
        if type(trace_id) is tuple:
            rid, t_send = trace_id
            trace_id = rid
            if self._stageclock:
                # The lifecycle vector dict exists only when the tail
                # plane will read it — stage histograms alone need no
                # per-request allocation.
                st = StageClock(
                    rid, t_send,
                    vec={} if self.tail is not None else None,
                )
                st.fold(
                    obs.metrics, "wire",
                    t_read if t_read is not None else t0,
                )
                st.fold(obs.metrics, "dispatch", t0)

        # Span dicts are only built when someone will read them: a
        # tagged request (cross-process follow-the-id) or a trace-dir
        # run.  The untraced hot path is a counter bump + one observe.
        want_span = trace_id is not None or self._trace_all

        frec = self._frec

        def _done(conn_, req_id_, value):
            ca = time.thread_time() if c0 is not None else 0.0
            if adm is not None:
                # Frees this dispatch's slot in the bounded
                # per-connection queue (pairs with the admit above).
                adm.release(conn_, lane)
            dt = time.perf_counter() - t0
            obs.metrics.observe("rpc.handle_s", dt)
            if st is not None:
                # Engine handlers folded handler/engine themselves and
                # this closes the ack leg (commit → reply enqueue);
                # plain handlers close their whole body as handler.
                st.fold(obs.metrics, "ack" if st.engine else "handler")
                if st.vec is not None:
                    # Ambient context rides on the exemplar: what the
                    # process looked like the moment this request
                    # finished (the exemplar is finalized — and the
                    # reply-queue age folded — at flush).
                    st.ambient = self._tail_ambient(conn_)
            if frec is not None and not is_control(svc_meth):
                frec.record(
                    flightrec.RPC_HANDLE, a=int(dt * 1e6),
                    b=int(value is not None), tag=svc_meth,
                )
            if want_span:
                sargs: Dict[str, Any] = {
                    "outcome": "ok" if value is not None else "none"
                }
                if trace_id is not None:
                    sargs["req"] = trace_id
                obs.tracer.span(
                    svc_meth, t0 * 1e6, dt * 1e6, track="rpc", **sargs
                )
            if st is not None and st.vec is not None:
                self._reply_st = st
            reply(conn_, req_id_, value)
            self._reply_st = None
            if c0 is not None:
                # cpu.ack_s: completion bookkeeping + reply enqueue
                # (the flush write itself lands in cpu.flush_s).
                obs.metrics.observe("cpu.ack_s", time.thread_time() - ca)

        try:
            handler = self._handlers.get(svc_meth)
            if handler is None:
                svc_name, meth = svc_meth.split(".", 1)
                obj = self._services[svc_name]
                handler = getattr(obj, _snake(meth))
                self._handlers[svc_meth] = handler
            # Loop-thread-only breadcrumbs: _cur_conn lets a handler
            # exempt the connection its own request rode in on
            # (Chaos.sever must not cut the control channel out from
            # under its reply); _cur_trace carries the request id so
            # service code can tag downstream spans with it.
            self._cur_conn = conn
            self._cur_trace = trace_id
            self._cur_stages = st
            if c0 is not None:
                # cpu.dispatch_s: admission + stage setup + handler
                # lookup; cpu.handler_s: the synchronous handler body
                # (generator handlers count creation here and fold
                # their own submit cost — see engine_server.command).
                ch = time.thread_time()
                obs.metrics.observe("cpu.dispatch_s", ch - c0)
                result = handler(args)
                obs.metrics.observe(
                    "cpu.handler_s", time.thread_time() - ch
                )
            else:
                result = handler(args)
        except Exception:
            obs.metrics.inc("rpc.handler_errors")
            result = None
        if _is_gen(result):
            # Guard the coroutine body too: a handler that raises mid-wait
            # must still produce a reply (None = "RPC failed"), or the
            # caller retries the same failing request forever.
            reply_fut = self.sched.spawn(_guarded(result))
            reply_fut.add_done_callback(
                lambda f: _done(conn, req_id, f.value)
            )
        else:
            _done(conn, req_id, result)

    def _tail_ambient(self, conn: int) -> Dict[str, Any]:
        """Completion-time context for a tail exemplar (loop thread,
        cheap attribute reads only): the queue depths and degradation
        state a human asks about first when staring at an outlier —
        was the process deep in replies, shedding, browned out, or
        inside a chaos window when this request finished?"""
        amb: Dict[str, Any] = {"replyq": len(self._outq.get(conn, ()))}
        adm = self.admission
        if adm is not None:
            amb["inflight"] = adm.inflight_total()
            amb["adm_level"] = adm.level
        ow = getattr(self, "overload_watch", None)
        if ow is not None:
            amb["brownout"] = ow.brownout.state
        ch = self.chaos
        if ch is not None:
            active = [
                k for k in ("all_in", "all_out", "reply")
                if getattr(ch, k, None) is not None
            ]
            if ch.peer_out:
                active.append("peer_out")
            if active:
                amb["chaos"] = active
        return amb

    def _shed(self, conn: int, req_id: int, retry_after_s: float) -> None:
        """Admission refused the request.  A busy-capable peer gets an
        immediate ``("busy", ...)`` frame — shed replies must not wait
        out a coalescing flush; their whole point is a fast hint.  A
        legacy peer (no hello, or MRT_WIRE_LEGACY) gets nothing: the
        unknown tag would fall through its ``_handle_msg`` anyway, so
        the shed degrades to a silent drop and the caller's ordinary
        timeout + backoff — the pre-round-8 overload behavior."""
        m = self.obs.metrics
        m.inc("rpc.shed")
        caps = self._peer_caps.get(conn)
        if caps is None or "busy" not in caps:
            return
        try:
            buf = codec.encode(("busy", req_id, retry_after_s))
            self._tr.send(conn, buf)
            m.inc("rpc.frames_out")
            m.inc("rpc.bytes_out", len(buf))
        except Exception:
            m.inc("rpc.reply_send_fail")

    def _reply_chaos(self, conn: int, req_id: int, value: Any) -> None:
        """Reply path with fault injection: labrpc's dropped-reply case
        — the handler RAN (the op may have applied), the caller never
        learns.  Only session dedup keeps the ensuing retry
        exactly-once, which is exactly the bug class this exercises."""
        chaos = self.chaos
        if chaos is not None:
            act = chaos.decide_reply()
            if act == "drop":
                self.obs.metrics.inc("rpc.replies_dropped")
                return
            if act != "pass":
                self.obs.metrics.inc("rpc.replies_delayed")
                self.sched.call_after(act, self._reply, conn, req_id, value)
                return
        self._reply(conn, req_id, value)

    def _reply(self, conn: int, req_id: int, value: Any) -> None:
        # Queue for the end-of-iteration flush.  Replies are produced
        # on the loop thread by construction (dispatch, future
        # callbacks, chaos-delay timers all run there), so every reply
        # from one timer burst coalesces into one vectored write per
        # connection; a non-loop caller (defensive) sends immediately.
        if not self._legacy_wire and self.sched.on_loop_thread():
            if not self._outq:
                self._outq_since = time.perf_counter()
            q = self._outq.setdefault(conn, [])
            if len(q) >= _REPLY_Q_CAP:
                q.pop(0)  # shed-oldest: that caller already retried
                self.obs.metrics.inc("rpc.reply_shed")
            q.append((req_id, value))
            if self._stageclock:
                # Parallel enqueue stamp for the flush-stage fold;
                # shed/flushed/closed in lockstep with q above, so the
                # reply cap bounds this list too.
                sq = self._outq_stamps.setdefault(conn, [])
                if len(sq) >= len(q):
                    sq.pop(0)  # twin of the shed above
                sq.append((time.perf_counter(), self._reply_st))  # graftlint: disable=unbounded-queue
            if self._san is not None:
                self._san.guard_queue("rpc.outq", len(q), _REPLY_Q_CAP)
            # Bulk blob replies (a firehose frame's results) gate a
            # serial client's next frame: flush now — mid-tick, like
            # the legacy inline send — instead of riding out the rest
            # of a pump tick.  Anything already queued coalesces in.
            if (
                isinstance(value, (bytes, bytearray, memoryview))
                and len(value) >= _BULK_REPLY_BYTES
            ):
                self._flush_replies()
            return
        self._reply_now(conn, req_id, value)

    def _reply_now(self, conn: int, req_id: int, value: Any) -> None:
        try:
            buf = codec.encode(("rep", req_id, value))
            self._tr.send(conn, buf)
            m = self.obs.metrics
            m.inc("rpc.frames_out")
            m.inc("rpc.bytes_out", len(buf))
        except Exception:
            self.obs.metrics.inc("rpc.reply_send_fail")

    def _flush_replies(self, force: bool = True) -> None:
        """Drain the per-connection reply queues.  The scheduler calls
        this forced right before it blocks in the poller (no reply ever
        waits out an idle sleep) and soft (``force=False``) after every
        timer callback.  The soft call flushes only once the oldest
        queued reply has aged past ``_FLUSH_MAX_AGE_S``: back-to-back
        cheap callbacks (a pump burst resolving tickets) keep batching,
        but a reply never waits out more than ~one engine tick when the
        timer heap is saturated and the before-poll flush would starve.
        Each connection's batch leaves as ONE vectored write: a single
        ``repb`` frame when the peer negotiated it, else its frames
        back to back in one syscall."""
        q = self._outq
        if not q:
            return
        if not force and (
            time.perf_counter() - self._outq_since < _FLUSH_MAX_AGE_S
        ):
            return
        self._outq = {}
        stamps_by_conn, self._outq_stamps = self._outq_stamps, {}
        m = self.obs.metrics
        cf = time.thread_time() if self._stageclock else None
        if stamps_by_conn:
            # Flush-stage fold: how long each reply coalesced between
            # enqueue and this vectored write (stat-only; folded even
            # for a failed send — the reply left the queue either way).
            # Stamps carrying a StageClock fold through it instead, so
            # the flush leg lands in the lifecycle vector too and the
            # completed exemplar — total now closed t0→flush — goes to
            # the tail store.
            t_flush = time.perf_counter()
            tl = self.tail
            for stamps in stamps_by_conn.values():
                for ts, st in stamps:
                    if st is None:
                        m.observe("stage.flush_s", t_flush - ts)
                        continue
                    st.fold(m, "flush", t_flush)
                    if tl is not None:
                        # Deferred build: the store decides from the
                        # total alone whether this completion is kept;
                        # dropped ones (saturation past the SLO cap)
                        # never materialize their exemplar dicts.
                        tl.offer_deferred(
                            max(0.0, st.last - st.t0),
                            lambda st=st: exemplar_from_clock(
                                st, ambient=st.ambient
                            ),
                        )
        for conn, pairs in q.items():
            caps = self._peer_caps.get(conn)
            oob = caps is not None and "oob" in caps
            try:
                if caps is not None and "repb" in caps and len(pairs) > 1:
                    frames: List[Tuple] = [("repb", pairs)]
                else:
                    frames = [("rep", rid, val) for rid, val in pairs]
                parts: List[Any] = []
                nbytes = 0
                for fr in frames:
                    segs = codec.encode_oob(fr) if oob else [codec.encode(fr)]
                    if len(segs) > 1:
                        m.inc("rpc.oob_buffers", len(segs) - 1)
                    n = sum(_seg_len(s) for s in segs)
                    parts.append(_frame_header(n))
                    parts.extend(segs)
                    nbytes += n
                if len(parts) == 2 and isinstance(parts[1], bytes):
                    # Lone in-band reply: the transport's plain send
                    # frames and writes header‖body in one shot, without
                    # the vectored path's per-part pointer marshalling.
                    ok = self._tr.send(conn, parts[1])
                else:
                    ok = self._tr.send_parts(conn, parts)
                if not ok:
                    m.inc("rpc.reply_send_fail", len(pairs))
                    continue
                m.inc("rpc.frames_out", len(frames))
                m.inc("rpc.bytes_out", nbytes)
                m.inc("rpc.flushes")
                # Counter twin of the sample: flush_replies / flushes
                # is the exact mean coalescing factor (samples only
                # surface percentiles in snapshots).
                m.inc("rpc.flush_replies", len(pairs))
                m.observe("rpc.frames_per_flush", float(len(pairs)))
            except Exception:
                m.inc("rpc.reply_send_fail", len(pairs))
        if cf is not None:
            # cpu.flush_s: reply encode + vectored write for the whole
            # batch (one segment per flush, not per reply).
            m.observe("cpu.flush_s", time.thread_time() - cf)

    def sever(
        self,
        addr: Optional[Tuple[str, int]] = None,
        exclude: Optional[int] = None,
    ) -> int:
        """Forcibly close live connections (chaos: mid-stream
        connection loss).  ``addr`` limits the cut to that outbound
        edge; ``None`` cuts every connection this node knows about —
        outbound and accepted, except ``exclude`` (the control
        connection a Chaos.sever request arrived on — cutting it would
        strand the reply).  Local pending calls on the cut connections
        fail immediately (resolve ``None``); the peer sees EV_CLOSED
        and fails its own side.  Returns the number cut."""
        with self._lock:
            if addr is not None:
                cid = self._conns.get(addr)
                cids = [cid] if cid is not None else []
            else:
                cids = list(self._conns.values()) + list(self._accepted)
        cids = [c for c in cids if c != exclude]
        for cid in cids:
            self._tr.close_conn(cid)
            self._accepted.discard(cid)
            # close_conn is locally silent (no EV_CLOSED to ourselves):
            # fail the pending calls and drop the addr cache now, the
            # way a remote reset would.
            self._on_closed(cid)
        return len(cids)

    def close(self) -> None:
        """Stop the scheduler loop (joining the reactor thread), then
        tear down the transport.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        self.sched.stop()
        self._tr.close()
        if self._frec is not None:
            # Clean-shutdown marker: its absence as the ring's last
            # record is how the postmortem doctor tells an unclean
            # death from an orderly exit.  The shared recorder itself
            # stays open (other nodes in this process still write).
            self._frec.record(flightrec.NODE_CLOSE, tag=self.obs.name)
        if self.tracer is not None and self._trace_path:
            try:
                self.tracer.save(self._trace_path)
            except Exception:
                pass  # tracing must never fail a shutdown


def _is_gen(obj: Any) -> bool:
    import types

    return isinstance(obj, types.GeneratorType)


def _guarded(gen):
    """Run a handler coroutine, converting an escaped exception into a
    ``None`` result (labrpc's "RPC failed") instead of a lost reply."""
    try:
        result = yield from gen
    except Exception:
        result = None
    return result


def _snake(name: str) -> str:
    """``RequestVote`` → ``request_vote``; already-snake names pass through."""
    out = []
    for i, ch in enumerate(name):
        if ch.isupper() and i > 0 and (name[i - 1].islower() or name[i - 1].isdigit()):
            out.append("_")
        out.append(ch.lower())
    return "".join(out)
