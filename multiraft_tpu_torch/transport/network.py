"""Simulated fault-injecting RPC fabric — the labrpc equivalent (the
PyTorch port's copy of ``multiraft_tpu/transport/network.py``; one
seeded RNG, drawn in the reference's order).

Multi-node-without-a-cluster: every "server" is an object registered in a
:class:`Network` under a name; every directed client→server edge is a
uniquely named :class:`ClientEnd` that can be individually enabled or
disabled, so partitions are per-edge and asymmetric-capable
(reference: labrpc/labrpc.go:316-364).

Fault model reproduced from ``Network.processReq``
(reference: labrpc/labrpc.go:221-312), on virtual time:

* disabled / unknown server → failure (``None``) after U(0, 100 ms), or
  U(0, 7 s) with ``long_delays`` — emulating a timeout.
* unreliable → U(0, 26 ms) request delay, then 10 % request drop
  (immediate failure), then 10 % reply drop after execution.
* ``long_reordering`` → 2/3 of surviving replies delayed a further
  200–2400 ms.
* replies from a server instance that has been deleted or replaced are
  suppressed (crash-before-reply; reference: labrpc/labrpc.go:267-277).

Unlike the reference there are no goroutines: a call returns a
:class:`~multiraft_tpu_torch.sim.scheduler.Future` resolved by scheduler events,
and all randomness comes from one seeded RNG, so runs are deterministic.

RPC payloads pass through :mod:`multiraft_tpu_torch.transport.codec` both ways,
giving value isolation and honest byte counters
(reference: labrpc/labrpc.go:375-383).  The codec writes the port's
registered classes under the reference package's module names, so the
byte counters equal the reference package's for the same traffic.
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Any, Callable, Dict, Optional

from ..sim.scheduler import Future, Scheduler
from ..utils.config import FaultModel, settings
from ..utils.metrics import Metrics
from . import codec

__all__ = ["Network", "ClientEnd", "Server", "Service"]

# Reliable-mode per-hop latency.  labrpc executes reliable RPCs
# "immediately" on a fresh goroutine; its measured cost is ~22 µs/RPC
# (reference: labrpc/test_test.go:596).  A small nonzero hop keeps
# happened-before ordering visible in virtual time.
RELIABLE_HOP_DELAY = 11e-6


class Service:
    """Dispatch wrapper exposing an object's public methods as RPC handlers
    (reference: labrpc/labrpc.go:481-516, reflection-based dispatch)."""

    def __init__(self, obj: Any, name: Optional[str] = None) -> None:
        self.obj = obj
        self.name = name or type(obj).__name__

    def dispatch(self, method: str, args: Any) -> Any:
        fn = getattr(self.obj, method, None)
        if fn is None or not callable(fn) or method.startswith("_"):
            raise KeyError(
                f"Service.dispatch: unknown method {self.name}.{method}"
            )
        return fn(args)


class Server:
    """A named collection of services (reference: labrpc/labrpc.go:387-443)."""

    def __init__(self) -> None:
        self._services: Dict[str, Service] = {}
        self.rpc_count = 0

    def add_service(self, svc: Service) -> None:
        self._services[svc.name] = svc

    def dispatch(self, svc_meth: str, args: Any) -> Any:
        self.rpc_count += 1
        svc_name, _, method = svc_meth.partition(".")
        svc = self._services.get(svc_name)
        if svc is None:
            raise KeyError(
                f"Server.dispatch: unknown service {svc_name} in {svc_meth}; "
                f"have {sorted(self._services)}"
            )
        return svc.dispatch(method, args)


class ClientEnd:
    """One directed client→server edge (reference: labrpc/labrpc.go:81-126)."""

    def __init__(self, network: "Network", endname: Any) -> None:
        self._network = network
        self.endname = endname

    def call(self, svc_meth: str, args: Any) -> Future:
        """Fire an RPC; the future resolves to the decoded reply, or
        ``None`` on drop/timeout/dead-server — labrpc's ``ok=false``."""
        return self._network._process(self.endname, svc_meth, args)


class Network:
    def __init__(
        self,
        sched: Scheduler,
        seed: int = 0,
        faults: Optional["FaultModel"] = None,
        metrics: Optional[Metrics] = None,
    ) -> None:
        self.sched = sched
        self.rng = random.Random(seed)
        self.reliable = True
        self.long_delays = False
        self.long_reordering = False
        # All fault constants come from the config system's FaultModel
        # (utils/config.py) — one authoritative copy of the labrpc
        # numbers instead of literals scattered through this file.
        self.faults = faults or settings().faults
        # RPC/byte accounting lives in a Metrics registry (shared with
        # the harness, utils/metrics.py); get_total_count()/get_count()
        # read through it.
        self.metrics = metrics or Metrics()
        self._ends: Dict[Any, ClientEnd] = {}
        self._servers: Dict[Any, Optional[Server]] = {}
        self._connections: Dict[Any, Any] = {}  # endname -> servername
        self._enabled: Dict[Any, bool] = {}
        self._count: Dict[Any, int] = defaultdict(int)  # delivered per server
        self._done = False
        # Optional utils.trace.Tracer: every RPC becomes a span
        # (send→resolve) tagged with its outcome; None = zero overhead.
        self.tracer = None

    def _trace_rpc(
        self, endname: Any, svc_meth: str, t0: float, end: float, status: str
    ) -> None:
        if self.tracer is not None:
            self.tracer.span(
                svc_meth,
                t0 * 1e6,
                (end - t0) * 1e6,
                track=str(endname),
                status=status,
            )

    # -- topology ---------------------------------------------------------

    def make_end(self, endname: Any) -> ClientEnd:
        if endname in self._ends:
            raise ValueError(f"make_end: {endname!r} already exists")
        end = ClientEnd(self, endname)
        self._ends[endname] = end
        self._enabled[endname] = False
        self._connections[endname] = None
        return end

    def add_server(self, servername: Any, server: Server) -> None:
        self._servers[servername] = server

    def delete_server(self, servername: Any) -> None:
        """Remove a server; in-flight replies from the old instance are
        suppressed (reference: labrpc/labrpc.go:267-277)."""
        self._servers[servername] = None

    def connect(self, endname: Any, servername: Any) -> None:
        self._connections[endname] = servername

    def enable(self, endname: Any, enabled: bool) -> None:
        self._enabled[endname] = enabled

    def set_reliable(self, yes: bool) -> None:
        self.reliable = yes

    def set_long_delays(self, yes: bool) -> None:
        self.long_delays = yes

    def set_long_reordering(self, yes: bool) -> None:
        self.long_reordering = yes

    def cleanup(self) -> None:
        self._done = True

    # -- statistics (reference: labrpc/labrpc.go:370-383) -----------------

    def get_count(self, servername: Any) -> int:
        return self._count[servername]

    def get_total_count(self) -> int:
        return self.metrics.counters["rpcs_total"]

    def get_total_bytes(self) -> int:
        return self.metrics.counters["bytes_total"]

    # -- the fault model --------------------------------------------------

    def _process(self, endname: Any, svc_meth: str, args: Any) -> Future:
        fut: Future = Future()
        if self._done:
            return fut  # never resolves after Cleanup, like a closed network
        self.metrics.inc("rpcs_total")
        req_bytes = codec.encode(args)
        t0 = self.sched.now

        enabled = self._enabled.get(endname, False)
        servername = self._connections.get(endname)
        server = self._servers.get(servername) if servername is not None else None

        if not enabled or server is None:
            # Simulate no reply and an eventual timeout
            # (reference: labrpc/labrpc.go:296-310).
            if self.long_delays:
                delay = self.rng.uniform(0, self.faults.long_dead_timeout)
            else:
                delay = self.rng.uniform(0, self.faults.dead_timeout)
            self.sched.call_after(delay, fut.resolve, None)
            self._trace_rpc(endname, svc_meth, t0, t0 + delay, "timeout")
            return fut

        delay = RELIABLE_HOP_DELAY
        if not self.reliable:
            # Short delay before the request arrives
            # (reference: labrpc/labrpc.go:228-231).
            delay += self.rng.uniform(0, self.faults.unreliable_delay)
            if self.rng.random() < self.faults.drop_request:
                # Drop the request: caller sees a failure quickly
                # (reference: labrpc/labrpc.go:233-239).
                self.sched.call_after(delay, fut.resolve, None)
                self._trace_rpc(
                    endname, svc_meth, t0, t0 + delay, "drop_request"
                )
                return fut
        self.sched.call_after(
            delay, self._execute, endname, servername, server, svc_meth,
            req_bytes, fut, t0,
        )
        return fut

    def _execute(
        self,
        endname: Any,
        servername: Any,
        server: Server,
        svc_meth: str,
        req_bytes: bytes,
        fut: Future,
        t0: float,
    ) -> None:
        # Fresh decode per delivery: value isolation across the wire.
        if self._servers.get(servername) is not server:
            # Server crashed while the request was in flight
            # (reference: labrpc/labrpc.go:253-265 death polling).
            self._dead_server_reply(fut, endname, svc_meth, t0, "dead_server")
            return
        args = codec.decode(req_bytes)
        self._count[servername] += 1
        self.metrics.inc("bytes_total", len(req_bytes))
        result = server.dispatch(svc_meth, args)
        done = self.sched.spawn(result) if _is_gen(result) else None
        if done is None:
            self._finish(endname, servername, server, result, fut, svc_meth, t0)
        else:
            done.add_done_callback(
                lambda f: self._finish(
                    endname, servername, server, f.value, fut, svc_meth, t0
                )
            )

    def _finish(
        self,
        endname: Any,
        servername: Any,
        server: Server,
        reply: Any,
        fut: Future,
        svc_meth: str,
        t0: float,
    ) -> None:
        if self._servers.get(servername) is not server:
            # DeleteServer() while the handler ran: suppress the reply so a
            # client can't receive an answer from a crashed server
            # (reference: labrpc/labrpc.go:267-277).
            self._dead_server_reply(
                fut, endname, svc_meth, t0, "reply_suppressed"
            )
            return
        reply_bytes = codec.encode(reply)
        if not self.reliable and self.rng.random() < self.faults.drop_reply:
            # Drop the reply (reference: labrpc/labrpc.go:279-284).
            self.sched.call_after(RELIABLE_HOP_DELAY, fut.resolve, None)
            self._trace_rpc(
                endname, svc_meth, t0,
                self.sched.now + RELIABLE_HOP_DELAY, "drop_reply",
            )
            return
        delay = RELIABLE_HOP_DELAY
        if self.long_reordering and self.rng.random() < self.faults.reorder_fraction:
            # Delay the response for a while
            # (reference: labrpc/labrpc.go:285-294).
            lo, hi = self.faults.reorder_delay
            delay += lo + self.rng.uniform(0, hi - lo)
        self.metrics.inc("bytes_total", len(reply_bytes))
        self.sched.call_after(delay, fut.resolve, codec.decode(reply_bytes))
        self._trace_rpc(endname, svc_meth, t0, self.sched.now + delay, "ok")

    def _dead_server_reply(
        self,
        fut: Future,
        endname: Any = None,
        svc_meth: str = "",
        t0: float = 0.0,
        status: str = "dead_server",
    ) -> None:
        delay = self.rng.uniform(0, self.faults.dead_timeout)
        self.sched.call_after(delay, fut.resolve, None)
        if svc_meth:
            self._trace_rpc(endname, svc_meth, t0, self.sched.now + delay, status)


def _is_gen(obj: Any) -> bool:
    import types

    return isinstance(obj, types.GeneratorType)
