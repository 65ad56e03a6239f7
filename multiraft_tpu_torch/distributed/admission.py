"""Admission control: the layer that turns overload signals into
overload *behavior* (round 8).

The telemetry plane and the OverloadWatch can *see* queueing
collapse — LOADCURVE_r01 shows wire-stage p99 exploding to seconds past
a ~2000 ops/s knee while the engine itself stays at ~18 ms — but until
now nothing shed, bounded, or pushed back, so overload degraded every
client instead of a controlled few.  This module is the front door's
bouncer, consulted by ``tcp.py``'s dispatch before any handler runs:

* **Token-bucket admission per client session.**  Each connection is a
  client session (every clerk owns its own RpcNode/connection); each
  session gets a refill-on-read token bucket, plus one node-wide bucket
  bounding aggregate intake.  Buckets refill at ``rate × factor`` where
  ``factor`` comes from the brownout state machine (overload.py) —
  HEALTHY admits at the configured rate, SHEDDING and BROWNOUT tighten
  it, so the OverloadWatch's stage-p99/gauge trips translate directly
  into fewer admitted requests.
* **Bounded per-connection dispatch queue.**  A cap on
  dispatched-but-unreplied requests per connection.  The open-loop
  generator can offer load the server cannot refuse; this bound is what
  refuses it — past the cap the request is shed instead of joining the
  collapse queue.
* **Shed with an explicit retry hint.**  Refused requests get a
  ``("busy", req_id, retry_after_s)`` frame when the peer negotiated the
  ``busy`` hello capability, so the clerk resolves immediately with
  :data:`~.engine_wire.ERR_BUSY` and backs off for a *jittered*
  ``retry_after_s`` instead of burning its full timeout.  Legacy peers
  (no hello, or ``MRT_WIRE_LEGACY=1``) never see the frame — the shed
  degrades to a silent drop and the clerk's ordinary timeout+backoff,
  exactly the pre-round-8 overload behavior.
* **Priority lanes.**  Control-plane (``Chaos.*``/``Obs.*``), system
  traffic (placement/config/admin verbs, anything that is not the KV
  data plane), and the porcupine verifier's clerks (rids prefixed
  ``verify.``) are exempt from shedding, so the fleet stays observable,
  steerable, and verifiable while user traffic sheds.

Kill switch: ``MRT_ADMISSION=0`` skips the install entirely.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

from ..utils.knobs import knob_bool, knob_float, knob_int, knob_str
from .engine_wire import busy_reply  # noqa: F401  (re-export for tcp.py)
from .observe import is_control

__all__ = [
    "TokenBucket",
    "AdmissionController",
    "install_admission",
    "lane_of",
    "LANE_USER",
    "LANE_VERIFY",
    "LANE_SYSTEM",
    "LANE_CONTROL",
]


# -- lanes ------------------------------------------------------------------

LANE_USER = "user"        # KV data plane: the only lane that sheds
LANE_VERIFY = "verify"    # porcupine sampler clerks (rid prefix "verify.")
LANE_SYSTEM = "system"    # placement/config/admin/firehose-admin verbs
LANE_CONTROL = "control"  # Chaos.* / Obs.* — never shed, never counted

# The KV data plane is a small closed set of verbs; everything else on
# an engine service (placement, config, admin, pull_shard, ...) is
# system traffic that must keep flowing while user traffic sheds.
_DATA_METHS = frozenset({"command", "batch", "firehose"})


def lane_of(svc_meth: str, rid: Any) -> str:
    """Classify one dispatch into its priority lane.  ``rid`` is the
    request's trace id (clerks send ``"<lane.>client.seq"`` strings;
    open-loop raw calls send ``(rid, t_send)`` tuples)."""
    if is_control(svc_meth):
        return LANE_CONTROL
    _, _, meth = svc_meth.partition(".")
    if meth not in _DATA_METHS:
        return LANE_SYSTEM
    tag = rid[0] if isinstance(rid, tuple) and rid else rid
    if isinstance(tag, str) and tag.startswith("verify."):
        return LANE_VERIFY
    return LANE_USER


# -- token bucket -----------------------------------------------------------

class TokenBucket:
    """Refill-on-read token bucket.  ``take`` returns 0.0 on admit or
    the seconds until one token exists at the *current* effective rate
    — the raw material for the retry_after_s hint.  ``factor`` scales
    the refill rate (brownout tightening) without resetting state."""

    __slots__ = ("rate", "burst", "tokens", "_t", "_now")

    def __init__(self, rate: float, burst: float, now=time.monotonic):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst
        self._now = now
        self._t = now()

    def take(self, factor: float = 1.0) -> float:
        eff = self.rate * factor
        now = self._now()
        if eff > 0:
            self.tokens = min(self.burst, self.tokens + (now - self._t) * eff)
        self._t = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        if eff <= 0:
            return 1.0
        return (1.0 - self.tokens) / eff


# -- controller -------------------------------------------------------------

class AdmissionController:
    """Dispatch-layer admission: consulted by tcp.py before handler
    lookup, driven by overload.py's brownout machine via
    :meth:`set_level`.  All calls happen on the node's single loop
    thread (dispatch, reply, overload tick), so no locking."""

    def __init__(
        self,
        metrics: Any = None,
        rate: Optional[float] = None,
        burst: Optional[float] = None,
        session_rate: Optional[float] = None,
        inflight_cap: Optional[int] = None,
        now=time.monotonic,
    ):
        # Default: 0.8x the measured per-op serving knee (LOADCURVE_r01
        # put it at 2000 offered ops/s) — admit into the region where
        # accepted-request latency is bounded AND stable, shed the
        # rest.  0.9x was tried and sits too close to saturation: the
        # knee-step p99 swung 85->196ms between identical sweeps.
        # Deployments serving a faster path (firehose batching, a
        # beefier host) should raise MRT_ADMIT_RATE to ~0.8x THEIR knee.
        self.rate = rate if rate is not None else knob_float("MRT_ADMIT_RATE")
        # Bucket depth = 125ms of rate: deep enough to absorb Poisson
        # arrival clumps (sd ~ sqrt(rate) per second), shallow enough
        # that a sustained overload starts shedding within ~an RTT
        # instead of admitting seconds of excess into the queues first.
        self.burst = burst if burst is not None else knob_float(
            "MRT_ADMIT_BURST", self.rate / 8.0)
        self.session_rate = session_rate if session_rate is not None else knob_float(
            "MRT_ADMIT_SESSION_RATE", self.rate)
        self.inflight_cap = int(inflight_cap if inflight_cap is not None
                                else knob_int("MRT_ADMIT_INFLIGHT"))
        # Minimum retry hint per brownout level — bucket deficits at
        # high refill rates are sub-millisecond, which would invite an
        # immediate re-offer; the floor grows as the node browns out.
        self.base_hint_s = knob_float("MRT_ADMIT_RETRY_S")
        self._now = now
        self._m = metrics
        self._global = TokenBucket(self.rate, self.burst, now=now)
        self._sessions: Dict[Any, TokenBucket] = {}
        self._inflight: Dict[Any, int] = {}
        # Brownout level (overload.HEALTHY/SHEDDING/BROWNOUT) and the
        # admission factor it maps to.
        self.level = 0
        self._factors = self._parse_factors(
            knob_str("MRT_BROWNOUT_FACTORS") or "")

    @staticmethod
    def _parse_factors(raw: str) -> Tuple[float, float, float]:
        try:
            parts = tuple(float(x) for x in raw.split(",") if x.strip())
            if len(parts) == 3:
                return parts  # type: ignore[return-value]
        except ValueError:
            pass
        return (1.0, 0.5, 0.2)

    @property
    def factor(self) -> float:
        return self._factors[min(self.level, len(self._factors) - 1)]

    def set_level(self, level: int) -> None:
        """Brownout drive: 0=healthy, 1=shedding, 2=brownout."""
        self.level = max(0, int(level))

    def tokens(self) -> float:
        """Current node-wide bucket depth (refreshed) — the
        ``gauge.admit_tokens`` export."""
        b = self._global
        eff = b.rate * self.factor
        if eff > 0:
            now = b._now()
            b.tokens = min(b.burst, b.tokens + (now - b._t) * eff)
            b._t = now
        return b.tokens

    def inflight_total(self) -> int:
        return sum(self._inflight.values())

    # -- the hot path -------------------------------------------------------

    def admit(self, conn: Any, lane: str) -> Optional[float]:
        """``None`` = admitted; a float = shed, with that retry_after_s
        hint.  Only the user lane ever sheds — control/system/verify
        traffic must survive the very overload this layer manages."""
        m = self._m
        if m is not None:
            m.inc(f"admit.lane.{lane}")
        if lane != LANE_USER:
            return None
        factor = self.factor
        hint = 0.0
        inflight = self._inflight.get(conn, 0)
        if inflight >= max(1, int(self.inflight_cap * factor)):
            hint = self.base_hint_s * (1 + self.level)
        else:
            wait = self._global.take(factor)
            if wait <= 0.0 and self.session_rate > 0:
                sess = self._sessions.get(conn)
                if sess is None:
                    sess = self._sessions[conn] = TokenBucket(
                        self.session_rate, max(1.0, self.session_rate / 8.0),
                        now=self._now)
                wait = sess.take(factor)
            if wait > 0.0:
                hint = max(wait, self.base_hint_s * (1 + self.level))
        if hint > 0.0:
            hint = min(hint, 5.0)
            if m is not None:
                m.inc("admit.shed")
                m.observe("admit.retry_after_s", hint)
            return hint
        self._inflight[conn] = inflight + 1
        if m is not None:
            m.inc("admit.accepted")
        return None

    def release(self, conn: Any, lane: str) -> None:
        """One admitted user-lane dispatch replied (or its connection
        died) — pairs 1:1 with a ``None`` return from :meth:`admit`."""
        if lane != LANE_USER:
            return
        left = self._inflight.get(conn, 0) - 1
        if left > 0:
            self._inflight[conn] = left
        else:
            self._inflight.pop(conn, None)

    def conn_closed(self, conn: Any) -> None:
        self._sessions.pop(conn, None)
        self._inflight.pop(conn, None)


def install_admission(node: Any, **kw: Any) -> Optional[AdmissionController]:
    """Attach an AdmissionController to a serving node (the engine
    front doors call this next to install_overload_watch).  Gated on
    ``MRT_ADMISSION`` (default on)."""
    if not knob_bool("MRT_ADMISSION"):
        return None
    adm = AdmissionController(metrics=node.obs.metrics, **kw)
    node.admission = adm
    return adm
