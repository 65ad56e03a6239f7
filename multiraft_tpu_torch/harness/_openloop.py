"""The open-loop burst behind the nemesis's ``load_surge`` window.

A private copy of the two functions of the reference's open-loop load
generator (``benchmarks/openloop.py``) that the nemesis uses —
:func:`gen_schedule` (with :class:`ZipfKeys` and :func:`rate_at`) and
:func:`fire_schedule` — on this package's clerks and wire, so that the
harness reaches neither the reference package nor the benchmarks tree.
``gen_schedule`` draws the same arrivals as the reference's from the
same seed; ``fire_schedule`` fires them open-loop at one server's
``<service>.command`` RPC (``EngineKV`` for ``serve-kv``,
``EngineShardKV`` for ``serve-shardkv``) and returns the client-side
record.
"""

from __future__ import annotations

import bisect
import math
import random
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

ARRIVAL_MODES = ("poisson", "bursty", "diurnal")

# One scheduled arrival: (t_offset_s, op, key, value).
Arrival = Tuple[float, str, str, str]


# -- pure schedule generation ----------------------------------------------

class ZipfKeys:
    """Zipf(s) sampler over ``n`` keys via inverse CDF — key ``i`` has
    weight ``(i+1)^-s``, so key 0 is hottest.  Pure (caller supplies
    the rng), so schedules stay deterministic."""

    def __init__(self, n: int, s: float = 1.1, prefix: str = "olk") -> None:
        assert n >= 1
        weights = [(i + 1) ** -s for i in range(n)]
        total = sum(weights)
        acc = 0.0
        self._cdf: List[float] = []
        for w in weights:
            acc += w / total
            self._cdf.append(acc)
        self._cdf[-1] = 1.0  # guard float drift at the tail
        self.prefix = prefix

    def pick(self, rng: random.Random) -> str:
        i = bisect.bisect_left(self._cdf, rng.random())
        return f"{self.prefix}{i}"


def rate_at(
    mode: str, t: float, duration: float, rate: float,
    burst_factor: float = 4.0, burst_cycle: float = 1.0,
    burst_duty: float = 0.2,
) -> float:
    """Instantaneous arrival rate λ(t) for the three shapes.  All keep
    the MEAN offered rate ≈ ``rate`` so a ladder step means the same
    load regardless of shape:

    * ``poisson`` — constant λ.
    * ``bursty`` — on/off square wave: ``burst_duty`` of each
      ``burst_cycle`` runs at ``burst_factor``·rate, the rest at the
      complementary rate that preserves the mean.
    * ``diurnal`` — half-sine ramp 0→peak→0 across the step (peak =
      π/2·rate keeps the mean at ``rate``), the compressed shape of a
      daily traffic cycle.
    """
    if mode == "poisson":
        return rate
    if mode == "bursty":
        assert burst_factor * burst_duty <= 1.0, "burst exceeds the mean"
        phase = (t % burst_cycle) / burst_cycle
        if phase < burst_duty:
            return rate * burst_factor
        off = rate * (1.0 - burst_factor * burst_duty) / (1.0 - burst_duty)
        return max(off, rate * 0.01)
    if mode == "diurnal":
        frac = min(max(t / duration, 0.0), 1.0)
        lam = rate * (math.pi / 2.0) * math.sin(math.pi * frac)
        return max(lam, rate * 0.01)  # floor: no zero-rate stall at edges
    raise ValueError(f"unknown arrival mode {mode!r}")


def gen_schedule(
    seed: int,
    rate: float,
    duration: float,
    mode: str = "poisson",
    keyspace: int = 512,
    zipf_s: float = 1.1,
    get_frac: float = 0.2,
    append_frac: float = 0.2,
    burst_factor: float = 4.0,
    burst_cycle: float = 1.0,
    burst_duty: float = 0.2,
) -> List[Arrival]:
    """Deterministic arrival schedule: ``[(t, op, key, value), ...]``
    sorted by ``t`` ∈ [0, duration).  Inter-arrivals are exponential at
    the instantaneous λ(t) (stepwise time-rescaling — exact for
    ``poisson``, a fine approximation for the smooth shapes at bench
    rates); keys are zipf-skewed; the op mix is Get/Append/Put at
    ``get_frac``/``append_frac``/remainder."""
    assert mode in ARRIVAL_MODES, mode
    rng = random.Random(seed)
    keys = ZipfKeys(keyspace, zipf_s)
    out: List[Arrival] = []
    t = 0.0
    i = 0
    while True:
        lam = rate_at(mode, t, duration, rate,
                      burst_factor, burst_cycle, burst_duty)
        t += rng.expovariate(lam)
        if t >= duration:
            break
        u = rng.random()
        if u < get_frac:
            op, value = "Get", ""
        elif u < get_frac + append_frac:
            op, value = "Append", f"a{i},"
        else:
            op, value = "Put", f"v{i}"
        out.append((t, op, keys.pick(rng), value))
        i += 1
    return out


# -- one open-loop step -----------------------------------------------------

def fire_schedule(
    host: str,
    port: int,
    schedule: Sequence[Arrival],
    duration: float,
    service: str = "EngineKV",
    drain_s: float = 2.0,
) -> Dict[str, Any]:
    """Fire one schedule open-loop and return the client-side record.

    The driver coroutine runs on a fresh client node's loop: it sleeps
    to each arrival's instant, fires the call with a per-rid trace id,
    and moves on — reply timestamps land via done-callbacks (loop
    thread), never blocking the firing line.  Replies that never come
    (starved under overload) count as ``drops``; requests the server's
    admission layer refused come back fast as ErrBusy and count as
    ``shed`` — the bounded-latency alternative to a drop.  The latency
    histogram folds ACCEPTED (OK) replies only: the headline p50/p99 is
    the latency of requests the server chose to serve, which is exactly
    the number admission control promises to bound (a sub-millisecond
    busy reply averaged in would flatter the curve).  The fresh node
    per step bounds leaked futures to the step's lifetime."""
    from ..distributed.engine_clerks import EngineClerk
    from ..distributed.engine_wire import ERR_BUSY, OK, EngineCmdArgs
    from ..distributed.tcp import RpcNode
    from ..sim.scheduler import TIMEOUT
    from ..utils.ids import unique_client_id
    from ..utils.metrics import Hist

    node = RpcNode()
    try:
        end = node.client_end(host, port)
        sched = node.sched
        n = len(schedule)
        # Indexed by arrival; written only on the loop thread.
        lats: List[Optional[float]] = [None] * n
        oks = [0] * n
        sheds = [0] * n
        client_id = unique_client_id(next(EngineClerk._next))

        def make_done(i: int, t_send: float):
            def _done(f) -> None:
                lats[i] = time.perf_counter() - t_send
                r = f.value
                err = getattr(r, "err", None) if (
                    r is not None and r is not TIMEOUT
                ) else None
                if err == OK:
                    oks[i] = 1
                elif err == ERR_BUSY:
                    sheds[i] = 1
            return _done

        def driver():
            cmd = 0
            t0 = time.perf_counter()
            for i, (at, op, key, value) in enumerate(schedule):
                delay = at - (time.perf_counter() - t0)
                if delay > 0.0002:
                    yield delay
                if op != "Get":
                    cmd += 1
                args = EngineCmdArgs(
                    op=op, key=key, value=value,
                    client_id=client_id, command_id=cmd,
                )
                t_send = time.perf_counter()
                fut = end.call(
                    f"{service}.command", args, trace=f"ol.{i}"
                )
                fut.add_done_callback(make_done(i, t_send))
            return time.perf_counter() - t0

        wall = sched.wait(sched.spawn(driver()), duration + 120.0)
        assert wall is not TIMEOUT, "open-loop driver wedged"
        # Drain grace: let in-flight replies land (stop early once all
        # have; under true overload some never will — those are drops).
        deadline = time.monotonic() + drain_s
        while time.monotonic() < deadline:
            if all(v is not None for v in lats):
                break
            time.sleep(0.05)

        h = Hist()
        replied = 0
        for i, v in enumerate(lats):
            if v is None:
                continue
            replied += 1
            if oks[i]:
                h.observe(v)  # accepted-request latency only
        ok = sum(oks)
        shed = sum(sheds)
        p50 = h.percentile(0.50)
        p99 = h.percentile(0.99)
        p999 = h.percentile(0.999)
        return {
            "sent": n,
            "replied": replied,
            "ok": ok,
            "shed": shed,
            "drops": n - replied,
            "wall_s": round(float(wall), 3),
            "achieved_ops_per_sec": round(ok / wall, 1) if wall else 0.0,
            "client_p50_ms": round(1e3 * p50, 3) if p50 is not None else None,
            "client_p99_ms": round(1e3 * p99, 3) if p99 is not None else None,
            "client_p999_ms": (
                round(1e3 * p999, 3) if p999 is not None else None
            ),
            "client_mean_ms": (
                round(1e3 * h.total / h.count, 3) if h.count else None
            ),
        }
    finally:
        node.close()
