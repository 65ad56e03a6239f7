"""Open-loop load generator: offered rate the server cannot refuse (the
PyTorch port of ``benchmarks/openloop.py``).

Every closed-loop bench lets clerks wait for each reply before sending
the next op, so an overloaded server silently throttles its own offered
load and the measured "latency at X ops/s" is really "latency at
whatever rate the server let us sustain" — the coordinated-omission
trap.  This generator is open-loop: arrivals come from a precomputed
schedule (Poisson, bursty, or diurnal-ramp, with zipfian key skew),
each arrival fires an ``EngineKV.command`` RPC at its scheduled instant
WITHOUT waiting for the previous reply, and per-rid send/reply
timestamps are recorded via future done-callbacks.  Under overload the
queues (not the generator) absorb the excess, so the latency curve
shows the real knee.

Layering:

* :func:`gen_schedule` / :class:`ZipfKeys` — pure and deterministic
  (seeded ``random.Random``; same seed → the reference's schedule, byte
  for byte), so a step is reproducible and testable without sockets.
* :func:`fire_schedule` — one open-loop step against a served engine:
  fresh client ``RpcNode`` per step (bounds dropped-reply futures to
  the step), fires the schedule, drains briefly, folds client-observed
  latencies into a :class:`~multiraft_tpu_torch.utils.metrics.Hist`.
  The nemesis's ``load_surge`` window fires its bursts through it.
* :func:`sweep` — rate ladder via ``harness/loadcurve.py`` (windowed
  fleet scrapes give the per-stage p50/p99 per step), with a porcupine
  sampler clerk running THROUGHOUT the sweep — overload may shed or
  starve, but it must never reorder acknowledged state.  The served
  engine runs on ``device`` (the card unless ``"cpu"`` is asked for).

Usage::

    python -m multiraft_tpu_torch.benchmarks.openloop
        [--mode poisson|bursty|diurnal] [--rates 500,1000,...]
        [--step-s 4] [--seed 7] [--out PATH] [--device cpu]

Writes the LOADCURVE JSON (throughput-vs-p99 curve, detected knee,
per-stage decomposition per rate step) that
``multiraft_tpu_torch.scripts.bench_compare --family loadcurve`` gates.
"""

from __future__ import annotations

import bisect
import json
import math
import random
import sys
import threading
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


# -- porcupine sampling -----------------------------------------------------

class PorcupineSampler:
    """Low-rate closed-loop clerk sampling linearizability THROUGHOUT
    an open-loop sweep: two blocking clerks interleave Appends/Gets on
    shared keys, recording wall-clock histories checked against the KV
    model at :meth:`finish`.  Overload may delay or shed the samplers'
    ops (they retry), but acknowledged state must stay linearizable —
    running the checker clerk DURING overload is the point.

    An Append that outlives the clerk's timeout stays in the history
    with an open return (``ret`` = infinity): its request may still be
    applied after the clerk gave up, so the checker may order it
    anywhere after its call, or after every read.  (The reference drops
    it, and a later Get that sees its tag then reads as a violation; a
    timed-out Get changes nothing and is dropped here too.)"""

    def __init__(self, host: str, port: int, n_clerks: int = 2,
                 period_s: float = 0.05) -> None:
        self.host, self.port = host, port
        self.period_s = period_s
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.history: List[Any] = []
        self.open_appends = 0  # timed-out Appends kept with an open return
        self.dropped_gets = 0
        self._threads = [
            threading.Thread(
                target=self._run, args=(vi,), daemon=True,
                name=f"porcupine-sampler-{vi}",
            )
            for vi in range(n_clerks)
        ]

    def start(self) -> "PorcupineSampler":
        for t in self._threads:
            t.start()
        return self

    def _run(self, vi: int) -> None:
        from ..distributed.engine_cluster import (
            BlockingEngineClerk,
        )
        from ..porcupine.kv import (
            OP_APPEND, OP_GET, KvInput, KvOutput,
        )
        from ..porcupine.model import Operation

        # Verify lane: admission exempts these clerks, so the
        # linearizability witness keeps sampling through the very
        # overload the sweep creates (that's its whole point).
        ck = BlockingEngineClerk(self.port, host=self.host, lane="verify")
        try:
            j = 0
            while not self._stop.is_set():
                key = f"olshared{j % 2}"
                t0 = time.monotonic()
                timed_out = False
                if j % 3 == 2:
                    inp = KvInput(op=OP_GET, key=key)
                    try:
                        out = KvOutput(value=ck.get(key, timeout=60.0))
                    except TimeoutError:
                        # Starved past the clerk timeout: a Get has no
                        # effect, so the ambiguous read is dropped.
                        with self._lock:
                            self.dropped_gets += 1
                        j += 1
                        continue
                else:
                    tag = f"({vi}.{j})"
                    inp = KvInput(op=OP_APPEND, key=key, value=tag)
                    out = KvOutput(value="")
                    try:
                        ck.append(key, tag, timeout=60.0)
                    except TimeoutError:
                        # Ambiguous: the request may still be applied,
                        # so the Append stays, with no return edge.
                        timed_out = True
                with self._lock:
                    self.open_appends += timed_out
                    self.history.append(Operation(
                        client_id=vi, input=inp, call=t0, output=out,
                        ret=math.inf if timed_out else time.monotonic(),
                    ))
                j += 1
                self._stop.wait(self.period_s)
        finally:
            ck.close()

    def finish(self, timeout: float = 60.0) -> Dict[str, Any]:
        """Stop sampling and porcupine-check the recorded history."""
        from ..porcupine.checker import check_operations
        from ..porcupine.kv import kv_model
        from ..porcupine.model import CheckResult

        self._stop.set()
        for t in self._threads:
            t.join(timeout=120.0)
        with self._lock:
            history = list(self.history)
        if self.open_appends or self.dropped_gets:
            print(f"porcupine sampler: {self.open_appends} timed-out "
                  f"append(s) kept with an open return, {self.dropped_gets} "
                  f"timed-out get(s) dropped", file=sys.stderr, flush=True)
        if not history:
            return {"porcupine": "empty", "verifier_ops": 0}
        verdict = check_operations(kv_model, history, timeout=timeout)
        assert verdict is not CheckResult.ILLEGAL, (
            "open-loop sweep history not linearizable"
        )
        return {"porcupine": verdict.value, "verifier_ops": len(history)}


# -- the sweep --------------------------------------------------------------

DEFAULT_RATES = (250.0, 500.0, 1000.0, 2000.0, 4000.0, 8000.0)


def sweep(
    rates: Sequence[float] = DEFAULT_RATES,
    step_s: float = 4.0,
    mode: str = "poisson",
    seed: int = 7,
    groups: int = 64,
    keyspace: int = 512,
    p99_target_ms: float = 50.0,
    verify: bool = True,
    drain_s: float = 2.0,
    flame_out: str = "",
    device: str = "cuda",
) -> Dict[str, Any]:
    """Run the full open-loop rate ladder against one served engine
    (its process builds the engine on ``device``) and return the
    LOADCURVE report (see module docstring)."""
    from ..distributed.engine_cluster import (
        BlockingEngineClerk, EngineProcessCluster,
    )
    from ..harness.loadcurve import build_loadcurve, run_sweep
    from ..harness.observe import FleetObserver

    cluster = EngineProcessCluster(kind="engine_kv", groups=groups, seed=41,
                                   device=device)
    obs = None
    sampler = None
    try:
        cluster.start()
        # Warm both server tick variants before the ladder starts.
        warm = BlockingEngineClerk(cluster.port, host=cluster.host)
        warm.put("warm", "1")
        warm.close()
        obs = FleetObserver([(cluster.host, cluster.port)])
        if verify:
            sampler = PorcupineSampler(cluster.host, cluster.port).start()

        def fire_step(rate: float) -> Dict[str, Any]:
            sched = gen_schedule(
                seed=seed + int(rate), rate=rate, duration=step_s,
                mode=mode, keyspace=keyspace,
            )
            return fire_schedule(
                cluster.host, cluster.port, sched, duration=step_s,
                drain_s=drain_s,
            )

        flame: Dict[str, int] = {}
        steps = run_sweep(obs, fire_step, rates, flame_acc=flame)
        porc = sampler.finish() if sampler is not None else {
            "porcupine": "skipped", "verifier_ops": 0,
        }
        out = build_loadcurve(steps, p99_target_ms=p99_target_ms)
        out.update(porc)
        out["mode"] = mode
        out["seed"] = seed
        out["step_s"] = step_s
        out["keyspace"] = keyspace
        # Whole-sweep CPU attribution: the merged fleet flame's top
        # functions land in the report; the raw flame (collapsed
        # format, flamegraph.pl/speedscope-ready) goes to flame_out.
        if flame:
            from ..distributed.profile import (
                SERVING_THREAD_PREFIXES, to_collapsed, top_functions,
            )

            # Strip the process prefix for ranking (top_functions
            # expects "thread;frames" keys, as in one process's dump).
            # The headline ranks serving threads only — every thread
            # is sampled every tick, so a parked main thread otherwise
            # outranks the pegged loop (same cut as profile_window).
            bare: Dict[str, int] = {}
            serving: Dict[str, int] = {}
            for k, v in flame.items():
                b = k.split(";", 1)[1] if ";" in k else k
                bare[b] = bare.get(b, 0) + v
                if b.startswith(SERVING_THREAD_PREFIXES):
                    serving[b] = serving.get(b, 0) + v
            out["profile"] = {
                "samples": sum(flame.values()),
                "top": top_functions(serving or bare, 20),
                "top_all_threads": top_functions(bare, 20),
            }
            if flame_out:
                with open(flame_out, "w") as f:
                    f.write(to_collapsed(flame) + "\n")
                out["profile"]["flame_path"] = flame_out
        return out
    finally:
        if sampler is not None and not sampler._stop.is_set():
            sampler._stop.set()
        if obs is not None:
            obs.close()
        cluster.shutdown()


def main(argv: List[str]) -> None:
    rates: Sequence[float] = DEFAULT_RATES
    mode, step_s, seed, out_path, verify = "poisson", 4.0, 7, "", True
    target = 50.0
    flame_out = ""
    device = "cuda"
    it = iter(argv[1:])
    for a in it:
        if a == "--mode":
            mode = next(it)
        elif a == "--flame":
            flame_out = next(it)
        elif a == "--rates":
            rates = [float(x) for x in next(it).split(",")]
        elif a == "--step-s":
            step_s = float(next(it))
        elif a == "--seed":
            seed = int(next(it))
        elif a == "--out":
            out_path = next(it)
        elif a == "--p99-target-ms":
            target = float(next(it))
        elif a == "--no-verify":
            verify = False
        elif a == "--device":
            device = next(it)
        else:
            raise SystemExit(f"unknown arg {a!r}")
    report = sweep(
        rates=rates, step_s=step_s, mode=mode, seed=seed,
        p99_target_ms=target, verify=verify, flame_out=flame_out,
        device=device,
    )
    blob = json.dumps(report, indent=1)
    if out_path:
        with open(out_path, "w") as f:
            f.write(blob + "\n")
    print(blob, flush=True)


if __name__ == "__main__":
    main(sys.argv)
