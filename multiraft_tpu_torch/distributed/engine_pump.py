"""Dedicated engine-pump thread for the asynchronous tick pipeline.

The continuous profiler showed the serving knee is tick-bound: the
scheduler loop thread spent its budget blocked in ``host.step`` device
readbacks (538 µs/op vs 29 µs/op ingress decode at LOADCURVE_r03), so
socket I/O, decode, and acks starved behind device compute.  The fix is
a division of labor:

* the **scheduler loop** dispatches fused tick batches without waiting
  (``EngineDriver.dispatch_ticks`` — JAX async dispatch makes the
  results futures) and later folds fetched results back in
  (``complete_ticks`` + ``FrontierService.after_step``);
* the **engine-pump thread** (:class:`EnginePump`, one per serving
  scheduler, named ``multiraft-pump[/<port>]`` so the profiler's
  serving-thread ranking cut and py-spy both attribute it) does the
  ONLY thing that blocks: waiting for a batch's stacked metrics to
  land on host (``PendingTicks.fetch``), then posts the result back to
  the loop via the scheduler's thread-safe ``post``.

Blocking here is the design, not a bug: this module is allowlisted in
graftlint's blocking-in-callback rule (analysis/dataflow.py) the same
way the WAL/disk modules are — the rule protects the *scheduler loop's*
latency budget, and this thread exists precisely to keep blocking off
that loop.  The work-queue lock registers with the lock-order sanitizer
(MRT_SANITIZE=1) so a cycle against the scheduler or durability locks
is caught in CI, and the thread is a daemon so a wedged device wait
never blocks interpreter shutdown.

:class:`LoopOccupancy` is the observability half: the fraction of
scheduler-loop wall the pump path consumes (``pump.loop_occupancy``).
Pre-pipeline this sat near 1.0 under load — the loop WAS the pump;
with the pipeline it should collapse to the dispatch+bookkeeping cost.
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import deque
from typing import Callable

from .sanitize import get_sanitizer

__all__ = ["EnginePump", "LoopOccupancy", "PUMP_THREAD_PREFIX"]

# Thread-name prefix: distributed/profile.py includes it (with
# "multiraft-loop") in SERVING_THREAD_PREFIXES, the profiler's
# serving-side CPU attribution cut.
PUMP_THREAD_PREFIX = "multiraft-pump"


class EnginePump:
    """One worker thread that blocks on device readbacks so the
    scheduler loop never does.

    ``submit(fetch, done)`` queues ``fetch()`` (typically
    ``PendingTicks.fetch``) for the pump thread; ``done(result)`` is
    then posted to the scheduler loop — with the fetched value, or
    with the exception ``fetch`` raised (the loop-side handler
    re-raises, so device failures surface on the thread that owns the
    engine, with the loop's crash handling)."""

    def __init__(self, sched, name: str = PUMP_THREAD_PREFIX) -> None:
        self.sched = sched
        self.name = name
        self._lock = threading.Lock()
        san = get_sanitizer()
        if san is not None:
            # Register BEFORE the Condition wraps it: the recorded
            # proxy then sees every acquire from both threads and the
            # pump edge joins the global lock-order graph.
            san.install_locks(self, {"_lock": f"{name}._lock"})
        self._cv = threading.Condition(self._lock)
        self._q: deque = deque()
        self._stopped = False
        # Wall seconds the pump thread spent blocked in fetches —
        # exported by the serving loop as the pump side of the
        # occupancy story (the loop's own share goes to LoopOccupancy).
        self.fetch_wall_s = 0.0
        self._thread = threading.Thread(
            target=self._run, name=name, daemon=True
        )
        self._thread.start()

    def submit(self, fetch: Callable, done: Callable) -> None:
        """Queue ``fetch`` for the pump thread (thread-safe).  Bounded
        by the pipeline depth: the serving loop never dispatches more
        than MRT_PIPELINE_DEPTH batches before a completion drains."""
        with self._cv:
            self._q.append((fetch, done))  # graftlint: disable=unbounded-queue
            self._cv.notify()

    def stop(self, timeout: float = 5.0) -> None:
        """Drain outstanding fetches, then join the thread."""
        with self._cv:
            self._stopped = True
            self._cv.notify()
        self._thread.join(timeout=timeout)

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._stopped:
                    self._cv.wait()
                if not self._q:
                    return  # stopped and drained
                fetch, done = self._q.popleft()
            t0 = time.perf_counter()
            try:
                res = fetch()
            except BaseException as e:  # device failure: ship it back
                traceback.print_exc()
                res = e
            self.fetch_wall_s += time.perf_counter() - t0
            self.sched.post(done, res)


class LoopOccupancy:
    """``pump.loop_occupancy`` gauge: scheduler-loop wall spent in the
    pump path (dispatch + completion bookkeeping + legacy sync pumps)
    divided by elapsed wall, over ~1 s windows.  The doctor/loadcurve
    read it to show whether the serving thread is still monopolized by
    the engine (≈1.0 pre-pipeline) or free for wire work."""

    WINDOW_S = 1.0

    def __init__(self, metrics) -> None:
        self.m = metrics
        self._acc = 0.0
        self._t0 = time.monotonic()

    def add(self, dt: float) -> None:
        self._acc += dt
        now = time.monotonic()
        elapsed = now - self._t0
        if elapsed >= self.WINDOW_S:
            self.m.set("pump.loop_occupancy", min(self._acc / elapsed, 1.0))
            self._acc = 0.0
            self._t0 = now
