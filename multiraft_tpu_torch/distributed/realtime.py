"""Wall-clock event loop with the sim Scheduler's exact surface.

Every framework component (RaftNode, KVServer, ShardCtrler, clerks) is
written against the virtual-time ``Scheduler`` API: timers via
``call_at/call_after/call_soon``, suspension via ``Future``, blocking
control flow via generator coroutines (``spawn``).  This class provides
the same contract on real time: one event-loop thread owns all callback
execution (so the single-threaded mutation model the sim guarantees by
construction still holds), a monotonic clock replaces virtual ``now``,
and a thread-safe ``post`` lets IO threads (the TCP transport) marshal
completions onto the loop.

This is the deployment analog of the reference's goroutine runtime
(reference: raft/raft.go:51-87) — except there is exactly one mutator
thread, so the reference's mutex discipline (raft/raft.go:22) has no
equivalent to get wrong.
"""

from __future__ import annotations

import heapq
import threading
import time
import types
from typing import Any, Callable, Generator, Optional

from ..sim.scheduler import TIMEOUT, Future, Timer
from ..utils.cpus import usable_cpus
from ..utils.knobs import knob_bool
from .sanitize import get_sanitizer

__all__ = [
    "RealtimeScheduler",
    "IoScheduler",
    "PumpCadence",
    "Backoff",
    "service_busy",
]


class Backoff:
    """Bounded exponential backoff with equal jitter, for clerk retry
    loops.  Without it, a fast-failing RPC (connection refused while a
    server restarts, a partitioned minority answering instantly) turns
    the reference retry loop into a hot spin — thousands of doomed
    calls per second hammering the exact process trying to recover.

    ``next_delay()`` draws uniformly from ``[cur/2, cur]`` (equal
    jitter: a floor keeps the loop off the CPU, the random half
    de-synchronizes clerks that failed together), then doubles ``cur``
    up to ``cap``.  ``reset()`` on success re-arms the fast first
    retry."""

    def __init__(
        self,
        base: float = 0.02,
        cap: float = 1.0,
        factor: float = 2.0,
        rng: Optional[Any] = None,
    ) -> None:
        import random

        self.base = base
        self.cap = cap
        self.factor = factor
        self._cur = base
        self._rng = rng if rng is not None else random.Random()

    def next_delay(self) -> float:
        cur = self._cur
        self._cur = min(self.cap, cur * self.factor)
        return cur / 2.0 + self._rng.random() * (cur / 2.0)

    def jittered(self, base: float) -> float:
        """Equal-jitter a caller-supplied delay — a server's
        ``retry_after_s`` hint, a fixed config-wait — WITHOUT advancing
        the doubling state.  The server hands the same hint to every
        clerk it sheds; a deterministic wait would re-synchronize them
        into the next thundering herd."""
        return base / 2.0 + self._rng.random() * (base / 2.0)

    def reset(self) -> None:
        self._cur = self.base


class RealtimeScheduler:
    """Drop-in wall-clock implementation of the sim ``Scheduler`` API.

    ``now`` is seconds on a monotonic clock (an absolute epoch is never
    exposed, matching the sim's relative-time semantics).  All callbacks
    — timer fires, future resolutions, coroutine steps — execute on the
    single loop thread.  External threads interact only through
    :meth:`post` and :meth:`wait`.
    """

    def __init__(self, name: str = "multiraft-loop") -> None:
        self._origin = time.monotonic()
        self._heap: list[tuple[float, int, Timer]] = []
        self._seq = 0
        self._lock = threading.Lock()
        self._wakeup = threading.Condition(self._lock)
        self._stopped = False
        self.fired_events = 0
        # Runtime sanitizer (MRT_SANITIZE=1): every callback the loop
        # runs goes through its duration-budget shim.  None = off =
        # one `is None` check per dispatch.
        self._san = get_sanitizer()
        # ``name`` is the loop thread's name — the profiler keys CPU
        # attribution by it (profile.py), so multi-node processes pass
        # a per-node suffix ("multiraft-loop/9001") to keep their
        # loops distinguishable in the fleet flame.
        self._thread = threading.Thread(
            target=self._run, name=name, daemon=True
        )
        self._thread.start()

    # -- clock ------------------------------------------------------------

    @property
    def now(self) -> float:
        return time.monotonic() - self._origin

    def on_loop_thread(self) -> bool:
        """True when called from the loop thread (the only thread that
        may touch loop-owned state like RpcNode's reply queue)."""
        return threading.current_thread() is self._thread

    def flush_io(self) -> None:
        """Force any pending IO flush now.  No-op here; IoScheduler
        overrides it.  Long-running timer callbacks (an engine pump
        about to grind for milliseconds) call this first so replies
        already queued don't wait them out."""

    # -- scheduling (sim-compatible) --------------------------------------

    def call_at(self, when: float, fn: Callable, *args: Any) -> Timer:
        timer = Timer(when, fn, args)
        with self._lock:
            self._seq += 1
            heapq.heappush(self._heap, (when, self._seq, timer))
            self._wakeup.notify()
        return timer

    def call_after(self, delay: float, fn: Callable, *args: Any) -> Timer:
        return self.call_at(self.now + delay, fn, *args)

    def call_soon(self, fn: Callable, *args: Any) -> Timer:
        return self.call_at(self.now, fn, *args)

    # ``post`` is the documented thread-safe entry point; internally
    # call_at already locks, so they share one implementation.
    post = call_soon

    # -- futures / coroutines (same semantics as sim Scheduler) -----------

    def sleep(self, delay: float) -> Future:
        fut = Future()
        self.call_after(delay, fut.resolve, None)
        return fut

    def with_timeout(self, fut: Future, timeout: float) -> Future:
        out = Future()
        timer = self.call_after(timeout, out.resolve, TIMEOUT)

        def _done(f: Future) -> None:
            timer.cancel()
            out.resolve(f.value)

        fut.add_done_callback(_done)
        return out

    def spawn(self, gen: Generator) -> Future:
        result = Future()
        if not isinstance(gen, types.GeneratorType):
            result.resolve(gen)
            return result

        def step(send_value: Any) -> None:
            if result.done:  # cancelled from outside (BlockingClerk timeout)
                gen.close()
                return
            try:
                waited = gen.send(send_value)
            except StopIteration as stop:
                result.resolve(stop.value)
                return
            if isinstance(waited, Future):
                # Step inline on resolution — the sim Scheduler's exact
                # semantics (sim/scheduler.py spawn).  Safe because every
                # resolve already runs on the loop thread; posting would
                # add a heap round trip per coroutine step.
                waited.add_done_callback(lambda f: step(f.value))
            elif isinstance(waited, (int, float)):
                self.call_after(float(waited), step, None)
            else:  # pragma: no cover - defensive
                raise TypeError(f"coroutine yielded {waited!r}")

        self.call_soon(step, None)
        return result

    # -- cross-thread waiting ---------------------------------------------

    def wait(self, fut: Future, timeout: Optional[float] = None) -> Any:
        """Block the *calling* (non-loop) thread until ``fut`` resolves.

        Returns the future's value, or :data:`TIMEOUT` on timeout.  The
        external-thread analog of the sim's ``run_until``.

        ``Future`` is not thread-safe (it never needs to be on the loop),
        so the callback is *attached on the loop thread* — the same
        thread every resolve runs on — making the done-check/append
        sequence race-free by construction.
        """
        done = threading.Event()
        box: list[Any] = []

        def _resolved(f: Future) -> None:
            box.append(f.value)
            done.set()

        self.post(lambda: fut.add_done_callback(_resolved))
        if not done.wait(timeout):
            return TIMEOUT
        return box[0]

    def run_call(self, fn: Callable, *args: Any, timeout: float = 30.0) -> Any:
        """Run ``fn(*args)`` on the loop thread and return its result to
        the calling thread; exceptions propagate to the caller instead of
        dying on the loop (construction-time errors must be loud)."""
        fut = Future()

        def _invoke() -> None:
            try:
                fut.resolve((True, fn(*args)))
            except BaseException as e:  # noqa: BLE001 - transported
                fut.resolve((False, e))

        self.post(_invoke)
        out = self.wait(fut, timeout)
        if out is TIMEOUT:
            raise TimeoutError(f"run_call timed out after {timeout}s")
        ok, value = out
        if not ok:
            raise value
        return value

    # -- lifecycle ---------------------------------------------------------

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            self._wakeup.notify()
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=5.0)

    def _run(self) -> None:
        while True:
            with self._lock:
                if self._stopped:
                    return
                while True:
                    if not self._heap:
                        self._wakeup.wait()
                        if self._stopped:
                            return
                        continue
                    when, _, timer = self._heap[0]
                    if timer.cancelled:
                        heapq.heappop(self._heap)
                        continue
                    delay = when - self.now
                    if delay <= 0:
                        heapq.heappop(self._heap)
                        break
                    self._wakeup.wait(delay)
                    if self._stopped:
                        return
                fn, args = timer._fn, timer._args
                timer._fn, timer._args = None, ()
            if fn is None:  # cancelled between pop and dispatch
                continue
            self.fired_events += 1
            try:
                if self._san is not None:
                    self._san.run_callback(fn, *args)
                else:
                    fn(*args)
            except Exception:  # pragma: no cover - keep the loop alive
                import traceback

                traceback.print_exc()


class IoScheduler(RealtimeScheduler):
    """A :class:`RealtimeScheduler` whose loop thread is ALSO the IO
    dispatcher: instead of sleeping on a condition variable between
    timers, it blocks in ``io_poll`` (the native transport's inline
    epoll reactor) and handles each event with ``io_handle`` right on
    the loop thread.

    This erases the sim-era thread topology's latency tax.  With a
    separate poller thread, every inbound frame costs two futex
    handoffs (transport → poller condvar, poller → loop ``post``);
    here a frame goes kernel → loop thread → handler inline, so a
    serial RPC round trip crosses exactly one wakeup per process.

    ``io_wake`` must interrupt a blocked ``io_poll`` (it returns
    ``None``); cross-thread ``call_at``/``post``/``stop`` use it in
    place of the condvar notify.  Wakes are level-triggered in the
    transport (an eventfd counter), so a wake that lands before the
    poll starts is not lost.

    ``io_flush`` (optional) runs on the loop thread at two points,
    distinguished by its ``force`` argument.  ``io_flush(True)`` runs
    immediately before every ``io_poll`` — nothing may sit queued while
    the loop blocks.  ``io_flush(False)`` runs after every timer
    callback, and the hook may decline it: under saturation the timer
    heap is never empty (pump ticks requeue faster than they run), so
    the before-poll flush can starve for many milliseconds — a convoy
    where every client waits on replies stuck behind engine compute.
    The soft flush bounds that starvation at one callback, while still
    letting the hook accumulate replies across back-to-back cheap
    callbacks into one vectored write per connection.
    """

    def __init__(
        self,
        io_poll: Callable[[float], Any],
        io_handle: Callable[[Any], None],
        io_wake: Callable[[], None],
        idle_max: float = 0.2,
        io_flush: Optional[Callable[[bool], None]] = None,
        name: str = "multiraft-loop",
    ) -> None:
        self._io_poll = io_poll
        self._io_handle = io_handle
        self._io_wake = io_wake
        self._io_flush = io_flush
        self._idle_max = idle_max
        super().__init__(name=name)

    def flush_io(self) -> None:
        """Run the io_flush hook forced, from the loop thread.  The
        entry point for callbacks that KNOW they are about to block the
        loop for a while (engine pump ticks): queued replies leave
        before the grind instead of aging through it."""
        if self._io_flush is not None and self.on_loop_thread():
            self._io_flush(True)

    def call_at(self, when: float, fn: Callable, *args: Any) -> Timer:
        timer = Timer(when, fn, args)
        with self._lock:
            self._seq += 1
            heapq.heappush(self._heap, (when, self._seq, timer))
        # The loop blocks in io_poll, not on the condvar — interrupt it
        # unless we ARE the loop (it re-checks the heap after every
        # callback and IO event anyway, so a self-wake is pure syscall
        # overhead on the hot path).
        if threading.current_thread() is not self._thread:
            self._io_wake()
        return timer

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
        self._io_wake()
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=5.0)

    def _run(self) -> None:
        while True:
            fn = args = None
            popped = False
            with self._lock:
                if self._stopped:
                    return
                delay = self._idle_max
                while self._heap:
                    when, _, timer = self._heap[0]
                    if timer.cancelled:
                        heapq.heappop(self._heap)
                        continue
                    d = when - self.now
                    if d <= 0:
                        heapq.heappop(self._heap)
                        fn, args = timer._fn, timer._args
                        timer._fn, timer._args = None, ()
                        popped = True
                    else:
                        delay = min(d, self._idle_max)
                    break
            if popped:
                if fn is not None:  # else cancelled between push and pop
                    self.fired_events += 1
                    try:
                        if self._san is not None:
                            self._san.run_callback(fn, *args)
                        else:
                            fn(*args)
                    except Exception:  # pragma: no cover - keep loop alive
                        import traceback

                        traceback.print_exc()
                    # Soft flush after every timer callback: the hook
                    # flushes only replies old enough that waiting out
                    # another (potentially milliseconds-long) pump tick
                    # would hurt, and keeps batching fresh ones.
                    if self._io_flush is not None:
                        try:
                            self._io_flush(False)
                        except Exception:  # pragma: no cover
                            import traceback

                            traceback.print_exc()
                continue
            if self._io_flush is not None:
                try:
                    self._io_flush(True)
                except Exception:  # pragma: no cover - keep the loop alive
                    import traceback

                    traceback.print_exc()
            ev = self._io_poll(delay)
            if ev is not None:
                self.fired_events += 1
                try:
                    if self._san is not None:
                        self._san.run_callback(self._io_handle, ev)
                    else:
                        self._io_handle(ev)
                except Exception:  # pragma: no cover - keep the loop alive
                    import traceback

                    traceback.print_exc()


class PumpCadence:
    """Adaptive pump scheduling shared by the serving loops: pump HOT
    (a fraction of the idle interval) while client work is in flight,
    idle cadence otherwise.  The fixed-interval loop leaves the pump
    ~half idle under load (measured: the in-process framed ceiling
    rises 28k → 45k ops/s at a fixed hot cadence); the idle interval
    still bounds the steady-state CPU burn, and the hot interval keeps
    a real idle window each cycle so the socket reactor (the
    scheduler's idle wait) continues to run.

    GATED ON CORE COUNT, like the transport's adaptive busy-poll
    (tcp.py MRT_SPIN_US): on a single-CPU box the hot pump steals the
    co-located clients' cycles and the end-to-end number DROPS
    (measured −38% on the 1-core test VM), so single-core hosts keep
    the fixed cadence.  ``MRT_PUMP_HOT=1/0`` overrides."""

    HOT_DIV = 5     # hot interval = interval / HOT_DIV
    HOT_PUMPS = 3   # stay hot this many pumps past the last work

    def __init__(self, interval: float) -> None:
        self.interval = interval
        self.hot_interval = interval / self.HOT_DIV
        self.enabled = knob_bool("MRT_PUMP_HOT",
                                 default=usable_cpus() > 1)
        self._hot = 0

    def next_delay(self, busy: bool) -> float:
        """``busy`` = the service observed in-flight work this pump
        (entries applied, or commands waiting in the backlog)."""
        if not self.enabled:
            return self.interval
        if busy:
            self._hot = self.HOT_PUMPS
            return self.hot_interval
        if self._hot:
            self._hot -= 1
            return self.hot_interval
        return self.interval


def service_busy(svc) -> bool:
    """The serving loops' shared work-pending signal: the last sweep
    applied entries, or submitted commands await ingestion."""
    return bool(svc.last_applied) or bool(svc.driver.backlog.any())
