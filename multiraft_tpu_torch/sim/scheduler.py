"""Virtual-time discrete-event scheduler — the framework's host runtime.

The reference runs each Raft peer as 3+2(n-1) goroutines on wall-clock
timers (reference: raft/raft.go:51-87, labrpc/labrpc.go:153-165).  The
TPU-native design inverts that: every node, client, and network delivery is
an *event* on one deterministic virtual clock.  This gives

  * determinism — a seeded run replays bit-for-bit (no data races by
    construction, replacing ``go test -race``),
  * speed — a "5 second" fault-injection scenario executes in milliseconds
    of real time because sleeps cost nothing,
  * a direct path to the batched engine — the engine's tick loop is this
    scheduler with a fixed tick quantum and a dense mailbox.

Blocking control flow (clerk retry loops, server wait-channels —
reference: kvraft/client.go:47-71, kvraft/server.go:56-96) is expressed as
generator coroutines that ``yield`` :class:`Future` objects.
"""

from __future__ import annotations

import heapq
import types
from typing import Any, Callable, Generator, Optional

__all__ = [
    "Future",
    "Scheduler",
    "Timer",
    "TIMEOUT",
    "DeadlockError",
]


class _TimeoutSentinel:
    """Unique sentinel distinguishing a timeout from any RPC reply."""

    _instance: "_TimeoutSentinel | None" = None

    def __new__(cls) -> "_TimeoutSentinel":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return "<TIMEOUT>"

    def __bool__(self) -> bool:
        return False


TIMEOUT = _TimeoutSentinel()


class DeadlockError(RuntimeError):
    """Raised when the event loop runs dry while a caller still waits."""


class Future:
    """A one-shot value container resolved by the scheduler.

    Coroutines ``yield`` a Future to suspend until it resolves.  Unlike
    asyncio futures there is no exception transport — failures are encoded
    as values (``None`` for a dropped RPC, :data:`TIMEOUT` for a timer
    race), mirroring labrpc's boolean ``ok`` result
    (reference: labrpc/labrpc.go:87-126).
    """

    __slots__ = ("done", "value", "_callbacks")

    def __init__(self) -> None:
        self.done = False
        self.value: Any = None
        self._callbacks: list[Callable[["Future"], None]] = []

    def resolve(self, value: Any = None) -> None:
        if self.done:
            return
        self.done = True
        self.value = value
        callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            cb(self)

    def add_done_callback(self, cb: Callable[["Future"], None]) -> None:
        if self.done:
            cb(self)
        else:
            self._callbacks.append(cb)


class Timer:
    """Cancellable handle for a scheduled callback."""

    __slots__ = ("when", "cancelled", "_fn", "_args")

    def __init__(self, when: float, fn: Callable, args: tuple) -> None:
        self.when = when
        self.cancelled = False
        self._fn = fn
        self._args = args

    def cancel(self) -> None:
        self.cancelled = True
        self._fn = None
        self._args = ()


class Scheduler:
    """Deterministic virtual-time event loop.

    All timestamps are virtual seconds.  Events at equal timestamps fire in
    scheduling order (a monotone sequence number breaks ties), so a seeded
    simulation is fully reproducible.
    """

    def __init__(self) -> None:
        self.now: float = 0.0
        self._heap: list[tuple[float, int, Timer]] = []
        self._seq = 0
        # Count of live (uncancelled, unfired) events, kept so tests can
        # detect runaway simulations cheaply.
        self.fired_events = 0

    # -- scheduling -------------------------------------------------------

    def call_at(self, when: float, fn: Callable, *args: Any) -> Timer:
        if when < self.now:
            when = self.now
        self._seq += 1
        timer = Timer(when, fn, args)
        heapq.heappush(self._heap, (when, self._seq, timer))
        return timer

    def call_after(self, delay: float, fn: Callable, *args: Any) -> Timer:
        return self.call_at(self.now + delay, fn, *args)

    def call_soon(self, fn: Callable, *args: Any) -> Timer:
        return self.call_at(self.now, fn, *args)

    # -- futures / coroutines --------------------------------------------

    def sleep(self, delay: float) -> Future:
        fut = Future()
        self.call_after(delay, fut.resolve, None)
        return fut

    def with_timeout(self, fut: Future, timeout: float) -> Future:
        """A future resolving to ``fut.value``, or :data:`TIMEOUT` if the
        timer wins — the clerk's 100 ms retry pattern
        (reference: kvraft/client.go:57-69)."""
        out = Future()
        timer = self.call_after(timeout, out.resolve, TIMEOUT)

        def _done(f: Future) -> None:
            timer.cancel()
            out.resolve(f.value)

        fut.add_done_callback(_done)
        return out

    def spawn(self, gen: Generator) -> Future:
        """Drive a generator coroutine; the returned future resolves with
        the generator's return value.

        Resolving the returned future externally *cancels* the coroutine:
        the next step notices and closes the generator instead of driving
        it further.  ``BlockingClerk`` uses this to abandon retry loops
        whose caller timed out."""
        result = Future()
        if not isinstance(gen, types.GeneratorType):
            # Allow plain functions that return a value immediately.
            result.resolve(gen)
            return result

        def step(send_value: Any) -> None:
            if result.done:  # cancelled from outside
                gen.close()
                return
            try:
                waited = gen.send(send_value)
            except StopIteration as stop:
                result.resolve(stop.value)
                return
            if isinstance(waited, Future):
                waited.add_done_callback(lambda f: step(f.value))
            elif isinstance(waited, (int, float)):
                # ``yield seconds`` sleeps.
                self.call_after(float(waited), step, None)
            else:  # pragma: no cover - defensive
                raise TypeError(f"coroutine yielded {waited!r}")

        self.call_soon(step, None)
        return result

    # -- running ----------------------------------------------------------

    def _pop(self) -> Optional[Timer]:
        while self._heap:
            _, _, timer = heapq.heappop(self._heap)
            if not timer.cancelled:
                return timer
        return None

    def run_until(
        self,
        fut: Optional[Future] = None,
        deadline: Optional[float] = None,
        max_events: Optional[int] = None,
    ) -> Any:
        """Run events until ``fut`` resolves (returning its value), the
        virtual ``deadline`` passes, or the heap drains.

        With a future and no deadline, a drained heap means no event can
        ever resolve it — that is a deadlock, reported loudly rather than
        hung (the reference relies on the 2-minute wall-clock test cap for
        this, raft/config.go:342-347).
        """
        budget = max_events
        while True:
            if fut is not None and fut.done:
                return fut.value
            if budget is not None and budget <= 0:
                raise RuntimeError("scheduler exceeded max_events budget")
            timer = self._pop()
            if timer is None:
                if fut is not None:
                    raise DeadlockError(
                        f"event loop drained at t={self.now:.6f} with an "
                        "unresolved future — simulated deadlock"
                    )
                if deadline is not None and deadline > self.now:
                    self.now = deadline
                return None
            if deadline is not None and timer.when > deadline:
                # Put it back; the caller only wanted time advanced so far.
                self._seq += 1
                heapq.heappush(self._heap, (timer.when, self._seq, timer))
                self.now = deadline
                return fut.value if (fut is not None and fut.done) else None
            self.now = timer.when
            fn, args = timer._fn, timer._args
            timer._fn, timer._args = None, ()
            self.fired_events += 1
            if budget is not None:
                budget -= 1
            fn(*args)

    def run_for(self, duration: float) -> None:
        """Advance virtual time by ``duration``, firing due events."""
        self.run_until(deadline=self.now + duration)

    def pending_events(self) -> int:
        return sum(1 for _, _, t in self._heap if not t.cancelled)
