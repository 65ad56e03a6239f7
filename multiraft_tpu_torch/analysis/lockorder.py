"""Dynamic lock-order recorder: the runtime cross-check for the
static audit in :mod:`.lockgraph`.

Go's race detector instruments every acquisition; we cannot, but we
can wrap the handful of *named* locks in the transport stack and
record the observed acquisition-order graph while the chaos tests
drive real traffic.  If the graph ever contains a cycle, two threads
can interleave into an ABBA deadlock even if no run has hung yet.

Usage (see tests/test_chaos.py)::

    rec = LockOrderRecorder()
    rec.wrap(node, "_lock", "RpcNode._lock")
    rec.wrap(node._tr, "_lock", "NativeTransport._lock")
    ... drive traffic ...
    rec.assert_acyclic()

The wrapper is a transparent proxy installed on the *instance*
attribute, so only the objects under test pay the (tiny) bookkeeping
cost; nothing global is monkeypatched.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Set, Tuple

__all__ = ["LockOrderRecorder", "RecordingLock"]


class RecordingLock:
    """Proxy around a ``threading.Lock``-like object that reports
    acquire/release to a :class:`LockOrderRecorder`."""

    def __init__(self, inner, label: str, rec: "LockOrderRecorder") -> None:
        self._inner = inner
        self._label = label
        self._rec = rec

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._rec._acquired(self._label)
        return ok

    def release(self) -> None:
        self._inner.release()
        self._rec._released(self._label)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class LockOrderRecorder:
    """Observed acquisition-order graph across all threads."""

    def __init__(
        self,
        on_edge: Optional[Callable[[str, str, str], None]] = None,
    ) -> None:
        self._tls = threading.local()
        self._mu = threading.Lock()
        # (held_label, acquired_label) → witness thread name
        self.edges: Dict[Tuple[str, str], str] = {}
        # Called once per NEW edge as (held, acquired, thread_name),
        # outside the recorder's own lock — the runtime sanitizer uses
        # it to check acyclicity as edges appear instead of only at
        # test teardown.
        self._on_edge = on_edge

    # -- wiring ------------------------------------------------------------

    def wrap(self, obj, attr: str, label: Optional[str] = None) -> None:
        """Replace ``obj.<attr>`` with a recording proxy."""
        label = label or f"{type(obj).__name__}.{attr}"
        inner = getattr(obj, attr)
        if isinstance(inner, RecordingLock):  # idempotent
            return
        setattr(obj, attr, RecordingLock(inner, label, self))

    # -- recording (called from RecordingLock) -----------------------------

    def _stack(self) -> List[str]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _acquired(self, label: str) -> None:
        st = self._stack()
        if st:
            new = [
                (h, label)
                for h in st
                if h != label and (h, label) not in self.edges
            ]
            if new:
                tname = threading.current_thread().name
                inserted: List[Tuple[str, str]] = []
                with self._mu:
                    for key in new:
                        if key not in self.edges:
                            self.edges[key] = tname
                            inserted.append(key)
                if self._on_edge is not None:
                    for held, acq in inserted:
                        self._on_edge(held, acq, tname)
        st.append(label)

    def _released(self, label: str) -> None:
        st = self._stack()
        # locks may release out of LIFO order; drop the last occurrence
        for i in range(len(st) - 1, -1, -1):
            if st[i] == label:
                del st[i]
                break

    # -- queries -----------------------------------------------------------

    def cycle(self) -> Optional[List[str]]:
        """One observed acquisition-order cycle, or None."""
        graph: Dict[str, Set[str]] = {}
        for (a, b) in self.edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        WHITE, GREY, BLACK = 0, 1, 2
        color = {n: WHITE for n in graph}
        stack: List[str] = []

        def dfs(n: str) -> Optional[List[str]]:
            color[n] = GREY
            stack.append(n)
            for m in graph.get(n, ()):  # noqa: B007
                if color[m] == GREY:
                    return stack[stack.index(m):] + [m]
                if color[m] == WHITE:
                    got = dfs(m)
                    if got:
                        return got
            stack.pop()
            color[n] = BLACK
            return None

        for n in list(graph):
            if color[n] == WHITE:
                got = dfs(n)
                if got:
                    return got
        return None

    def assert_acyclic(self) -> None:
        cyc = self.cycle()
        if cyc is not None:
            raise AssertionError(
                "observed lock acquisition-order cycle (potential ABBA "
                f"deadlock): {' -> '.join(cyc)}; edges={sorted(self.edges)}"
            )
