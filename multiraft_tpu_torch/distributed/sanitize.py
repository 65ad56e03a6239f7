"""Runtime sanitizer: the dynamic twin of graftlint's serving-path
rules (``MRT_SANITIZE=1``).

The static rules (analysis/dataflow.py) prove properties about the
AST; this module asserts the same three properties about the *running*
process while the existing chaos/nemesis tests drive real traffic:

* **lock-order acyclicity** — every named lock in the transport stack
  is wrapped in :class:`~multiraft_tpu_torch.analysis.lockorder.RecordingLock`
  and the observed acquisition graph is checked for a cycle on every
  NEW edge, not just at test teardown.  A cycle is a latent ABBA
  deadlock even if no run has hung yet.
* **queue bounds** — the serving queues the ``unbounded-queue`` rule
  audits (per-connection reply backlog today) assert their cap at
  every growth site via :meth:`Sanitizer.guard_queue`.
* **callback-duration budget** — every scheduler timer/IO callback is
  timed; one exceeding ``MRT_SANITIZE_CB_BUDGET_MS`` (default 250)
  stalls every reply riding the loop thread, which is exactly what the
  ``blocking-in-callback`` rule flags statically.

A violation is never silent: it is appended to the in-process log,
written to the flight recorder (``SANITIZE`` records — the postmortem
doctor surfaces them as ``sanitizer_violation`` anomalies), printed to
stderr, and counted on every registered node's metrics
(``sanitize.violations``).  ``MRT_SANITIZE_STRICT=1`` additionally
raises :class:`SanitizerViolation` at the detection site (unit tests;
the serving loops catch-and-log so a violating process keeps serving
while still leaving evidence).

Env vars:

* ``MRT_SANITIZE=1`` — master switch; off means zero hot-path cost
  (one ``is None`` check per callback).
* ``MRT_SANITIZE_CB_BUDGET_MS`` — callback budget (float, ms).
* ``MRT_SANITIZE_STRICT=1`` — raise on violation instead of only
  recording it.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..utils.knobs import knob_bool, knob_float
from . import flightrec

__all__ = [
    "Sanitizer",
    "SanitizerViolation",
    "enabled",
    "get_sanitizer",
]

# Retained violation details (the full stream still reaches stderr,
# metrics, and the flight recorder) — the in-process log itself must
# not become the unbounded queue it polices.
_MAX_VIOLATIONS = 256


class SanitizerViolation(AssertionError):
    """Raised at the detection site under ``MRT_SANITIZE_STRICT=1``."""


class Sanitizer:
    """Process-wide runtime checker; see the module docstring.

    Constructed directly in unit tests; production code goes through
    :func:`get_sanitizer` so one instance watches the whole process."""

    def __init__(
        self, strict: bool = False, budget_ms: float = 250.0
    ) -> None:
        from ..analysis.lockorder import LockOrderRecorder

        self.strict = strict
        self.budget_s = budget_ms / 1000.0
        self.recorder = LockOrderRecorder(on_edge=self._on_lock_edge)
        self.violations: List[Dict[str, Any]] = []
        self._mu = threading.Lock()
        # Metrics sinks (Observability.metrics-shaped: .inc(name)) of
        # every node that installed us, so violations show up on the
        # scrape plane too.
        self._metrics: List[Any] = []

    # -- wiring ------------------------------------------------------------

    def install_locks(self, obj: Any, attrs: Dict[str, str]) -> None:
        """Wrap ``obj.<attr>`` locks in recording proxies;
        ``attrs`` maps attribute name → graph label."""
        for attr, label in attrs.items():
            self.recorder.wrap(obj, attr, label)

    def register_metrics(self, metrics: Any) -> None:
        with self._mu:
            if metrics not in self._metrics:
                self._metrics.append(metrics)
        metrics.inc("sanitize.active")

    # -- checks ------------------------------------------------------------

    def guard_queue(self, name: str, length: int, cap: int) -> None:
        """Assert a serving queue honors its cap (called after growth:
        a shed-oldest queue is exactly at cap, never past it)."""
        if length > cap:
            self._violate(
                "queue_bound",
                f"queue '{name}' at {length} entries, cap {cap}",
                a=length,
                b=cap,
                tag=name,
            )

    def run_callback(self, fn: Callable[..., Any], *args: Any) -> Any:
        """Run a scheduler callback under the duration budget."""
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            dur = time.perf_counter() - t0
            if dur > self.budget_s:
                label = getattr(fn, "__qualname__", None) or getattr(
                    fn, "__name__", "?"
                )
                self._violate(
                    "callback_budget",
                    f"callback {label} ran {dur * 1e3:.1f} ms on the "
                    f"loop thread (budget {self.budget_s * 1e3:.0f} ms)",
                    a=int(dur * 1e6),
                    b=int(self.budget_s * 1e6),
                    tag=label,
                )

    def _on_lock_edge(self, held: str, acquired: str, thread: str) -> None:
        cyc = self.recorder.cycle()
        if cyc is not None:
            self._violate(
                "lock_order",
                f"acquisition-order cycle {' -> '.join(cyc)} "
                f"(edge {held} -> {acquired} on thread {thread})",
                tag=acquired,
            )

    # -- reporting ---------------------------------------------------------

    def _violate(
        self, kind: str, detail: str, a: int = 0, b: int = 0, tag: str = ""
    ) -> None:
        v = {"kind": kind, "detail": detail}
        with self._mu:
            if len(self.violations) < _MAX_VIOLATIONS:
                self.violations.append(v)
            metrics = list(self._metrics)
        for m in metrics:
            try:
                m.inc("sanitize.violations")
            except Exception:  # pragma: no cover - scrape plane is best-effort
                pass
        rec = flightrec.get_recorder()
        if rec is not None:
            rec.record(
                flightrec.SANITIZE,
                code=flightrec.SANITIZE_KIND_CODES.get(kind, 0),
                a=a,
                b=b,
                tag=tag,
            )
        print(f"MRT_SANITIZE violation [{kind}]: {detail}", file=sys.stderr)
        if self.strict:
            raise SanitizerViolation(f"[{kind}] {detail}")


# Process-wide singleton, created lazily on first use when
# MRT_SANITIZE=1 (same enablement pattern as flightrec.get_recorder).
_san: Optional[Sanitizer] = None
_san_lock = threading.Lock()


def enabled() -> bool:
    return knob_bool("MRT_SANITIZE")


def get_sanitizer() -> Optional[Sanitizer]:
    """The process-wide sanitizer, or ``None`` when disabled."""
    global _san
    if not enabled():
        return None
    with _san_lock:
        if _san is None:
            _san = Sanitizer(
                strict=knob_bool("MRT_SANITIZE_STRICT"),
                budget_ms=knob_float("MRT_SANITIZE_CB_BUDGET_MS"),
            )
    return _san
