"""Continuous sampling profiler: CPU attribution from socket to tick.

The telemetry plane measures *where requests wait* (stage clocks,
observe.py) and *what happened after death* (flight rings,
flightrec.py) — this module measures *where CPU time goes*.  Every
process runs one daemon sampler thread over ``sys._current_frames()``
at a configurable rate, folding each thread's stack into a bounded
``{folded_stack: count}`` aggregate keyed by THREAD NAME — which is
why every long-lived thread in the tree is named at its spawn site
(``multiraft-loop/<node>``, ``porcupine-sampler-<i>``, ...): the
profile is readable attribution, not ``Thread-7``.

Design points, in the order they matter:

* **Sampling, not tracing.**  ``sys._current_frames()`` is one C call
  returning every thread's current frame; walking ``f_back`` chains is
  pure pointer chasing, and per-code-object label memoization keeps a
  sample at ~40 µs.  The default rate adapts to the host (67 Hz with
  spare cores, 19 Hz on one CPU where every wakeup preempts the
  serving thread — see :func:`_default_hz`), keeping measured cost on
  the firehose-sockets bench <2% throughput (BENCHMARKS "Continuous
  profiling") — which is what lets ``MRT_PROFILE`` default ON: a
  profiler you must remember to enable is never running when the
  incident happens.  Both rates are prime: they avoid lockstep with
  10 ms scheduler timers and 100 Hz OS tick harmonics.
* **Folded stacks, bounded memory.**  Aggregation is a dict from
  ``"thread;mod.fn;mod.fn;..."`` (root first, the flamegraph collapsed
  format) to sample count, capped at ``MRT_PROFILE_MAX_STACKS``
  distinct keys; once full, new stacks fold into a per-thread
  ``(overflow)`` bucket and ``overflow`` counts them — stack churn
  (deep recursion over varying data) costs a counter, never unbounded
  memory.  Frame walks are depth-capped at ``MRT_PROFILE_DEPTH``
  (deepest frames kept — the leaf names the hot function; the root
  beyond the cap collapses into ``(...)``).
* **Drain-on-read fleet scrape.**  ``Obs.profile`` (observe.py) drains
  the aggregate — repeated scrapes never double-count a sample, and
  the windowed scrape discipline the loadcurve already uses for
  histograms applies unchanged: each rate step's profile is exactly
  the samples taken during that step.  Obs verbs are control-exempt
  (``CONTROL_PREFIXES``), so chaos cannot partition the profiler away.
* **Self-accounting.**  The sampler measures its own cost
  (``self_cpu_s`` via ``time.thread_time`` deltas on the sampler
  thread) and reports it in every snapshot, so the overhead budget is
  continuously observable, not a one-time benchmark claim.
* **Black-box breadcrumbs.**  Once a second the sampler drops a PROF
  flight record (samples, distinct stacks, hottest leaf function in
  the tag, and — in the code field — process CPU busy per-mille of
  wall over the breadcrumb window) so a SIGKILL'd process still
  leaves evidence of what it was burning CPU on — the postmortem
  doctor reads these next to the OVERLOAD records to split "CPU
  saturation" (busy ≈ 1000‰: the stage's CPU-seconds fill the wall
  window, the tag names the hot function) from "queueing collapse"
  (queues diverged while the CPU sat idle).

The pure helpers at the bottom (:func:`merge_folded`,
:func:`top_functions`, :func:`per_thread_totals`, :func:`to_collapsed`)
are shared by the fleet merger (harness/observe.py), the loadcurve
per-window attribution (harness/loadcurve.py), and the CLI
(scripts/profile_summary.py) — one vocabulary end to end.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ..utils.knobs import knob_bool, knob_float, knob_int

__all__ = [
    "SERVING_THREAD_PREFIXES",
    "SamplingProfiler",
    "profiler_enabled",
    "get_profiler",
    "maybe_start_profiler",
    "fold_frame",
    "merge_folded",
    "top_functions",
    "per_thread_totals",
    "to_collapsed",
    "from_collapsed",
    "diff_folded",
]

_PROFILE = knob_bool("MRT_PROFILE")

# Thread-name prefixes counting as SERVING-side CPU in ranking cuts
# (loadcurve per-window attribution, openloop sweeps): the scheduler
# loops and, since the asynchronous pipeline, the engine-pump threads
# that block on device readbacks on the loops' behalf
# (distributed/engine_pump.py).  A new serving thread family must be
# added here or its CPU silently drops out of the serving headline.
SERVING_THREAD_PREFIXES: Tuple[str, ...] = (
    "multiraft-loop",
    "multiraft-pump",
)


def _default_hz() -> float:
    """Sampling rate: 67 Hz with spare cores, 19 Hz on a 1-CPU host.

    On multi-core the sampler runs BESIDE the workers and the budget is
    its own CPU (~40 µs/sample → ~0.3% of one core at 67 Hz).  On one
    CPU the budget is WAKEUPS, not sampler CPU: every sample forces a
    GIL handoff that preempts the serving thread mid-batch (smaller
    socket batches per epoll wake → more syscalls per op), measured at
    ~0.08% throughput per Hz on the firehose bench — 67 Hz would cost
    ~5%, 19 Hz stays under the 2% default-on budget (BENCHMARKS
    "Continuous profiling").  Both primes, off OS-tick harmonics.
    ``MRT_PROFILE_HZ`` overrides unconditionally."""
    try:
        ncpu = len(os.sched_getaffinity(0))  # type: ignore[attr-defined]
    except AttributeError:  # non-Linux
        ncpu = os.cpu_count() or 1
    return knob_float("MRT_PROFILE_HZ",
                      default=67.0 if ncpu > 1 else 19.0)


_DEF_HZ = _default_hz()
_DEF_DEPTH = knob_int("MRT_PROFILE_DEPTH")
_DEF_MAX_STACKS = knob_int("MRT_PROFILE_MAX_STACKS")

OVERFLOW_FRAME = "(overflow)"
TRUNC_FRAME = "(...)"


def profiler_enabled() -> bool:
    """True unless ``MRT_PROFILE=0`` (read once at import)."""
    return _PROFILE


def _mod_of(filename: str) -> str:
    """Compact module label from a code object's filename: the
    basename without ``.py`` (``.../distributed/tcp.py`` → ``tcp``).
    Package-qualified names would be prettier but cost a path walk per
    frame on the sampling hot path; the basename is unambiguous within
    this tree and short enough for 20-byte flight-record tags."""
    base = filename.rsplit("/", 1)[-1].rsplit("\\", 1)[-1]
    return base[:-3] if base.endswith(".py") else base


# Per-code-object label memo.  Code objects are module-lifetime, so
# keying on them directly turns the per-frame f-string + basename work
# into one dict hit after the first sample of each function — the
# difference between ~2.6% and <1% sampler overhead on a 1-CPU host.
# Capped so pathological codegen (exec'd one-shot code objects) cannot
# pin memory; past the cap labels are rebuilt per sample, never wrong.
_label_cache: Dict[Any, str] = {}
_LABEL_CACHE_MAX = 32768


def _frame_label(code: Any) -> str:
    lbl = _label_cache.get(code)
    if lbl is None:
        name = getattr(code, "co_qualname", None) or code.co_name
        lbl = f"{_mod_of(code.co_filename)}.{name}"
        if len(_label_cache) < _LABEL_CACHE_MAX:
            _label_cache[code] = lbl
    return lbl


def fold_frame(frame: Any, depth: int = _DEF_DEPTH) -> str:
    """Fold one thread's live frame chain into the collapsed-stack
    string, ROOT FIRST (``main;tcp._run;codec.decode``).  Deterministic
    for a given frame chain — the property the folded-stack tests pin.
    Deeper than ``depth`` keeps the LEAF side (the hot function) and
    collapses the excess root into ``(...)``."""
    parts: List[str] = []
    f = frame
    while f is not None and len(parts) < depth:
        parts.append(_frame_label(f.f_code))
        f = f.f_back
    if f is not None:
        parts.append(TRUNC_FRAME)
    parts.reverse()
    return ";".join(parts)


class SamplingProfiler:
    """One process's continuous sampler (start/stop idempotent).

    The aggregate maps ``"thread;frames..."`` → count; ``snapshot()``
    copies it, ``drain()`` hands it off and resets — the Obs scrape
    verb.  All mutation happens under ``_lock`` (sampler thread writes,
    scrape reads cross-thread)."""

    def __init__(
        self,
        hz: float = _DEF_HZ,
        depth: int = _DEF_DEPTH,
        max_stacks: int = _DEF_MAX_STACKS,
    ) -> None:
        self.hz = max(float(hz), 0.1)
        self.depth = int(depth)
        self.max_stacks = int(max_stacks)
        self.stacks: Dict[str, int] = {}
        self.samples = 0
        self.overflow = 0
        self.errors = 0
        self.self_cpu_s = 0.0
        self.started_at: Optional[float] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # ident → thread name, lazily rebuilt: only when a sampled
        # ident is unknown (a thread was spawned) or on the periodic
        # refresh in sample_once (drops names of dead threads).
        # threading.enumerate() per sample is the other avoidable
        # per-sample allocation on the hot path.
        self._names: Dict[int, str] = {}

    # -- lifecycle --------------------------------------------------------

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> "SamplingProfiler":
        """Spawn the sampler thread (no-op if already running)."""
        if self.running:
            return self
        self._stop.clear()
        self.started_at = time.perf_counter()
        self._thread = threading.Thread(
            target=self._run, name="mrt-profiler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop and join the sampler (no-op if not running)."""
        t = self._thread
        if t is None:
            return
        self._stop.set()
        if t.is_alive() and t is not threading.current_thread():
            t.join(timeout=2.0)
        self._thread = None

    # -- sampling ---------------------------------------------------------

    def _run(self) -> None:
        interval = 1.0 / self.hz
        rec = None
        try:  # local import: flightrec imports observe, not us — but
            from .flightrec import PROF, get_recorder  # keep lazy anyway
            rec = get_recorder()
        except Exception:
            PROF = 0
        last_wall = time.perf_counter()
        last_cpu = time.process_time()
        next_rec = last_wall + 1.0
        while not self._stop.wait(interval):
            t0 = time.thread_time()
            try:
                self.sample_once()
            except Exception:
                with self._lock:
                    self.errors += 1
            self.self_cpu_s += time.thread_time() - t0
            if rec is not None:
                now = time.perf_counter()
                if now >= next_rec:
                    next_rec = now + 1.0
                    # Busy per-mille: process CPU over wall since the
                    # last breadcrumb.  ~1000‰ means one thread pegged
                    # the window end to end (can exceed 1000 with
                    # several busy threads) — the doctor's CPU-
                    # saturation evidence.  Clamped to the record's
                    # u16 code field.
                    cpu = time.process_time()
                    dw = now - last_wall
                    busy = (
                        int(1000.0 * (cpu - last_cpu) / dw)
                        if dw > 0 else 0
                    )
                    last_wall, last_cpu = now, cpu
                    with self._lock:
                        hot = self._hottest_leaf()
                        rec.record(
                            PROF, max(0, min(busy, 64000)),
                            self.samples, len(self.stacks),
                            self.overflow, tag=hot,
                        )

    def sample_once(self) -> None:
        """Take exactly one sample of every thread but the sampler's
        own (callable directly — the deterministic test hook; the
        sampler thread calls it on its cadence)."""
        me = threading.get_ident()
        frames = sys._current_frames()
        names = self._names
        if (
            any(i != me and i not in names for i in frames)
            or self.samples % 256 == 0
        ):
            names = self._names = {
                t.ident: t.name
                for t in threading.enumerate()
                if t.ident is not None
            }
        with self._lock:
            self.samples += 1
            for ident, frame in frames.items():
                if ident == me:
                    continue
                tname = names.get(ident, f"tid-{ident}")
                key = f"{tname};{fold_frame(frame, self.depth)}"
                n = self.stacks.get(key)
                if n is not None:
                    self.stacks[key] = n + 1
                elif len(self.stacks) < self.max_stacks:
                    self.stacks[key] = 1
                else:
                    self.overflow += 1
                    okey = f"{tname};{OVERFLOW_FRAME}"
                    self.stacks[okey] = self.stacks.get(okey, 0) + 1

    def _hottest_leaf(self) -> str:
        """Leaf function of the highest-count stack (lock held)."""
        if not self.stacks:
            return ""
        key = max(self.stacks, key=self.stacks.__getitem__)
        return key.rsplit(";", 1)[-1][:20]

    # -- scrape -----------------------------------------------------------

    def _dump(self, reset: bool) -> Dict[str, Any]:
        with self._lock:
            out = {
                "hz": self.hz,
                "samples": self.samples,
                "overflow": self.overflow,
                "errors": self.errors,
                "self_cpu_s": round(self.self_cpu_s, 6),
                "stacks": dict(self.stacks),
            }
            if reset:
                self.stacks = {}
                self.samples = 0
                self.overflow = 0
        return out

    def snapshot(self) -> Dict[str, Any]:
        """Read-only copy of the aggregate (counts keep accumulating)."""
        return self._dump(reset=False)

    def drain(self) -> Dict[str, Any]:
        """Hand off the aggregate and reset it — the scrape protocol:
        repeated drains never duplicate a sample.  ``self_cpu_s`` and
        ``errors`` stay cumulative (they are overhead/health telemetry,
        not window data)."""
        return self._dump(reset=True)


# -- process singleton ------------------------------------------------------

_proc_lock = threading.Lock()
_proc_profiler: Optional[SamplingProfiler] = None


def get_profiler() -> Optional[SamplingProfiler]:
    """The process's running profiler, if any (None when disabled or
    never started)."""
    return _proc_profiler


def maybe_start_profiler() -> Optional[SamplingProfiler]:
    """Start the per-process sampler if ``MRT_PROFILE`` allows it
    (idempotent; every RpcNode calls this at construction — first node
    in a process starts the sampler, the rest share it)."""
    global _proc_profiler
    if not _PROFILE:
        return None
    with _proc_lock:
        if _proc_profiler is None:
            _proc_profiler = SamplingProfiler()
            _proc_profiler.start()
        return _proc_profiler


# -- pure folded-stack algebra (shared by fleet merge / CLI / loadcurve) ----

def merge_folded(dumps: Iterable[Dict[str, int]]) -> Dict[str, int]:
    """Merge many ``{folded: count}`` aggregates into one (exact —
    sample counts add)."""
    out: Dict[str, int] = {}
    for d in dumps:
        for k, v in d.items():
            out[k] = out.get(k, 0) + int(v)
    return out


def diff_folded(
    after: Dict[str, int], before: Dict[str, int]
) -> Dict[str, int]:
    """``after − before`` per stack, clamped at 0 and 0-entries
    dropped — the window between two cumulative snapshots."""
    out: Dict[str, int] = {}
    for k, v in after.items():
        d = int(v) - int(before.get(k, 0))
        if d > 0:
            out[k] = d
    return out


def _split(key: str) -> Tuple[str, List[str]]:
    parts = key.split(";")
    return parts[0], parts[1:]


def per_thread_totals(folded: Dict[str, int]) -> Dict[str, int]:
    """Samples per thread name (first folded segment)."""
    out: Dict[str, int] = {}
    for k, v in folded.items():
        t, _ = _split(k)
        out[t] = out.get(t, 0) + int(v)
    return out


def top_functions(
    folded: Dict[str, int], n: int = 10
) -> List[Dict[str, Any]]:
    """Rank functions by SELF samples (leaf of the stack — where the
    CPU actually was), carrying cumulative (anywhere-on-stack) counts
    alongside: ``[{"func", "self", "cum"}, ...]``.  Cumulative counts
    a function once per stack it appears on (recursion doesn't double
    count).  Synthetic frames — ``(overflow)``, ``(...)`` — rank like
    any other so truncation is visible in the report."""
    self_c: Dict[str, int] = {}
    cum_c: Dict[str, int] = {}
    for k, v in folded.items():
        _, frames = _split(k)
        if not frames:
            continue
        v = int(v)
        leaf = frames[-1]
        self_c[leaf] = self_c.get(leaf, 0) + v
        for fn in set(frames):
            cum_c[fn] = cum_c.get(fn, 0) + v
    ranked = sorted(self_c.items(), key=lambda kv: (-kv[1], kv[0]))
    return [
        {"func": fn, "self": s, "cum": cum_c.get(fn, s)}
        for fn, s in ranked[:n]
    ]


def to_collapsed(folded: Dict[str, int]) -> str:
    """Render as flamegraph collapsed format: one ``stack count`` line
    per entry, sorted for determinism (feed to ``flamegraph.pl`` or
    speedscope directly)."""
    return "\n".join(
        f"{k} {int(v)}" for k, v in sorted(folded.items())
    )


def from_collapsed(text: str) -> Dict[str, int]:
    """Parse :func:`to_collapsed` output (tolerates blank lines)."""
    out: Dict[str, int] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        stack, _, cnt = line.rpartition(" ")
        if not stack:
            continue
        try:
            out[stack] = out.get(stack, 0) + int(cnt)
        except ValueError:
            continue
    return out
