"""The program's phase spans (``mrt.*``, from ``multiraft_tpu_torch``'s
tick) grouped into PERF.md's layers, for the per-layer readers.

Two readings per layer:

* :func:`idle_share`: of the stretch traced with the host's activity,
  the device's idle gaps whose midpoint falls under one of the layer's
  spans, over the stretch's window, in %.  A gap goes to the innermost
  ``mrt.*`` span covering its midpoint; an ``mrt.kernel.*`` range counts
  under the phase around it.  The gap walk and the midpoint rule are
  those of :meth:`cellbench.trace.Stretch.idle_gaps`.
* :func:`device_ms_per_tick`: the program's own per-phase device
  milliseconds (``multiraft_tpu_torch.utils.trace.PHASES``, CUDA events
  at the phases' ends) over the device stretch's ticks, which are the
  first ``harness.TRACE_TICKS`` of the recorder's first session: the
  harness traces the device stretch first (``harness.STRETCHES``).

Each takes a layer of :data:`LAYERS` or a tuple of ``mrt.*`` span names,
so that a reader of other spans is a file of its own.  A program without
these spans or that recorder reads as nothing: each function then
returns None.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional, Tuple, Union

from .harness import TRACE_TICKS, log
from .trace import gaps

LAYERS = {
    "prng": ("mrt.prng",),
    "recovery": ("mrt.votes", "mrt.tally", "mrt.fast_forward", "mrt.check_quorum",
                 "mrt.elections"),
    "replication": ("mrt.append", "mrt.commit", "mrt.ingest", "mrt.sends"),
}
PREFIX = "mrt."
KERNEL_PREFIX = "mrt.kernel."
NO_SPAN = ""  # idle time under no mrt.* span
Spans = Union[str, Tuple[str, ...]]  # a layer of LAYERS, or span names

# The last reading of each kind, with what it read: a run's three readers
# of a kind share one reading and one log line.
_memo: Dict[str, tuple] = {}


def _once(kind: str, obj, compute):
    hit = _memo.get(kind)
    if hit is None or hit[0] is not obj:
        hit = _memo[kind] = (obj, compute(obj))
    return hit[1]


def spans_of(spans: Spans) -> Tuple[str, ...]:
    return LAYERS[spans] if isinstance(spans, str) else tuple(spans)


def _phase_spans(stretch):
    return sorted((ts, ts + dur, name) for name, ts, dur in stretch.host_ops
                  if name.startswith(PREFIX) and not name.startswith(KERNEL_PREFIX))


def _innermost(spans, points):
    """For each of the ascending ``points``, the name of the shortest of
    the ``spans`` (sorted by start) that covers it, :data:`NO_SPAN` where
    none does: the rule of ``Stretch.idle_gaps``."""
    out, i, active = [], 0, []
    for x in points:
        while i < len(spans) and spans[i][0] <= x:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s[1] > x]
        out.append(min((e - s, name) for s, e, name in active)[1] if active else NO_SPAN)
    return out


def idle_by_span(stretch) -> Optional[Dict[str, float]]:
    """Idle microseconds in ``stretch``'s window by the innermost
    ``mrt.*`` phase span over each gap's midpoint (:data:`NO_SPAN`: none);
    None if the stretch holds no such span."""
    spans = _phase_spans(stretch)
    if not spans:
        return None
    idle = gaps(stretch.busy_intervals(), stretch.window)
    by: Dict[str, float] = defaultdict(float)
    for (a, b), name in zip(idle, _innermost(spans, [(a + b) / 2 for a, b in idle])):
        by[name] += b - a
    return dict(by)


def ops_by_span(stretch) -> Dict[str, int]:
    """Top-level ATen operations (none inside another) by the innermost
    ``mrt.*`` phase span over each one's midpoint."""
    top, end = [], float("-inf")
    for ts, dur in sorted((ts, dur) for name, ts, dur in stretch.host_ops
                          if name.startswith("aten::")):
        if ts >= end:
            top.append(ts + dur / 2)
            end = ts + dur
    by: Dict[str, int] = defaultdict(int)
    for name in _innermost(_phase_spans(stretch), top):
        by[name] += 1
    return dict(by)


def idle_share(stretch, layer: Spans) -> Optional[float]:
    """The share of ``stretch``'s window spent idle under ``layer``'s
    spans, in %."""
    if stretch is None or stretch.window[1] <= stretch.window[0]:
        return None
    by = _once("idle", stretch, _logged_idle)
    if by is None:
        return None
    window = stretch.window[1] - stretch.window[0]
    return 100.0 * sum(by.get(s, 0.0) for s in spans_of(layer)) / window


def _logged_idle(stretch) -> Optional[Dict[str, float]]:
    by = idle_by_span(stretch)
    if by is None:
        return None
    window = stretch.window[1] - stretch.window[0]
    share = {name: 100.0 * us / window for name, us in by.items()}
    layers = {k: sum(share.get(s, 0.0) for s in v) for k, v in LAYERS.items()}
    total = 100.0 * (1.0 - stretch.busy_s / stretch.window_s)
    bare = dict(stretch.idle_gaps(len(stretch.host_ops) + 1)).get("cellbench.tick", 0.0)
    ops = ops_by_span(stretch)
    in_tick = sum(n for name, n in ops.items() if name != NO_SPAN)
    log(f"cellbench: host stretch idle share {total:.3f}%: "
        + ", ".join(f"{k} {v:.3f}" for k, v in layers.items())
        + f", under no layer {sum(share.values()) - sum(layers.values()):.3f} (of it under "
        f"no mrt span {share.get(NO_SPAN, 0.0):.3f}); remainder "
        f"{total - sum(share.values()):.4f}; by span " + ", ".join(
            f"{k or '-'} {v:.3f}" for k, v in sorted(share.items(), key=lambda kv: -kv[1])))
    log(f"cellbench: host stretch idle under cellbench.tick with no op or mrt span "
        f"{bare * 1e3 / stretch.ticks:.4f} ms a tick; top-level ATen ops a tick under mrt "
        f"spans {in_tick / stretch.ticks:.1f}, under mrt.prng "
        f"{ops.get('mrt.prng', 0) / stretch.ticks:.1f} ("
        f"{100.0 * ops.get('mrt.prng', 0) / max(in_tick, 1):.1f}%); by span " + ", ".join(
            f"{k or '-'} {v / stretch.ticks:.1f}" for k, v in
            sorted(ops.items(), key=lambda kv: -kv[1])))
    return by


def phase_ms(out) -> Optional[Dict[str, float]]:
    """Mean device ms a tick by phase over the device stretch's ticks,
    from the program's recorder; None where it has none or recorded
    nothing."""
    return _once("device", out, _phase_ms)


def _phase_ms(out) -> Optional[Dict[str, float]]:
    try:
        from multiraft_tpu_torch.utils import trace as program_trace
    except ImportError:
        return None
    rec = getattr(program_trace, "PHASES", None)
    if rec is None or not hasattr(rec, "read"):
        return None
    sessions = rec.read()
    ticks = sessions[0][:TRACE_TICKS] if sessions else []
    if not ticks:
        return None
    mean: Dict[str, float] = defaultdict(float)
    for t in ticks:
        for phase, ms in t.items():
            mean[phase] += ms / len(ticks)
    s = out.stretch
    window = s.window_s * 1e3 / s.ticks if s is not None and s.ticks else float("nan")
    log(f"cellbench: recorder, {len(ticks)} ticks of {len(sessions[0])} in its first "
        f"session ({len(sessions)} sessions, {rec.dropped} events dropped): device ms a tick "
        f"by phase " + ", ".join(f"{k} {v:.4f}" for k, v in
                                 sorted(mean.items(), key=lambda kv: -kv[1]))
        + f"; sum {sum(mean.values()):.4f} against the device stretch's window a tick "
        f"{window:.4f}")
    return dict(mean)


def device_ms_per_tick(out, layer: Spans) -> Optional[float]:
    """The device ms a tick of ``layer``'s spans over the device stretch's
    ticks."""
    ms = phase_ms(out)
    if ms is None:
        return None
    return sum(ms.get(s, 0.0) for s in spans_of(layer))
