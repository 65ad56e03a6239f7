"""Compare a fresh benchmark result against its recorded trajectory (the
PyTorch port of ``scripts/bench_compare.py``: the same families, table,
direction rules and exit codes; only the default history differs).

    python -m multiraft_tpu_torch.scripts.bench_compare FRESH.json
        [--family NAME] [--threshold PCT]
        [--history 'build/rounds/BENCH_r*.json'] [--quiet]

Three result FAMILIES share one comparison engine, selected with
``--family`` (default ``bench`` — the CI invocation predates families
and must keep meaning what it meant):

* ``bench`` — ``multiraft_tpu_torch.bench`` summaries tracked as
  ``BENCH_r*.json``
  (``value`` commits/s, ``p99_commit_latency_ms``, ...);
* ``serving`` — ``benchmarks/serving_throughput.py`` firehose reports
  tracked as
  ``SERVING_r*.json`` (socket + in-process ops/s);
* ``loadcurve`` — ``benchmarks/openloop.py`` open-loop sweeps tracked as
  ``LOADCURVE_r*.json`` (max sustainable rate at the p99 target, knee
  position, and latency at the SHARED operating point: the fresh
  round's p99 is read off its curve at the incumbent round's knee
  rate, so a round that moves the knee outward — admission control
  flattening the curve — is not penalized for measuring its own knee
  further up the ladder);
* ``placement`` — ``scripts/placement_scenario.py`` controller runs
  tracked as
  ``PLACEMENT_r*.json`` (per-process commit-rate spread reduction
  after rebalancing a hot/cold skew, failover re-place time after a
  process kill, migrations executed — fewer is better: the planner
  should fix the skew with minimal movement);
* ``cpu`` — the profiling plane's CPU-attribution columns inside the
  SAME ``LOADCURVE_r*.json`` rounds (per-stage CPU-µs per acknowledged
  op at the knee step, lower is better — the cost-accounting gate the
  front-door rebuild proves its wins against; rounds recorded before
  the profiling plane lack the columns and read n/a).

``FRESH.json`` is either the family's raw result object or a round
wrapper (``{"parsed": {...}}``).  The history is every round file of
the family in the port's own rounds directory, ``build/rounds/``
(override with ``--history``, which takes any glob).  The repository
root's ``*_r*.json`` rounds were recorded by the JAX package on a TPU
and on CPUs; the card is never compared against them by default.

Prints one table row per tracked metric: the full round trajectory,
the fresh value, and the delta against the LATEST round.  Exit status:

* 0 — within ``--threshold`` (default 5%) of the latest round on every
  metric present in both (direction-aware: commits/s regresses DOWN,
  latency regresses UP; improvements never fail);
* 1 — at least one metric regressed past the threshold;
* 2 — the fresh result (or the entire history) was unreadable.

Metrics missing on either side are reported as ``n/a`` and never fail
the comparison — early rounds lack failover numbers (BENCH_r01 is a
different headline metric entirely) and a CPU-only smoke run may lack
everything but commits/s.  CI runs this as a NON-BLOCKING artifact
step: the table lands in the job log and the exit code is recorded,
but a perf regression alone does not veto a merge (the ±5% gate in the
acceptance checklist is enforced on the benchmark host, where the
numbers are not noise).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import Any, Dict, List, Optional, Tuple

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# The port's round files (``scripts/loadcurve.py`` writes its rounds
# here); ``build/`` is not committed.
ROUNDS_DIR = os.path.join(REPO_ROOT, "build", "rounds")

# Per-family metric tables: (key, label, higher_is_better).  Direction
# matters — throughput regresses DOWN, latency regresses UP; a metric
# moving the good way never fails the gate.
FAMILIES: Dict[str, Dict[str, Any]] = {
    "bench": {
        "history": "BENCH_r*.json",
        "strip": "BENCH_",
        "metrics": [
            ("value", "commits/s", True),
            ("p99_commit_latency_ms", "p99 commit latency (ms)", False),
            ("failover_p99_ms", "failover p99 (ms)", False),
        ],
    },
    "serving": {
        "history": "SERVING_r*.json",
        "strip": "SERVING_",
        "metrics": [
            ("firehose_sockets_ops_per_sec", "sockets ops/s", True),
            ("firehose_inprocess_ops_per_sec", "in-process ops/s", True),
        ],
    },
    "loadcurve": {
        "history": "LOADCURVE_r*.json",
        "strip": "LOADCURVE_",
        "metrics": [
            ("max_sustainable_ops_per_sec", "max sustainable ops/s", True),
            ("knee_ops_per_sec", "knee offered rate (ops/s)", True),
            ("p99_at_knee_ms", "p99 at knee (ms)", False),
            # Tail-microscope columns (r05+; absent in earlier rounds →
            # n/a, never a regression).
            ("p999_at_knee_ms", "p99.9 at knee (ms)", False),
            ("tail_dominant_wait", "dominant tail wait", False),
        ],
    },
    "placement": {
        "history": "PLACEMENT_r*.json",
        "strip": "PLACEMENT_",
        "metrics": [
            ("spread_reduction_pct", "load-spread reduction (%)", True),
            ("failover_replace_s", "failover re-place time (s)", False),
            ("moves", "migrations executed", False),
            # Durable state plane (r02+; absent in earlier rounds →
            # shown as n/a, never a regression).
            ("durable_failover_s", "durable failover time (s)", False),
            ("lost_acked_writes", "acked writes lost", False),
            ("ship_tail_records", "tail records shipped", True),
            # Self-healing replica sets (r03+): dead-voter replacement
            # via joint consensus.
            ("replace_replica_s", "replica replace time (s)", False),
            ("degraded_quorum_window_s", "degraded quorum window (s)",
             False),
        ],
    },
    # CPU cost accounting rides the loadcurve rounds: same history
    # files, different metric table — per-stage CPU-µs per op at the
    # knee (observe.py's segment-accounting vocabulary).  Direction:
    # burning MORE CPU per op at the same operating point is the
    # regression, whatever the latency curve did.
    "cpu": {
        "history": "LOADCURVE_r*.json",
        "strip": "LOADCURVE_",
        "metrics": [
            ("cpu_total_us_per_op", "total CPU (µs/op)", False),
            ("cpu_wire_us_per_op", "wire CPU (µs/op)", False),
            ("cpu_dispatch_us_per_op", "dispatch CPU (µs/op)", False),
            ("cpu_handler_us_per_op", "handler CPU (µs/op)", False),
            ("cpu_engine_us_per_op", "engine CPU (µs/op)", False),
            ("cpu_ack_us_per_op", "ack CPU (µs/op)", False),
            ("cpu_flush_us_per_op", "flush CPU (µs/op)", False),
        ],
    },
}


def load_result(path: str) -> Dict[str, Any]:
    """Load a bench result; unwrap the ``BENCH_r*`` round shape."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: not a bench result (top-level "
                         f"{type(doc).__name__})")
    if "parsed" in doc and isinstance(doc["parsed"], dict):
        return doc["parsed"]
    return doc


def load_history(pattern: str) -> List[Tuple[str, Dict[str, Any]]]:
    """``[(round_name, parsed), ...]`` sorted by round number; rounds
    that fail to parse are skipped (one corrupt round must not kill
    the comparison)."""
    out: List[Tuple[str, Dict[str, Any]]] = []
    for p in glob.glob(pattern):
        try:
            out.append((os.path.basename(p), load_result(p)))
        except (OSError, ValueError):
            print(f"bench_compare: skipping unreadable {p}",
                  file=sys.stderr)
    def round_no(item: Tuple[str, Dict[str, Any]]) -> Tuple[int, str]:
        m = re.search(r"(\d+)", item[0])
        return (int(m.group(1)) if m else 0, item[0])
    out.sort(key=round_no)
    return out


def _get(doc: Dict[str, Any], key: str) -> Optional[float]:
    v = doc.get(key)
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    return None


# Informational string-valued columns: rendered in the table (the
# trajectory of labels is the point — e.g. the dominant tail wait
# migrating from "pump" to "wire" across rounds) but never gated.
_STR_KEYS = {"tail_dominant_wait"}


def _get_str(doc: Dict[str, Any], key: str) -> Optional[str]:
    v = doc.get(key)
    return v if isinstance(v, str) else None


def _p99_at_rate(doc: Dict[str, Any], rate: float) -> Optional[float]:
    """Client p99 of the sweep step at exactly ``rate`` offered ops/s,
    from a loadcurve result's ``curve`` arrays (None if the round
    didn't sweep that rate)."""
    curve = doc.get("curve")
    if not isinstance(curve, dict):
        return None
    rates = curve.get("offered_rate") or []
    p99s = curve.get("client_p99_ms") or []
    for r, p in zip(rates, p99s):
        if r == rate and isinstance(p, (int, float)):
            return float(p)
    return None


def _fmt(v: Optional[float]) -> str:
    if v is None:
        return "n/a"
    if abs(v) >= 1e6:
        return f"{v / 1e6:.1f}M"
    if abs(v) >= 1e3:
        return f"{v / 1e3:.1f}k"
    return f"{v:.3g}"


def compare(
    fresh: Dict[str, Any],
    history: List[Tuple[str, Dict[str, Any]]],
    threshold_pct: float,
    family: str = "bench",
) -> Tuple[List[str], List[str]]:
    """Returns ``(table_lines, regressions)``; empty regressions means
    every shared metric is within the threshold of the latest round."""
    fam = FAMILIES[family]
    lines: List[str] = []
    regressions: List[str] = []
    latest_name, latest = history[-1] if history else ("(none)", {})
    lines.append(
        f"{'metric':28s} "
        + " ".join(f"{name.replace(fam['strip'], ''):>10s}"
                   for name, _ in history)
        + f" {'fresh':>10s} {'delta':>9s}"
    )
    for key, label, higher_better in fam["metrics"]:
        if key in _STR_KEYS:
            lines.append(
                f"{label:28s} "
                + " ".join(f"{(_get_str(doc, key) or 'n/a'):>10s}"
                           for _, doc in history)
                + f" {(_get_str(fresh, key) or 'n/a'):>10s} {'n/a':>9s}"
            )
            continue
        fv = _get(fresh, key)
        traj = [_get(doc, key) for _, doc in history]
        lv = _get(latest, key)
        if key == "p99_at_knee_ms":
            # "p99 at the knee" is only comparable when both rounds
            # knee at the same rate.  A round that moves the knee OUT
            # (admission control flattening the curve) would otherwise
            # be penalized for exactly that improvement: its knee p99
            # is measured further up the ladder.  Gate latency at the
            # SHARED operating point instead — the incumbent round's
            # knee rate, whose p99 is by definition what lv holds.
            shared = _get(latest, "knee_ops_per_sec")
            if shared is not None:
                at_shared = _p99_at_rate(fresh, shared)
                if at_shared is not None:
                    fv = at_shared
                    label = f"p99 at {_fmt(shared)} ops/s (ms)"
        if fv is None or lv is None:
            delta_s = "n/a"
        else:
            delta = (fv - lv) / lv * 100.0 if lv else 0.0
            delta_s = f"{delta:+.1f}%"
            regressed = (-delta if higher_better else delta) > threshold_pct
            if regressed:
                regressions.append(
                    f"{label}: {_fmt(fv)} vs {_fmt(lv)} in {latest_name} "
                    f"({delta_s}, threshold {threshold_pct:.1f}%)"
                )
        lines.append(
            f"{label:28s} "
            + " ".join(f"{_fmt(v):>10s}" for v in traj)
            + f" {_fmt(fv):>10s} {delta_s:>9s}"
        )
    return lines, regressions


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="bench_compare")
    ap.add_argument("fresh", help="fresh benchmark JSON result")
    ap.add_argument(
        "--family", choices=sorted(FAMILIES), default="bench",
        help="result family: picks the metric table and the default "
             "history glob (default bench)",
    )
    ap.add_argument(
        "--threshold", type=float, default=5.0,
        help="regression threshold in percent (default 5)",
    )
    ap.add_argument(
        "--history", default=None,
        help="glob of recorded rounds (default: the family's "
             "<FAMILY>_r*.json in build/rounds/)",
    )
    ap.add_argument("--quiet", action="store_true",
                    help="print only regressions")
    ns = ap.parse_args(argv)
    pattern = ns.history or os.path.join(
        ROUNDS_DIR, FAMILIES[ns.family]["history"]
    )

    try:
        fresh = load_result(ns.fresh)
    except (OSError, ValueError) as exc:
        print(f"bench_compare: cannot read fresh result: {exc}",
              file=sys.stderr)
        return 2
    history = load_history(pattern)
    if not history:
        print(
            f"bench_compare: no readable history at {pattern!r}; "
            f"nothing to compare against", file=sys.stderr,
        )
        return 2

    lines, regressions = compare(fresh, history, ns.threshold, ns.family)
    if not ns.quiet:
        print("\n".join(lines))
    if regressions:
        print(
            f"bench_compare: {len(regressions)} regression(s) past "
            f"{ns.threshold:.1f}%:", file=sys.stderr,
        )
        for r in regressions:
            print(f"  {r}", file=sys.stderr)
        return 1
    latest_name = history[-1][0]
    print(f"bench_compare: within {ns.threshold:.1f}% of {latest_name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
