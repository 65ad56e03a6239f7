"""Load-curve aggregation: windowed fleet scrapes + the knee finder.

The open-loop generator (benchmarks/openloop.py) offers load the
servers cannot refuse; this module turns what the fleet recorded into
the latency-under-load curve the paper's serving story needs:

* :func:`scrape_hists` hits every process's ``Obs.hist`` verb — the
  CUMULATIVE per-stage histogram dumps plus the live queue gauges —
  through the same :class:`~multiraft_tpu_torch.harness.observe.FleetObserver`
  (clock-aligned, control-exempt) the nemesis timeline uses.
* :func:`window_hists` diffs two scrapes (``Hist.sub``) and merges the
  per-process windows into ONE fleet-wide histogram per stage, so each
  rate step reports the p50/p99 of exactly the requests it offered.
  Cumulative-dump-then-diff beats a server-side reset verb: scrapes
  stay read-only (two observers can't clobber each other) and a missed
  scrape degrades to a wider window instead of lost data.
* :func:`find_knee` locates the knee of the throughput-vs-latency
  curve (max distance from the endpoint chord — the Kneedle shape,
  pure and dependency-free), and :func:`max_sustainable` reports the
  highest offered rate whose client p99 stayed under a target.

:func:`run_sweep` ties it together: scrape, fire one open-loop step
(caller-supplied — this module never imports the generator, keeping
harness → benchmarks dependency-free), scrape again, attach the
windowed stage decomposition to the step record.

PyTorch port of ``multiraft_tpu/harness/loadcurve.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

from ..distributed.profile import SERVING_THREAD_PREFIXES, top_functions
from ..distributed.tail import dominant_wait, merge_drains
from ..utils.metrics import Hist
from .observe import FleetObserver

__all__ = [
    "scrape_hists",
    "window_hists",
    "stage_stats",
    "cpu_stage_stats",
    "gauge_peaks",
    "window_proc_cpu_s",
    "profile_window",
    "tail_window",
    "find_knee",
    "max_sustainable",
    "run_sweep",
    "build_loadcurve",
]


# -- scraping ---------------------------------------------------------------

def scrape_hists(obs: FleetObserver) -> Dict[str, Dict[str, Any]]:
    """One fleet-wide ``Obs.hist`` scrape: ``{"host:port": {"hists":
    {name: Hist}, "gauges": {...}, "now_us": float}}``.  Unreachable
    processes get an explicit ``{"missing": True}`` marker (same
    discipline as ``snapshot_all`` — a silently shorter fleet would
    present a partial window as the whole one)."""
    out: Dict[str, Dict[str, Any]] = {}
    for a in obs.addrs:
        key = f"{a[0]}:{a[1]}"
        dump = obs.hist(a)
        if dump is None:
            out[key] = {"missing": True}
            continue
        out[key] = {
            "hists": {
                name: Hist.from_dump(d)
                for name, d in (dump.get("hists") or {}).items()
            },
            "gauges": dict(dump.get("gauges") or {}),
            "now_us": float(dump.get("now_us", 0.0)),
        }
    return out


def window_hists(
    before: Dict[str, Dict[str, Any]],
    after: Dict[str, Dict[str, Any]],
) -> Dict[str, Hist]:
    """Fleet-wide windowed histograms: per process ``after − before``
    (``Hist.sub``; a process absent from ``before`` — restarted, or
    first scrape — contributes its cumulative hist), then merged
    across processes per metric name.  Exact for counts; window
    extremes are cumulative (Hist.sub's documented approximation)."""
    merged: Dict[str, Hist] = {}
    for key, snap in after.items():
        if snap.get("missing"):
            continue
        prev = before.get(key) or {}
        prev_hists = prev.get("hists") or {}
        for name, h in snap["hists"].items():
            ph = prev_hists.get(name)
            win = Hist.sub(h, ph) if ph is not None else h
            if win.count <= 0:
                continue
            tgt = merged.get(name)
            if tgt is None:
                tgt = merged[name] = Hist()
            tgt.merge(win)
    return merged


def stage_stats(windows: Dict[str, Hist]) -> Dict[str, Dict[str, Any]]:
    """Per-stage decomposition of one window: ``{"wire": {"count",
    "p50_ms", "p99_ms", "mean_ms"}, ...}`` for every ``stage.*_s``
    histogram that saw samples (names shortened to the bare stage)."""
    out: Dict[str, Dict[str, Any]] = {}
    for name, h in sorted(windows.items()):
        if not (name.startswith("stage.") and name.endswith("_s")):
            continue
        stage = name[len("stage."):-len("_s")]
        p50 = h.percentile(0.50)
        p99 = h.percentile(0.99)
        out[stage] = {
            "count": h.count,
            "p50_ms": round(1e3 * p50, 3) if p50 is not None else None,
            "p99_ms": round(1e3 * p99, 3) if p99 is not None else None,
            "mean_ms": round(1e3 * h.total / h.count, 3) if h.count else None,
        }
    return out


def cpu_stage_stats(windows: Dict[str, Hist]) -> Dict[str, Dict[str, Any]]:
    """Per-stage CPU cost accounting for one window: the ``cpu.*_s``
    twins of the wall stages (observe.py's segment-accounting
    vocabulary).  ``cpu_s`` is the window's fleet-wide CPU-seconds sum
    for the stage (Hist.total diffs exactly, like counts), ``count``
    the number of segments — together they answer "which stage burned
    the loop's CPU this step"."""
    out: Dict[str, Dict[str, Any]] = {}
    for name, h in sorted(windows.items()):
        if not (name.startswith("cpu.") and name.endswith("_s")):
            continue
        stage = name[len("cpu."):-len("_s")]
        out[stage] = {
            "count": h.count,
            "cpu_s": round(h.total, 6),
        }
    return out


def window_proc_cpu_s(
    before: Dict[str, Dict[str, Any]],
    after: Dict[str, Dict[str, Any]],
) -> Optional[float]:
    """Fleet-wide process CPU-seconds burned between two scrapes —
    ``gauge.cpu_s`` (the cumulative process CPU clock) diffed per
    process and summed.  Against the step's wall time this says
    whether the fleet was CPU-pegged; None when no process reported
    the gauge on both sides."""
    total, seen = 0.0, False
    for key, snap in after.items():
        if snap.get("missing"):
            continue
        a = (snap.get("gauges") or {}).get("gauge.cpu_s")
        b = ((before.get(key) or {}).get("gauges") or {}).get("gauge.cpu_s")
        if isinstance(a, (int, float)) and isinstance(b, (int, float)):
            total += max(0.0, float(a) - float(b))
            seen = True
    return round(total, 6) if seen else None


def profile_window(
    obs: FleetObserver, topn: int = 15
) -> Dict[str, Any]:
    """Drain the fleet's sampling profilers (``Obs.profile``) and fold
    the window into its attribution summary: total samples, per-thread
    totals, the top-N functions by self samples — plus the raw merged
    ``flame`` (folded stacks, process-name-prefixed) for callers that
    accumulate a whole-sweep flamegraph.  Drain-on-read gives the same
    windowing the histogram scrapes get from cumulative-diff: each
    call returns exactly the samples since the previous one."""
    dumps = obs.profile_all()
    flame = FleetObserver.fleet_flame(dumps)
    # Fleet-flame keys are "proc;thread;frames..." — attribution rows
    # are the proc;thread pair (per_thread_totals alone would stop at
    # the process segment).
    threads: Dict[str, int] = {}
    unprefixed: Dict[str, int] = {}
    serving: Dict[str, int] = {}
    for k, v in flame.items():
        row = ";".join(k.split(";", 2)[:2])
        threads[row] = threads.get(row, 0) + int(v)
        bare = k.split(";", 1)[1] if ";" in k else k
        unprefixed[bare] = unprefixed.get(bare, 0) + int(v)
        # The sampler records every thread every tick — a main thread
        # parked in sleep shows the same sample rate as a pegged loop.
        # The serving-thread cut ranks only the serving-side threads
        # (SERVING_THREAD_PREFIXES: the per-node loops plus their
        # engine-pump device-wait threads), so the headline names what
        # serving CPU was spent on rather than where idle threads
        # happened to be parked.
        if bare.startswith(SERVING_THREAD_PREFIXES):
            serving[bare] = serving.get(bare, 0) + int(v)
    return {
        "samples": sum(flame.values()),
        "per_thread": threads,
        "top": top_functions(serving or unprefixed, topn),
        "top_all_threads": top_functions(unprefixed, topn),
        "flame": flame,
    }


def tail_window(
    obs: FleetObserver,
    p99_ms: Optional[float] = None,
    keep: int = 8,
) -> Optional[Dict[str, Any]]:
    """Drain the fleet's tail-exemplar stores (``Obs.tail``) and fold
    the window into the step's tail digest: retention counters, the
    ``keep`` slowest exemplars verbatim (full stage + wait vectors —
    the waterfall rows), and the dominant-wait attribution of the tail
    slice.  The slice is every retained exemplar at/above the step's
    client p99 when one is given (those ARE the p99+ requests), else
    the ``keep`` slowest — so ``dominant`` answers "what did the p99
    wait on this step".  ``None`` when no process runs the tail plane
    (MRT_TAIL=0): absent, not zeros, so readers can tell "off" from
    "quiet"."""
    drains = [
        (d or {}).get("tail") for d in obs.tail_all().values()
    ]
    if not any(isinstance(d, dict) for d in drains):
        return None
    merged = merge_drains(drains)
    # slo + topk are both sorted slowest-first; the merged tail keeps
    # the guaranteed outliers ahead of the windowed top-k.
    retained = merged["slo"] + merged["topk"]
    retained.sort(key=lambda e: -(e.get("total_s") or 0.0))
    if p99_ms is not None:
        cut = p99_ms / 1e3
        tail_slice = [e for e in retained if (e.get("total_s") or 0.0) >= cut]
    else:
        tail_slice = []
    if not tail_slice:
        tail_slice = retained[:keep]
    waits: Dict[str, int] = {}
    for e in tail_slice:
        w = dominant_wait(e)
        waits[w] = waits.get(w, 0) + 1
    return {
        "seen": merged["seen"],
        "over_slo": merged["over_slo"],
        "dropped_slo": merged["dropped_slo"],
        "exemplars": retained[:keep],
        "dominant_waits": waits,
        "dominant": (
            max(waits.items(), key=lambda kv: kv[1])[0] if waits else None
        ),
    }


def gauge_peaks(after: Dict[str, Dict[str, Any]]) -> Dict[str, float]:
    """Max of each queue gauge across the fleet at scrape time — the
    step's congestion witness next to its latency decomposition."""
    peaks: Dict[str, float] = {}
    for snap in after.values():
        for name, val in (snap.get("gauges") or {}).items():
            if isinstance(val, (int, float)):
                peaks[name] = max(peaks.get(name, 0.0), float(val))
    return peaks


# -- knee detection ---------------------------------------------------------

def find_knee(
    xs: Sequence[float], ys: Sequence[float],
) -> Optional[int]:
    """Index of the knee of an increasing curve: the point with max
    perpendicular-ish (vertical, after normalization) distance from the
    chord joining the endpoints — the Kneedle construction without the
    smoothing (rate ladders are short and already monotone in x).
    Works for both convex (latency hockey stick: knee is below the
    chord) and concave (throughput rollover: above) shapes by taking
    the absolute distance.  ``None`` when fewer than 3 points or the
    curve is flat."""
    n = len(xs)
    if n != len(ys) or n < 3:
        return None
    x0, x1 = float(xs[0]), float(xs[-1])
    y0, y1 = float(ys[0]), float(ys[-1])
    dx, dy = x1 - x0, y1 - y0
    if dx == 0 or dy == 0:
        return None
    best_i, best_d = None, 0.0
    for i in range(1, n - 1):
        xn = (float(xs[i]) - x0) / dx
        yn = (float(ys[i]) - y0) / dy
        d = abs(yn - xn)  # chord of the normalized curve is y = x
        if d > best_d:
            best_i, best_d = i, d
    return best_i


def max_sustainable(
    rates: Sequence[float],
    p99s_ms: Sequence[Optional[float]],
    target_ms: float,
) -> Optional[float]:
    """Highest offered rate whose p99 stayed at/under ``target_ms``
    (steps with no p99 — nothing measured — don't qualify)."""
    best = None
    for r, p in zip(rates, p99s_ms):
        if p is not None and p <= target_ms:
            best = max(best, float(r)) if best is not None else float(r)
    return best


# -- sweep orchestration ----------------------------------------------------

def run_sweep(
    obs: FleetObserver,
    fire_step: Callable[[float], Dict[str, Any]],
    rates: Sequence[float],
    profile_topn: int = 15,
    flame_acc: Optional[Dict[str, int]] = None,
) -> List[Dict[str, Any]]:
    """Step the offered rate up the ladder: scrape → fire → scrape,
    attach the windowed per-stage decomposition (wall AND cpu), the
    queue-gauge peaks, the window's process-CPU burn, and the window's
    profiler attribution (top functions + per-thread samples) to
    whatever the step driver returned.  ``fire_step(rate)`` runs one
    open-loop step to completion (including its drain grace, so the
    closing scrape sees the step's replies) and returns its client-side
    record (offered/achieved rate, client p50/p99, drops).

    ``flame_acc`` (mutated in place when given) accumulates the merged
    fleet flame across every step — the whole-sweep flamegraph the
    loadcurve CLI writes next to the round file.  The profiler is
    drained once before the ladder so step 1's window excludes warmup."""
    steps: List[Dict[str, Any]] = []
    before = scrape_hists(obs)
    obs.profile_all()  # drain: the ladder starts with a clean window
    obs.tail_all()     # ditto for the tail-exemplar stores
    for rate in rates:
        res = dict(fire_step(float(rate)))
        after = scrape_hists(obs)
        win = window_hists(before, after)
        prof = profile_window(obs, topn=profile_topn)
        res["offered_rate"] = float(rate)
        res["stages"] = stage_stats(win)
        res["cpu"] = cpu_stage_stats(win)
        res["gauges"] = gauge_peaks(after)
        res["proc_cpu_s"] = window_proc_cpu_s(before, after)
        tails = tail_window(obs, p99_ms=res.get("client_p99_ms"))
        if tails is not None:
            res["tail"] = tails
        if flame_acc is not None:
            for k, v in prof.pop("flame").items():
                flame_acc[k] = flame_acc.get(k, 0) + v
        else:
            prof.pop("flame")
        res["profile"] = prof
        steps.append(res)
        before = after  # next step's window starts where this ended
    return steps


def build_loadcurve(
    steps: Sequence[Dict[str, Any]],
    p99_target_ms: float = 50.0,
) -> Dict[str, Any]:
    """Fold the per-step records into the final load-curve report:
    the throughput-vs-latency curve, the detected knee, and the max
    sustainable rate at the p99 target — the JSON body of
    ``LOADCURVE_r*.json`` (metadata added by the caller)."""
    rates = [s["offered_rate"] for s in steps]
    p99s = [s.get("client_p99_ms") for s in steps]
    achieved = [s.get("achieved_ops_per_sec") for s in steps]
    knee_i = find_knee(
        rates, [p if p is not None else 0.0 for p in p99s]
    )
    knee = None
    if knee_i is not None:
        knee = {
            "offered_rate": rates[knee_i],
            "achieved_ops_per_sec": achieved[knee_i],
            "client_p99_ms": p99s[knee_i],
            "index": knee_i,
        }
    sustainable = max_sustainable(rates, p99s, p99_target_ms)
    out = {
        "steps": list(steps),
        "curve": {
            "offered_rate": rates,
            "achieved_ops_per_sec": achieved,
            "client_p50_ms": [s.get("client_p50_ms") for s in steps],
            "client_p99_ms": p99s,
            "client_p999_ms": [s.get("client_p999_ms") for s in steps],
        },
        "knee": knee,
        # Flat mirrors of the headline numbers, so the trajectory gate
        # (scripts/bench_compare.py --family loadcurve) reads them with
        # the same top-level-key lookup as every other family.
        "knee_ops_per_sec": knee["offered_rate"] if knee else None,
        "p99_at_knee_ms": knee["client_p99_ms"] if knee else None,
        "p99_target_ms": p99_target_ms,
        "max_sustainable_ops_per_sec": sustainable,
    }
    if knee_i is not None:
        # Tail-microscope headline columns at the comparable operating
        # point: the extreme tail (p99.9) at the knee, and which queue
        # wait dominated the knee step's retained tail exemplars
        # (tail.py attribution).  Absent in pre-tail rounds → n/a in
        # the gate, never a regression.
        p999 = steps[knee_i].get("client_p999_ms")
        if p999 is not None:
            out["p999_at_knee_ms"] = p999
        dom = (steps[knee_i].get("tail") or {}).get("dominant")
        if dom is not None:
            out["tail_dominant_wait"] = dom
    # CPU-attribution headline columns (bench_compare --family cpu):
    # per-stage CPU-µs per acknowledged op at the KNEE step — the
    # comparable operating point — plus the profiler's top functions
    # at the knee and at saturation (the top of the ladder).  Absent
    # in pre-profiling rounds → n/a in the gate, never a regression.
    if knee_i is not None:
        ks = steps[knee_i]
        ok = ks.get("ok") or 0
        total_us = 0.0
        for stage, rec in (ks.get("cpu") or {}).items():
            if ok and isinstance(rec.get("cpu_s"), (int, float)):
                us = 1e6 * float(rec["cpu_s"]) / ok
                out[f"cpu_{stage}_us_per_op"] = round(us, 2)
                total_us += us
        if ok and total_us:
            out["cpu_total_us_per_op"] = round(total_us, 2)
        out["top_funcs_at_knee"] = (
            (ks.get("profile") or {}).get("top") or []
        )[:5]
    if steps:
        out["top_funcs_at_saturation"] = (
            (steps[-1].get("profile") or {}).get("top") or []
        )[:5]
    return out
