"""Postmortem doctor: read the fleet's black boxes and say what broke.

``python -m multiraft_tpu_torch.analysis.postmortem <bundle>`` consumes a
bundle directory produced by :func:`multiraft_tpu_torch.harness.bundle.
collect_bundle` (flight rings + final snapshots + manifest) and emits:

* a human-readable report (stdout + ``<bundle>/report.txt``): per
  process — clean vs UNCLEAN death, last committed op (group / client /
  command / rid), WAL fsync gap (appends that were staged but never
  fsync'd when the process died), last known role/term/commit per raft
  peer, chaos fault bursts; fleet-wide — a clock-aligned anomaly
  timeline with the FIRST anomaly called out, and commit/apply lag
  from the final ``Obs.groups`` snapshots.
* a Perfetto trace (``<bundle>/flight_trace.json.gz``): every intact
  ring record as a span/instant/counter on one clock-aligned time
  axis, commit instants tagged with their rid so a request can be
  chased across processes with the trace viewer's search.

Clock alignment reuses the harness's min-RTT offsets: the manifest
maps address → offset (remote perf_counter µs − host) and address →
pid, so each ring's timestamps shift by −offset onto the host clock —
including rings of processes that were dead at collection time, whose
offsets were cached while they lived.

The doctor also accepts a bare ``.ring`` file or a directory of rings
(no manifest): alignment degrades to per-process clocks, the analyses
still run.

PyTorch port of ``multiraft_tpu/analysis/postmortem.py``.  The flight
rings of both packages share one format, so the doctor reads a bundle
written by either.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

from ..distributed import flightrec
from ..utils.knobs import knob_float, knob_int
from ..utils.trace import Tracer

__all__ = ["load_bundle", "analyze", "build_report", "main"]

Record = Dict[str, Any]

# A reply-drop (or any chaos) burst this dense is worth a report line:
# ≥ BURST_MIN faults inside BURST_WINDOW_US.
BURST_WINDOW_US = 1_000_000.0
BURST_MIN = 5

# Placement thrash: the same group moved ≥ THRASH_MIN times inside
# THRASH_WINDOW_US (PLACE records, placement.py controller).  A healthy
# controller's cooldown/hysteresis keeps any one group far below this;
# hitting it means the planner is oscillating.
THRASH_WINDOW_US = 30_000_000.0
THRASH_MIN = 3

# Data-loss window for shipped state (stateplane.py): an UNCLEAN death
# whose last shipment for some group is older than this at the ring's
# end means writes inside the window died unshipped.  Resolved from the
# same env knob the shipper uses, so doctor and plane agree.
def _ship_window_us() -> float:
    return knob_float("MRT_SHIP_WINDOW_S") * 1e6


# Degraded-quorum bound for membership changes (placement.py healer):
# a reconfig open longer than the replace deadline means the group ran
# on a reduced quorum past the budget the operator set.  Same env knob
# the controller uses, so doctor and healer agree.
def _replace_deadline_us() -> float:
    return knob_float("MRT_PLACE_REPLACE_DEADLINE_S") * 1e6


# SANITIZE record code → violation kind (sanitize.py writes them).
_SANITIZE_KINDS = {v: k for k, v in flightrec.SANITIZE_KIND_CODES.items()}

# TAIL record code → queue-wait name (tail.py writes them).
_TAIL_WAITS = {v: k for k, v in flightrec.TAIL_WAIT_CODES.items()}


def _covering_window(
    windows: List[Dict[str, Any]], ts: float,
) -> Optional[Dict[str, Any]]:
    """The nemesis fault window active at host-clock ``ts`` — exact
    containment first; else the latest window that STARTED before
    ``ts`` (a wedge is declared stall_ticks scrapes after its cause,
    and may outlive a short window by detection lag)."""
    best = None
    for w in windows:
        t0 = w.get("t_start_us")
        if t0 is None or t0 > ts:
            continue
        t1 = w.get("t_stop_us")
        if t1 is not None and t1 >= ts:
            return w  # contains ts
        if best is None or t0 > best.get("t_start_us", 0):
            best = w
    return best

# OVERLOAD record codes (overload.py writes them).
_OVL_STAGE = flightrec.OVERLOAD_KIND_CODES["stage_p99"]
_OVL_GAUGE = flightrec.OVERLOAD_KIND_CODES["gauge"]
_OVL_CTX = flightrec.OVERLOAD_KIND_CODES["gauge_ctx"]
_OVL_BROWNOUT = flightrec.OVERLOAD_KIND_CODES["brownout"]

# Brownout states (overload.py BrownoutMachine) named for the note.
_BROWNOUT_NAMES = {0: "healthy", 1: "shedding", 2: "brownout"}

# CPU-saturation evidence bound: a PROF breadcrumb (profile.py, ~1/s)
# carries process CPU busy per-mille of wall in its code field; a
# collapse window whose peak busy reaches this is reclassified from
# "queueing collapse" to "cpu saturation" — the queues diverged because
# the CPU could not keep up, and the breadcrumb's tag names the hot
# function.  ~850‰ rather than 1000‰: the sampler's 1 s windows
# straddle the onset, diluting the pegged fraction.
def _cpusat_permille() -> int:
    return knob_int("MRT_CPUSAT_PERMILLE")


# -- loading ---------------------------------------------------------------


def load_bundle(path: str) -> Dict[str, Any]:
    """Load a bundle dir, a directory of rings, or one ``.ring`` file
    into ``{"dir", "manifest", "snapshots", "windows", "tails",
    "rings"}``.  Unreadable rings are skipped with a note in
    ``"skipped"`` — one corrupt file must not block the rest of the
    postmortem."""
    out: Dict[str, Any] = {
        "dir": path, "manifest": {}, "snapshots": {}, "windows": [],
        "tails": {}, "rings": [], "skipped": [],
    }
    if os.path.isfile(path):
        ring_paths = [path]
        out["dir"] = os.path.dirname(path) or "."
    else:
        for name in ("manifest.json", "snapshots.json", "windows.json",
                     "tails.json"):
            p = os.path.join(path, name)
            if os.path.exists(p):
                try:
                    with open(p) as f:
                        out[name.split(".", 1)[0]] = json.load(f)
                except (OSError, ValueError) as exc:
                    out["skipped"].append(f"{name}: {exc}")
        ring_paths = sorted(
            glob.glob(os.path.join(path, "rings", "*.ring"))
            or glob.glob(os.path.join(path, "*.ring"))
        )
    for rp in ring_paths:
        try:
            ring = flightrec.read_ring(rp)
        except (OSError, ValueError) as exc:
            out["skipped"].append(f"{os.path.basename(rp)}: {exc}")
            continue
        ring["path"] = rp
        out["rings"].append(ring)
    return out


def _pid_offsets(manifest: Dict[str, Any]) -> Dict[int, float]:
    """pid → clock offset (remote − host, µs) via the manifest's
    addr→offset and addr→ident tables; the collecting host is 0."""
    offs: Dict[int, float] = {}
    idents = manifest.get("idents") or {}
    offsets = manifest.get("offsets_us") or {}
    for addr, ident in idents.items():
        off = offsets.get(addr)
        pid = int(ident.get("pid", -1))
        if off is not None and pid > 0:
            offs[pid] = float(off)
    host_pid = manifest.get("host_pid")
    if host_pid:
        offs[int(host_pid)] = 0.0
    return offs


def _pid_addr(manifest: Dict[str, Any], pid: int) -> Optional[str]:
    for addr, ident in (manifest.get("idents") or {}).items():
        if int(ident.get("pid", -1)) == pid:
            return addr
    return None


# -- per-ring + fleet analysis ---------------------------------------------


def _last(records: List[Record], etype: int) -> Optional[Record]:
    for r in reversed(records):
        if r["type"] == etype:
            return r
    return None


def _max_burst(
    ts_list: List[float], window_us: float = BURST_WINDOW_US,
) -> Tuple[int, float]:
    """Densest ``window_us`` window over sorted timestamps:
    ``(count, window_start_ts)``."""
    best, best_ts = 0, 0.0
    lo = 0
    for hi, t in enumerate(ts_list):
        while t - ts_list[lo] > window_us:
            lo += 1
        if hi - lo + 1 > best:
            best, best_ts = hi - lo + 1, ts_list[lo]
    return best, best_ts


def analyze(bundle: Dict[str, Any]) -> Dict[str, Any]:
    """Run every per-ring analysis plus the fleet-wide anomaly merge.

    Returns ``{"procs": [per-ring dict...], "anomalies": [...],
    "first_anomaly": ... | None, "lag": {addr: ...}}``.  Anomaly
    timestamps are host-clock µs when the manifest provides offsets,
    else the ring's own clock (flagged ``aligned: False``)."""
    manifest = bundle.get("manifest") or {}
    offsets = _pid_offsets(manifest)
    procs: List[Dict[str, Any]] = []
    anomalies: List[Dict[str, Any]] = []

    for ring in bundle["rings"]:
        recs: List[Record] = ring["records"]
        pid = ring["pid"]
        off = offsets.get(pid)
        addr = _pid_addr(manifest, pid)
        label = f"{ring['name'] or 'pid' + str(pid)}" + (
            f" @ {addr}" if addr else ""
        )

        def aligned(ts: float, _off: Optional[float] = off) -> float:
            return ts - _off if _off is not None else ts

        info: Dict[str, Any] = {
            "pid": pid, "name": ring["name"], "addr": addr,
            "label": label, "path": ring["path"],
            "records": len(recs), "torn": ring["torn"],
            "slots": ring["slots"], "clean_close": ring["clean_close"],
            "aligned": off is not None,
        }
        if not recs:
            procs.append(info)
            continue
        info["first_seq"] = recs[0]["seq"]
        info["last_seq"] = recs[-1]["seq"]
        info["last_event"] = recs[-1]

        last_commit = _last(recs, flightrec.COMMIT)
        if last_commit is not None:
            info["last_commit"] = last_commit
        last_append = _last(recs, flightrec.WAL_APPEND)
        last_fsync = _last(recs, flightrec.WAL_FSYNC)
        if last_append is not None:
            appended = last_append["a"]
            synced = last_fsync["a"] if last_fsync is not None else 0
            info["wal"] = {"appended": appended, "synced": synced,
                           "gap": appended - synced}
        roles: Dict[int, Record] = {}
        for r in recs:
            if r["type"] == flightrec.ROLE:
                roles[r["code"]] = r
        if roles:
            info["roles"] = {
                peer: {"role": r["a"], "term": r["b"], "commit": r["c"]}
                for peer, r in sorted(roles.items())
            }
        chaos_ts: Dict[str, List[float]] = {}
        for r in recs:
            if r["type"] == flightrec.CHAOS:
                chaos_ts.setdefault(r["tag"], []).append(r["ts"])
        bursts = {}
        for path_tag, ts_list in chaos_ts.items():
            n, t0 = _max_burst(ts_list)
            bursts[path_tag] = {
                "total": len(ts_list), "max_burst": n,
                "burst_at": aligned(t0),
            }
        if bursts:
            info["chaos"] = bursts

        # -- anomaly extraction (all timestamps aligned when possible)
        if not ring["clean_close"]:
            last = recs[-1]
            what = f"last event {last['type_name']} seq {last['seq']}"
            if last_commit is not None:
                what += f"; last commit {_fmt_commit(last_commit)}"
            anomalies.append({
                "ts": aligned(last["ts"]), "proc": label,
                "kind": "unclean_death", "detail": what,
                "aligned": off is not None,
            })
        if info.get("wal", {}).get("gap", 0) > 0:
            gap = info["wal"]["gap"]
            anomalies.append({
                "ts": aligned(last_append["ts"]), "proc": label,
                "kind": "fsync_gap",
                "detail": (
                    f"{gap} WAL append(s) past last fsync "
                    f"(appended seq {info['wal']['appended']}, "
                    f"synced {info['wal']['synced']}) — unacked writes "
                    f"staged at death"
                ),
                "aligned": off is not None,
            })
        for path_tag, bst in bursts.items():
            if bst["max_burst"] >= BURST_MIN:
                anomalies.append({
                    "ts": bst["burst_at"], "proc": label,
                    "kind": "chaos_burst",
                    "detail": (
                        f"{bst['max_burst']} faults on '{path_tag}' "
                        f"within {BURST_WINDOW_US / 1e6:.0f}s "
                        f"({bst['total']} total)"
                    ),
                    "aligned": off is not None,
                })
        for r in recs:
            if r["type"] != flightrec.SANITIZE:
                continue
            kind = _SANITIZE_KINDS.get(r["code"], f"kind{r['code']}")
            detail = f"runtime sanitizer: {kind} on '{r['tag']}'"
            if r["a"] or r["b"]:
                detail += f" (value {r['a']}, limit {r['b']})"
            anomalies.append({
                "ts": aligned(r["ts"]), "proc": label,
                "kind": "sanitizer_violation",
                "detail": detail,
                "aligned": off is not None,
            })
        # Profiler breadcrumbs (PROF, ~1/s): cumulative samples,
        # distinct stacks, process CPU busy per-mille per window
        # (code), hottest leaf function (tag) — the sampler's black
        # box.  Summarized here; consumed below to discriminate the
        # overload diagnosis.
        profs = [r for r in recs if r["type"] == flightrec.PROF]
        if profs:
            info["profile"] = {
                "records": len(profs),
                "samples": profs[-1]["a"],
                "peak_busy_permille": max(r["code"] for r in profs),
                "hottest": next(
                    (r["tag"] for r in reversed(profs) if r["tag"]), ""
                ),
            }
        # Tail-microscope breadcrumbs (TAIL, tail.py): over-SLO and
        # new-slowest completions — code=dominant-wait, a=total_us,
        # b=wait_us, c=carrying engine tick, tag=rid.  The ring's
        # slowest request survives SIGKILL; summarized per ring, and
        # escalated to a tail_outlier anomaly when it breached the SLO
        # — anchored on the request, naming the dominating wait and
        # (when the ledger covers it) the nemesis window it rode out.
        tails = [r for r in recs if r["type"] == flightrec.TAIL]
        if tails:
            slow = max(tails, key=lambda r: r["a"])
            wait = _TAIL_WAITS.get(slow["code"], f"code{slow['code']}")
            info["tail"] = {
                "records": len(tails),
                "slowest_ms": round(slow["a"] / 1e3, 3),
                "dominant_wait": wait,
                "rid": slow["tag"],
                "tick": slow["c"],
            }
            if slow["a"] / 1e3 > knob_float("MRT_TAIL_SLO_MS"):
                detail = (
                    f"slowest request {slow['tag'] or '<untagged>'}: "
                    f"{slow['a'] / 1e3:.1f} ms total, "
                    f"{slow['b'] / 1e3:.1f} ms in the '{wait}' wait"
                    + (f", engine tick {slow['c']}" if slow["c"] else "")
                )
                win = _covering_window(
                    bundle.get("windows") or [], aligned(slow["ts"])
                )
                if win is not None:
                    detail += (
                        f"; during fault window '{win['kind']}' on "
                        f"proc(s) {win.get('procs')}"
                    )
                anomalies.append({
                    "ts": aligned(slow["ts"]), "proc": label,
                    "kind": "tail_outlier", "detail": detail,
                    "aligned": off is not None,
                })
        # Overload-watch trips → ONE collapse anomaly per ring,
        # anchored on the FIRST saturated stage (a collapse can leave
        # hundreds of trip records; the first one names where the
        # queueing started).  The paired gauge_ctx record supplies the
        # queue the collapse backed up into.  The PROF breadcrumbs
        # then pick the diagnosis: pegged CPU during the collapse
        # window → "cpu_saturation" (the stage's CPU-seconds fill the
        # wall window; fix the hot function); CPU idle → the classic
        # "queueing_collapse" (something downstream stalled).
        over = [r for r in recs if r["type"] == flightrec.OVERLOAD]
        # Brownout transitions are control decisions, not bound trips —
        # excluded from the collapse evidence so the two notes stay
        # distinct: "queueing collapse" = queues diverged; "shedding
        # engaged" = the admission plane acted on it.
        trips = [r for r in over
                 if r["code"] not in (_OVL_CTX, _OVL_BROWNOUT)]
        browns = [r for r in over if r["code"] == _OVL_BROWNOUT]
        escalations = [r for r in browns if r["a"] > r["b"]]
        if escalations:
            first_up = escalations[0]
            peak = max(r["a"] for r in browns)
            detail = (
                f"shedding engaged: brownout machine "
                f"{_BROWNOUT_NAMES.get(first_up['b'], first_up['b'])} → "
                f"{_BROWNOUT_NAMES.get(first_up['a'], first_up['a'])} "
                f"({first_up['c']} trip(s) that tick); peak state "
                f"{_BROWNOUT_NAMES.get(peak, peak)}, "
                f"{len(browns)} transition(s) total — admission "
                f"tightened; user-lane requests were shed with "
                f"retry_after hints (this is the overload plane "
                f"WORKING, distinct from an uncontrolled collapse)"
            )
            anomalies.append({
                "ts": aligned(first_up["ts"]), "proc": label,
                "kind": "shedding_engaged", "detail": detail,
                "aligned": off is not None,
            })
            info["brownout"] = {
                "transitions": len(browns),
                "peak": _BROWNOUT_NAMES.get(peak, str(peak)),
            }
        if trips:
            first = trips[0]
            gauge = next(
                (r for r in over
                 if r["code"] == _OVL_CTX and r["seq"] >= first["seq"]),
                None,
            ) or next(
                (r for r in over
                 if r["code"] == _OVL_GAUGE and r is not first),
                None,
            )
            if first["code"] == _OVL_STAGE:
                what = (
                    f"first saturated stage "
                    f"'{first['tag']}' windowed p99 "
                    f"{first['a'] / 1e3:.1f}ms > bound "
                    f"{first['b'] / 1e3:.1f}ms "
                    f"({first['c']} sample(s) in window)"
                )
            else:
                what = (
                    f"queue gauge '{first['tag']}' "
                    f"depth {first['a']} > bound {first['b']}"
                )
            if gauge is not None:
                what += (
                    f"; queue gauge {gauge['tag']}={gauge['a']}"
                    + (f" (bound {gauge['b']})" if gauge["b"] else "")
                )
            what += f"; {len(trips)} overload trip(s) total"
            # Discrimination: PROF breadcrumbs from the first trip to
            # the ring's end (fall back to the whole ring if the
            # sampler died before the trip landed).
            wprofs = [r for r in profs if r["ts"] >= first["ts"]] or profs
            busy = max((r["code"] for r in wprofs), default=0)
            hot = next(
                (r["tag"] for r in reversed(wprofs) if r["tag"]), ""
            )
            if busy >= _cpusat_permille():
                kind = "cpu_saturation"
                detail = (
                    f"CPU saturation: {what}; process CPU busy "
                    f"{busy}‰ of wall at peak during the collapse"
                    + (f"; profiler hottest function '{hot}'"
                       if hot else "")
                    + " — the stage's CPU-seconds fill the wall window "
                      "(host-bound): the queue bound is the symptom, "
                      "the hot function is the fix"
                )
            else:
                kind = "queueing_collapse"
                detail = f"queueing collapse: {what}"
                if profs:
                    detail += (
                        f"; CPU idle while queues diverged (peak busy "
                        f"{busy}‰) — a downstream stall, not a CPU "
                        f"shortage"
                    )
            anomalies.append({
                "ts": aligned(first["ts"]), "proc": label,
                "kind": kind, "detail": detail,
                "aligned": off is not None,
            })
            info["overload"] = {
                "trips": len(trips),
                "first": first["tag"],
                "gauge": gauge["tag"] if gauge is not None else None,
                "diagnosis": kind,
                "peak_busy_permille": busy,
            }
        # Placement thrash: PLACE records (the controller's decision
        # log) grouped by gid; the densest window per gid against the
        # thrash bound.  The controller's own ring is usually the only
        # one carrying these.
        place_ts: Dict[int, List[float]] = {}
        for r in recs:
            if r["type"] == flightrec.PLACE:
                place_ts.setdefault(r["code"], []).append(r["ts"])
        if place_ts:
            info["placements"] = {
                gid: len(ts) for gid, ts in sorted(place_ts.items())
            }
        for gid, ts_list in sorted(place_ts.items()):
            n, t0 = _max_burst(ts_list, THRASH_WINDOW_US)
            if n >= THRASH_MIN:
                anomalies.append({
                    "ts": aligned(t0), "proc": label,
                    "kind": "placement_thrash",
                    "detail": (
                        f"group {gid} moved {n} times within "
                        f"{THRASH_WINDOW_US / 1e6:.0f}s "
                        f"({len(ts_list)} move(s) total) — the planner "
                        f"is oscillating; raise MRT_PLACE_COOLDOWN_S / "
                        f"MRT_PLACE_MIN_GAIN"
                    ),
                    "aligned": off is not None,
                })
        # Shipped-state loss window: only rings that actually shipped
        # (SHIP records present) are judged — a fleet without the state
        # plane must not produce false positives.  For each shipped
        # group, the gap between its last acked shipment and the ring's
        # end is the data the standbys never saw; on an unclean death a
        # gap past the shipping window is exactly "data loss window
        # exceeded".
        ship_last: Dict[int, Record] = {}
        n_ship = 0
        for r in recs:
            if r["type"] == flightrec.SHIP:
                ship_last[r["code"]] = r
                n_ship += 1
        if ship_last:
            info["shipments"] = {
                gid: {"last_frontier": r["c"], "last_kind": r["tag"]}
                for gid, r in sorted(ship_last.items())
            }
            info["ship_records"] = n_ship
        if ship_last and not ring["clean_close"]:
            end_ts = recs[-1]["ts"]
            window = _ship_window_us()
            for gid, r in sorted(ship_last.items()):
                gap = end_ts - r["ts"]
                if gap > window:
                    anomalies.append({
                        "ts": aligned(r["ts"]), "proc": label,
                        "kind": "ship_window_exceeded",
                        "detail": (
                            f"data loss window exceeded: group {gid}'s "
                            f"last shipment ({r['tag']}, frontier "
                            f"{r['c']}) was {gap / 1e6:.1f}s before "
                            f"death > window "
                            f"{window / 1e6:.1f}s — writes in the gap "
                            f"died unshipped"
                        ),
                        "aligned": off is not None,
                    })
        # Wedged leadership: WEDGE records (wedge.py watchdog) grouped
        # by group — ONE anomaly per wedged group, anchored on the
        # wedge ONSET, naming the stalled group, the stuck leader (the
        # record tag carries "p<peer>@t<term>"), and the nemesis fault
        # window that caused it (windows.json, same host clock the
        # anomaly is aligned to).
        wedge_by_g: Dict[int, List[Record]] = {}
        for r in recs:
            if r["type"] == flightrec.WEDGE:
                wedge_by_g.setdefault(r["code"], []).append(r)
        if wedge_by_g:
            info["wedges"] = {
                g: {
                    "records": len(rs),
                    "peak_stall": max(r["a"] for r in rs),
                    "leader": rs[0]["tag"],
                }
                for g, rs in sorted(wedge_by_g.items())
            }
        for g, rs in sorted(wedge_by_g.items()):
            first, last = rs[0], rs[-1]
            onset = aligned(first["ts"])
            span_s = (last["ts"] - first["ts"]) / 1e6
            detail = (
                f"wedged leadership: group {g} commit frontier stalled "
                f"at {first['b']} with {first['c']} proposal(s) "
                f"pending; stuck leader {first['tag']}; "
                f"{len(rs)} wedge record(s) over {span_s:.1f}s, peak "
                f"stall {max(r['a'] for r in rs)} scrape(s)"
            )
            win = (
                _covering_window(bundle.get("windows") or [], onset)
                if off is not None else None
            )
            if win is not None:
                t1 = win.get("t_stop_us")
                detail += (
                    f"; during fault window '{win['kind']}' on "
                    f"proc(s) {win.get('procs')} "
                    f"(t={win.get('t_start_us', 0):.0f}–"
                    + (f"{t1:.0f}us" if t1 is not None else "open")
                    + ")"
                )
            anomalies.append({
                "ts": onset, "proc": label,
                "kind": "wedged_leadership", "detail": detail,
                "aligned": off is not None,
            })
        # Degraded quorum: CONFIG records (placement.py healer) grouped
        # by group.  A replace-replica reconfig runs the group on a
        # reduced quorum from the voter's death until "done"; flag any
        # reconfig still OPEN at the ring's end (begun, never done or
        # aborted — on an unclean controller death that's a heal the
        # successor must resume) and any that ran past the replace
        # deadline even when it eventually finished.
        cfg_by_g: Dict[int, List[Record]] = {}
        for r in recs:
            if r["type"] == flightrec.CONFIG:
                cfg_by_g.setdefault(r["code"], []).append(r)
        if cfg_by_g:
            info["reconfigs"] = {
                g: {
                    "records": len(rs),
                    "last_phase": rs[-1]["tag"],
                    "dead_peer": rs[0]["a"],
                    "new_peer": rs[0]["b"],
                }
                for g, rs in sorted(cfg_by_g.items())
            }
        deadline_us = _replace_deadline_us()
        for g, rs in sorted(cfg_by_g.items()):
            first, last = rs[0], rs[-1]
            onset = aligned(first["ts"])
            span_us = last["ts"] - first["ts"]
            open_end = last["tag"] not in ("done", "abort")
            overran = span_us > deadline_us
            if not open_end and not overran:
                continue
            if open_end:
                what = (
                    f"reconfig still open at ring end (last phase "
                    f"'{last['tag']}' after {span_us / 1e6:.1f}s"
                    + ("" if ring["clean_close"]
                       else "; controller died mid-reconfig — successor "
                            "must resume the replicated intent")
                    + ")"
                )
            else:
                what = (
                    f"reconfig took {span_us / 1e6:.1f}s > deadline "
                    f"{deadline_us / 1e6:.0f}s before '{last['tag']}'"
                )
            detail = (
                f"degraded quorum: group {g} lost voter "
                f"{first['a']} (replacement peer {first['b']}, epoch "
                f"{first['c']}); {what}; {len(rs)} config record(s)"
            )
            win = (
                _covering_window(bundle.get("windows") or [], onset)
                if off is not None else None
            )
            if win is not None:
                detail += (
                    f"; during fault window '{win['kind']}' on "
                    f"proc(s) {win.get('procs')}"
                )
            anomalies.append({
                "ts": onset, "proc": label,
                "kind": "degraded_quorum", "detail": detail,
                "aligned": off is not None,
            })
        torn = ring["torn"]
        if torn > 1:
            # One torn slot is the expected SIGKILL signature; more
            # means the file itself took damage — say so.
            anomalies.append({
                "ts": aligned(recs[-1]["ts"]), "proc": label,
                "kind": "torn_slots",
                "detail": f"{torn} slots failed checksum",
                "aligned": off is not None,
            })
        procs.append(info)

    # Missing processes per the final scrape (dead at collection).
    lag: Dict[str, Any] = {}
    for addr, snap in (bundle.get("snapshots") or {}).items():
        if snap.get("missing"):
            lag[addr] = {"missing": True, "pid": snap.get("pid")}
            continue
        groups = snap.get("groups")
        if not groups:
            continue
        commit = groups.get("commit") or []
        applied = groups.get("applied") or []
        pairs = list(zip(commit, applied))
        if not pairs:
            continue
        worst = max(range(len(pairs)), key=lambda i: pairs[i][0] - pairs[i][1])
        lag[addr] = {
            "max_lag": pairs[worst][0] - pairs[worst][1],
            "group": worst,
            "commit": pairs[worst][0],
            "applied": pairs[worst][1],
        }

    anomalies.sort(key=lambda a: a["ts"])
    return {
        "procs": procs,
        "anomalies": anomalies,
        "first_anomaly": anomalies[0] if anomalies else None,
        "lag": lag,
    }


# -- Perfetto export -------------------------------------------------------


def rings_to_trace(bundle: Dict[str, Any]) -> Tracer:
    """One clock-aligned Chrome trace from every ring in the bundle."""
    manifest = bundle.get("manifest") or {}
    offsets = _pid_offsets(manifest)
    total = sum(len(r["records"]) for r in bundle["rings"])
    # ×2: a PROF record can emit a counter AND a hottest-function
    # instant; every other type emits at most one event.
    out = Tracer(max_events=2 * total + 16 * max(1, len(bundle["rings"])))
    for ring in bundle["rings"]:
        pid = ring["pid"]
        off = offsets.get(pid, 0.0)
        last_hot = ""
        addr = _pid_addr(manifest, pid)
        tagbits = "" if pid in offsets else " (unaligned clock)"
        out.process_name(
            pid, f"{ring['name'] or 'pid' + str(pid)}"
                 + (f" @ {addr}" if addr else "") + tagbits,
        )
        for r in ring["records"]:
            ts = r["ts"] - off
            t = r["type"]
            if t in (flightrec.RPC_HANDLE, flightrec.RPC_CLIENT):
                track = "rpc" if t == flightrec.RPC_HANDLE else "rpc_client"
                out.span(r["tag"] or r["type_name"], ts - r["a"], r["a"],
                         track=track, pid=pid, ok=r["b"], seq=r["seq"])
            elif t == flightrec.RPC_OUT:
                out.instant(r["tag"] or "rpc_out", ts, track="rpc_out",
                            pid=pid, req_id=r["a"], bytes=r["b"])
            elif t == flightrec.WAL_APPEND:
                out.counter("wal_appended", ts, {"seq": r["a"]}, pid=pid,
                            track="wal")
            elif t == flightrec.WAL_FSYNC:
                out.counter("wal_synced", ts, {"seq": r["a"]}, pid=pid,
                            track="wal")
            elif t in (flightrec.STATE, flightrec.TICK):
                out.counter("commits_total", ts,
                            {"commits": r["a"] if t == flightrec.STATE
                             else r["c"]}, pid=pid, track="engine")
            elif t == flightrec.COMMIT:
                out.instant("commit", ts, track="commit", pid=pid,
                            group=r["code"], client=r["a"], cmd=r["b"],
                            rid=r["tag"])
            elif t == flightrec.CHAOS:
                out.instant(f"chaos:{r['tag']}", ts, track="chaos",
                            pid=pid, kind=r["code"])
            elif t == flightrec.ROLE:
                out.instant(f"role:peer{r['code']}", ts, track="raft",
                            pid=pid, role=r["a"], term=r["b"],
                            commit=r["c"])
            elif t == flightrec.OVERLOAD:
                out.instant(f"overload:{r['tag']}", ts, track="overload",
                            pid=pid, kind=r["code"], value=r["a"],
                            bound=r["b"])
            elif t == flightrec.PLACE:
                out.instant(
                    f"place:g{r['code']}", ts, track="placement",
                    pid=pid, group=r["code"], src=r["a"], dst=r["b"],
                    version=r["c"], reason=r["tag"],
                )
            elif t == flightrec.SHIP:
                out.instant(
                    f"ship:g{r['code']}", ts, track="ship",
                    pid=pid, group=r["code"], records=r["a"],
                    bytes=r["b"], frontier=r["c"], kind=r["tag"],
                )
            elif t == flightrec.WEDGE:
                out.instant(
                    f"wedge:g{r['code']}", ts, track="wedge",
                    pid=pid, group=r["code"], stall=r["a"],
                    commit=r["b"], backlog=r["c"], leader=r["tag"],
                )
            elif t == flightrec.CONFIG:
                out.instant(
                    f"config:g{r['code']}", ts, track="config",
                    pid=pid, group=r["code"], dead_peer=r["a"],
                    new_peer=r["b"], epoch=r["c"], phase=r["tag"],
                )
            elif t == flightrec.PROF:
                out.counter(
                    "profiler", ts,
                    {"busy_permille": r["code"], "samples": r["a"],
                     "stacks": r["b"], "overflow": r["c"]},
                    pid=pid, track="profile",
                )
                if r["tag"] and r["tag"] != last_hot:
                    last_hot = r["tag"]
                    out.instant(f"hot:{r['tag']}", ts, track="profile",
                                pid=pid, busy_permille=r["code"])
            elif t == flightrec.NODE_CLOSE:
                out.instant(f"close:{r['tag']}", ts, track="marks",
                            pid=pid, node=r["tag"], clean=True)
            elif t == flightrec.TAIL:
                # Slow-request breadcrumb: span back over the request's
                # whole lifetime so the outlier overlaps the pump ticks
                # and RPC spans that produced it.
                out.span(
                    f"tail:{r['tag'] or 'request'}", ts - r["a"], r["a"],
                    track="tail", pid=pid,
                    wait=_TAIL_WAITS.get(r["code"], r["code"]),
                    wait_us=r["b"], tick=r["c"], seq=r["seq"],
                )
            elif t == flightrec.MARK:
                out.instant(f"mark:{r['tag']}", ts, track="marks",
                            pid=pid, tag=r["tag"])
            else:  # future types: show, don't drop
                out.instant(r["type_name"], ts, track="marks", pid=pid,
                            tag=r["tag"])
    return out


def rid_events(
    bundle: Dict[str, Any], rid: str,
) -> List[Tuple[str, Record]]:
    """Every ring record tagged with ``rid`` (the request's commit
    trail across processes), as ``(ring label, record)`` in seq order
    per ring."""
    hits: List[Tuple[str, Record]] = []
    for ring in bundle["rings"]:
        label = ring["name"] or f"pid{ring['pid']}"
        for r in ring["records"]:
            if r["tag"] == rid:
                hits.append((label, r))
    return hits


# -- report ----------------------------------------------------------------

_ROLE_NAMES = {0: "follower", 1: "candidate", 2: "leader"}


def _fmt_commit(r: Record) -> str:
    # Client ids are unsigned 64-bit on the wire; the ring stores the
    # low 64 bits two's-complement (flightrec._i64) — undo that here.
    client = r["a"] & 0xFFFFFFFFFFFFFFFF
    return (
        f"group {r['code']} client {client:#x} cmd {r['b']}"
        + (f" rid {r['tag']}" if r["tag"] else "")
    )


def build_report(bundle: Dict[str, Any], analysis: Dict[str, Any]) -> str:
    manifest = bundle.get("manifest") or {}
    lines: List[str] = []
    add = lines.append
    add("=" * 72)
    add(f"POSTMORTEM  {bundle['dir']}")
    if manifest.get("reason"):
        add(f"reason: {manifest['reason']}")
    if manifest.get("addrs"):
        add(
            f"fleet: {len(manifest['addrs'])} process(es), "
            f"{len(bundle['rings'])} ring(s), "
            f"{len(manifest.get('unreachable') or [])} unreachable at "
            f"collection"
        )
    add("=" * 72)

    fa = analysis["first_anomaly"]
    if fa is not None:
        add("")
        add("FIRST ANOMALY")
        mark = "" if fa["aligned"] else " (unaligned clock)"
        add(f"  t={fa['ts']:.0f}us{mark}  [{fa['proc']}]  {fa['kind']}")
        add(f"  {fa['detail']}")
    else:
        add("")
        add("no anomalies detected (all rings closed cleanly, no fsync "
            "gaps, no chaos bursts)")

    add("")
    add("PROCESSES")
    for p in analysis["procs"]:
        death = "clean close" if p["clean_close"] else "UNCLEAN DEATH"
        add(f"  {p['label']}  (pid {p['pid']})  — {death}")
        add(
            f"    ring: {p['records']} intact record(s)"
            f" / {p['slots']} slots, {p['torn']} torn"
            + ("" if p["aligned"] else ", clock unaligned")
        )
        if "last_event" in p:
            le = p["last_event"]
            add(f"    last event: {le['type_name']} seq {le['seq']}")
        if "last_commit" in p:
            add(f"    last commit: {_fmt_commit(p['last_commit'])}")
        if "wal" in p:
            w = p["wal"]
            gap = (
                f"  ** {w['gap']} append(s) NOT fsync'd **"
                if w["gap"] > 0 else ""
            )
            add(f"    wal: appended seq {w['appended']}, "
                f"synced {w['synced']}{gap}")
        for peer, r in (p.get("roles") or {}).items():
            add(
                f"    raft peer {peer}: "
                f"{_ROLE_NAMES.get(r['role'], r['role'])} "
                f"term {r['term']} commit {r['commit']}"
            )
        for path_tag, b in (p.get("chaos") or {}).items():
            add(
                f"    chaos '{path_tag}': {b['total']} fault(s), "
                f"max burst {b['max_burst']}/"
                f"{BURST_WINDOW_US / 1e6:.0f}s"
            )
        if "overload" in p:
            o = p["overload"]
            add(
                f"    overload: {o['trips']} trip(s), first saturated: "
                f"{o['first']}"
                + (f", queue gauge {o['gauge']}" if o["gauge"] else "")
                + (f" — diagnosed {o['diagnosis']} "
                   f"(peak busy {o['peak_busy_permille']}‰)"
                   if "diagnosis" in o else "")
            )
        if "profile" in p:
            pr = p["profile"]
            add(
                f"    profiler: {pr['records']} breadcrumb(s), "
                f"{pr['samples']} sample(s), peak busy "
                f"{pr['peak_busy_permille']}‰"
                + (f", hottest {pr['hottest']}" if pr["hottest"] else "")
            )
        if "tail" in p:
            tl = p["tail"]
            add(
                f"    tail: {tl['records']} breadcrumb(s), slowest "
                f"{tl['slowest_ms']:.1f} ms"
                + (f" (rid {tl['rid']})" if tl["rid"] else "")
                + f", dominant wait {tl['dominant_wait']}"
                + (f", tick {tl['tick']}" if tl["tick"] else "")
            )
        if "shipments" in p:
            gids = ", ".join(
                f"g{gid}@{d['last_frontier']}"
                for gid, d in p["shipments"].items()
            )
            add(
                f"    shipped state: {p['ship_records']} shipment(s), "
                f"last frontiers {gids}"
            )
        for g, w in (p.get("wedges") or {}).items():
            add(
                f"    wedged: group {g} leader {w['leader']}, "
                f"{w['records']} record(s), peak stall "
                f"{w['peak_stall']} scrape(s)"
            )
        for g, c in (p.get("reconfigs") or {}).items():
            add(
                f"    reconfig: group {g} voter {c['dead_peer']} → "
                f"peer {c['new_peer']}, last phase '{c['last_phase']}' "
                f"({c['records']} record(s))"
            )

    if analysis["lag"]:
        add("")
        add("COMMIT/APPLY AT FINAL SCRAPE")
        for addr, d in sorted(analysis["lag"].items()):
            if d.get("missing"):
                add(f"  {addr}: MISSING (dead at collection, "
                    f"pid {d.get('pid')})")
            else:
                add(
                    f"  {addr}: max lag {d['max_lag']} "
                    f"(group {d['group']}: commit {d['commit']}, "
                    f"applied {d['applied']})"
                )

    if analysis["anomalies"]:
        add("")
        add("ANOMALY TIMELINE (host-clock us)")
        for a in analysis["anomalies"]:
            mark = "" if a["aligned"] else " ~"
            add(f"  t={a['ts']:>16.0f}{mark}  [{a['proc']}] "
                f"{a['kind']}: {a['detail']}")

    if bundle["skipped"]:
        add("")
        add("SKIPPED INPUTS")
        for s in bundle["skipped"]:
            add(f"  {s}")
    add("")
    return "\n".join(lines)


# -- CLI -------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m multiraft_tpu_torch.analysis.postmortem",
        description="Flight-recorder postmortem doctor",
    )
    ap.add_argument("bundle", help="bundle dir, rings dir, or .ring file")
    ap.add_argument(
        "--trace-out", default=None,
        help="Perfetto trace path (default <bundle>/flight_trace.json.gz;"
             " 'none' to skip)",
    )
    ap.add_argument(
        "--rid", default=None,
        help="also print every ring record tagged with this request id",
    )
    ap.add_argument(
        "--json", action="store_true",
        help="emit the analysis as JSON instead of the text report",
    )
    ns = ap.parse_args(argv)

    if not os.path.exists(ns.bundle):
        print(f"postmortem: no such bundle: {ns.bundle}", file=sys.stderr)
        return 2
    bundle = load_bundle(ns.bundle)
    if not bundle["rings"] and not bundle["snapshots"]:
        print(
            f"postmortem: {ns.bundle}: no readable rings or snapshots"
            + (f" ({'; '.join(bundle['skipped'])})"
               if bundle["skipped"] else ""),
            file=sys.stderr,
        )
        return 2
    analysis = analyze(bundle)

    if ns.json:
        print(json.dumps(analysis, indent=2, sort_keys=True, default=str))
    else:
        report = build_report(bundle, analysis)
        print(report)
        if os.path.isdir(bundle["dir"]):
            try:
                with open(os.path.join(bundle["dir"], "report.txt"),
                          "w") as f:
                    f.write(report)
            except OSError:
                pass

    if ns.rid:
        hits = rid_events(bundle, ns.rid)
        print(f"rid {ns.rid}: {len(hits)} record(s)")
        for label, r in hits:
            print(
                f"  [{label}] seq {r['seq']} {r['type_name']} "
                f"code={r['code']} a={r['a']} b={r['b']} ts={r['ts']:.0f}"
            )

    if ns.trace_out != "none" and bundle["rings"]:
        trace_path = ns.trace_out or os.path.join(
            bundle["dir"], "flight_trace.json.gz"
        )
        try:
            rings_to_trace(bundle).save(trace_path)
            print(f"perfetto trace: {trace_path}", file=sys.stderr)
        except OSError as exc:  # pragma: no cover - fs full etc.
            print(f"postmortem: trace write failed: {exc}",
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
