"""Postmortem bundle collection: freeze the fleet's black boxes.

When a run goes wrong — a nemesis window silently misses, a chaos test
fails, a process dies when it shouldn't — the evidence is scattered
across N processes, some of them already dead.  :func:`collect_bundle`
gathers everything a postmortem needs into ONE directory while it is
still fresh:

* ``manifest.json``  — addresses, per-address clock offsets (min-RTT
  estimates, cached so a DEAD process keeps the offset measured while
  it lived), pid/name idents, unreachable list, collection reason.
* ``snapshots.json`` — final ``Obs.snapshot`` per process, with
  explicit ``{"missing": true}`` markers for the dead
  (:meth:`FleetObserver.snapshot_all`).
* ``tails.json``     — per-process tail exemplars (``Obs.tail``,
  peeked non-destructively), best-effort: the slowest requests each
  survivor was holding, with full stage/wait vectors.
* ``rings/``         — every ``flight-<pid>.ring`` from the flight
  recorder directory, copied byte-for-byte.  The rings are the only
  evidence that survives SIGKILL; copying them into the bundle pins
  the run's state before a retry or cleanup overwrites it.
* ``trace.json.gz``  — the merged clock-aligned fleet timeline
  (best-effort: reachable processes only, missing rows marked).
* ``windows.json``   — the nemesis fault-window ledger, when given.

The bundle is self-contained: ``python -m
multiraft_tpu_torch.analysis.postmortem <bundle>`` needs nothing else.

PyTorch port of ``multiraft_tpu/harness/bundle.py``.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..distributed import flightrec
from ..distributed.observe import now_us
from ..utils.knobs import knob_str
from .observe import FleetObserver

__all__ = ["collect_bundle"]

Addr = Tuple[str, int]


def _jsonable(obj: Any) -> Any:
    """Best-effort plain-data projection (windows ledgers hold only
    plain types today; ``default=str`` guards future additions)."""
    return json.loads(json.dumps(obj, default=str))


def collect_bundle(
    out_dir: str,
    addrs: Sequence[Addr] = (),
    observer: Optional[FleetObserver] = None,
    reason: str = "",
    windows: Sequence[Dict[str, Any]] = (),
    schedule: Sequence[Any] = (),
    t0_us: Optional[float] = None,
    local_events: Sequence[Dict[str, Any]] = (),
    flight_dir: Optional[str] = None,
) -> str:
    """Collect a postmortem bundle into ``out_dir`` and return it.

    Pass an existing ``observer`` to reuse its cached clock offsets and
    pid idents (essential: a process that died mid-run can only be
    clock-aligned from offsets measured before death); otherwise a
    throwaway :class:`FleetObserver` over ``addrs`` is created and
    closed.  Never raises on a partially dead fleet — collecting less
    evidence beats collecting none."""
    owned = observer is None
    if observer is None:
        observer = FleetObserver(list(addrs))
    try:
        os.makedirs(out_dir, exist_ok=True)

        # Flush this host process's own ring so clerk/nemesis records
        # written microseconds ago are on disk before the copy.
        rec = flightrec.get_recorder()
        if rec is not None:
            rec.flush()

        snaps = observer.snapshot_all()
        with open(os.path.join(out_dir, "snapshots.json"), "w") as f:
            json.dump(snaps, f, indent=2, sort_keys=True, default=str)

        try:
            # Tail exemplars, NON-destructively (reset=False): evidence
            # collection must not consume the window a concurrent
            # loadcurve scrape is about to drain.  Best-effort — a
            # fleet with MRT_TAIL=0 just reports tail: null rows.
            tails = observer.tail_all(reset=False)
            if any(
                isinstance(t, dict) and t.get("tail") is not None
                for t in tails.values()
            ):
                with open(os.path.join(out_dir, "tails.json"), "w") as f:
                    json.dump(
                        tails, f, indent=2, sort_keys=True, default=str
                    )
        except Exception:
            pass  # same contract as the timeline: rings are load-bearing

        try:
            tr = observer.merged_timeline(
                local_events=local_events, windows=windows,
                schedule=schedule, t0_us=t0_us,
            )
            tr.save(os.path.join(out_dir, "trace.json.gz"))
        except Exception:
            pass  # the rings + snapshots are the load-bearing evidence

        if windows:
            with open(os.path.join(out_dir, "windows.json"), "w") as f:
                json.dump(_jsonable(list(windows)), f, indent=2)

        fdir = flight_dir or knob_str("MRT_FLIGHTREC_DIR")
        rings: List[str] = []
        if fdir and os.path.isdir(fdir):
            rdir = os.path.join(out_dir, "rings")
            os.makedirs(rdir, exist_ok=True)
            for p in sorted(glob.glob(os.path.join(fdir, "flight-*.ring"))):
                try:
                    shutil.copy2(p, rdir)
                    rings.append(os.path.basename(p))
                except OSError:
                    continue

        manifest = {
            "reason": reason,
            "created_at": time.time(),
            "host_now_us": now_us(),
            "host_pid": os.getpid(),
            "addrs": [f"{h}:{p}" for h, p in observer.addrs],
            "offsets_us": {
                f"{h}:{p}": off
                for (h, p), off in observer.offsets.items()
            },
            "idents": {
                f"{h}:{p}": {"pid": pid, "name": name}
                for (h, p), (pid, name) in observer.idents.items()
            },
            "unreachable": [f"{h}:{p}" for h, p in observer.unreachable],
            "rings": rings,
            "flight_dir": fdir,
        }
        with open(os.path.join(out_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
        return out_dir
    finally:
        if owned:
            observer.close()
