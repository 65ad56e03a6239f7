"""The benchmark's command.

    python -m cellbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card and prints, as the last
line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace
0``, its per-layer metrics with ``--trace 1``), ``device``, on a traced
run ``breakdown``, and last ``compared``: each number the check compared,
with its limit.  The same numbers close standard error.  Without a card,
with fewer cards than the cell asks for, or with JAX or the JAX package
loaded by the end of the run, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

_PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from . import manifest  # noqa: E402
from .isolation import forbidden_modules  # noqa: E402

EXIT_NO_CARD = 2
EXIT_FORBIDDEN = 3


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def process_age_s() -> float:
    """Seconds since this process started, from ``/proc`` (Linux); the
    time since this module was imported where that cannot be read."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        hz = os.sysconf("SC_CLK_TCK")
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(uptime - start_ticks / hz, time.perf_counter() - _PROCESS_START)
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _PROCESS_START


def card_line() -> str:
    """``name, power limit`` of the first card, as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def metrics_of(out, trace: bool) -> dict:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    metrics as their readers find them (a reader that finds nothing
    leaves its metric out)."""
    cell = out.cell
    if not trace:
        values = {
            "writes_per_s": out.writes["committed"] / out.window.seconds,
            "write_p99_ms": out.writes["ms_p99"],
            "failover_p99_ms": out.failover["ms_p99"] if out.failover else None,
            "setup_s": out.setup_s,
        }
        chosen = cell.end_to_end
    else:
        chosen = cell.per_layer
        values = {m["name"]: manifest.reader(m["name"])(out) for m in chosen}
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in chosen if values.get(m["name"]) is not None}


def result(out, trace: bool) -> dict:
    import torch

    dev = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": out.cell.chips,
        "memory_peak_bytes": out.memory_peak_bytes,
    }
    line = {
        "correct": out.correct,
        "attempted": out.attempted,
        "failed": out.failed,
        "metrics": metrics_of(out, trace),
        "device": dev,
    }
    if trace and out.stretch is not None:
        dev["busy_s"] = out.stretch.busy_s
        dev["window_s"] = out.stretch.window_s
        line["breakdown"] = {"device_ops": out.stretch.top_device_ops(),
                             "idle_gaps": out.host_stretch.idle_gaps()}
    line["card"] = out.card
    line["compared"] = out.checks
    return line


def main(argv=None) -> int:
    args = parse(argv)
    cell = manifest.cell(args.workload)
    import torch

    import multiraft_tpu_torch.engine.core  # noqa: F401  (the program must be here)

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"cellbench: {args.workload} needs {cell.chips} CUDA card(s), "
            f"found {n}; no result")
        return EXIT_NO_CARD
    torch.set_num_threads(1)
    from . import harness

    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                      process_start=time.perf_counter() - process_age_s())
    out.card = card_line()
    bad = forbidden_modules()
    if bad:
        log(f"cellbench: forbidden modules loaded: {bad}; no result")
        return EXIT_FORBIDDEN
    line = result(out, bool(args.trace))
    w, fo = out.writes, out.failover
    log(f"cellbench: {cell.name} seed {args.seed} on {out.card}: "
        f"{out.window.ticks} ticks in {out.window.seconds:.3f} s, drain "
        f"{out.window.drain}; setup {out.setup_s:.3f} s; enqueue "
        f"{out.window.enqueue_s:.3f} s, events {out.window.event_s:.3f} s; committed {w['committed']}, accepted "
        f"{w['accepted']} (committed {w['accepted_committed']}, truncated "
        f"{w['truncated']}, in flight {w['in_flight']}, unplaced {w['unplaced']}); "
        f"commit ticks p50/p99 {w['ticks_p50']}/{w['ticks_p99']}, ms "
        f"{w['ms_p50']}/{w['ms_p99']}")
    if fo:
        log(f"cellbench: kills {fo['kills']}, unserved {fo['unserved']}, "
            f"ticks p50/p99 {fo['ticks_p50']}/{fo['ticks_p99']}, ms "
            f"{fo['ms_p50']}/{fo['ms_p99']}")
    c = out.count
    log(f"cellbench: failure count over window ticks [0, {c['span']}) judged by ticks "
        f"[0, {c['judged_at']}): attempted {out.attempted} (committed {c['committed']}, truncated "
        f"{c['truncated']}), failed {out.failed} (unserved {c['unserved']})")
    for name, c in out.checks.items():
        log(f"compared {name} {c['value']} limit {c['limit']}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
