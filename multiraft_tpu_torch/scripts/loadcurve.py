"""Run the open-loop load-curve sweep and record the round (the PyTorch
port of ``scripts/loadcurve.py``).

    python -m multiraft_tpu_torch.scripts.loadcurve [--rates 250,500,...]
        [--step-s 4] [--mode poisson|bursty|diurnal] [--seed 7]
        [--p99-target-ms 50] [--out PATH] [--no-verify] [--compare]
        [--device cpu]

Drives ``multiraft_tpu_torch.benchmarks.openloop``'s rate ladder
against one served engine on ``--device`` (the card unless ``cpu`` is
asked for; per-stage decomposition scraped fleet-wide per step), then:

* writes the report to ``--out``, defaulting to the next free
  ``LOADCURVE_rNN.json`` in the port's ``build/rounds/`` — the
  trajectory file the ``loadcurve`` family of
  ``multiraft_tpu_torch.scripts.bench_compare`` tracks;
* with ``--compare``, gates the fresh result against the recorded
  trajectory BEFORE it becomes a round (exit 1 on regression past the
  threshold, like CI's bench gate).

The report is the raw sweep object (flat headline keys:
``max_sustainable_ops_per_sec``, ``knee_ops_per_sec``,
``p99_at_knee_ms``), so bench_compare reads rounds and fresh results
identically.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import List, Optional

from .bench_compare import ROUNDS_DIR


def next_round_path() -> str:
    """First unused ``LOADCURVE_rNN.json`` in ``build/rounds/`` (made
    if it is missing)."""
    os.makedirs(ROUNDS_DIR, exist_ok=True)
    taken = set()
    for p in glob.glob(os.path.join(ROUNDS_DIR, "LOADCURVE_r*.json")):
        m = re.search(r"LOADCURVE_r(\d+)\.json$", p)
        if m:
            taken.add(int(m.group(1)))
    n = 1
    while n in taken:
        n += 1
    return os.path.join(ROUNDS_DIR, f"LOADCURVE_r{n:02d}.json")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="loadcurve")
    ap.add_argument("--rates", default="",
                    help="comma-separated offered-rate ladder (ops/s)")
    ap.add_argument("--step-s", type=float, default=4.0,
                    help="seconds per rate step (default 4)")
    ap.add_argument("--mode", default="poisson",
                    choices=("poisson", "bursty", "diurnal"))
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--p99-target-ms", type=float, default=50.0,
                    help="p99 target for max sustainable load")
    ap.add_argument("--out", default="",
                    help="output path (default: the next "
                         "build/rounds/LOADCURVE_rNN.json)")
    ap.add_argument("--no-verify", action="store_true",
                    help="skip the porcupine sampler clerks")
    ap.add_argument("--flame", default="",
                    help="write the merged fleet flame (collapsed "
                         "folded-stack format) to this path")
    ap.add_argument("--compare", action="store_true",
                    help="gate against the port's recorded LOADCURVE rounds "
                         "(exit 1 on regression)")
    ap.add_argument("--threshold", type=float, default=5.0)
    ap.add_argument("--device", default="cuda",
                    help="the served engine's device (default cuda)")
    ns = ap.parse_args(argv)

    from ..benchmarks.openloop import DEFAULT_RATES, sweep

    rates = ([float(x) for x in ns.rates.split(",")] if ns.rates
             else list(DEFAULT_RATES))
    report = sweep(
        rates=rates, step_s=ns.step_s, mode=ns.mode, seed=ns.seed,
        p99_target_ms=ns.p99_target_ms, verify=not ns.no_verify,
        flame_out=ns.flame, device=ns.device,
    )
    rc = 0
    if ns.compare:
        # Gate BEFORE the result lands as a round file — once written
        # into the rounds directory it would be its own "latest round"
        # and the comparison would trivially pass.
        import tempfile

        from .bench_compare import main as compare_main

        os.makedirs(ROUNDS_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".json", dir=ROUNDS_DIR)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(report, f)
            rc = compare_main([
                tmp, "--family", "loadcurve",
                "--threshold", str(ns.threshold),
            ])
        finally:
            os.unlink(tmp)

    out_path = ns.out or next_round_path()
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
        f.write("\n")
    knee = report.get("knee") or {}
    print(
        f"loadcurve: {len(report['steps'])} step(s) {ns.mode} -> "
        f"{out_path}\n"
        f"  max sustainable @ p99<={ns.p99_target_ms:g}ms: "
        f"{report.get('max_sustainable_ops_per_sec')} ops/s\n"
        f"  knee: {knee.get('offered_rate')} offered "
        f"(p99 {knee.get('client_p99_ms')} ms)\n"
        f"  porcupine: {report.get('porcupine')} "
        f"({report.get('verifier_ops')} sampled op(s))",
        flush=True,
    )
    prof = report.get("profile") or {}
    if prof.get("top"):
        hot = prof["top"][0]
        print(
            f"  profile: {prof.get('samples')} sample(s), hottest "
            f"{hot['func']} (self {hot['self']})"
            + (f" -> {prof['flame_path']}" if prof.get("flame_path")
               else ""),
            flush=True,
        )

    return rc


if __name__ == "__main__":
    sys.exit(main())
