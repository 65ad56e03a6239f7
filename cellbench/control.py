"""The control of the check: the reference put in the program's place,
with one guarantee of the configuration broken, has to come out not
correct.

The configurations state no precision; the guarantee broken is the
commit quorum: the control's leader commits an entry as soon as it holds
it itself (a quorum of 1), acknowledging writes that no follower has.
It runs the cell's whole run, at the cell's own size on the card, with
the tick of the cell's reference (:mod:`.reference.tick` by default) in
the window's place, and the sound reference replays the sample as in
every run.

    python -m cellbench.control --workload <name> --seeds 1 2 3 --seconds 5

prints one JSON line per seed with each compared number; it does not
decide ``correct`` for the benchmark's runs, which never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import harness, manifest
from .reference import prng

BROKEN_QUORUM = 1


def control_step(conf: dict, device, commit_quorum: int = BROKEN_QUORUM):
    """A window step that runs the reference's tick over every group
    with ``commit_quorum``, in the engine's calling convention."""
    ref = harness.reference(conf)
    rcfg = ref.config(conf, conf["G"], commit_quorum)
    rows = torch.arange(conf["G"], device=torch.device(device))

    def step(cfg, state, inbox, new_cmds, key):
        k = prng.fold_in(tuple(int(x) for x in key.tolist()), 0)
        state, inbox, rec = ref.tick(rcfg, state, inbox, new_cmds, k, rows)
        return state, inbox, {name: v[None] for name, v in rec.items()}

    return step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cellbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    cell = manifest.cell(args.workload)
    for seed in args.seeds:
        out = harness.run(cell, seed, args.seconds, False, "cuda:0",
                          step=control_step(cell.conf, "cuda:0"))
        print(json.dumps({
            "workload": cell.name, "seed": seed, "control": "commit quorum 1",
            "correct": out.correct, "ticks": out.window.ticks,
            "compared": out.checks,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
