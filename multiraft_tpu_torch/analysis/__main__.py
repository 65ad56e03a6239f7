"""CLI: ``python -m multiraft_tpu_torch.analysis [paths...]`` (PyTorch
port of the reference's graftlint CLI; default path: this package).

Exit status 1 on any unsuppressed finding, 0 otherwise.  Suppressed
findings (``# graftlint: disable=<rule>``) are listed with ``-v`` so
the suppression inventory stays reviewable.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .core import ALL_RULES, run
from . import rules as _rules  # noqa: F401
from . import lockgraph as _lockgraph  # noqa: F401
from . import dataflow as _dataflow  # noqa: F401
from . import planes as _planes  # noqa: F401
from . import registry as _registry  # noqa: F401


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="graftlint")
    ap.add_argument(
        "paths",
        nargs="*",
        default=[str(Path(__file__).resolve().parents[1])],
        help="files or directories to lint (default: multiraft_tpu_torch)",
    )
    ap.add_argument(
        "-v",
        "--verbose",
        action="store_true",
        help="also list suppressed findings",
    )
    ap.add_argument(
        "--rule",
        action="append",
        default=None,
        help="run only the named rule(s)",
    )
    ap.add_argument(
        "--format",
        choices=("text", "github"),
        default="text",
        help=(
            "finding output format: github emits ::error annotation "
            "lines that render inline on PRs"
        ),
    )
    ap.add_argument(
        "--timings",
        action="store_true",
        help="print per-rule wall-clock timing to stderr",
    )
    ap.add_argument(
        "--per-rule",
        action="store_true",
        help=(
            "print per-rule active/suppressed finding counts to "
            "stderr (the suppression inventory at a glance)"
        ),
    )
    ns = ap.parse_args(argv)
    rules = ALL_RULES
    if ns.rule:
        rules = [r for r in ALL_RULES if r.name in ns.rule]
        if not rules:
            known = ", ".join(sorted(r.name for r in ALL_RULES))
            print(f"graftlint: no such rule(s); known: {known}",
                  file=sys.stderr)
            return 2
    timings = {} if ns.timings else None
    active, suppressed = run(
        [Path(p) for p in ns.paths], rules, timings=timings
    )
    for f in active:
        if ns.format == "github":
            # GitHub workflow-command annotation: shows inline on the PR
            # diff.  Message must be single-line (newlines end the
            # command) and paths repo-relative.
            msg = f.message.replace("\n", " ")
            print(
                f"::error file={f.path},line={f.line},"
                f"title=graftlint/{f.rule}::{msg}"
            )
        else:
            print(f)
    if timings is not None:
        for rname, secs in sorted(
            timings.items(), key=lambda kv: -kv[1]
        ):
            print(f"  rule {rname:<22} {secs * 1000:8.1f} ms",
                  file=sys.stderr)
    if ns.per_rule:
        counts = {r.name: [0, 0] for r in rules}
        for f in active:
            counts[f.rule][0] += 1
        for f in suppressed:
            counts[f.rule][1] += 1
        for rname in sorted(counts):
            a, s = counts[rname]
            print(
                f"  rule {rname:<22} {a:3d} active {s:3d} suppressed",
                file=sys.stderr,
            )
    if ns.verbose and suppressed:
        print(f"-- {len(suppressed)} suppressed --")
        for f in suppressed:
            print(f"  {f}")
    if active:
        print(
            f"graftlint: {len(active)} finding(s) "
            f"({len(suppressed)} suppressed)",
            file=sys.stderr,
        )
        return 1
    print(
        f"graftlint: clean ({len(ALL_RULES) if rules is ALL_RULES else len(rules)}"
        f" rules, {len(suppressed)} suppressed finding(s))",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
