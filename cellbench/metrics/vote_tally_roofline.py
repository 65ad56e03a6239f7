"""The vote-tally kernel's share of its roofline, in %: as
``quorum_commit_roofline``, with ``cellbench.roofline.tally_bound``."""

from cellbench import roofline

KERNEL = "vote_tally_kernel"


def read(out):
    s = out.stretch
    if s is None or roofline.peak(out.kind) is None:
        return None
    calls = s.kernel_calls.get("vote_tally", [])
    times = s.kernels(KERNEL)
    pairs = [(roofline.tally_bound(args[:3], out.kind), times[i][1])
             for i, args in calls if i < len(times)]
    spent_ms = sum(d for _, d in pairs) * 1e-3
    if spent_ms <= 0:
        return None
    return 100.0 * sum(b for b, _ in pairs) / spent_ms
