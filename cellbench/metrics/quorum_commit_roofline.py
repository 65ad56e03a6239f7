"""The quorum-commit kernel's share of its roofline, in %: the least
time of each captured launch on its own inputs
(``cellbench.roofline.commit_bound``) over that launch's device time in
the trace, summed over the captured launches."""

from cellbench import roofline

KERNEL = "quorum_commit_kernel"


def read(out):
    s = out.stretch
    if s is None or roofline.peak(out.kind) is None:
        return None
    calls = s.kernel_calls.get("quorum_commit", [])
    times = s.kernels(KERNEL)
    pairs = [(roofline.commit_bound(args[:7], int(args[7]), out.kind), times[i][1])
             for i, args in calls if i < len(times)]
    spent_ms = sum(d for _, d in pairs) * 1e-3
    if spent_ms <= 0:
        return None
    return 100.0 * sum(b for b, _ in pairs) / spent_ms
