"""The 99th percentile, in ticks, of the time without service after a
leader kill: the count behind ``failover_p99_ms``; only cells with
kills have it."""


def read(out):
    if out.failover is None or out.failover["ticks_p99"] is None:
        return None
    return float(out.failover["ticks_p99"])
