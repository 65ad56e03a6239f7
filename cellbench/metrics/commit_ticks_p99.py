"""The 99th percentile, in ticks, of accept-to-commit over every entry
accepted and committed in the window: the count behind
``write_p99_ms``, exact for a given seed."""


def read(out):
    v = out.writes.get("ticks_p99")
    return None if v is None or v != v else float(v)
