"""The whole tick's share of the card's memory bandwidth, in %: the
one-pass bytes a tick touches (``cellbench.roofline.bytes_per_tick``)
at the card's peak rate, over the window's host-clock time per tick,
leaving out the traced stretch, which the profiler slows."""

from cellbench import roofline


def read(out):
    w = out.window
    ticks, seconds = w.ticks - w.stretch_ticks, w.seconds - w.stretch_s
    pk = roofline.peak(out.kind)
    if ticks <= 0 or seconds <= 0 or pk is None:
        return None
    c = out.cell.conf
    least_s = roofline.bytes_per_tick(c["G"], c["P"], c["L"], c["E"]) / pk["bytes_per_s"]
    return 100.0 * least_s / (seconds / ticks)
