"""Host milliseconds a tick spent in the calls into the tick loop
(``run_ticks_traced_vec``), read by ``perf_counter`` around each call
before any synchronise, over the window's untraced ticks."""


def read(out):
    w = out.window
    if w.enqueue_ticks <= 0:
        return None
    return w.enqueue_s * 1e3 / w.enqueue_ticks
