"""The device's idle share, in %: one minus the union of its operations'
intervals over the wall window of the stretch traced with the device's
activity alone, from its first operation's start to its last one's end."""


def read(out):
    s = out.stretch
    if s is None or s.window_s <= 0 or not s.device_ops:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
