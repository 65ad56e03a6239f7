"""Kernel launches a tick: the CUDA kernels in the traced stretch's
device trace over the stretch's ticks (the engine's own and the few the
benchmark adds a tick to keep its records)."""


def read(out):
    s = out.stretch
    if s is None or s.ticks <= 0:
        return None
    n = sum(1 for cat, *_ in s.device_ops if cat == "kernel")
    return n / s.ticks if n else None
