"""Device milliseconds a tick in the recovery layer's phases
(``mrt.votes``, ``mrt.tally``, ``mrt.fast_forward``,
``mrt.check_quorum``, ``mrt.elections``), from the program's CUDA events
at the phases' ends, over the device stretch's ticks
(:func:`cellbench.phases.device_ms_per_tick`)."""

from cellbench import phases


def read(out):
    return phases.device_ms_per_tick(out, "recovery")
