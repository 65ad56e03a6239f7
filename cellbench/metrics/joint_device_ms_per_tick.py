"""Device milliseconds a tick in the phases that hold the quorum work of
the joint-consensus path (``mrt.membership``, ``mrt.tally``,
``mrt.commit``, ``mrt.check_quorum``): the masked reductions where the
configuration takes the joint path, the two kernels and the plain
reductions where it does not (``mrt.membership`` then never runs), from
the program's CUDA events at the phases' ends, over the device stretch's
ticks (:func:`cellbench.phases.device_ms_per_tick`)."""

from cellbench import phases

SPANS = ("mrt.membership", "mrt.tally", "mrt.commit", "mrt.check_quorum")


def read(out):
    return phases.device_ms_per_tick(out, SPANS)
