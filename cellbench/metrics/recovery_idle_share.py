"""The device's idle time under the recovery layer's spans
(``mrt.votes``, ``mrt.tally``, ``mrt.fast_forward``,
``mrt.check_quorum``, ``mrt.elections``), in % of the window of the
stretch traced with the host's activity: the idle gaps whose midpoint
falls under one of them (:func:`cellbench.phases.idle_share`)."""

from cellbench import phases


def read(out):
    return phases.idle_share(out.host_stretch, "recovery")
