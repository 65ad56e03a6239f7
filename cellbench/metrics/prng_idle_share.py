"""The device's idle time under the jitter draw's span, ``mrt.prng``, in
% of the window of the stretch traced with the host's activity: the
idle gaps whose midpoint falls under it
(:func:`cellbench.phases.idle_share`)."""

from cellbench import phases


def read(out):
    return phases.idle_share(out.host_stretch, "prng")
