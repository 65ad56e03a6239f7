"""The device's idle time under the replication and commit layer's spans
(``mrt.append`` less the ``mrt.fast_forward`` inside it, ``mrt.commit``,
``mrt.ingest``, ``mrt.sends``), in % of the window of the stretch traced
with the host's activity: the idle gaps whose midpoint falls under one
of them (:func:`cellbench.phases.idle_share`)."""

from cellbench import phases


def read(out):
    return phases.idle_share(out.host_stretch, "replication")
