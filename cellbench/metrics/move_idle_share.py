"""The device's idle time under the replica moves' spans
(``mrt.move.seat``, ``mrt.move.begin``, ``mrt.move.remove``, from
``multiraft_tpu_torch.engine.membership``), in % of the window of the
stretch traced with the host's activity: a host synchronise in a round
of moves leaves the card idle under it
(:func:`cellbench.phases.idle_share`)."""

from cellbench import phases

SPANS = ("mrt.move.seat", "mrt.move.begin", "mrt.move.remove")


def read(out):
    return phases.idle_share(out.host_stretch, SPANS)
