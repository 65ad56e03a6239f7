"""Leader kills (:func:`cellbench.surgery.kill_leaders`): every ``every_ticks``
ticks the live leaders of a fresh ``share`` of the groups
(:class:`cellbench.traffic.Victims`) are killed and the previous round's
victims revived.  A round takes away the service of every group in which
it found a live leader."""

from __future__ import annotations

from cellbench import surgery, traffic


class LeaderKills:
    def __init__(self, params: dict, G: int, seed: int) -> None:
        self.every = int(params["every_ticks"])
        self.victims = traffic.Victims(float(params["share"]), G, seed)

    def rows(self, r: int):
        return self.victims.round(r)

    def apply(self, state, inbox, at, groups, carry):
        return surgery.kill_leaders(state, inbox, at, carry)

    def lost(self, carry):
        return carry.groups, carry.hit


def plan(params: dict, G: int, seed: int) -> LeaderKills:
    return LeaderKills(params, G, seed)
