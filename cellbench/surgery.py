"""The benchmark's fault model: leader kills as device ops.

The semantics are those of ``apply_leader_kills`` in
``multiraft_tpu_torch/bench.py`` at commit 73b8d79, which copies every
plane to the host and back; here every step is a tensor op on the
state's own device, enqueued between two ticks without a host round
trip, and written out of place (the tick never writes its inputs in
place, so a plane that an earlier tick returned stays valid).

It acts on any state and mailbox with the engine's field names, so the
program's run and the reference's replay of a sample of groups inject
the same faults; rows are independent, so killing the sampled victims
of a sample gives each of them what the whole batch gives it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

LEADER = 2


class Killed(NamedTuple):
    groups: torch.Tensor  # int64[K] rows the round named
    peer: torch.Tensor  # int64[K] the replica killed in each
    hit: torch.Tensor  # bool[K] whether the group had a live leader to kill


def kill_leaders(state, inbox, groups: torch.Tensor,
                 prev: Optional[Killed]) -> Tuple[object, object, Killed]:
    """Revive ``prev``'s victims (follower, votes and prevotes cleared,
    ``last_heard`` set to the current tick; commit and applied not
    rewound), then kill the live leader at the highest term of every
    row in ``groups`` and drop every in-flight message to or from it."""
    alive, role = state.alive, state.role
    votes, pre_votes, last_heard = state.votes, state.pre_votes, state.last_heard
    if prev is not None and prev.groups.numel():
        g, p, hit = prev
        at = (g, p)
        alive = alive.index_put(at, alive[at] | hit)
        role = role.index_put(at, torch.where(hit, 0, role[at]))
        votes = votes.index_put(at, votes[at] & ~hit[:, None])
        pre_votes = pre_votes.index_put(at, pre_votes[at] & ~hit[:, None])
        last_heard = last_heard.index_put(
            at, torch.where(hit, state.tick_no, last_heard[at]))
    lead_term = torch.where((role == LEADER) & alive, state.term, -1)[groups]
    best, peer = lead_term.max(dim=1)
    hit = best >= 0
    at = (groups, peer)
    alive = alive.index_put(at, alive[at] & ~hit)
    state = state._replace(alive=alive, role=role, votes=votes,
                           pre_votes=pre_votes, last_heard=last_heard)
    dead = torch.zeros_like(alive).index_put(at, hit)
    edge_ok = ~(dead[:, :, None] | dead[:, None, :])
    inbox = inbox._replace(**{
        f: getattr(inbox, f) & edge_ok
        for f in inbox._fields if f.endswith("_active")
    })
    return state, inbox, Killed(groups, peer, hit)
