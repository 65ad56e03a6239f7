"""Replica moves by joint consensus as batched device ops.

TiKV's scheduler (PD) moves a replica in three steps, each over an index
tensor of groups at once (TiKV's ChangePeerV2, with PD's
``schedule.enable-joint-consensus``):

1. :func:`seat_learners`: a dead spare slot of each group becomes a
   fresh, non-voting learner (:func:`reset_replica`, its config view the
   leader's);
2. :func:`begin_joint`: the leader appends the C_old,new entry
   (``EngineDriver.begin_joint``); the tick replicates it, commits it
   under both quorums and appends the C_new exit entry itself;
3. :func:`remove_peers`: once the leader has left the joint config and
   committed C_new, the demoted slot goes down, its in-flight messages
   dropped; it is the group's next spare.

Every function works on the state's own device and writes out of place
(the tick never writes its inputs in place); nothing reads a value back
to the host, so a round of moves is enqueued between two ticks without a
synchronise.  ``rows`` holds distinct groups.  A row that does not
qualify (no live leader, no spare, a change in flight, no log headroom,
a learner still pending) is left unchanged and counted as deferred; a
row whose ``want`` is False is neither changed nor counted.  Each
function runs under an ``mrt.move.*`` range while ``torch.profiler``
records (``utils.trace.span``), and adds its rows to :data:`COUNTS`.

The leader of a group is its live leader at the highest term, the first
in slot order on a tie (``EngineDriver.leader_of``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..utils import trace
from .core import FOLLOWER, I32, LEADER, EngineConfig

__all__ = [
    "Moved", "MoveCounts", "COUNTS", "leaders", "drop_edges", "reset_replica",
    "seat_learners", "begin_joint", "remove_peers",
]

KINDS = ("seated", "begun", "removed",
         "deferred_seat", "deferred_begin", "deferred_remove")


class Moved(NamedTuple):
    done: torch.Tensor  # bool[n]: the row changed
    slot: torch.Tensor  # int64[n]: seated learner / demoted voter / removed slot


class MoveCounts:
    """Cumulative rows seated, begun, removed and deferred, per device, as
    device tensors: adding never synchronises; :meth:`read` does, once."""

    def __init__(self) -> None:
        self._by_device: Dict[str, torch.Tensor] = {}

    def add(self, kind: int, done: torch.Tensor, deferred: torch.Tensor) -> None:
        dev = done.device
        c = self._by_device.get(str(dev))
        if c is None:
            c = self._by_device[str(dev)] = torch.zeros(
                len(KINDS), dtype=torch.int64, device=dev)
        c[kind] += done.sum()
        c[3 + kind] += deferred.sum()

    def read(self) -> Dict[str, Dict[str, int]]:
        """Per device, each count and ``deferred``, their sum over the
        three steps."""
        out = {}
        for dev, c in self._by_device.items():
            v = dict(zip(KINDS, c.tolist()))
            v["deferred"] = sum(v[k] for k in KINDS[3:])
            out[dev] = v
        return out

    def reset(self) -> None:
        self._by_device.clear()


COUNTS = MoveCounts()


def leaders(state, rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64[n] the leader's slot, bool[n] the row has a live leader)."""
    lead_term = torch.where(
        (state.role[rows] == LEADER) & state.alive[rows], state.term[rows], -1)
    best, slot = lead_term.max(dim=1)
    return slot, best >= 0


def _lanes(bits: torch.Tensor, P: int) -> torch.Tensor:
    """i32 voter bitmask [n] -> bool lanes [n, P]."""
    return ((bits[:, None] >> torch.arange(P, dtype=I32, device=bits.device)) & 1) == 1


def _first(lanes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64[n] the first True lane, clamped into range; bool[n] any)."""
    P = lanes.shape[1]
    ar = torch.arange(P, device=lanes.device)
    k = torch.where(lanes, ar, P).amin(dim=1)
    return k.clamp(max=P - 1), k < P


def _set(x: torch.Tensor, ok: torch.Tensor, *writes) -> torch.Tensor:
    """A copy of ``x`` with ``(index, value)`` writes applied in order on
    the rows where ``ok`` (``ok`` broadcast over each indexed block's
    trailing axes): the batched form of ``host._set``."""
    x = x.clone()
    for index, value in writes:
        old = x[index]
        okb = ok.reshape(ok.shape + (1,) * (old.dim() - ok.dim()))
        x[index] = torch.where(okb, value, old)
    return x


def drop_edges(inbox, rows: torch.Tensor, slots: torch.Tensor,
               ok: Optional[torch.Tensor] = None):
    """Every in-flight message to or from replica ``(rows[i], slots[i])``
    dropped where ``ok`` (default: every row)."""
    ok = torch.ones_like(rows, dtype=torch.bool) if ok is None else ok
    at, col = (rows, slots), (rows, slice(None), slots)
    return inbox._replace(**{
        f: _set(getattr(inbox, f), ok, (at, False), (col, False))
        for f in inbox._fields if f.endswith("_active")
    })


def reset_replica(cfg: EngineConfig, state, inbox, rows: torch.Tensor,
                  slots: torch.Tensor, alive: bool,
                  ok: Optional[torch.Tensor] = None):
    """Wipe replica ``(rows[i], slots[i])`` to a fresh incarnation where
    ``ok`` (default: every row), its ``alive`` set to ``alive``: the
    re-add path (a removed peer index reused for a new server), not a
    crash-restart (``EngineDriver.restart_replica``, where persistent
    state survives).  Returns ``(state, inbox)``.

    Beyond its own row, this clears the other replicas' per-column state
    about it: a stale ``votes[g, :, p]`` grant of the old incarnation
    would otherwise count toward a quorum of the new config at the old
    term, and a stale ``match_idx`` would let a leader commit over
    entries the new incarnation never acknowledged.  Its in-flight
    messages die with the old incarnation.  The config view is left as
    it was: the membership ops seed it."""
    ok = torch.ones_like(rows, dtype=torch.bool) if ok is None else ok
    at, col = (rows, slots), (rows, slice(None), slots)
    now = state.tick_no
    st = state
    state = st._replace(
        # Own row: blank server.
        term=_set(st.term, ok, (at, 0)),
        voted_for=_set(st.voted_for, ok, (at, -1)),
        role=_set(st.role, ok, (at, FOLLOWER)),
        commit=_set(st.commit, ok, (at, 0)),
        applied=_set(st.applied, ok, (at, 0)),
        base=_set(st.base, ok, (at, 0)),
        base_term=_set(st.base_term, ok, (at, 0)),
        log_len=_set(st.log_len, ok, (at, 0)),
        log_term=_set(st.log_term, ok, (at, 0)),
        next_idx=_set(st.next_idx, ok, (at, 1), (col, 1)),
        hb_due=_set(st.hb_due, ok, (at, 0)),
        last_heard=_set(st.last_heard, ok, (at, now)),
        elect_dl=_set(st.elect_dl, ok, (at, now + cfg.ELECT_MAX)),
        # Cross-replica columns about the slot.  The row write comes
        # first, so [g, p, p] ends at the column's value.
        votes=_set(st.votes, ok, (at, False), (col, False)),
        pre_votes=_set(st.pre_votes, ok, (at, False), (col, False)),
        match_idx=_set(st.match_idx, ok, (at, 0), (col, 0)),
        last_ack=_set(st.last_ack, ok, (at, 0), (col, now)),
        alive=_set(st.alive, ok, (at, alive)),
    )
    return state, drop_edges(inbox, rows, slots, ok)


def _asked(ok: torch.Tensor, want: Optional[torch.Tensor]) -> torch.Tensor:
    """The rows offered: ``want``, or all."""
    return torch.ones_like(ok) if want is None else want


def seat_learners(cfg: EngineConfig, state, inbox, rows: torch.Tensor,
                  slots: Optional[torch.Tensor] = None,
                  want: Optional[torch.Tensor] = None):
    """Seat a learner in each of ``rows``: in ``slots`` where given (a
    slot that is neither the leader nor a voter of its config), else in
    the group's first slot that is down and no voter.  Returns
    ``(state, inbox, Moved)``."""
    with trace.span("mrt.move.seat"):
        P = cfg.P
        lead, has = leaders(state, rows)
        lat = (rows, lead)
        vo, vn = state.voters_old[lat], state.voters_new[lat]
        member = _lanes(vo | vn, P)
        if slots is None:
            slot, spare = _first(~member & ~state.alive[rows])
            ok = has & spare
        else:
            slot = slots.to(torch.int64)
            ok = has & ~member.gather(1, slot[:, None])[:, 0] & (slot != lead)
        asked = _asked(ok, want)
        ok = ok & asked
        state, inbox = reset_replica(cfg, state, inbox, rows, slot, True, ok)
        at = (rows, slot)
        st = state
        # The learner's config view is its leader's: it is no voter and
        # never campaigns.
        state = st._replace(
            voters_old=_set(st.voters_old, ok, (at, vo)),
            voters_new=_set(st.voters_new, ok, (at, vn)),
            joint=_set(st.joint, ok, (at, st.joint[lat])),
            cfg_epoch=_set(st.cfg_epoch, ok, (at, st.cfg_epoch[lat])),
            cfg_idx=_set(st.cfg_idx, ok, (at, st.cfg_idx[lat])),
        )
        COUNTS.add(0, ok, asked & ~ok)
        return state, inbox, Moved(ok, slot)


def begin_joint(cfg: EngineConfig, state, rows: torch.Tensor,
                new_voters: Optional[torch.Tensor] = None,
                want: Optional[torch.Tensor] = None):
    """Append the C_old,new entry at each row's leader, where it has no
    change in flight (not joint) and log headroom.

    With ``new_voters`` (i32[n] voter bitmasks, not empty and not C_old)
    that is the target.  Without, it is PD's move: C_old
    less the first voter after the leader in slot order (the leader is
    never the one moved) plus the group's learner (its first live slot
    outside the config), where the last config entry has committed and
    the learner is no longer pending: it has acknowledged the leader's
    snapshot (or entries), so the leader's match for it, zeroed when it
    was seated, is above 0.  TiKV counts a peer pending while its match
    is below the leader's truncated index, which trails the applied index
    by its log-GC thresholds; this engine compacts its ring to the commit
    index as soon as it runs short, under full ingest every tick, so the
    snapshot an acknowledgement reports is already below the leader's
    floor when it arrives, and the first acknowledgement is the mark of
    an installed snapshot; the promoted voter stays a snapshot behind
    while the ingest lasts.  Returns
    ``(state, Moved)``, ``slot`` the demoted voter (without
    ``new_voters``)."""
    with trace.span("mrt.move.begin"):
        P, L = cfg.P, cfg.L
        lead, has = leaders(state, rows)
        at = (rows, lead)
        vo = state.voters_old[at]
        log_len, base = state.log_len[at], state.base[at]
        ok = has & ~state.joint[at] & ((L - 2 - cfg.E - log_len) >= 1)
        if new_voters is None:
            voter = _lanes(vo, P)
            learner, has_learner = _first(~_lanes(vo | state.voters_new[at], P) & state.alive[rows])
            order = torch.remainder(lead[:, None] + 1 + torch.arange(P - 1, device=rows.device), P)
            k, has_follower = _first(voter.gather(1, order))
            slot = order.gather(1, k[:, None])[:, 0]
            caught_up = state.match_idx[rows, lead, learner] > 0
            ok = (ok & has_learner & has_follower & caught_up
                  & (state.cfg_idx[at] <= state.commit[at]))
            one = torch.ones_like(vo)
            mask = (vo & ~(one << slot.to(I32))) | (one << learner.to(I32))
        else:
            mask = new_voters.to(I32)
            slot = lead
            ok = ok & (mask != vo) & (mask != 0)
        asked = _asked(ok, want)
        ok = ok & asked
        idx = base + log_len + 1
        st = state
        state = st._replace(
            log_term=_set(st.log_term, ok, ((rows, lead, torch.remainder(idx, L).long()),
                                            st.term[at])),
            log_len=_set(st.log_len, ok, (at, log_len + 1)),
            voters_new=_set(st.voters_new, ok, (at, mask)),
            joint=_set(st.joint, ok, (at, True)),
            cfg_epoch=_set(st.cfg_epoch, ok, (at, st.cfg_epoch[at] + 1)),
            cfg_idx=_set(st.cfg_idx, ok, (at, idx)),
        )
        COUNTS.add(1, ok, asked & ~ok)
        return state, Moved(ok, slot)


def remove_peers(cfg: EngineConfig, state, inbox, rows: torch.Tensor,
                 slots: torch.Tensor, want: Optional[torch.Tensor] = None):
    """Take down ``slots`` (each row's demoted voter), where the leader
    has left the joint config and committed C_new, and the slot is
    neither the leader nor a voter of it.  Returns ``(state, inbox,
    Moved)``."""
    with trace.span("mrt.move.remove"):
        lead, has = leaders(state, rows)
        at = (rows, lead)
        slot = slots.to(torch.int64)
        member = _lanes(state.voters_old[at] | state.voters_new[at], cfg.P)
        ok = (has & ~state.joint[at] & (state.commit[at] >= state.cfg_idx[at])
              & ~member.gather(1, slot[:, None])[:, 0] & (slot != lead))
        asked = _asked(ok, want)
        ok = ok & asked
        state = state._replace(alive=_set(state.alive, ok, ((rows, slot), False)))
        inbox = drop_edges(inbox, rows, slot, ok)
        COUNTS.add(2, ok, asked & ~ok)
        return state, inbox, Moved(ok, slot)
