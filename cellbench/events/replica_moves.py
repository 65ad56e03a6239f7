"""Replica moves by joint consensus, as TiKV's scheduler (PD)
schedules them with ``schedule.enable-joint-consensus`` on: one
ChangePeerV2 operator a group, in three stages a round apart.

Every ``every_ticks`` ticks, round ``r``:

1. removes the demoted peers of the groups whose joint config round
   ``r - 1`` (or earlier) began, where the leader has left the joint
   config and committed C_new;
2. begins the joint config of the groups whose learners were seated in
   round ``r - 1`` (or earlier): the learner promoted, the first voter
   after the leader demoted, once the learner is no longer pending (it
   has acknowledged the leader's snapshot);
3. seats a learner in the dead spare slot of a fresh ``share`` of the
   groups (:class:`cellbench.traffic.Victims`), leaving out any group
   whose move is still in flight, and of the groups a round deferred.

A row that a stage defers (no live leader, no spare, a change in flight,
the learner still pending, no log headroom) carries to the next round at
the same stage; each group takes at most one stage a round, except that
a group drawn in round ``r`` is seated in it.  A move takes no service
away, so :meth:`ReplicaMoves.lost` is None.

:meth:`ReplicaMoves.apply` runs the program's batched moves
(``multiraft_tpu_torch.engine.membership``) over the groups that hold a
stage or are drawn, the first ``HELD`` of them picked by a sort on the
device, each stage on the groups its stage marks, with no host round
trip in the window (the mix holds about 1,200; a group beyond ``HELD``
waits at its stage);
:meth:`ReplicaMoves.apply_reference` is a plain row-by-row
implementation on the reference's state.  The learner's first election
deadline is ``elect_max_ticks`` ticks after it is seated (the
configuration's ``ELECT_MAX``).  At the end of the process the program's
counts of seated, begun, removed and deferred rows, and the groups at
each stage after the last round, go to standard error.
"""

from __future__ import annotations

import atexit
import sys
from types import SimpleNamespace
from typing import NamedTuple, Optional

import numpy as np
import torch

from cellbench import traffic
from multiraft_tpu_torch.engine import membership

IDLE, WANT, SEATED, BEGUN = 0, 1, 2, 3  # a group's stage
LEADER = 2
HELD = 4096  # groups a round runs its stages over


class Carry(NamedTuple):
    stage: torch.Tensor  # int32[groups]
    demoted: torch.Tensor  # int64[groups]: the voter a begun move demotes


class ReplicaMoves:
    def __init__(self, params: dict, G: int, seed: int) -> None:
        self.every = int(params["every_ticks"])
        self.elect_max = int(params["elect_max_ticks"])
        self.victims = traffic.Victims(float(params["share"]), G, seed)
        self._last: Optional[Carry] = None
        self._reported = False

    def rows(self, r: int) -> np.ndarray:
        return self.victims.round(r)

    def lost(self, carry):
        return None

    # -- the program's side --------------------------------------------------

    def apply(self, state, inbox, at, groups, carry: Optional[Carry]):
        G, dev = state.term.shape[0], state.term.device
        if carry is None:
            atexit.register(self.report)
            carry = Carry(torch.zeros(G, dtype=torch.int32, device=dev),
                          torch.zeros(G, dtype=torch.int64, device=dev))
        stage, demoted = carry
        held = (stage != IDLE).index_put((at,), torch.ones_like(at, dtype=torch.bool))
        rows = torch.sort(held.to(torch.int8), descending=True, stable=True).indices[:HELD]
        cfg = SimpleNamespace(P=state.alive.shape[1], L=state.log_term.shape[2],
                              E=inbox.ar_terms.shape[3], ELECT_MAX=self.elect_max)

        def advance(moved, to):
            return stage.index_put((rows,), torch.where(moved.done, to, stage[rows]))

        state, inbox, rm = membership.remove_peers(cfg, state, inbox, rows, demoted[rows],
                                                   want=stage[rows] == BEGUN)
        stage = advance(rm, IDLE)
        state, bj = membership.begin_joint(cfg, state, rows, want=stage[rows] == SEATED)
        demoted = demoted.index_put((rows,), torch.where(bj.done, bj.slot, demoted[rows]))
        stage = advance(bj, BEGUN)
        stage = stage.index_put((at,), torch.where(stage[at] == IDLE, WANT, stage[at]))
        state, inbox, sl = membership.seat_learners(cfg, state, inbox, rows,
                                                    want=stage[rows] == WANT)
        stage = advance(sl, SEATED)
        self._last = Carry(stage, demoted)
        return state, inbox, self._last

    def report(self) -> None:
        """The counts, and the groups at each stage after the last round,
        on standard error (one synchronise)."""
        if self._reported or self._last is None:
            return
        self._reported = True
        stages = torch.bincount(self._last.stage, minlength=4).tolist()
        log = lambda m: print(f"cellbench.events.replica_moves: {m}", file=sys.stderr, flush=True)
        log(f"counts {membership.COUNTS.read()}")
        log(f"groups idle/wanting a learner/seated/in joint or awaiting removal after the last "
            f"round: {stages[IDLE]}/{stages[WANT]}/{stages[SEATED]}/{stages[BEGUN]}")

    # -- the reference's side ------------------------------------------------

    def apply_reference(self, state, inbox, at, groups, carry: Optional[Carry]):
        """The same round on the reference's state, row by row: ``at``
        are the round's sampled groups' positions among its rows."""
        n, P = state.alive.shape
        L, E = state.log_term.shape[2], inbox.ar_terms.shape[3]
        if carry is None:
            carry = Carry(torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int64))
        stage, demoted = carry.stage.clone(), carry.demoted.clone()
        st = state._replace(**{f: getattr(state, f).clone() for f in state._fields})
        mb = inbox._replace(**{f: getattr(inbox, f).clone() for f in inbox._fields})

        def leader(i):
            best, who = -1, None
            for p in range(P):
                if int(st.role[i, p]) == LEADER and bool(st.alive[i, p]) and int(st.term[i, p]) > best:
                    best, who = int(st.term[i, p]), p
            return who

        def members(i, p):
            bits = int(st.voters_old[i, p]) | int(st.voters_new[i, p])
            return [q for q in range(P) if (bits >> q) & 1]

        def drop_edges(i, q):
            for f in mb._fields:
                if f.endswith("_active"):
                    getattr(mb, f)[i, q, :] = False
                    getattr(mb, f)[i, :, q] = False

        for i in range(n):  # 1. remove the demoted peers
            lead = leader(i)
            q = int(demoted[i])
            if int(stage[i]) != BEGUN or lead is None or q == lead or q in members(i, lead) \
                    or bool(st.joint[i, lead]) or int(st.commit[i, lead]) < int(st.cfg_idx[i, lead]):
                continue
            st.alive[i, q] = False
            drop_edges(i, q)
            stage[i] = IDLE
        for i in range(n):  # 2. begin the joint configs
            lead = leader(i)
            if int(stage[i]) != SEATED or lead is None:
                continue
            vo = int(st.voters_old[i, lead])
            learners = [q for q in range(P) if q not in members(i, lead) and bool(st.alive[i, q])]
            followers = [q for q in ((lead + d) % P for d in range(1, P)) if (vo >> q) & 1]
            log_len, base = int(st.log_len[i, lead]), int(st.base[i, lead])
            if not learners or not followers or bool(st.joint[i, lead]) \
                    or int(st.cfg_idx[i, lead]) > int(st.commit[i, lead]) \
                    or L - 2 - E - log_len < 1 or int(st.match_idx[i, lead, learners[0]]) == 0:
                continue
            idx = base + log_len + 1
            st.log_term[i, lead, idx % L] = st.term[i, lead]
            st.log_len[i, lead] = log_len + 1
            st.voters_new[i, lead] = (vo & ~(1 << followers[0])) | (1 << learners[0])
            st.joint[i, lead] = True
            st.cfg_epoch[i, lead] += 1
            st.cfg_idx[i, lead] = idx
            demoted[i] = followers[0]
            stage[i] = BEGUN
        for i in at.tolist():  # 3. this round's groups want a learner
            if int(stage[i]) == IDLE:
                stage[i] = WANT
        now = int(st.tick_no)
        for i in range(n):  # 4. seat the learners
            lead = leader(i)
            if int(stage[i]) != WANT or lead is None:
                continue
            spares = [q for q in range(P) if q not in members(i, lead) and not bool(st.alive[i, q])]
            if not spares:
                continue
            q = spares[0]
            for f, v in (("term", 0), ("voted_for", -1), ("role", 0), ("commit", 0),
                         ("applied", 0), ("base", 0), ("base_term", 0), ("log_len", 0),
                         ("hb_due", 0), ("last_heard", now), ("elect_dl", now + self.elect_max)):
                getattr(st, f)[i, q] = v
            st.log_term[i, q, :] = 0
            for f, row, col in (("next_idx", 1, 1), ("votes", False, False),
                                ("pre_votes", False, False), ("match_idx", 0, 0),
                                ("last_ack", 0, now)):
                getattr(st, f)[i, q, :] = row
                getattr(st, f)[i, :, q] = col
            for f in ("voters_old", "voters_new", "joint", "cfg_epoch", "cfg_idx"):
                getattr(st, f)[i, q] = getattr(st, f)[i, lead]
            st.alive[i, q] = True
            drop_edges(i, q)
            stage[i] = SEATED
        return st, mb, Carry(stage, demoted)


def plan(params: dict, G: int, seed: int) -> ReplicaMoves:
    return ReplicaMoves(params, G, seed)
