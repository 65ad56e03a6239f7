"""The batched Raft tick with the joint-consensus path, plain: the tick of
:mod:`.tick` with what ``multiraft_tpu_torch/engine/core.py:tick_impl``
does when ``membership`` is on and its kernels are off, as that file
stands after commit 40f6957.

The joint path, phase by phase:

* 2: a prevote round promotes, and a candidate wins, only on a majority
  of C_old's voters and one of C_new's; a leader elected while a config
  change is pending (joint, or its last config entry above its commit)
  appends a no-op at its term, where its log has room;
* 3: a follower whose log covers the winning message's config entry
  (or that took the message's snapshot) adopts the sender's config view;
* 4: the commit index is the smaller of the two masked quorum indices,
  under the current-term guard; 4b check-quorum the same over acks;
* 4c: a leader that is no voter of its config, out of the joint phase
  with its last config entry committed, steps down at its term;
* 5: a replica outside both voter sets (a learner, a removed peer)
  never campaigns;
* 5a-bis: a joint leader whose joint entry has committed appends the
  C_new exit entry, where its log has room, before ingest;
* 5c: every append message carries the sender's config view.

What differs from the program, and why:

* The masked quorum index is the ``need``-th largest voter lane, read
  from a sort, where the program runs a compare-swap network and picks
  a column; both are the same order statistic.
* ``commit_quorum``, when set, is the ``need`` of both commit quorums
  (C_old's and C_new's) in place of their majorities, so that a control
  can break the commit rule alone.
* :func:`init_state` seeds ``replicas`` as the program's ``EngineConfig``
  does: slots ``0..replicas-1`` are every group's voters, the others
  dead spares.
* What :mod:`.tick` leaves out (the uniform-suffix choice of the outgoing
  entry terms, which only changes lanes no receiver reads) is left out.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import torch

from . import prng
from .tick import (
    CANDIDATE, FOLLOWER, I32, LEADER, RECORD_KEYS, State, _ar,
    _last_index, _ring_read, _ring_write, _step_down, _term_at, _vT, counters,
)
from .tick import init_state as _plain_init_state

__all__ = ["Config", "config", "State", "Mailbox", "init_state", "empty_mailbox",
           "tick", "RECORD_KEYS"]


@dataclasses.dataclass(frozen=True)
class Config:
    G: int  # rows held (all groups, or the replayed sample)
    P: int
    L: int
    E: int
    INGEST: int
    HB_TICKS: int
    ELECT_MIN: int
    ELECT_MAX: int
    prevote: bool
    check_quorum: bool
    replicas: int = 0  # 0: all P
    commit_quorum: int = 0  # 0: a majority of each voter set

    @property
    def full_voters(self) -> int:
        return (1 << self.P) - 1

    @property
    def voters(self) -> int:
        return (1 << (self.replicas or self.P)) - 1


def config(conf: dict, G: int, commit_quorum: int = 0) -> Config:
    """The :class:`Config` of a configuration file, with ``G`` the rows
    held.  Refuses one whose program does not take the joint path:
    ``membership`` off, or the kernels on."""
    if not conf["membership"] or conf["use_kernels"]:
        raise ValueError("the joint reference replays membership on, kernels off")
    names = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in conf.items() if k in names}
    return Config(**dict(kw, G=G, commit_quorum=commit_quorum))


class Mailbox(NamedTuple):
    vr_active: torch.Tensor
    vr_term: torch.Tensor
    vr_last_idx: torch.Tensor
    vr_last_term: torch.Tensor
    vr_pre: torch.Tensor
    vp_active: torch.Tensor
    vp_term: torch.Tensor
    vp_granted: torch.Tensor
    vp_pre: torch.Tensor
    ar_active: torch.Tensor
    ar_term: torch.Tensor
    ar_prev_idx: torch.Tensor
    ar_prev_term: torch.Tensor
    ar_n: torch.Tensor
    ar_terms: torch.Tensor
    ar_commit: torch.Tensor
    ar_snap: torch.Tensor
    ap_active: torch.Tensor
    ap_term: torch.Tensor
    ap_success: torch.Tensor
    ap_match: torch.Tensor
    ap_conflict: torch.Tensor
    ar_cfg_epoch: torch.Tensor
    ar_cfg_idx: torch.Tensor
    ar_cfg_old: torch.Tensor
    ar_cfg_new: torch.Tensor
    ar_cfg_joint: torch.Tensor


_BOOL_LANES = frozenset({
    "vr_active", "vr_pre", "vp_active", "vp_granted", "vp_pre",
    "ar_active", "ar_snap", "ap_active", "ap_success", "ar_cfg_joint",
})


def init_state(cfg: Config, k: prng.Key, rows: torch.Tensor) -> State:
    st = _plain_init_state(cfg, k, rows)
    spare = _ar(cfg.P, rows.device) >= (cfg.replicas or cfg.P)
    return st._replace(
        voters_old=torch.full_like(st.voters_old, cfg.voters),
        voters_new=torch.full_like(st.voters_new, cfg.voters),
        alive=st.alive & ~spare,
    )


def empty_mailbox(cfg: Config, device) -> Mailbox:
    G, P, E = cfg.G, cfg.P, cfg.E
    return Mailbox(**{
        name: torch.zeros((G, P, P, E) if name == "ar_terms" else (G, P, P),
                          dtype=torch.bool if name in _BOOL_LANES else I32,
                          device=device)
        for name in Mailbox._fields
    })


def lanes(bits: torch.Tensor, P: int) -> torch.Tensor:
    """Voter bitmask [...] -> bool lanes [..., P]."""
    return torch.stack([(bits >> q) & 1 == 1 for q in range(P)], dim=-1)


def majority(bits: torch.Tensor, P: int) -> torch.Tensor:
    return lanes(bits, P).sum(-1, dtype=I32) // 2 + 1


def quorum_met(grants: torch.Tensor, bits: torch.Tensor, P: int) -> torch.Tensor:
    """Do ``grants`` [..., P] hold a majority of ``bits``' voters?"""
    return (grants & lanes(bits, P)).sum(-1, dtype=I32) >= majority(bits, P)


def quorum_index(vals: torch.Tensor, bits: torch.Tensor, P: int,
                 need: torch.Tensor) -> torch.Tensor:
    """The ``need``-th largest of ``vals`` [..., P] over ``bits``' voter
    lanes, the others counting as -1: the largest v that ``need`` voters
    reach."""
    masked = torch.where(lanes(bits, P), vals, -1)
    desc = torch.sort(masked, dim=-1, descending=True).values
    return desc.gather(-1, (need - 1).clamp(0, P - 1).long()[..., None])[..., 0]


def joint_index(vals: torch.Tensor, state: State, P: int, q: int = 0) -> torch.Tensor:
    """The smaller of C_old's and C_new's quorum indices (``q``: the
    count both take in place of their majorities)."""
    def one(bits):
        need = majority(bits, P)
        return quorum_index(vals, bits, P, torch.full_like(need, q) if q else need)

    return torch.minimum(one(state.voters_old), one(state.voters_new))


def _append_one(state: State, at: torch.Tensor, L: int) -> State:
    """Append one entry at the replica's term where ``at``."""
    slot = torch.remainder(_ar(L, at.device) - (_last_index(state) + 1)[..., None], L) == 0
    return state._replace(
        log_term=torch.where(slot & at[..., None], state.term[..., None], state.log_term),
        log_len=state.log_len + at.to(I32),
    )


def tick(
    cfg: Config,
    state: State,
    inbox: Mailbox,
    new_cmds: torch.Tensor,  # i32[G]
    k: prng.Key,
    rows: torch.Tensor,  # global group index of each row
) -> Tuple[State, Mailbox, Dict[str, torch.Tensor]]:
    G, P, L, E = cfg.G, cfg.P, cfg.L, cfg.E
    dev = state.term.device
    out: Dict[str, torch.Tensor] = {}
    now = state.tick_no + 1
    pi = _ar(P, dev)[None, :]
    own = pi[None] == pi[..., None]

    jitter = prng.randint(prng.fold_in(k, 7), counters(rows, P),
                          cfg.ELECT_MIN, cfg.ELECT_MAX)

    # 1. vote requests
    arrived = _vT(inbox.vr_active) & state.alive[:, :, None]
    is_pre = _vT(inbox.vr_pre)
    active = arrived & ~is_pre
    m_term = _vT(inbox.vr_term)
    higher_lane = active & (m_term > state.term[..., None])
    adopt = torch.where(higher_lane, m_term, -1).amax(dim=2)
    state = _step_down(cfg, state, higher_lane.any(dim=2), adopt)
    last_idx = _last_index(state)
    last_term = _term_at(cfg, state, last_idx)
    in_last_term = _vT(inbox.vr_last_term)
    up_to_date = (in_last_term > last_term[..., None]) | (
        (in_last_term == last_term[..., None])
        & (_vT(inbox.vr_last_idx) >= last_idx[..., None])
    )
    eligible = active & (m_term == state.term[..., None]) & up_to_date
    cand_ids = _ar(P, dev)
    bound = state.voted_for != -1
    cand_ok = eligible & torch.where(
        bound[..., None], cand_ids == state.voted_for[..., None], True
    )
    winner = torch.where(cand_ok, cand_ids, P).amin(dim=2)
    grant = cand_ok & (cand_ids == winner[..., None])
    grant_any = winner < P
    state = state._replace(
        voted_for=torch.where(grant_any, winner, state.voted_for),
        elect_dl=torch.where(grant_any, now + jitter, state.elect_dl),
        last_heard=torch.where(grant_any, now, state.last_heard),
    )
    if cfg.prevote:
        pre_act = arrived & is_pre
        lease_expired = (now - state.last_heard) >= cfg.ELECT_MIN
        grant_pre = (
            pre_act
            & (state.role != LEADER)[..., None]
            & (m_term > state.term[..., None])
            & lease_expired[..., None]
            & up_to_date
        )
    else:
        pre_act = torch.zeros_like(active)
        grant_pre = pre_act
    out["vp_active"] = active | pre_act
    out["vp_pre"] = pre_act
    out["vp_term"] = torch.where(pre_act & grant_pre, m_term, state.term[..., None])
    out["vp_granted"] = torch.where(pre_act, grant_pre, grant)

    # 2. vote replies -> tally (both voter sets) -> leadership
    arrived = _vT(inbox.vp_active) & state.alive[:, :, None]
    reply_pre = _vT(inbox.vp_pre)
    active = arrived & ~reply_pre
    m_term = _vT(inbox.vp_term)
    granted = _vT(inbox.vp_granted)
    higher_lane = active & (m_term > state.term[..., None])
    if cfg.prevote:
        higher_lane = higher_lane | (
            arrived & reply_pre & ~granted & (m_term > state.term[..., None])
        )
    adopt = torch.where(higher_lane, m_term, -1).amax(dim=2)
    state = _step_down(cfg, state, higher_lane.any(dim=2), adopt)
    good = (
        active
        & (state.role == CANDIDATE)[..., None]
        & (m_term == state.term[..., None])
        & granted
    )
    state = state._replace(votes=state.votes | good)
    if cfg.prevote:
        good_pre = (
            arrived & reply_pre & (m_term == state.term[..., None] + 1) & granted
        )
        state = state._replace(pre_votes=state.pre_votes | good_pre)
        promote = (
            state.alive & (state.role != LEADER)
            & quorum_met(state.pre_votes, state.voters_old, P)
            & quorum_met(state.pre_votes, state.voters_new, P)
        )
        state = state._replace(
            term=torch.where(promote, state.term + 1, state.term),
            role=torch.where(promote, CANDIDATE, state.role),
            voted_for=torch.where(promote, pi, state.voted_for),
            votes=torch.where(promote[..., None], own, state.votes),
            pre_votes=torch.where(promote[..., None], False, state.pre_votes),
            elect_dl=torch.where(promote, now + jitter, state.elect_dl),
        )
    else:
        promote = None
    become_leader = (
        (state.role == CANDIDATE) & state.alive
        & quorum_met(state.votes, state.voters_old, P)
        & quorum_met(state.votes, state.voters_new, P)
    )
    pending = state.joint | (state.cfg_idx > state.commit)
    state = _append_one(
        state, become_leader & pending & ((L - 2 - E - state.log_len) >= 1), L)
    last_idx = _last_index(state)
    state = state._replace(
        role=torch.where(become_leader, LEADER, state.role),
        next_idx=torch.where(
            become_leader[..., None], (last_idx + 1)[..., None], state.next_idx
        ),
        match_idx=torch.where(
            become_leader[..., None],
            torch.where(own, last_idx[..., None], 0),
            state.match_idx,
        ),
        hb_due=torch.where(become_leader, now, state.hb_due),
    )
    if cfg.check_quorum:
        state = state._replace(
            last_ack=torch.where(become_leader[..., None], now, state.last_ack)
        )

    # 3. append requests: the max-term message per dst wins
    act_in = _vT(inbox.ar_active) & state.alive[:, :, None]
    term_key = torch.where(act_in, _vT(inbox.ar_term), -1)
    max_term_in = term_key.amax(dim=2)
    is_max = act_in & (term_key == max_term_in[..., None])
    src_ids = _ar(P, dev)
    win_src = torch.where(is_max, src_ids, P).amin(dim=2)
    sel = src_ids == win_src[..., None]
    active = win_src < P
    src_at = win_src.clamp(max=P - 1).long()[:, None, :]

    def pick(x: torch.Tensor) -> torch.Tensor:
        v = x.gather(1, src_at)[:, 0]
        return torch.where(active, v, False if v.dtype == torch.bool else 0)

    m_term = pick(inbox.ar_term)
    stale = active & (m_term < state.term)
    ok = active & ~stale
    higher = ok & (m_term > state.term)
    state = state._replace(
        term=torch.where(higher, m_term, state.term),
        voted_for=torch.where(higher, -1, state.voted_for),
        role=torch.where(ok, FOLLOWER, state.role),
        elect_dl=torch.where(ok, now + jitter, state.elect_dl),
        last_heard=torch.where(ok, now, state.last_heard),
    )
    if cfg.prevote:
        state = state._replace(
            pre_votes=torch.where(ok[..., None], False, state.pre_votes)
        )

    prev = pick(inbox.ar_prev_idx)
    prev_t = pick(inbox.ar_prev_term)
    n_ent = pick(inbox.ar_n)
    snap = pick(inbox.ar_snap)

    do_snap = ok & snap & (prev > state.commit)
    state = state._replace(
        base=torch.where(do_snap, prev, state.base),
        base_term=torch.where(do_snap, prev_t, state.base_term),
        log_len=torch.where(do_snap, 0, state.log_len),
        commit=torch.where(do_snap, prev, state.commit),
        applied=torch.where(do_snap, prev, state.applied),
    )
    snap_handled = ok & snap

    last = _last_index(state)
    apn = ok & ~snap
    in_window = (prev >= state.base) & (prev <= last)
    match = apn & in_window & (_term_at(cfg, state, prev) == prev_t)

    ei = _ar(E, dev)
    idx = prev[..., None] + 1 + ei
    in_msg = match[..., None] & (ei < n_ent[..., None])
    incoming = inbox.ar_terms.gather(1, src_at[..., None].expand(G, 1, P, E))[:, 0]
    incoming = torch.where(active[..., None], incoming, 0)
    exists = idx <= last[..., None]
    overlap = in_msg & exists
    conflict_any = (
        overlap & (_ring_read(state.log_term, idx, L) != incoming)
    ).any(dim=-1)
    log = _ring_write(
        state.log_term, prev + 1, incoming, torch.where(match, n_ent, 0), L
    )
    state = state._replace(log_term=log)
    msg_last = prev + n_ent
    new_last = torch.where(
        match,
        torch.where(conflict_any, msg_last, torch.maximum(last, msg_last)),
        last,
    )
    state = state._replace(log_len=new_last - state.base)
    new_commit = torch.minimum(pick(inbox.ar_commit), msg_last)
    state = state._replace(
        commit=torch.where(match & (new_commit > state.commit), new_commit,
                           state.commit)
    )
    # The sender's config view, where this replica's log covers its entry.
    m_cfg_idx = pick(inbox.ar_cfg_idx)
    take = (match & (m_cfg_idx <= msg_last)) | do_snap
    state = state._replace(
        voters_old=torch.where(take, pick(inbox.ar_cfg_old), state.voters_old),
        voters_new=torch.where(take, pick(inbox.ar_cfg_new), state.voters_new),
        joint=torch.where(take, pick(inbox.ar_cfg_joint), state.joint),
        cfg_epoch=torch.where(take, pick(inbox.ar_cfg_epoch), state.cfg_epoch),
        cfg_idx=torch.where(take, m_cfg_idx, state.cfg_idx),
    )

    prev_all = _vT(inbox.ar_prev_idx)
    msg_last_all = prev_all + _vT(inbox.ar_n)
    success = match | snap_handled
    reply_match_w = torch.where(snap_handled, prev, msg_last)
    out["ap_active"] = act_in
    out["ap_term"] = state.term[..., None].expand(G, P, P)
    out["ap_success"] = sel & success[..., None]
    out["ap_match"] = torch.where(sel, reply_match_w[..., None], msg_last_all)
    out["ap_conflict"] = torch.minimum(prev_all, state.commit[..., None] + 1)

    # 4. append replies + the joint quorum commit
    active = _vT(inbox.ap_active) & state.alive[:, :, None]
    m_term = _vT(inbox.ap_term)
    higher_lane = active & (m_term > state.term[..., None])
    adopt = torch.where(higher_lane, m_term, -1).amax(dim=2)
    state = _step_down(cfg, state, higher_lane.any(dim=2), adopt)
    good = active & (state.role == LEADER)[..., None] & (m_term == state.term[..., None])
    if cfg.check_quorum:
        state = state._replace(last_ack=torch.where(good, now, state.last_ack))
    ap_success = _vT(inbox.ap_success)
    succ = good & ap_success
    fail = good & ~ap_success
    new_match = torch.maximum(state.match_idx, _vT(inbox.ap_match))
    state = state._replace(
        match_idx=torch.where(succ, new_match, state.match_idx),
        next_idx=torch.where(
            succ,
            torch.maximum(state.next_idx, new_match + 1),
            torch.where(
                fail,
                torch.maximum(_vT(inbox.ap_conflict).clamp(min=1),
                              state.match_idx + 1),
                state.next_idx,
            ),
        ),
    )

    last_idx = _last_index(state)
    is_leader = (state.role == LEADER) & state.alive
    eff_match = torch.where(own, last_idx[..., None], state.match_idx)
    q = joint_index(eff_match, state, P, cfg.commit_quorum)
    ok_commit = is_leader & (_term_at(cfg, state, q) == state.term)
    state = state._replace(
        commit=torch.where(ok_commit, torch.maximum(state.commit, q), state.commit))

    # 4b. check-quorum over both voter sets
    if cfg.check_quorum:
        eff_ack = torch.where(own, now, state.last_ack)
        q_heard = joint_index(eff_ack, state, P)
        demote = (state.role == LEADER) & state.alive & ((now - q_heard) >= cfg.ELECT_MAX)
        state = _step_down(cfg, state, demote, state.term, clear_vote=False)
        state = state._replace(
            elect_dl=torch.where(demote, now + jitter, state.elect_dl)
        )

    # 4c. a leader that the committed config left out steps down
    member = ((state.voters_old | state.voters_new) >> pi) & 1 == 1
    removed = (
        (state.role == LEADER) & state.alive & ~state.joint & ~member
        & (state.commit >= state.cfg_idx)
    )
    state = _step_down(cfg, state, removed, state.term, clear_vote=False)
    state = state._replace(elect_dl=torch.where(removed, now + jitter, state.elect_dl))

    # 5. timers: elections, members only
    timeout = state.alive & (now >= state.elect_dl) & (state.role != LEADER) & member
    if not cfg.prevote:
        state = state._replace(
            term=torch.where(timeout, state.term + 1, state.term),
            role=torch.where(timeout, CANDIDATE, state.role),
            voted_for=torch.where(timeout, pi, state.voted_for),
            votes=torch.where(timeout[..., None], own, state.votes),
            elect_dl=torch.where(timeout, now + jitter, state.elect_dl),
        )
        send_real = timeout
        send_pre = torch.zeros_like(timeout)
    else:
        state = state._replace(
            pre_votes=torch.where(timeout[..., None], own, state.pre_votes),
            elect_dl=torch.where(timeout, now + jitter, state.elect_dl),
        )
        send_real = promote & (state.role == CANDIDATE)
        send_pre = timeout
    last_idx = _last_index(state)
    last_term = _term_at(cfg, state, last_idx)
    sending = send_real | send_pre
    vr_act = sending[:, :, None] & ~own & state.alive[:, :, None]
    vr_term_per = torch.where(send_pre, state.term + 1, state.term)
    out["vr_active"] = vr_act
    out["vr_term"] = vr_term_per[:, :, None].expand(G, P, P)
    out["vr_last_idx"] = last_idx[:, :, None].expand(G, P, P)
    out["vr_last_term"] = last_term[:, :, None].expand(G, P, P)
    out["vr_pre"] = send_pre[:, :, None] & vr_act

    # 5a-bis. a joint leader whose joint entry committed appends C_new
    can_exit = (
        (state.role == LEADER) & state.alive & state.joint
        & (state.commit >= state.cfg_idx) & ((L - 2 - E - state.log_len) >= 1)
    )
    exit_idx = _last_index(state) + 1
    state = _append_one(state, can_exit, L)
    state = state._replace(
        voters_old=torch.where(can_exit, state.voters_new, state.voters_old),
        joint=state.joint & ~can_exit,
        cfg_epoch=state.cfg_epoch + can_exit.to(I32),
        cfg_idx=torch.where(can_exit, exit_idx, state.cfg_idx),
    )

    # 5b. Start() ingestion: the max-term alive leader appends
    is_leader = (state.role == LEADER) & state.alive
    group_max_term = torch.where(state.alive, state.term, -1).amax(dim=1, keepdim=True)
    is_leader = is_leader & (state.term == group_max_term)
    capacity = (L - 2 - cfg.E - state.log_len).clamp(min=0)
    want = new_cmds[:, None].clamp(max=cfg.INGEST)
    accept = torch.where(is_leader, torch.minimum(want, capacity), 0)
    last_idx = _last_index(state)
    e_l = torch.remainder(_ar(L, dev) - (last_idx[..., None] + 1), L)
    hit = e_l < accept[..., None]
    state = state._replace(
        log_term=torch.where(hit, state.term[..., None], state.log_term),
        log_len=state.log_len + accept,
    )
    accepted_per_group = accept.sum(dim=1, dtype=I32)
    start_index = torch.where(accept > 0, last_idx, 0).sum(dim=1, dtype=I32)

    # 5c. append sends: heartbeat + lag repair, with the config view
    last_idx = _last_index(state)
    is_leader = (state.role == LEADER) & state.alive
    hb_fire = is_leader & (now >= state.hb_due)
    lag = state.next_idx <= last_idx[:, :, None]
    send = (hb_fire[:, :, None] | (is_leader[:, :, None] & lag)) & ~own
    send = send & state.alive[:, :, None]
    prev = state.next_idx - 1
    need_snap = prev < state.base[:, :, None]
    prev = torch.where(need_snap, state.base[:, :, None], prev)
    prev_term = _ring_read(state.log_term, prev, L)
    prev_term = torch.where(
        prev == state.base[:, :, None], state.base_term[:, :, None], prev_term
    )
    n_send = torch.where(need_snap, 0, (last_idx[:, :, None] - prev).clamp(0, E))
    send_idx = prev[..., None] + 1 + ei
    t_full = _ring_read(state.log_term, send_idx.reshape(G, P, P * E), L).reshape(G, P, P, E)
    out["ar_active"] = send
    out["ar_term"] = state.term[:, :, None].expand(G, P, P)
    out["ar_prev_idx"] = prev
    out["ar_prev_term"] = prev_term
    out["ar_n"] = n_send
    out["ar_terms"] = torch.where(ei < n_send[..., None], t_full, 0)
    out["ar_commit"] = state.commit[:, :, None].expand(G, P, P)
    out["ar_snap"] = need_snap & send
    for lane, plane in (("ar_cfg_epoch", state.cfg_epoch), ("ar_cfg_idx", state.cfg_idx),
                        ("ar_cfg_old", state.voters_old), ("ar_cfg_new", state.voters_new),
                        ("ar_cfg_joint", state.joint)):
        out[lane] = plane[:, :, None].expand(G, P, P)
    state = state._replace(
        hb_due=torch.where(hb_fire, now + cfg.HB_TICKS, state.hb_due),
        next_idx=torch.where(send, state.next_idx + n_send, state.next_idx),
    )

    # 6. apply frontier + ring compaction
    state = state._replace(applied=torch.maximum(state.applied, state.commit))
    need = (L - state.log_len) < (cfg.E + cfg.INGEST + 2)
    target = torch.minimum(state.applied, _last_index(state))
    new_base = torch.where(need, torch.maximum(state.base, target), state.base)
    state = state._replace(
        log_len=_last_index(state) - new_base,
        base=new_base,
        base_term=_term_at(cfg, state, new_base),
        tick_no=now,
    )
    rec = {
        "ing_hi": start_index + accepted_per_group,
        "accepted": accepted_per_group,
        "accept_term": torch.where(accept > 0, state.term, 0).sum(dim=1, dtype=I32),
        "commit": state.commit.amax(dim=1),
    }
    return state, Mailbox(**out), rec
