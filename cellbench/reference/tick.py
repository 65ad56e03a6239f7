"""The batched Raft tick, plain: a frozen copy of the plain path of
``multiraft_tpu_torch/engine/core.py:tick_impl`` at commit 73b8d79.

What differs from the program, and why:

* The vote tally and the quorum commit are the plain formulas, never a
  kernel; ``commit_quorum`` may be set apart from the vote quorum so
  that a control can break the commit rule alone.
* Every random draw is taken at the rows' own counters (``rows[g] * P
  + p``), so a replay of a subset of groups draws exactly what the whole
  ``[G, P]`` draw gives those groups.  Groups share nothing else: the
  one whole-batch flag of the program (the uniform-suffix choice of the
  outgoing entry terms) only changes lanes that no receiver reads, and
  is left out.
* The joint-consensus membership path is left out: the program takes it
  only without its kernels, and :func:`config` refuses a configuration
  that would take it.  The config lanes of the mailbox go with it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import torch

from . import prng

FOLLOWER, CANDIDATE, LEADER = 0, 1, 2
I32 = torch.int32
RECORD_KEYS = ("ing_hi", "accepted", "accept_term", "commit")


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
    commit_quorum: int = 0  # 0: a majority of P

    @property
    def quorum(self) -> int:
        return self.P // 2 + 1

    @property
    def q_commit(self) -> int:
        return self.commit_quorum or self.quorum

    @property
    def full_voters(self) -> int:
        return (1 << self.P) - 1


def config(conf: dict, G: int, commit_quorum: int = 0) -> Config:
    """The :class:`Config` of a configuration file: every key that names
    one of its fields, with ``G`` the rows held.  Refuses what this tick
    cannot replay: the program's joint-consensus path, which it takes with
    ``membership`` on and its kernels off."""
    if conf["membership"] and not conf["use_kernels"]:
        raise NotImplementedError("the reference has no joint-consensus path")
    names = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in conf.items() if k in names}
    return Config(**dict(kw, G=G, commit_quorum=commit_quorum))


class State(NamedTuple):
    tick_no: torch.Tensor
    term: torch.Tensor
    voted_for: torch.Tensor
    role: torch.Tensor
    commit: torch.Tensor
    applied: torch.Tensor
    base: torch.Tensor
    base_term: torch.Tensor
    log_len: torch.Tensor
    log_term: torch.Tensor
    next_idx: torch.Tensor
    match_idx: torch.Tensor
    votes: torch.Tensor
    elect_dl: torch.Tensor
    hb_due: torch.Tensor
    alive: torch.Tensor
    pre_votes: torch.Tensor
    last_heard: torch.Tensor
    last_ack: torch.Tensor
    voters_old: torch.Tensor
    voters_new: torch.Tensor
    joint: torch.Tensor
    cfg_epoch: torch.Tensor
    cfg_idx: torch.Tensor


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


_BOOL_LANES = frozenset({
    "vr_active", "vr_pre", "vp_active", "vp_granted", "vp_pre",
    "ar_active", "ar_snap", "ap_active", "ap_success",
})


def _ar(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=device)


def counters(rows: torch.Tensor, P: int) -> torch.Tensor:
    """Flat counters ``[len(rows), P]`` of the rows' replicas."""
    return rows.to(torch.int64)[:, None] * P + torch.arange(
        P, dtype=torch.int64, device=rows.device)


def init_state(cfg: Config, k: prng.Key, rows: torch.Tensor) -> State:
    G, P, L = cfg.G, cfg.P, cfg.L
    dev = rows.device
    z = lambda *s: torch.zeros(s, dtype=I32, device=dev)
    full = lambda v, *s: torch.full(s, v, dtype=I32, device=dev)
    return State(
        tick_no=torch.zeros((), dtype=I32, device=dev),
        term=z(G, P), voted_for=full(-1, G, P), role=z(G, P), commit=z(G, P),
        applied=z(G, P), base=z(G, P), base_term=z(G, P), log_len=z(G, P),
        log_term=z(G, P, L), next_idx=full(1, G, P, P), match_idx=z(G, P, P),
        votes=torch.zeros((G, P, P), dtype=torch.bool, device=dev),
        elect_dl=prng.randint(k, counters(rows, P), cfg.ELECT_MIN, cfg.ELECT_MAX),
        hb_due=z(G, P),
        alive=torch.ones((G, P), dtype=torch.bool, device=dev),
        pre_votes=torch.zeros((G, P, P), dtype=torch.bool, device=dev),
        last_heard=z(G, P), last_ack=z(G, P, P),
        voters_old=full(cfg.full_voters, G, P),
        voters_new=full(cfg.full_voters, G, P),
        joint=torch.zeros((G, P), dtype=torch.bool, device=dev),
        cfg_epoch=z(G, P), cfg_idx=z(G, P),
    )


def empty_mailbox(cfg: Config, device) -> Mailbox:
    G, P, E = cfg.G, cfg.P, cfg.E
    return Mailbox(**{
        name: torch.zeros((G, P, P, E) if name == "ar_terms" else (G, P, P),
                          dtype=torch.bool if name in _BOOL_LANES else I32,
                          device=device)
        for name in Mailbox._fields
    })


def _ring_read(log: torch.Tensor, idx: torch.Tensor, L: int) -> torch.Tensor:
    return torch.gather(log, -1, torch.remainder(idx, L).long())


def _ring_write(log, start, vals, n, L):
    E = vals.shape[-1]
    e_l = torch.remainder(_ar(L, log.device) - start[..., None], L)
    hit = e_l < n[..., None]
    v = torch.gather(vals, -1, e_l.clamp(max=E - 1).long())
    v = torch.where(e_l < E, v, 0)
    return torch.where(hit, v, log)


def _kth_smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    cols = [x[..., i] for i in range(x.shape[-1])]
    n = len(cols)
    for i in range(n):
        for j in range(n - 1 - i):
            a, b = cols[j], cols[j + 1]
            cols[j], cols[j + 1] = torch.minimum(a, b), torch.maximum(a, b)
    return cols[k]


def _term_at(cfg: Config, state: State, idx: torch.Tensor) -> torch.Tensor:
    gathered = _ring_read(state.log_term, idx[..., None], cfg.L)[..., 0]
    return torch.where(idx == state.base, state.base_term, gathered)


def _last_index(state: State) -> torch.Tensor:
    return state.base + state.log_len


def _step_down(cfg, state, higher, m_term, clear_vote=True):
    kw = dict(
        term=torch.where(higher, m_term, state.term),
        role=torch.where(higher, FOLLOWER, state.role),
    )
    if clear_vote:
        kw["voted_for"] = torch.where(higher, -1, state.voted_for)
    if cfg.prevote:
        kw["pre_votes"] = torch.where(higher[..., None], False, state.pre_votes)
    return state._replace(**kw)


def _vT(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2)


def quorum_commit(eff_match, term, commit, base, base_term, log_term,
                  is_leader, quorum):
    """New commit per replica: the quorum-th largest match under the
    current-term guard (the commit kernel's counting identity)."""
    L = log_term.shape[-1]
    ge = eff_match[..., :, None] >= eff_match[..., None, :]
    eligible = ge.sum(dim=-2) >= quorum
    q = torch.where(eligible, eff_match, 0).amax(dim=-1)
    ring = torch.gather(log_term, -1, torch.remainder(q, L).long()[..., None])
    q_term = torch.where(q == base, base_term, ring[..., 0])
    ok = is_leader & (q_term == term) & (q > commit)
    return torch.where(ok, q, commit)


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
    commit_before = state.commit
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

    # 2. vote replies -> tally -> leadership
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
        n_pre = state.pre_votes.sum(-1, dtype=I32)
        promote = state.alive & (state.role != LEADER) & (n_pre >= cfg.quorum)
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
    n_votes = state.votes.sum(-1, dtype=I32)
    become_leader = (
        (state.role == CANDIDATE) & state.alive & (n_votes >= cfg.quorum)
    )
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

    prev_all = _vT(inbox.ar_prev_idx)
    msg_last_all = prev_all + _vT(inbox.ar_n)
    success = match | snap_handled
    reply_match_w = torch.where(snap_handled, prev, msg_last)
    out["ap_active"] = act_in
    out["ap_term"] = state.term[..., None].expand(G, P, P)
    out["ap_success"] = sel & success[..., None]
    out["ap_match"] = torch.where(sel, reply_match_w[..., None], msg_last_all)
    out["ap_conflict"] = torch.minimum(prev_all, state.commit[..., None] + 1)

    # 4. append replies + quorum commit advance
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
    state = state._replace(commit=quorum_commit(
        eff_match, state.term, state.commit, state.base, state.base_term,
        state.log_term, is_leader, cfg.q_commit))

    # 4b. check-quorum
    if cfg.check_quorum:
        eff_ack = torch.where(own, now, state.last_ack)
        q_heard = _kth_smallest(eff_ack, P - cfg.quorum)
        demote = (state.role == LEADER) & state.alive & ((now - q_heard) >= cfg.ELECT_MAX)
        state = _step_down(cfg, state, demote, state.term, clear_vote=False)
        state = state._replace(
            elect_dl=torch.where(demote, now + jitter, state.elect_dl)
        )

    # 5. timers: elections
    timeout = state.alive & (now >= state.elect_dl) & (state.role != LEADER)
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

    # 5c. append sends: heartbeat + lag repair
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
