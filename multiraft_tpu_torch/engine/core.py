"""The batched consensus engine — multi-Raft as one tick over tensors.

PyTorch port of ``multiraft_tpu/engine/core.py``.  Every replica of
every group lives in struct-of-arrays state tensors with a leading
``(G, P)`` = (groups, peers) axis, and one pure
``tick_impl(cfg, state, inbox, new_cmds, key) -> (state, outbox,
metrics)`` advances them all.  RPCs are dense per-edge mailboxes
``[G, src, dst]``.  The phase structure, the flags and every value are
the reference's; the tests hold each plane and metric equal to it.

What differs from the JAX formulation, and why:

* Ring access is a ``gather``.  The reference reads and writes the log
  ring through on-the-fly one-hots over L that XLA fuses; eager PyTorch
  would materialise them (the outgoing-suffix read alone would be
  [G,P,P*E,L], gigabytes at the headline shape).  A one-hot always hits
  exactly one lane, so the gather returns the same values, including
  reads outside the ring window.  The same holds for selecting the
  winning append message out of the [G,dst,src] lanes.
* No ``lax.cond``.  The conflict check is computed unconditionally (its
  fast path returns what the full branch would), and the uniform-suffix
  fast path is a ``torch.where`` on a device-side flag, so a tick never
  synchronises with the host.
* Every plane stays ``int32`` or ``bool`` as JAX keeps it with 64-bit
  types off: reductions pass ``dtype=torch.int32`` and index grids are
  ``int32`` aranges.
* ``use_kernels`` replaces ``use_pallas``: the vote tally and the quorum
  commit advance go through the hand-written CUDA kernels of
  :mod:`.kernels` (their plain PyTorch versions on a CPU tensor).
* The tick is functional: no input is donated or written in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from ..utils import prng, trace
from ..utils.knobs import knob_bool
from . import kernels

__all__ = [
    "EngineConfig", "EngineState", "Mailbox", "init_state", "seed_voters",
    "empty_mailbox", "tick_impl", "run_ticks", "run_ticks_traced",
    "run_ticks_traced_vec", "METRIC_KEYS", "SCALAR_METRIC_KEYS",
    "TRACE_KEYS",
]

FOLLOWER, CANDIDATE, LEADER = 0, 1, 2
I32 = torch.int32

SCALAR_METRIC_KEYS = ("commits", "leaders", "max_term")
METRIC_KEYS = SCALAR_METRIC_KEYS + (
    "accepted", "start_index", "accept_term", "commit_index",
)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static shape/timing parameters; the reference's fields, with
    ``use_kernels`` in place of ``use_pallas``/``pallas_interpret``, and
    ``replicas``, the first voter set, which the reference sets with
    ``EngineDriver.seed_config`` instead."""

    G: int = 8  # groups
    P: int = 3  # peers per group
    L: int = 64  # log ring capacity per replica
    E: int = 8  # max entries per append message
    INGEST: int = 8  # max Start() commands accepted per group per tick
    HB_TICKS: int = 9
    ELECT_MIN: int = 30
    ELECT_MAX: int = 60
    # Hand-written CUDA kernels for vote tally + quorum commit.
    use_kernels: bool = False
    # The tick leaves `applied` to the host (split-group mode).
    host_paced_compaction: bool = False
    prevote: bool = dataclasses.field(
        default_factory=lambda: knob_bool("MRT_PREVOTE")
    )
    check_quorum: bool = dataclasses.field(
        default_factory=lambda: knob_bool("MRT_CHECK_QUORUM")
    )
    membership: bool = dataclasses.field(
        default_factory=lambda: knob_bool("MRT_MEMBERSHIP")
    )
    # Voters each group starts with: init_state seeds slots
    # 0..replicas-1 as every group's C_old and C_new and the slots above
    # as dead spares, which a replica move seats as learners (None: all
    # P, every slot a voter).  Fewer than P needs the masked quorums of
    # the joint-consensus path (membership_on).
    replicas: Optional[int] = None

    def __post_init__(self) -> None:
        if self.L <= self.E + self.INGEST + 2:
            raise ValueError(
                f"EngineConfig: L={self.L} must exceed "
                f"E+INGEST+2={self.E + self.INGEST + 2}"
            )
        if self.P < 1 or self.G < 1 or self.E < 1:
            raise ValueError("EngineConfig: G, P, E must be >= 1")
        if self.ELECT_MIN >= self.ELECT_MAX or self.HB_TICKS < 1:
            raise ValueError("EngineConfig: bad timing parameters")
        if self.membership and self.P > 30:
            raise ValueError(
                f"EngineConfig: membership mode supports P <= 30 "
                f"(i32 voter bitmasks), got P={self.P}"
            )
        if self.replicas is None:
            object.__setattr__(self, "replicas", self.P)
        if not 1 <= self.replicas <= self.P:
            raise ValueError(
                f"EngineConfig: replicas={self.replicas} must lie in 1..P={self.P}"
            )
        if self.replicas < self.P and not self.membership_on:
            raise ValueError(
                f"EngineConfig: replicas={self.replicas} < P={self.P} leaves "
                f"spare slots, which need the masked quorums: membership on "
                f"and use_kernels off"
            )

    def __getstate__(self) -> dict:
        # A checkpoint of a config whose every slot is a voter keeps the
        # fields it had before ``replicas``, and loads where they are all.
        state = dict(self.__dict__)
        if state["replicas"] == self.P:
            del state["replicas"]
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self.__dict__.setdefault("replicas", self.P)

    @property
    def quorum(self) -> int:
        return self.P // 2 + 1

    @property
    def membership_on(self) -> bool:
        """Masked (joint-consensus) reductions: the kernels are
        mask-unaware, so membership runs only on the plain path."""
        return self.membership and not self.use_kernels

    @property
    def full_voters(self) -> int:
        return (1 << self.P) - 1


class EngineState(NamedTuple):
    """Struct-of-arrays Raft state, leading axes (G, P)."""

    tick_no: torch.Tensor  # i32 scalar
    term: torch.Tensor  # i32[G,P]
    voted_for: torch.Tensor  # i32[G,P] (-1 = none)
    role: torch.Tensor  # i32[G,P]
    commit: torch.Tensor  # i32[G,P]
    applied: torch.Tensor  # i32[G,P]
    base: torch.Tensor  # i32[G,P] snapshot index (log ring floor)
    base_term: torch.Tensor  # i32[G,P]
    log_len: torch.Tensor  # i32[G,P] entries above base
    log_term: torch.Tensor  # i32[G,P,L] ring: abs index i at slot i % L
    next_idx: torch.Tensor  # i32[G,P,P] leader p's next for peer q
    match_idx: torch.Tensor  # i32[G,P,P]
    votes: torch.Tensor  # bool[G,P,P] candidate p's votes from q
    elect_dl: torch.Tensor  # i32[G,P] election deadline tick
    hb_due: torch.Tensor  # i32[G,P] next heartbeat tick
    alive: torch.Tensor  # bool[G,P] fault-injection: replica up
    pre_votes: torch.Tensor  # bool[G,P,P] prevote grants (prevote mode)
    last_heard: torch.Tensor  # i32[G,P] last tick a leader was heard
    last_ack: torch.Tensor  # i32[G,P,P] leader p: last ack tick from q
    voters_old: torch.Tensor  # i32[G,P] bitmask: C_old voters
    voters_new: torch.Tensor  # i32[G,P] bitmask: C_new voters
    joint: torch.Tensor  # bool[G,P] in the C_old,new transition
    cfg_epoch: torch.Tensor  # i32[G,P] config generation counter
    cfg_idx: torch.Tensor  # i32[G,P] log index of the latest cfg entry


class Mailbox(NamedTuple):
    """Dense per-edge messages, all ``[G, src, dst]`` (+ trailing dims)."""

    vr_active: torch.Tensor  # bool[G,P,P]
    vr_term: torch.Tensor  # i32[G,P,P]
    vr_last_idx: torch.Tensor  # i32[G,P,P]
    vr_last_term: torch.Tensor  # i32[G,P,P]
    vr_pre: torch.Tensor  # bool[G,P,P]
    vp_active: torch.Tensor  # bool[G,P,P]  src=voter, dst=candidate
    vp_term: torch.Tensor  # i32[G,P,P]
    vp_granted: torch.Tensor  # bool[G,P,P]
    vp_pre: torch.Tensor  # bool[G,P,P]
    ar_active: torch.Tensor  # bool[G,P,P]
    ar_term: torch.Tensor  # i32[G,P,P]
    ar_prev_idx: torch.Tensor  # i32[G,P,P]
    ar_prev_term: torch.Tensor  # i32[G,P,P]
    ar_n: torch.Tensor  # i32[G,P,P] entries carried (<= E)
    ar_terms: torch.Tensor  # i32[G,P,P,E]
    ar_commit: torch.Tensor  # i32[G,P,P] leader commit
    ar_snap: torch.Tensor  # bool[G,P,P] InstallSnapshot fast-forward
    ap_active: torch.Tensor  # bool[G,P,P]  src=follower, dst=leader
    ap_term: torch.Tensor  # i32[G,P,P]
    ap_success: torch.Tensor  # bool[G,P,P]
    ap_match: torch.Tensor  # i32[G,P,P]
    ap_conflict: torch.Tensor  # i32[G,P,P]
    ar_cfg_epoch: torch.Tensor  # i32[G,P,P]
    ar_cfg_idx: torch.Tensor  # i32[G,P,P]
    ar_cfg_old: torch.Tensor  # i32[G,P,P] voter bitmask
    ar_cfg_new: torch.Tensor  # i32[G,P,P] voter bitmask
    ar_cfg_joint: torch.Tensor  # bool[G,P,P]


def _ar(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=device)


def init_state(
    cfg: EngineConfig, key: torch.Tensor, device: torch.device
) -> EngineState:
    """Every group at tick 0, its first config the slots
    ``0..cfg.replicas-1`` (:func:`seed_voters`)."""
    G, P, L = cfg.G, cfg.P, cfg.L
    z = lambda *s: torch.zeros(s, dtype=I32, device=device)
    full = lambda v, *s: torch.full(s, v, dtype=I32, device=device)
    state = EngineState(
        tick_no=torch.zeros((), dtype=I32, device=device),
        term=z(G, P),
        voted_for=full(-1, G, P),
        role=z(G, P),
        commit=z(G, P),
        applied=z(G, P),
        base=z(G, P),
        base_term=z(G, P),
        log_len=z(G, P),
        log_term=z(G, P, L),
        next_idx=full(1, G, P, P),
        match_idx=z(G, P, P),
        votes=torch.zeros((G, P, P), dtype=torch.bool, device=device),
        elect_dl=prng.randint(
            key, (G, P), cfg.ELECT_MIN, cfg.ELECT_MAX, device
        ),
        hb_due=z(G, P),
        alive=torch.ones((G, P), dtype=torch.bool, device=device),
        pre_votes=torch.zeros((G, P, P), dtype=torch.bool, device=device),
        last_heard=z(G, P),
        last_ack=z(G, P, P),
        voters_old=full(cfg.full_voters, G, P),
        voters_new=full(cfg.full_voters, G, P),
        joint=torch.zeros((G, P), dtype=torch.bool, device=device),
        cfg_epoch=z(G, P),
        cfg_idx=z(G, P),
    )
    if cfg.replicas < P:
        state = seed_voters(state, range(cfg.replicas), P)
    return state


def seed_voters(state: EngineState, voters: Sequence[int], P: int) -> EngineState:
    """``voters`` (slot indices) as every group's C_old and C_new, and the
    other slots down: the bootstrap config of ``EngineDriver.seed_config``
    and of ``EngineConfig.replicas``."""
    mask = 0
    for q in voters:
        mask |= 1 << q
    spare = torch.tensor(
        [q not in voters for q in range(P)], device=state.alive.device
    )
    return state._replace(
        voters_old=torch.full_like(state.voters_old, mask),
        voters_new=torch.full_like(state.voters_new, mask),
        alive=state.alive & ~spare,
    )


def empty_mailbox(cfg: EngineConfig, device: torch.device) -> Mailbox:
    G, P, E = cfg.G, cfg.P, cfg.E
    fields = {}
    for name in Mailbox._fields:
        shape = (G, P, P, E) if name == "ar_terms" else (G, P, P)
        dtype = torch.bool if name in _BOOL_LANES else I32
        fields[name] = torch.zeros(shape, dtype=dtype, device=device)
    return Mailbox(**fields)


_BOOL_LANES = frozenset({
    "vr_active", "vr_pre", "vp_active", "vp_granted", "vp_pre",
    "ar_active", "ar_snap", "ap_active", "ap_success", "ar_cfg_joint",
})


# ---------------------------------------------------------------------------
# Ring-log helpers (the device mirror of raft/raft_log.go's index algebra)
# ---------------------------------------------------------------------------


def _ring_read(log: torch.Tensor, idx: torch.Tensor, L: int) -> torch.Tensor:
    """``log[..., idx mod L]`` (floor mod).  ``log``: [..., L]; ``idx``:
    [..., K] absolute indices with the same prefix.  Slots outside the
    ring window read whatever the ring holds — callers mask validity."""
    return torch.gather(log, -1, torch.remainder(idx, L).long())


def _ring_write(
    log: torch.Tensor,
    start: torch.Tensor,
    vals: torch.Tensor,
    n: torch.Tensor,
    L: int,
) -> torch.Tensor:
    """Write ``vals[..., e] -> slot (start+e) mod L`` for ``e < n``.

    Lane l takes message entry ``e_l = (l - start) mod L`` (unique since
    E <= L); a lane past the message (``e_l >= E``) reads 0, as the
    reference's empty one-hot sum does."""
    E = vals.shape[-1]
    e_l = torch.remainder(_ar(L, log.device) - start[..., None], L)
    hit = e_l < n[..., None]
    v = torch.gather(vals, -1, e_l.clamp(max=E - 1).long())
    v = torch.where(e_l < E, v, 0)
    return torch.where(hit, v, log)


def _sort_cols(x: torch.Tensor) -> list:
    """Ascending sort along the small last axis by an unrolled
    compare-swap network; returns the sorted columns."""
    cols = [x[..., i] for i in range(x.shape[-1])]
    n = len(cols)
    for i in range(n):
        for j in range(n - 1 - i):
            a, b = cols[j], cols[j + 1]
            cols[j], cols[j + 1] = torch.minimum(a, b), torch.maximum(a, b)
    return cols


def _kth_smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    return _sort_cols(x)[k]


def _voter_lanes(bits: torch.Tensor, P: int) -> torch.Tensor:
    """Expand an i32 voter bitmask [...] to a bool lane mask [..., P]."""
    return ((bits[..., None] >> _ar(P, bits.device)) & 1) == 1


def _quorum_met(grants: torch.Tensor, bits: torch.Tensor, P: int) -> torch.Tensor:
    """Do ``grants`` (bool[..., P]) hold a majority of the voters named
    by ``bits``?"""
    lanes = _voter_lanes(bits, P)
    n = (grants & lanes).sum(-1, dtype=I32)
    need = lanes.sum(-1, dtype=I32) // 2 + 1
    return n >= need


def _quorum_kth(vals: torch.Tensor, bits: torch.Tensor, P: int) -> torch.Tensor:
    """Largest v such that a majority of the voters in ``bits`` have
    ``vals >= v`` (non-voter lanes pushed below every value)."""
    lanes = _voter_lanes(bits, P)
    need = lanes.sum(-1, dtype=I32) // 2 + 1
    cols = _sort_cols(torch.where(lanes, vals, -1))
    k = P - need
    out = cols[0]
    for i in range(1, P):
        out = torch.where(k == i, cols[i], out)
    return out


def _term_at(cfg: EngineConfig, state: EngineState, idx: torch.Tensor) -> torch.Tensor:
    """Term of absolute index ``idx`` per replica; idx == base reads
    base_term."""
    gathered = _ring_read(state.log_term, idx[..., None], cfg.L)[..., 0]
    return torch.where(idx == state.base, state.base_term, gathered)


def _last_index(state: EngineState) -> torch.Tensor:
    return state.base + state.log_len


def _step_down(
    cfg: EngineConfig,
    state: EngineState,
    higher: torch.Tensor,
    m_term: torch.Tensor,
    clear_vote: bool = True,
) -> EngineState:
    """Adopt a higher term and drop to follower; ``clear_vote=False`` is
    the own-term demotion (check-quorum, removal), where the vote must
    survive."""
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
    """[G, src, dst] -> [G, dst, src] view."""
    return x.transpose(1, 2)


# ---------------------------------------------------------------------------
# The tick
# ---------------------------------------------------------------------------


def tick_impl(
    cfg: EngineConfig,
    state: EngineState,
    inbox: Mailbox,
    new_cmds: torch.Tensor,  # i32[G]: Start() firehose, appended at leaders
    key: torch.Tensor,
) -> Tuple[EngineState, Mailbox, Dict[str, torch.Tensor]]:
    """One tick of every group.  While ``torch.profiler`` records, the
    tick runs inside an ``mrt.tick`` range with one ``mrt.*`` range per
    phase (``utils.trace.phases``); otherwise it enters none."""
    with trace.phases(state.term.device, "mrt.tick") as sp:
        return _tick(cfg, state, inbox, new_cmds, key, sp)


def _tick(
    cfg: EngineConfig,
    state: EngineState,
    inbox: Mailbox,
    new_cmds: torch.Tensor,
    key: torch.Tensor,
    sp,  # the tick's phase spans: trace.TickPhases, or a no-op
) -> Tuple[EngineState, Mailbox, Dict[str, torch.Tensor]]:
    G, P, L, E = cfg.G, cfg.P, cfg.L, cfg.E
    dev = state.term.device
    out: Dict[str, torch.Tensor] = {}
    now = state.tick_no + 1
    commit_before = state.commit
    pi = _ar(P, dev)[None, :]  # [1,P] replica index grid
    own = pi[None] == pi[..., None]  # [1,P,P] diag mask

    # One jitter draw per tick, shared by every timer reset in it.
    sp.phase("mrt.prng")
    jitter = prng.randint(
        prng.fold_in(key, 7), (G, P), cfg.ELECT_MIN, cfg.ELECT_MAX, dev
    )

    # ---- 1. vote requests: one arbitrated pass over [G, voter, cand] ----
    sp.phase("mrt.votes")
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
    winner = torch.where(cand_ok, cand_ids, P).amin(dim=2)  # [G,P]
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
    out["vp_term"] = torch.where(
        pre_act & grant_pre, m_term, state.term[..., None]
    )
    out["vp_granted"] = torch.where(pre_act, grant_pre, grant)

    # ---- 2. vote replies -> tally -> leadership ----
    sp.phase("mrt.tally")
    arrived = _vT(inbox.vp_active) & state.alive[:, :, None]
    reply_pre = _vT(inbox.vp_pre)
    active = arrived & ~reply_pre
    m_term = _vT(inbox.vp_term)
    granted = _vT(inbox.vp_granted)
    higher_lane = active & (m_term > state.term[..., None])
    if cfg.prevote:
        # A refused pre reply carries the voter's actual term.
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
            arrived
            & reply_pre
            & (m_term == state.term[..., None] + 1)
            & granted
        )
        state = state._replace(pre_votes=state.pre_votes | good_pre)

    if cfg.prevote:
        # Prevote quorum -> a real candidacy (the only term bump).
        if cfg.membership_on:
            promote = (
                state.alive
                & (state.role != LEADER)
                & _quorum_met(state.pre_votes, state.voters_old, P)
                & _quorum_met(state.pre_votes, state.voters_new, P)
            )
        else:
            n_pre = state.pre_votes.sum(-1, dtype=I32)
            promote = (
                state.alive & (state.role != LEADER) & (n_pre >= cfg.quorum)
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
    if cfg.membership_on:
        become_leader = (
            (state.role == CANDIDATE)
            & state.alive
            & _quorum_met(state.votes, state.voters_old, P)
            & _quorum_met(state.votes, state.voters_new, P)
        )
    elif cfg.use_kernels:
        become_leader = kernels.vote_tally(
            state.votes.contiguous(),
            state.role.contiguous(),
            state.alive.contiguous(),
            cfg.quorum,
        )
    else:
        n_votes = state.votes.sum(-1, dtype=I32)
        become_leader = (
            (state.role == CANDIDATE) & state.alive & (n_votes >= cfg.quorum)
        )
    if cfg.membership_on:
        # A leader elected with a config change pending appends a no-op
        # at its own term so the change can commit on an idle group.
        noop = (
            become_leader
            & (state.joint | (state.cfg_idx > state.commit))
            & ((L - 2 - E - state.log_len) >= 1)
        )
        noop_idx = _last_index(state) + 1
        hit_no = (
            torch.remainder(_ar(L, dev) - noop_idx[..., None], L) == 0
        ) & noop[..., None]
        state = state._replace(
            log_term=torch.where(hit_no, state.term[..., None], state.log_term),
            log_len=state.log_len + noop.to(I32),
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

    # ---- 3. append requests: the max-term message per dst wins ----
    sp.phase("mrt.append")
    act_in = _vT(inbox.ar_active) & state.alive[:, :, None]  # [G,dst,src]
    term_key = torch.where(act_in, _vT(inbox.ar_term), -1)
    max_term_in = term_key.amax(dim=2)
    is_max = act_in & (term_key == max_term_in[..., None])
    src_ids = _ar(P, dev)
    win_src = torch.where(is_max, src_ids, P).amin(dim=2)  # [G,dst]
    sel = src_ids == win_src[..., None]  # [G,dst,src] one-hot (or none)
    active = win_src < P  # [G,P] a message arrived at dst
    src_at = win_src.clamp(max=P - 1).long()[:, None, :]  # [G,1,dst]

    def pick(x: torch.Tensor) -> torch.Tensor:
        """The winner's lane of ``x`` [G,src,dst] -> [G,dst]; zero (or
        False) where no message arrived, as the one-hot sum gives."""
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
        # Hearing a live leader aborts any in-flight prevote round.
        state = state._replace(
            pre_votes=torch.where(ok[..., None], False, state.pre_votes)
        )

    prev = pick(inbox.ar_prev_idx)
    prev_t = pick(inbox.ar_prev_term)
    n_ent = pick(inbox.ar_n)
    snap = pick(inbox.ar_snap)

    # InstallSnapshot fast-forward.
    with sp.span("mrt.fast_forward"):
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
    idx = prev[..., None] + 1 + ei  # [G,P,E]
    in_msg = match[..., None] & (ei < n_ent[..., None])
    # Winner's entry terms: ar_terms[g, win_src, dst, :] -> [G,dst,E].
    incoming = inbox.ar_terms.gather(
        1, src_at[..., None].expand(G, 1, P, E)
    )[:, 0]
    incoming = torch.where(active[..., None], incoming, 0)
    exists = idx <= last[..., None]
    overlap = in_msg & exists
    # Computed unconditionally: with no overlap it is all False, which
    # is what the reference's fast-path branch returns.
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
        commit=torch.where(
            match & (new_commit > state.commit), new_commit, state.commit
        )
    )

    if cfg.membership_on:
        # Config mirroring: a follower whose log covers the leader's
        # latest config entry adopts the leader's whole view.
        m_cfg_idx = pick(inbox.ar_cfg_idx)
        covered = m_cfg_idx <= (prev + n_ent)
        adopt_cfg = (match & covered) | do_snap
        state = state._replace(
            voters_old=torch.where(
                adopt_cfg, pick(inbox.ar_cfg_old), state.voters_old
            ),
            voters_new=torch.where(
                adopt_cfg, pick(inbox.ar_cfg_new), state.voters_new
            ),
            joint=torch.where(adopt_cfg, pick(inbox.ar_cfg_joint), state.joint),
            cfg_epoch=torch.where(
                adopt_cfg, pick(inbox.ar_cfg_epoch), state.cfg_epoch
            ),
            cfg_idx=torch.where(adopt_cfg, m_cfg_idx, state.cfg_idx),
        )

    # Replies go to every active sender; only the winner can succeed.
    prev_all = _vT(inbox.ar_prev_idx)
    msg_last_all = prev_all + _vT(inbox.ar_n)
    success = match | snap_handled
    reply_match_w = torch.where(snap_handled, prev, msg_last)
    out["ap_active"] = act_in
    out["ap_term"] = state.term[..., None].expand(G, P, P)
    out["ap_success"] = sel & success[..., None]
    out["ap_match"] = torch.where(sel, reply_match_w[..., None], msg_last_all)
    out["ap_conflict"] = torch.minimum(prev_all, state.commit[..., None] + 1)

    # ---- 4. append replies + quorum commit advance ----
    sp.phase("mrt.commit")
    active = _vT(inbox.ap_active) & state.alive[:, :, None]
    m_term = _vT(inbox.ap_term)
    higher_lane = active & (m_term > state.term[..., None])
    adopt = torch.where(higher_lane, m_term, -1).amax(dim=2)
    state = _step_down(cfg, state, higher_lane.any(dim=2), adopt)
    good = (
        active
        & (state.role == LEADER)[..., None]
        & (m_term == state.term[..., None])
    )
    if cfg.check_quorum:
        state = state._replace(
            last_ack=torch.where(good, now, state.last_ack)
        )
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
                torch.maximum(
                    _vT(inbox.ap_conflict).clamp(min=1), state.match_idx + 1
                ),
                state.next_idx,
            ),
        ),
    )

    last_idx = _last_index(state)
    is_leader = (state.role == LEADER) & state.alive
    eff_match = torch.where(own, last_idx[..., None], state.match_idx)
    if cfg.membership_on:
        # Joint commit rule: the min of the two masked quorum medians.
        quorum_idx = torch.minimum(
            _quorum_kth(eff_match, state.voters_old, P),
            _quorum_kth(eff_match, state.voters_new, P),
        )
        guard = _term_at(cfg, state, quorum_idx) == state.term
        new_commit = torch.where(
            is_leader & guard,
            torch.maximum(state.commit, quorum_idx),
            state.commit,
        )
    elif cfg.use_kernels:
        new_commit = kernels.quorum_commit(
            eff_match.contiguous(),
            state.term.contiguous(),
            state.commit.contiguous(),
            state.base.contiguous(),
            state.base_term.contiguous(),
            state.log_term.contiguous(),
            is_leader.contiguous(),
            cfg.quorum,
        )
    else:
        quorum_idx = _kth_smallest(eff_match, P - cfg.quorum)
        guard = _term_at(cfg, state, quorum_idx) == state.term
        new_commit = torch.where(
            is_leader & guard,
            torch.maximum(state.commit, quorum_idx),
            state.commit,
        )
    state = state._replace(commit=new_commit)

    # ---- 4b. check-quorum: quorum-severed leaders release their groups ----
    if cfg.check_quorum:
        sp.phase("mrt.check_quorum")
        eff_ack = torch.where(own, now, state.last_ack)
        if cfg.membership_on:
            q_heard = torch.minimum(
                _quorum_kth(eff_ack, state.voters_old, P),
                _quorum_kth(eff_ack, state.voters_new, P),
            )
        else:
            q_heard = _kth_smallest(eff_ack, P - cfg.quorum)
        demote = (
            (state.role == LEADER)
            & state.alive
            & ((now - q_heard) >= cfg.ELECT_MAX)
        )
        state = _step_down(cfg, state, demote, state.term, clear_vote=False)
        state = state._replace(
            elect_dl=torch.where(demote, now + jitter, state.elect_dl)
        )

    # ---- 4c. membership: a leader removed by a completed change steps
    # down once the removing entry commits ----
    if cfg.membership_on:
        sp.phase("mrt.membership")
        self_voter = (((state.voters_old | state.voters_new) >> pi) & 1) == 1
        removed = (
            (state.role == LEADER)
            & state.alive
            & ~state.joint
            & ~self_voter
            & (state.commit >= state.cfg_idx)
        )
        state = _step_down(cfg, state, removed, state.term, clear_vote=False)
        state = state._replace(
            elect_dl=torch.where(removed, now + jitter, state.elect_dl)
        )

    # ---- 5. timers: elections ----
    sp.phase("mrt.elections")
    timeout = state.alive & (now >= state.elect_dl) & (state.role != LEADER)
    if cfg.membership_on:
        member = (((state.voters_old | state.voters_new) >> pi) & 1) == 1
        timeout = timeout & member
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
        # Phase-2 promotions announce now, unless a later phase
        # already deposed the fresh candidate.
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

    # ---- 5a-bis. membership: joint auto-exit (before ingest, so the
    # capacity accounting already includes the exit entry) ----
    if cfg.membership_on:
        sp.phase("mrt.membership")
        last_idx = _last_index(state)
        can_exit = (
            (state.role == LEADER)
            & state.alive
            & state.joint
            & (state.commit >= state.cfg_idx)
            & ((L - 2 - E - state.log_len) >= 1)
        )
        exit_idx = last_idx + 1
        hit_cfg = (
            torch.remainder(_ar(L, dev) - exit_idx[..., None], L) == 0
        ) & can_exit[..., None]
        state = state._replace(
            log_term=torch.where(
                hit_cfg, state.term[..., None], state.log_term
            ),
            log_len=state.log_len + can_exit.to(I32),
            voters_old=torch.where(
                can_exit, state.voters_new, state.voters_old
            ),
            joint=torch.where(can_exit, False, state.joint),
            cfg_epoch=torch.where(
                can_exit, state.cfg_epoch + 1, state.cfg_epoch
            ),
            cfg_idx=torch.where(can_exit, exit_idx, state.cfg_idx),
        )

    # ---- 5b. Start() ingestion: the max-term alive leader appends ----
    sp.phase("mrt.ingest")
    is_leader = (state.role == LEADER) & state.alive
    group_max_term = torch.where(state.alive, state.term, -1).amax(
        dim=1, keepdim=True
    )
    is_leader = is_leader & (state.term == group_max_term)
    capacity = (L - 2 - cfg.E - state.log_len).clamp(min=0)
    want = new_cmds[:, None].clamp(max=cfg.INGEST)  # [G,1]
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

    # ---- 5c. append sends: heartbeat + lag repair ----
    sp.phase("mrt.sends")
    last_idx = _last_index(state)
    is_leader = (state.role == LEADER) & state.alive
    hb_fire = is_leader & (now >= state.hb_due)
    lag = state.next_idx <= last_idx[:, :, None]  # [G,P,P] dst lags
    send = (hb_fire[:, :, None] | (is_leader[:, :, None] & lag)) & ~own
    send = send & state.alive[:, :, None]
    prev = state.next_idx - 1  # [G,P,P] per (leader, dst)
    need_snap = prev < state.base[:, :, None]
    prev = torch.where(need_snap, state.base[:, :, None], prev)
    prev_term = _ring_read(state.log_term, prev, L)
    prev_term = torch.where(
        prev == state.base[:, :, None], state.base_term[:, :, None], prev_term
    )
    n_send = torch.where(
        need_snap, 0, (last_idx[:, :, None] - prev).clamp(0, E)
    )
    # Outgoing suffix terms.  The reference takes a broadcast of the
    # sender's term when every lane is "uniform" and the full ring read
    # otherwise; the two differ on lanes that send nothing, so the
    # choice is reproduced here on a device flag, without a host sync.
    first_term = _ring_read(state.log_term, prev + 1, L)
    uniform = ~send | (n_send == 0) | (first_term == state.term[:, :, None])
    send_idx = prev[..., None] + 1 + ei  # [G,P,P,E]
    t_full = _ring_read(
        state.log_term, send_idx.reshape(G, P, P * E), L
    ).reshape(G, P, P, E)
    t = torch.where(uniform.all(), state.term[:, :, None, None], t_full)
    out["ar_active"] = send
    out["ar_term"] = state.term[:, :, None].expand(G, P, P)
    out["ar_prev_idx"] = prev
    out["ar_prev_term"] = prev_term
    out["ar_n"] = n_send
    out["ar_terms"] = torch.where(ei < n_send[..., None], t, 0)
    out["ar_commit"] = state.commit[:, :, None].expand(G, P, P)
    out["ar_snap"] = need_snap & send
    out["ar_cfg_epoch"] = state.cfg_epoch[:, :, None].expand(G, P, P)
    out["ar_cfg_idx"] = state.cfg_idx[:, :, None].expand(G, P, P)
    out["ar_cfg_old"] = state.voters_old[:, :, None].expand(G, P, P)
    out["ar_cfg_new"] = state.voters_new[:, :, None].expand(G, P, P)
    out["ar_cfg_joint"] = state.joint[:, :, None].expand(G, P, P)
    state = state._replace(
        hb_due=torch.where(hb_fire, now + cfg.HB_TICKS, state.hb_due),
        # Pipelined replication: next_idx advances at send time.
        next_idx=torch.where(send, state.next_idx + n_send, state.next_idx),
    )

    # ---- 6. apply frontier + ring compaction ----
    sp.phase("mrt.compact")
    if not cfg.host_paced_compaction:
        state = state._replace(
            applied=torch.maximum(state.applied, state.commit)
        )
    need = (L - state.log_len) < (cfg.E + cfg.INGEST + 2)
    target = torch.minimum(state.applied, _last_index(state))
    new_base = torch.where(need, torch.maximum(state.base, target), state.base)
    state = state._replace(
        log_len=_last_index(state) - new_base,
        base=new_base,
        base_term=_term_at(cfg, state, new_base),
        tick_no=now,
    )

    leading = (state.role == LEADER) & state.alive
    leader_commit_delta = torch.where(leading, state.commit - commit_before, 0)
    metrics = {
        "commits": leader_commit_delta.clamp(min=0).sum(dtype=I32),
        "leaders": leading.sum(dtype=I32),
        "max_term": state.term.amax(),
        "accepted": accepted_per_group,
        "start_index": start_index,
        "accept_term": torch.where(accept > 0, state.term, 0).sum(
            dim=1, dtype=I32
        ),
        "commit_index": state.commit.amax(dim=1),
    }
    return state, Mailbox(**out), metrics


# Per-tick record fields the traced loops stack (i32[n_ticks, G] each).
TRACE_KEYS = ("ing_hi", "accepted", "accept_term", "commit")


def _trace_record(m: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {
        "ing_hi": m["start_index"] + m["accepted"],
        "accepted": m["accepted"],
        "accept_term": m["accept_term"],
        "commit": m["commit_index"],
    }


def run_ticks_traced_vec(
    cfg: EngineConfig,
    state: EngineState,
    inbox: Mailbox,
    n_ticks: int,
    new_cmds: torch.Tensor,
    key: torch.Tensor,
) -> Tuple[EngineState, Mailbox, Dict[str, torch.Tensor]]:
    """``n_ticks`` rounds with a per-group ingest vector, tick ``i`` keyed
    by ``fold_in(key, i)``, plus the stacked ``TRACE_KEYS`` record (the
    stacking is the last tick's ``mrt.record``)."""
    recs = []
    for i in range(n_ticks):
        with trace.phases(state.term.device) as sp:
            with sp.span("mrt.prng"):
                tick_key = prng.fold_in(key, i)
            state, inbox, m = tick_impl(cfg, state, inbox, new_cmds, tick_key)
            with sp.span("mrt.record"):
                recs.append(_trace_record(m))
                if i == n_ticks - 1:
                    rec = {k: torch.stack([r[k] for r in recs]) for k in TRACE_KEYS}
    return state, inbox, rec


def run_ticks_traced(
    cfg: EngineConfig,
    state: EngineState,
    inbox: Mailbox,
    n_ticks: int,
    ingest_per_tick: int,
    key: torch.Tensor,
) -> Tuple[EngineState, Mailbox, Dict[str, torch.Tensor]]:
    """:func:`run_ticks_traced_vec` with a constant firehose."""
    new_cmds = torch.full(
        (cfg.G,), ingest_per_tick, dtype=I32, device=state.term.device
    )
    return run_ticks_traced_vec(cfg, state, inbox, n_ticks, new_cmds, key)


def run_ticks(
    cfg: EngineConfig,
    state: EngineState,
    inbox: Mailbox,
    n_ticks: int,
    ingest_per_tick: int,
    key: torch.Tensor,
) -> Tuple[EngineState, Mailbox]:
    """``n_ticks`` rounds with a constant firehose and no record."""
    new_cmds = torch.full(
        (cfg.G,), ingest_per_tick, dtype=I32, device=state.term.device
    )
    for i in range(n_ticks):
        with trace.phases(state.term.device) as sp:
            with sp.span("mrt.prng"):
                tick_key = prng.fold_in(key, i)
            state, inbox, _ = tick_impl(cfg, state, inbox, new_cmds, tick_key)
    return state, inbox
