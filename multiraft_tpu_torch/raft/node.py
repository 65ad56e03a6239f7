"""Event-driven single-group Raft — the framework's correctness oracle.

The reference runs each peer as goroutine families: a ticker, per-peer
replicators, and an applier (reference: raft/raft.go:51-87,106-203).
This implementation inverts that into pure event handlers on the
virtual-time scheduler: timers are scheduled events, RPC replies are
future callbacks, and apply is a drained queue — zero locks, fully
deterministic, and structurally identical to one lane of the batched
engine's tick function (see ``multiraft_tpu_torch.engine``), which is
golden-tested against this class by the differential conformance rig
(``multiraft_tpu_torch/conformance.py`` + ``tests/test_torch_conformance.py``:
identical seeded fault scenarios on both backends must commit
identical command streams).  This is the PyTorch port's copy of the
reference package's ``multiraft_tpu/raft/node.py``: the same event
handlers and the same order of draws from the node's seeded RNG, so a
seeded run replays the reference's event trace exactly.

Protocol semantics follow the reference:

* election and vote-granting rules (reference: raft/raft_election.go)
* heartbeat-as-repair: every heartbeat is a full AppendEntries carrying
  any missing suffix (reference: raft/raft_append_entry.go:9-12,44-55)
* conflict-index fast backup (reference: raft/raft_append_entry.go:136-143)
* quorum commit advance with the current-term guard
  (reference: raft/raft_append_entry.go:89-105)
* out-of-order/duplicate RPC tolerance: no truncation on stale prefixes
  (reference: raft/raft_append_entry.go:146-155), staleness guard on
  replies (reference: raft/raft_append_entry.go:74)
* service-driven snapshots + InstallSnapshot with commit fast-forward and
  the apply-ordering guarantee (reference: raft/raft_snapshot.go)

Documented divergences from reference quirks (SURVEY §7.5): fresh RNG
per timeout is replaced by one seeded per-node RNG; the Term=0 reply
quirk is fixed; ``CondInstallSnapshot`` (a constant-true vestige) is not
reproduced.
"""

from __future__ import annotations

import random
from typing import Any, Callable, List, Optional

from ..sim.scheduler import Scheduler
from ..transport import codec
from ..transport.network import ClientEnd
from .log import RaftLog
from .messages import (
    AppendEntriesArgs,
    AppendEntriesReply,
    ApplyMsg,
    Entry,
    InstallSnapshotArgs,
    InstallSnapshotReply,
    PersistentState,
    RequestVoteArgs,
    RequestVoteReply,
    Role,
)
from .persister import Persister
from ..distributed import flightrec
from ..utils.metrics import trace

__all__ = ["RaftNode", "HEARTBEAT_INTERVAL", "ELECTION_TIMEOUT"]

# Timing (reference: raft/raft.go:42-50), in virtual seconds — read
# from the config system (utils/config.py), overridable via
# MULTIRAFT_HEARTBEAT / MULTIRAFT_ELECTION_MIN / _MAX.
from ..utils.config import settings as _settings

HEARTBEAT_INTERVAL = _settings().raft.heartbeat
ELECTION_TIMEOUT = _settings().raft.election


class RaftNode:
    """One Raft peer.  RPC handler methods (``request_vote``,
    ``append_entries``, ``install_snapshot``) are dispatched by the
    simulated network under service name ``"Raft"``."""

    def __init__(
        self,
        sched: Scheduler,
        peers: List[ClientEnd],
        me: int,
        persister: Persister,
        apply_fn: Callable[[ApplyMsg], None],
        seed: int = 0,
        prevote: bool = False,
    ) -> None:
        self.sched = sched
        self.peers = peers
        self.me = me
        self.persister = persister
        self.apply_fn = apply_fn
        self.rng = random.Random((seed << 16) ^ me)
        # PreVote (etcd/TiKV-style, beyond the reference): election
        # timeouts probe with a non-binding prevote round first; see
        # the engine's EngineConfig.prevote for the design notes.
        self.prevote = prevote
        self._last_heard = float("-inf")  # time a leader was last heard

        self.current_term = 0
        self.voted_for: Optional[int] = None
        self.log = RaftLog()
        self.role = Role.FOLLOWER
        self.commit_index = 0
        self.last_applied = 0
        self.next_index = [1] * len(peers)
        self.match_index = [0] * len(peers)
        self._killed = False

        # Replicator coalescing state (reference: raft/raft.go:134-150 —
        # one replicator goroutine per peer parking on a cond var).
        self._in_flight = [False] * len(peers)
        self._pending = [False] * len(peers)

        # Pending snapshot to surface on the apply path before newer
        # entries (reference: raft/raft.go:168-177).
        self._pending_snapshot: Optional[ApplyMsg] = None
        self._apply_scheduled = False

        self._election_timer = None
        self._heartbeat_timer = None

        # Black box (flightrec.py): role/term/commit transitions in the
        # crash-surviving ring.  None when MRT_FLIGHTREC_DIR is unset —
        # the sim suites pay one `is None` check per transition.
        self._frec = flightrec.get_recorder()

        self._read_persist()
        self.commit_index = self.log.base
        self.last_applied = self.log.base
        self._reset_election_timer()

    # ------------------------------------------------------------------
    # Public API (reference: raft/raft.go:51,90,237; raft/raft_snapshot.go:3)
    # ------------------------------------------------------------------

    def start(self, command: Any) -> tuple[int, int, bool]:
        """Propose a command (reference: raft/raft.go:90-104).  Returns
        (index, term, is_leader); replication begins immediately."""
        if self._killed or self.role != Role.LEADER:
            return -1, self.current_term, False
        entry = Entry(term=self.current_term, command=command)
        self.log.append(entry)
        self.match_index[self.me] = self.log.last_index
        self._persist()
        if len(self.peers) == 1:
            self._advance_commit()
        else:
            for p in range(len(self.peers)):
                if p != self.me:
                    self._kick_replicator(p)
        return entry.index, self.current_term, True

    def get_state(self) -> tuple[int, bool]:
        return self.current_term, self.role == Role.LEADER

    def kill(self) -> None:
        """(reference: raft/utility.go:9-24)"""
        self._killed = True
        if self._election_timer:
            self._election_timer.cancel()
        if self._heartbeat_timer:
            self._heartbeat_timer.cancel()

    def killed(self) -> bool:
        return self._killed

    def snapshot(self, index: int, snapshot: bytes) -> None:
        """Service-driven log compaction (reference: raft/raft_snapshot.go:3-13):
        the service has serialized its state through ``index``; discard
        entries ≤ index and persist the pair atomically."""
        if self._killed or index <= self.log.base:
            return
        self.log.compact_to(index)
        self.persister.save_state_and_snapshot(self._encode_state(), snapshot)

    def raft_state_size(self) -> int:
        return self.persister.raft_state_size()

    def read_snapshot(self) -> bytes:
        return self.persister.read_snapshot()

    # ------------------------------------------------------------------
    # Persistence (reference: raft/raft.go:205-235)
    # ------------------------------------------------------------------

    def _encode_state(self) -> bytes:
        return codec.encode(
            PersistentState(
                current_term=self.current_term,
                voted_for=self.voted_for,
                entries=self.log.entries,
            )
        )

    def _persist(self) -> None:
        # Full-state re-persist on every mutation, as the reference does
        # (quirk #6, raft/raft.go:205-216); the snapshot blob is carried
        # forward so the pair stays consistent.
        snap = self.persister.read_snapshot()
        if snap:
            self.persister.save_state_and_snapshot(self._encode_state(), snap)
        else:
            self.persister.save_raft_state(self._encode_state())

    def _read_persist(self) -> None:
        data = self.persister.read_raft_state()
        if not data:
            return
        st: PersistentState = codec.decode(data)
        self.current_term = st.current_term
        self.voted_for = st.voted_for
        self.log = RaftLog(st.entries)

    # ------------------------------------------------------------------
    # Timers (reference: raft/raft.go:106-125 ticker)
    # ------------------------------------------------------------------

    def _reset_election_timer(self) -> None:
        if self._election_timer:
            self._election_timer.cancel()
        timeout = self.rng.uniform(*ELECTION_TIMEOUT)
        self._election_timer = self.sched.call_after(
            timeout, self._on_election_timeout
        )

    def _on_election_timeout(self) -> None:
        if self._killed:
            return
        if self.role != Role.LEADER:
            if self.prevote:
                self._start_prevote()
            else:
                self._start_election()
        self._reset_election_timer()

    def _start_prevote(self) -> None:
        """Non-binding probe at term+1: no term bump, no voted_for, no
        persistence.  A quorum of grants (self included) launches the
        real election; hearing a leader mid-round aborts it."""
        term = self.current_term
        started = self.sched.now
        granted = [1]
        if self._quorum(granted[0]):
            self._start_election()
            return
        args = RequestVoteArgs(
            term=term + 1,
            candidate_id=self.me,
            last_log_index=self.log.last_index,
            last_log_term=self.log.last_term,
            pre=True,
        )
        for p in range(len(self.peers)):
            if p == self.me:
                continue
            fut = self.peers[p].call("Raft.request_vote", args)
            fut.add_done_callback(
                lambda f, _t=term, _s=started, _g=granted: (
                    self._on_prevote_reply(_t, _s, _g, f.value)
                )
            )

    def _on_prevote_reply(
        self,
        term: int,
        started: float,
        granted: list,
        reply: Optional[RequestVoteReply],
    ) -> None:
        if self._killed or reply is None:
            return
        if reply.term > self.current_term:
            self._step_down(reply.term)
            return
        # Round still current?  Same term, still not leader, and no
        # leader heard since the round began (an accepted append aborts
        # the campaign, as etcd does on MsgApp/MsgHeartbeat).
        if (
            self.role == Role.LEADER
            or self.current_term != term
            or self._last_heard >= started
        ):
            return
        if reply.vote_granted:
            granted[0] += 1
            if self._quorum(granted[0]):
                self._start_election()

    def _start_heartbeats(self) -> None:
        if self._heartbeat_timer:
            self._heartbeat_timer.cancel()
        self._heartbeat_timer = self.sched.call_after(
            HEARTBEAT_INTERVAL, self._on_heartbeat
        )

    def _on_heartbeat(self) -> None:
        if self._killed or self.role != Role.LEADER:
            return
        self._broadcast_heartbeat()
        self._start_heartbeats()

    # ------------------------------------------------------------------
    # Election (reference: raft/raft_election.go)
    # ------------------------------------------------------------------

    def _record_role(self) -> None:
        """Flight-recorder hook: one fixed-width record per role/term
        transition (no-op when recording is disabled)."""
        fr = self._frec
        if fr is not None:
            fr.record(
                flightrec.ROLE, code=self.me, a=int(self.role),
                b=self.current_term, c=self.commit_index,
            )

    def _start_election(self) -> None:
        """(reference: raft/raft_election.go:4-51)"""
        self.role = Role.CANDIDATE
        self.current_term += 1
        self.voted_for = self.me
        self._record_role()
        self._persist()
        term = self.current_term
        granted = [1]  # own vote; list for closure mutation
        if self._quorum(granted[0]):
            self._become_leader()
            return
        args = RequestVoteArgs(
            term=term,
            candidate_id=self.me,
            last_log_index=self.log.last_index,
            last_log_term=self.log.last_term,
        )
        for p in range(len(self.peers)):
            if p == self.me:
                continue
            fut = self.peers[p].call("Raft.request_vote", args)
            fut.add_done_callback(
                lambda f, _term=term, _g=granted: self._on_vote_reply(
                    _term, _g, f.value
                )
            )

    def _on_vote_reply(
        self, term: int, granted: list, reply: Optional[RequestVoteReply]
    ) -> None:
        """(reference: raft/raft_election.go:27-49 closure)"""
        if self._killed or reply is None:
            return
        if reply.term > self.current_term:
            self._step_down(reply.term)
            return
        # Staleness guards: still the same candidacy?
        if self.role != Role.CANDIDATE or self.current_term != term:
            return
        if reply.vote_granted:
            granted[0] += 1
            if self._quorum(granted[0]):
                self._become_leader()

    def _quorum(self, n: int) -> bool:
        return n > len(self.peers) // 2

    def _become_leader(self) -> None:
        """(reference: raft/raft_election.go:30-41)"""
        trace("raft %d: leader at term %d", self.me, self.current_term)
        self.role = Role.LEADER
        self._record_role()
        last = self.log.last_index
        for p in range(len(self.peers)):
            self.next_index[p] = last + 1
            self.match_index[p] = 0
        self.match_index[self.me] = last
        self._broadcast_heartbeat()
        self._start_heartbeats()

    def _step_down(self, term: int) -> None:
        changed = term > self.current_term
        if changed and self.role is not Role.FOLLOWER:
            trace("raft %d: step down %d -> %d", self.me,
                  self.current_term, term)
        was_follower = self.role is Role.FOLLOWER
        self.current_term = max(self.current_term, term)
        if changed:
            self.voted_for = None
        self.role = Role.FOLLOWER
        if changed or not was_follower:
            self._record_role()
        if self._heartbeat_timer:
            self._heartbeat_timer.cancel()
        if changed:
            self._persist()

    def request_vote(self, args: RequestVoteArgs) -> RequestVoteReply:
        """RPC handler (reference: raft/raft_election.go:54-77).  A
        ``pre`` probe is non-binding: grant iff the proposed term would
        win, the log is up to date, and this voter is out of lease —
        never while leading, never after hearing a leader within the
        minimum election timeout."""
        if args.pre:
            grant = (
                self.role != Role.LEADER
                and args.term > self.current_term
                and (self.sched.now - self._last_heard) >= ELECTION_TIMEOUT[0]
                and self.log.up_to_date(args.last_log_index, args.last_log_term)
            )
            return RequestVoteReply(term=self.current_term, vote_granted=grant)
        if args.term > self.current_term:
            self._step_down(args.term)
        if args.term < self.current_term:
            return RequestVoteReply(term=self.current_term, vote_granted=False)
        grant = self.voted_for in (None, args.candidate_id) and self.log.up_to_date(
            args.last_log_index, args.last_log_term
        )
        if grant:
            self.voted_for = args.candidate_id
            self._persist()
            self._reset_election_timer()
            self._last_heard = self.sched.now
        return RequestVoteReply(term=self.current_term, vote_granted=grant)

    # ------------------------------------------------------------------
    # Replication (reference: raft/raft_append_entry.go)
    # ------------------------------------------------------------------

    def _broadcast_heartbeat(self) -> None:
        """Heartbeats bypass the replicator coalescing and fire
        immediately (reference: raft/raft_append_entry.go:9-12); the
        reply staleness guard tolerates the resulting concurrency."""
        for p in range(len(self.peers)):
            if p != self.me:
                self._append_one_round(p)

    def _kick_replicator(self, peer: int) -> None:
        """Coalesce bursts of Start() into one RPC per peer — the
        replicator-thread pattern (reference: raft/raft.go:134-150)."""
        if self._in_flight[peer]:
            self._pending[peer] = True
        else:
            self._append_one_round(peer)

    def _append_one_round(self, peer: int) -> None:
        """(reference: raft/raft_append_entry.go:20-65)"""
        if self._killed or self.role != Role.LEADER:
            return
        ni = self.next_index[peer]
        if ni - 1 < self.log.base:
            self._send_install_snapshot(peer)
            return
        args = AppendEntriesArgs(
            term=self.current_term,
            leader_id=self.me,
            prev_log_index=ni - 1,
            prev_log_term=self.log.term_at(ni - 1),
            entries=self.log.slice_from(ni) if ni <= self.log.last_index else [],
            leader_commit=self.commit_index,
        )
        self._in_flight[peer] = True
        fut = self.peers[peer].call("Raft.append_entries", args)
        fut.add_done_callback(
            lambda f, _a=args: self._on_append_reply(peer, _a, f.value)
        )

    def _on_append_reply(
        self,
        peer: int,
        args: AppendEntriesArgs,
        reply: Optional[AppendEntriesReply],
    ) -> None:
        """(reference: raft/raft_append_entry.go:66-88)"""
        self._in_flight[peer] = False
        if self._killed:
            return
        if reply is not None and reply.term > self.current_term:
            self._step_down(reply.term)
            return
        if self.role != Role.LEADER or self.current_term != args.term:
            return
        if reply is not None:
            if reply.success:
                match = args.prev_log_index + len(args.entries)
                if match > self.match_index[peer]:
                    self.match_index[peer] = match
                    self.next_index[peer] = match + 1
                    self._advance_commit()
            elif args.prev_log_index == self.next_index[peer] - 1:
                # Staleness guard (reference: raft/raft_append_entry.go:74):
                # only back off if this reply answers the current round.
                self.next_index[peer] = max(1, reply.conflict_index)
                self._pending[peer] = True
        if self._pending[peer]:
            self._pending[peer] = False
            self._append_one_round(peer)

    def _advance_commit(self) -> None:
        """Quorum-median commit advance with the current-term guard
        (reference: raft/raft_append_entry.go:89-105).  This scan *is*
        the north-star batched kernel: per-group median of match_index."""
        for i in range(self.log.last_index, self.commit_index, -1):
            if self.log.term_at(i) != self.current_term:
                break  # only current-term entries commit by counting
            count = sum(1 for p in range(len(self.peers)) if self.match_index[p] >= i)
            if self._quorum(count):
                self.commit_index = i
                self._schedule_apply()
                break

    def append_entries(self, args: AppendEntriesArgs) -> AppendEntriesReply:
        """RPC handler (reference: raft/raft_append_entry.go:108-162)."""
        if args.term < self.current_term:
            return AppendEntriesReply(term=self.current_term, success=False)
        self._step_down(args.term)
        self._reset_election_timer()
        self._last_heard = self.sched.now  # lease: a live leader spoke

        if args.prev_log_index < self.log.base:
            # Our snapshot already covers prev; tell the leader where we
            # begin (divergence from the Term=0 quirk, SURVEY §7.5 #5).
            return AppendEntriesReply(
                term=self.current_term,
                success=False,
                conflict_index=self.log.base + 1,
            )
        if not self.log.matches(args.prev_log_index, args.prev_log_term):
            # Conflict fast-backup (reference: raft/raft_append_entry.go:136-143).
            if args.prev_log_index > self.log.last_index:
                ci = self.log.last_index + 1
            else:
                ci = self.log.first_index_of_term(
                    self.log.term_at(args.prev_log_index), args.prev_log_index
                )
            return AppendEntriesReply(
                term=self.current_term, success=False, conflict_index=ci
            )

        # Append entries, truncating only at a genuine conflict so
        # duplicated/reordered messages are harmless
        # (reference: raft/raft_append_entry.go:146-155).
        changed = False
        for entry in args.entries:
            if entry.index <= self.log.base:
                continue
            if self.log.has(entry.index):
                if self.log.term_at(entry.index) == entry.term:
                    continue
                self.log.truncate_from(entry.index)
                changed = True
            # Replicated log: bounded by snapshot compaction, not here.
            self.log.entries.append(entry)  # graftlint: disable=unbounded-queue
            changed = True
        if changed:
            self._persist()

        # Follower commit advance
        # (reference: raft/raft_append_entry.go:157-160).
        upper = args.prev_log_index + len(args.entries)
        if args.leader_commit > self.commit_index:
            new_commit = min(args.leader_commit, upper)
            if new_commit > self.commit_index:
                self.commit_index = new_commit
                self._schedule_apply()
        return AppendEntriesReply(term=self.current_term, success=True)

    # ------------------------------------------------------------------
    # Snapshots (reference: raft/raft_snapshot.go)
    # ------------------------------------------------------------------

    def _send_install_snapshot(self, peer: int) -> None:
        """(reference: raft/raft_append_entry.go:27-39 +
        raft/raft_snapshot.go:56-69)"""
        args = InstallSnapshotArgs(
            term=self.current_term,
            leader_id=self.me,
            last_included_index=self.log.base,
            last_included_term=self.log.base_term,
            data=self.persister.read_snapshot(),
        )
        self._in_flight[peer] = True
        fut = self.peers[peer].call("Raft.install_snapshot", args)

        def on_reply(f, _a=args):
            self._in_flight[peer] = False
            reply: Optional[InstallSnapshotReply] = f.value
            if self._killed or reply is None:
                return
            if reply.term > self.current_term:
                self._step_down(reply.term)
                return
            if self.role != Role.LEADER or self.current_term != _a.term:
                return
            if _a.last_included_index > self.match_index[peer]:
                self.match_index[peer] = _a.last_included_index
                self.next_index[peer] = _a.last_included_index + 1
            if self._pending[peer]:
                self._pending[peer] = False
                self._append_one_round(peer)

        fut.add_done_callback(on_reply)

    def install_snapshot(self, args: InstallSnapshotArgs) -> InstallSnapshotReply:
        """RPC handler (reference: raft/raft_snapshot.go:15-54)."""
        if args.term < self.current_term:
            return InstallSnapshotReply(term=self.current_term)
        self._step_down(args.term)
        self._reset_election_timer()
        self._last_heard = self.sched.now  # lease: a live leader spoke
        if args.last_included_index <= self.commit_index:
            # Already have everything the snapshot covers.
            return InstallSnapshotReply(term=self.current_term)

        if self.log.has(args.last_included_index) and self.log.term_at(
            args.last_included_index
        ) == args.last_included_term:
            self.log.compact_to(args.last_included_index)
        else:
            self.log.compact_to(
                args.last_included_index, term=args.last_included_term
            )
        # Fast-forward: everything ≤ snapshot index is, by definition,
        # committed and applied once the service installs the blob
        # (reference: raft/raft_snapshot.go:40-49).
        self.commit_index = args.last_included_index
        self.last_applied = args.last_included_index
        self.persister.save_state_and_snapshot(self._encode_state(), args.data)
        # Surface the snapshot on the apply path *before* later entries
        # (ordering guarantee, reference: raft/raft_snapshot.go:51-53).
        self._pending_snapshot = ApplyMsg(
            snapshot_valid=True,
            snapshot=args.data,
            snapshot_index=args.last_included_index,
            snapshot_term=args.last_included_term,
        )
        self._schedule_apply()
        return InstallSnapshotReply(term=self.current_term)

    # ------------------------------------------------------------------
    # Applier (reference: raft/raft.go:153-203)
    # ------------------------------------------------------------------

    def _schedule_apply(self) -> None:
        if not self._apply_scheduled:
            self._apply_scheduled = True
            self.sched.call_soon(self._apply_loop)

    def _apply_loop(self) -> None:
        self._apply_scheduled = False
        if self._killed:
            return
        if self._pending_snapshot is not None:
            msg, self._pending_snapshot = self._pending_snapshot, None
            self.apply_fn(msg)
        while self.last_applied < self.commit_index and not self._killed:
            self.last_applied += 1
            entry = self.log.at(self.last_applied)
            self.apply_fn(
                ApplyMsg(
                    command_valid=True,
                    command=entry.command,
                    command_index=entry.index,
                    command_term=entry.term,
                )
            )
            if self._pending_snapshot is not None:
                # An InstallSnapshot landed mid-apply; surface it in order.
                msg, self._pending_snapshot = self._pending_snapshot, None
                self.apply_fn(msg)

    # ------------------------------------------------------------------

    def __repr__(self) -> str:  # debug aid (GetState2, raft/utility.go:26-39)
        return (
            f"<Raft {self.me} {self.role.name} t={self.current_term} "
            f"log=[{self.log.base}..{self.log.last_index}] "
            f"commit={self.commit_index} applied={self.last_applied}>"
        )
