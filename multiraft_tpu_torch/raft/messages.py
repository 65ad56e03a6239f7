"""Raft message schemas (reference: raft/raft_rpc.go:3-95).

The reference carries several dead fields (``Entry.Id``,
``AppendEntriesReply.Conflict``, ``RequestVoteReply.State``,
``ClientMessageArgs/Reply`` — raft/raft_rpc.go:43,65,81,46-53); they are
deliberately not reproduced.  These dataclasses are also the wire schema
the batched engine packs into dense ``(groups, peers)`` tensors — every
field here is either a small integer (device-resident) or an opaque
payload (host-resident), and the split is annotated per message.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, List, Optional

from ..transport import codec


class Role(enum.IntEnum):
    """Peer role (reference: raft/raft_rpc.go state enums)."""

    FOLLOWER = 0
    CANDIDATE = 1
    LEADER = 2


@codec.registered
@dataclasses.dataclass
class Entry:
    """One log entry.  ``index``/``term`` live on device in the batched
    engine; ``command`` stays host-side keyed by (group, index)."""

    index: int = 0
    term: int = 0
    command: Any = None


@codec.registered
@dataclasses.dataclass
class ApplyMsg:
    """Commit notification to the service layer
    (reference: raft/raft_rpc.go:26-41)."""

    command_valid: bool = False
    command: Any = None
    command_index: int = 0
    command_term: int = 0

    snapshot_valid: bool = False
    snapshot: Any = None
    snapshot_index: int = 0
    snapshot_term: int = 0


@codec.registered
@dataclasses.dataclass
class RequestVoteArgs:
    """(reference: raft/raft_rpc.go RequestVote args)"""

    term: int = 0
    candidate_id: int = -1
    last_log_index: int = 0
    last_log_term: int = 0
    # Non-binding PreVote probe (opt-in; see RaftNode(prevote=True)):
    # ``term`` then carries the PROPOSED term (candidate's term + 1).
    pre: bool = False


@codec.registered
@dataclasses.dataclass
class RequestVoteReply:
    term: int = 0
    vote_granted: bool = False


@codec.registered
@dataclasses.dataclass
class AppendEntriesArgs:
    """(reference: raft/raft_rpc.go AppendEntries args).  In the batched
    engine this becomes a fixed-width record: entries are (start, count)
    plus a terms slice of max width E."""

    term: int = 0
    leader_id: int = -1
    prev_log_index: int = 0
    prev_log_term: int = 0
    entries: List[Entry] = dataclasses.field(default_factory=list)
    leader_commit: int = 0


@codec.registered
@dataclasses.dataclass
class AppendEntriesReply:
    """``conflict_index`` implements the term-skipping fast backup
    (reference: raft/raft_append_entry.go:136-143).  Divergence from the
    reference, documented: when ``prev_log_index`` falls below the
    follower's snapshot base the reference replies Term=0 (quirk;
    raft/raft_append_entry.go:123-127) — we reply with the real term and
    ``conflict_index = base + 1``."""

    term: int = 0
    success: bool = False
    conflict_index: int = 0


@codec.registered
@dataclasses.dataclass
class InstallSnapshotArgs:
    """(reference: raft/raft_rpc.go InstallSnapshot args).  ``data`` is
    the service snapshot blob — host-side in the batched engine."""

    term: int = 0
    leader_id: int = -1
    last_included_index: int = 0
    last_included_term: int = 0
    data: Any = None


@codec.registered
@dataclasses.dataclass
class InstallSnapshotReply:
    term: int = 0


@codec.registered
@dataclasses.dataclass
class PersistentState:
    """What survives a crash (reference: raft/raft.go:205-235): term,
    vote, and the full log including the dummy head entry that carries
    (last_snapshot_index, last_snapshot_term)."""

    current_term: int = 0
    voted_for: Optional[int] = None
    entries: List[Entry] = dataclasses.field(default_factory=list)
