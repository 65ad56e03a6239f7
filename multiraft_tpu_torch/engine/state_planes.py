"""Declared state-plane classification for the engine's tensors.

A copy of ``multiraft_tpu/engine/state_planes.py`` for the PyTorch
port, over the port's ``EngineState`` and ``Mailbox``.  The
classification is the single declared source of truth for the sites
that handle a plane by its lifecycle: checkpoint save/restore
(``EngineDriver.CKPT_VERSION``), crash-restart resets
(``restart_replica``), fresh-incarnation wipes (``reset_replica``) and
the cross-replica column clears.  The schema fingerprints are the
reference's: the same fields in the same order give the same digest,
and :func:`content_fingerprint` gives the same digest for equal planes
in either package.

Plane vocabulary (raft/raft.go persist discipline, tensorized):

* ``PERSISTENT`` — survives a crash-restart (term, vote, log shape,
  snapshot floor).  ``restart_replica`` must never touch these.
* ``VOLATILE`` — knowledge rebuilt from traffic (commit/applied
  frontiers, liveness).  ``restart_replica`` must reset all of these.
* ``LEADERSHIP`` — vote tallies, replication ledgers and timers that
  are reseeded at role transitions; ``restart_replica`` MAY reset them
  (it resets the tallies and the check-quorum clock, and leaves the
  timers to the follower transition).
* ``CONFIG`` — joint-consensus membership view, managed only by the
  config-change ops (add_learner/begin_joint); neither lifecycle
  function touches it.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Tuple

__all__ = [
    "PERSISTENT",
    "VOLATILE",
    "LEADERSHIP",
    "CONFIG",
    "STATE_PLANES",
    "MAILBOX_PLANES",
    "CROSS_COLUMNS",
    "GLOBAL_FIELDS",
    "check_classification",
    "state_fingerprint",
    "mailbox_fingerprint",
    "content_fingerprint",
]

PERSISTENT = "persistent"
VOLATILE = "volatile"
LEADERSHIP = "leadership"
CONFIG = "config"

# EngineState field -> plane.  Every field of the NamedTuple in
# engine/core.py must appear exactly once (plane-class enforces it).
STATE_PLANES: Dict[str, str] = {
    # Engine-global tick clock: checkpointed, never per-replica reset.
    "tick_no": PERSISTENT,
    # raft/raft.go persist(): currentTerm, votedFor, log.
    "term": PERSISTENT,
    "voted_for": PERSISTENT,
    "base": PERSISTENT,
    "base_term": PERSISTENT,
    "log_len": PERSISTENT,
    "log_term": PERSISTENT,
    # Rebuilt from traffic after a restart.
    "role": VOLATILE,
    "commit": VOLATILE,
    "applied": VOLATILE,
    "last_heard": VOLATILE,
    "alive": VOLATILE,
    # Reseeded at role transitions (become_leader/become_candidate).
    "votes": LEADERSHIP,
    "pre_votes": LEADERSHIP,
    "last_ack": LEADERSHIP,
    "next_idx": LEADERSHIP,
    "match_idx": LEADERSHIP,
    "hb_due": LEADERSHIP,
    "elect_dl": LEADERSHIP,
    # Joint-consensus membership view (config ops only).
    "voters_old": CONFIG,
    "voters_new": CONFIG,
    "joint": CONFIG,
    "cfg_epoch": CONFIG,
    "cfg_idx": CONFIG,
}

# Mailbox fields are all in-flight message state: volatile by
# construction (restart/reset drop the edges via membership.drop_edges
# rather than per-field), including the config piggyback lanes — the CONFIG
# *planes* live in EngineState; the ar_cfg_* lanes merely carry them.
MAILBOX_PLANES: Dict[str, str] = {
    "vr_active": VOLATILE,
    "vr_term": VOLATILE,
    "vr_last_idx": VOLATILE,
    "vr_last_term": VOLATILE,
    "vr_pre": VOLATILE,
    "vp_active": VOLATILE,
    "vp_term": VOLATILE,
    "vp_granted": VOLATILE,
    "vp_pre": VOLATILE,
    "ar_active": VOLATILE,
    "ar_term": VOLATILE,
    "ar_prev_idx": VOLATILE,
    "ar_prev_term": VOLATILE,
    "ar_n": VOLATILE,
    "ar_terms": VOLATILE,
    "ar_commit": VOLATILE,
    "ar_snap": VOLATILE,
    "ap_active": VOLATILE,
    "ap_term": VOLATILE,
    "ap_success": VOLATILE,
    "ap_match": VOLATILE,
    "ap_conflict": VOLATILE,
    "ar_cfg_epoch": VOLATILE,
    "ar_cfg_idx": VOLATILE,
    "ar_cfg_old": VOLATILE,
    "ar_cfg_new": VOLATILE,
    "ar_cfg_joint": VOLATILE,
}

# Fields holding per-peer state ABOUT a replica in their last axis:
# reset_replica must clear the [g, :, p] column too, or a stale vote /
# match / ack of the dead incarnation leaks into the new one's ledger
# (the regression that reset_replica's column clears fix).
CROSS_COLUMNS: Tuple[str, ...] = (
    "votes",
    "pre_votes",
    "next_idx",
    "match_idx",
    "last_ack",
)

# Engine-global scalars with no per-replica row: exempt from the
# reset_replica must-wipe set.
GLOBAL_FIELDS: Tuple[str, ...] = ("tick_no",)


def check_classification() -> list:
    """Runtime registry-vs-NamedTuple drift problems (empty = clean).
    The static ``plane-class`` rule does the same against the AST; the
    unit test runs this against the imported classes."""
    from .core import EngineState, Mailbox

    problems = []
    for cls, planes, label in (
        (EngineState, STATE_PLANES, "STATE_PLANES"),
        (Mailbox, MAILBOX_PLANES, "MAILBOX_PLANES"),
    ):
        fields = set(cls._fields)
        declared = set(planes)
        for f in sorted(fields - declared):
            problems.append(f"{cls.__name__}.{f} unclassified in {label}")
        for f in sorted(declared - fields):
            problems.append(f"{label}[{f!r}] names no {cls.__name__} field")
        for f, plane in planes.items():
            if plane not in (PERSISTENT, VOLATILE, LEADERSHIP, CONFIG):
                problems.append(f"{label}[{f!r}] = {plane!r} is not a plane")
    for f in CROSS_COLUMNS:
        if STATE_PLANES.get(f) != LEADERSHIP:
            problems.append(
                f"CROSS_COLUMNS field {f!r} must be a LEADERSHIP plane"
            )
    return problems


def _fingerprint(fields: Tuple[str, ...], planes: Dict[str, str]) -> str:
    """Order-sensitive digest of the classified field list: checkpoint
    arrays are saved by field name but restored positionally validated,
    so both the set AND the order are schema."""
    h = hashlib.sha256()
    for f in fields:
        h.update(f"{f}={planes.get(f, '?')};".encode())
    return h.hexdigest()[:16]


def state_fingerprint() -> str:
    from .core import EngineState

    return _fingerprint(EngineState._fields, STATE_PLANES)


def mailbox_fingerprint() -> str:
    from .core import Mailbox

    return _fingerprint(Mailbox._fields, MAILBOX_PLANES)


def content_fingerprint(nt) -> str:
    """sha256 over the VALUE bytes of every field of an ``EngineState``
    or ``Mailbox`` instance, in field order (name + dtype + raw bytes
    per field).  Where :func:`state_fingerprint` pins the SCHEMA, this
    witnesses the CONTENT: equal planes give the reference's digest.
    Copies every plane to the host: test/diagnostic use only."""
    h = hashlib.sha256()
    for name, value in zip(type(nt)._fields, nt):
        a = value.detach().cpu().numpy()
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]
