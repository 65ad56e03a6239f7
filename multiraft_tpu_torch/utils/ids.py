"""Cross-process-unique client identity.

Clerk dedup tables are keyed by ``client_id`` and persist in snapshots
(and migrate between shard groups), so IDs must be unique across every
process that ever talks to a cluster — a per-process class counter (the
sim's original scheme) collides the moment two OS processes each create
their "first" clerk, and a PID qualifier collides again when the OS
recycles PIDs. A per-process random nonce has no such lifetime: 40 bits
of entropy per process, 24 bits of counter space within it.
"""

from __future__ import annotations

import secrets

__all__ = ["unique_client_id"]

_PROC_NONCE = secrets.randbits(40)


def unique_client_id(counter: int) -> int:
    """Globally unique clerk id from a process-local counter (< 2^24)."""
    return (_PROC_NONCE << 24) | counter
