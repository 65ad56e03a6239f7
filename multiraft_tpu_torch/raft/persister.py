"""Durable-state store (reference: raft/persister.go).

In-memory byte slices with an atomic (state, snapshot) pair save and a
``copy()`` used by the crash/restart fixture to hand the reborn server
exactly what its predecessor persisted
(reference: raft/persister.go:57-64, raft/config.go:113-142).

This is the test/bench store; a real deployment plugs a durable backend
behind the same five methods.
"""

from __future__ import annotations


__all__ = ["Persister"]


class Persister:
    def __init__(self) -> None:
        self._raft_state: bytes = b""
        self._snapshot: bytes = b""

    def copy(self) -> "Persister":
        p = Persister()
        p._raft_state = self._raft_state
        p._snapshot = self._snapshot
        return p

    def save_raft_state(self, state: bytes) -> None:
        self._raft_state = state

    def read_raft_state(self) -> bytes:
        return self._raft_state

    def raft_state_size(self) -> int:
        return len(self._raft_state)

    def save_state_and_snapshot(self, state: bytes, snapshot: bytes) -> None:
        """Atomic pair save so the service snapshot can never run ahead of
        the raft state it corresponds to (reference: raft/persister.go:57-64)."""
        self._raft_state = state
        self._snapshot = snapshot

    def read_snapshot(self) -> bytes:
        return self._snapshot

    def snapshot_size(self) -> int:
        return len(self._snapshot)
