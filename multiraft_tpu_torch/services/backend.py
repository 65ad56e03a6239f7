"""The ConsensusEngine interface — services over pluggable backends.

SURVEY §7.1: services consume a consensus interface with two backends —
the event-driven simulation (:class:`~multiraft_tpu_torch.raft.node.RaftNode`,
the correctness oracle, default for the fault-injection test pyramid)
and the batched engine (:mod:`multiraft_tpu_torch.engine`, the throughput
path).  This module pins down that contract.

Two styles exist because the backends have different latency models:

* **Synchronous proposal** (sim backend): ``start()`` returns
  ``(index, term, is_leader)`` immediately — the service can key its
  wait-continuation on the index (kvraft/shardctrler/shardkv do this).
* **Deferred proposal** (batched engine): proposals are accepted by the
  next device tick; ``start()`` hands back a ticket resolved with the
  assigned index when the tick's acceptance readback lands.  Services
  written against :class:`DeferredConsensus` (see
  ``multiraft_tpu_torch.engine.kv.BatchedKV``) work on both, treating the sim
  backend as a zero-tick device.

Apply-path contract (both backends): committed commands are delivered
exactly once, in index order, via the apply callback, interleaved with
snapshot installs that always respect the ordering guarantee
(reference: raft/raft_snapshot.go:51-53).
"""

from __future__ import annotations

from typing import Any, Protocol, Tuple, runtime_checkable

__all__ = ["SyncConsensus", "DeferredConsensus"]


@runtime_checkable
class SyncConsensus(Protocol):
    """What kvraft/shardctrler/shardkv require of their consensus
    instance.  ``RaftNode`` conforms (raft/node.py)."""

    def start(self, command: Any) -> Tuple[int, int, bool]:
        """Propose; returns (index, term, is_leader)."""
        ...

    def get_state(self) -> Tuple[int, bool]:
        ...

    def snapshot(self, index: int, snapshot: bytes) -> None:
        ...

    def raft_state_size(self) -> int:
        ...

    def kill(self) -> None:
        ...


@runtime_checkable
class DeferredConsensus(Protocol):
    """Batch-friendly proposal surface: the engine accepts proposals at
    tick granularity.  ``EngineDriver`` + ``BatchedKV`` implement this
    shape (engine/host.py, engine/kv.py)."""

    def submit(self, group: int, command: Any) -> Any:
        """Queue a proposal for ``group``; returns a ticket whose
        completion carries the applied result."""
        ...

    def pump(self, n_ticks: int = 1) -> None:
        """Advance consensus and deliver apply callbacks."""
        ...
