"""Central configuration (the PyTorch port's copy of
``multiraft_tpu/utils/config.py``) — the "real config system" the reference lacks
(SURVEY §5.6: its knobs are constants scattered through the code:
heartbeat 90 ms raft/raft.go:42-44, election 300–600 ms raft/raft.go:
46-50, NShards=10 shardctrler/common.go:23, 99/100 ms service timeouts
kvraft/server.go:80 + kvraft/client.go:57, SnapShotInterval=10
raft/config.go:215, with ``maxraftstate`` the only runtime knob).

Everything is a frozen dataclass; ``Settings.default()`` reproduces the
reference's timing exactly.  The process-wide instance is
:func:`settings` (parsed once from ``MULTIRAFT_*`` environment
variables) — it is what the consumers actually read:

* ``raft.node`` takes its heartbeat/election timing from it,
* ``services.kvraft`` / ``shardctrler`` / ``shardkv`` take their
  server-wait, clerk-retry, config-poll, and snapshot thresholds,
* ``transport.network`` takes the whole labrpc fault model,
* :meth:`Settings.engine_config` derives the tick-domain
  :class:`~multiraft_tpu_torch.engine.core.EngineConfig` timing from the
  same wall-clock knobs (10 ms/tick).

Tests that need custom timing should pass explicit values or set the
environment before import; the cached instance keeps every layer's view
consistent within a process.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import TYPE_CHECKING, Any, Tuple

if TYPE_CHECKING:  # circular at runtime: engine.core reads settings()
    from ..engine.core import EngineConfig

__all__ = ["RaftTiming", "ServiceTiming", "FaultModel", "Settings", "settings"]


@dataclasses.dataclass(frozen=True)
class RaftTiming:
    heartbeat: float = 0.09  # (reference: raft/raft.go:42-44)
    election: Tuple[float, float] = (0.3, 0.6)  # (raft/raft.go:46-50)


@dataclasses.dataclass(frozen=True)
class ServiceTiming:
    server_wait: float = 0.099  # (reference: kvraft/server.go:80)
    clerk_retry: float = 0.1  # (reference: kvraft/client.go:57)
    config_poll: float = 0.08  # shardkv controller poll cadence
    snapshot_threshold: float = 0.8  # fraction of maxraftstate (fixed
    # from the reference's integer-division quirk, SURVEY §7.5 #1)


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """The labrpc fault constants (reference: labrpc/labrpc.go:221-312)."""

    drop_request: float = 0.1
    drop_reply: float = 0.1
    unreliable_delay: float = 0.026
    reorder_fraction: float = 2.0 / 3.0
    reorder_delay: Tuple[float, float] = (0.2, 2.6)
    dead_timeout: float = 0.1
    long_dead_timeout: float = 7.0


@dataclasses.dataclass(frozen=True)
class Settings:
    raft: RaftTiming = RaftTiming()
    service: ServiceTiming = ServiceTiming()
    faults: FaultModel = FaultModel()
    nshards: int = 10  # (reference: shardctrler/common.go:23)

    @staticmethod
    def default() -> "Settings":
        return Settings()

    @staticmethod
    def from_env(prefix: str = "MULTIRAFT_") -> "Settings":
        """Build Settings with every wall-clock/topology knob
        overridable from the environment:

        ========================  =================================
        MULTIRAFT_HEARTBEAT       raft heartbeat seconds
        MULTIRAFT_ELECTION_MIN    election timeout lower bound
        MULTIRAFT_ELECTION_MAX    election timeout upper bound
        MULTIRAFT_SERVER_WAIT     service wait-channel timeout
        MULTIRAFT_CLERK_RETRY     clerk per-RPC retry timeout
        MULTIRAFT_CONFIG_POLL     shardkv config poll cadence
        MULTIRAFT_SNAP_THRESHOLD  snapshot trigger fraction
        MULTIRAFT_NSHARDS         shard count
        ========================  =================================
        """

        def f(name: str, cur: float) -> float:
            v = os.environ.get(prefix + name)
            return float(v) if v else cur

        s = Settings()
        raft = RaftTiming(
            heartbeat=f("HEARTBEAT", s.raft.heartbeat),
            election=(
                f("ELECTION_MIN", s.raft.election[0]),
                f("ELECTION_MAX", s.raft.election[1]),
            ),
        )
        service = ServiceTiming(
            server_wait=f("SERVER_WAIT", s.service.server_wait),
            clerk_retry=f("CLERK_RETRY", s.service.clerk_retry),
            config_poll=f("CONFIG_POLL", s.service.config_poll),
            snapshot_threshold=f(
                "SNAP_THRESHOLD", s.service.snapshot_threshold
            ),
        )
        return dataclasses.replace(
            s,
            raft=raft,
            service=service,
            nshards=int(f("NSHARDS", s.nshards)),
        )

    def engine_config(self, tick_s: float = 0.01, **overrides: Any) -> "EngineConfig":
        """Derive the batched engine's tick-domain timing from these
        wall-clock knobs (SURVEY §2.2's 10 ms/tick mapping), keeping
        the two backends' timing in one place.  ``overrides`` pass
        through to :class:`~multiraft_tpu_torch.engine.core.EngineConfig`
        (shapes, ``use_kernels`` — the reference's ``use_pallas`` —,
        prevote, ...)."""
        from ..engine.core import EngineConfig

        timing = dict(
            HB_TICKS=max(1, round(self.raft.heartbeat / tick_s)),
            ELECT_MIN=max(2, round(self.raft.election[0] / tick_s)),
            ELECT_MAX=max(3, round(self.raft.election[1] / tick_s)),
        )
        timing.update(overrides)
        return EngineConfig(**timing)


@functools.lru_cache(maxsize=None)
def settings() -> Settings:
    """The process-wide Settings instance (parsed from the environment
    once; every consumer layer reads this so their views agree)."""
    return Settings.from_env()
