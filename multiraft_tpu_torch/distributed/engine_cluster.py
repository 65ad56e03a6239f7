"""Engine-backed multi-process clusters (PyTorch port of
``multiraft_tpu/distributed/engine_cluster.py``): one process per
CARD-OWNING engine rather than one per replica server.  Four
deployment shapes:

* :class:`EngineProcessCluster` — one engine process serving G groups
  (plain KV), optionally durable (checkpoint + WAL) and mesh-sharded;
* :class:`EngineFleetCluster` — several engine shard processes
  splitting one global gid space, migration riding
  pull_shard/delete_shard RPCs between them;
* :class:`SplitProcessCluster` — processes SHARING each replica
  group's peer slots (engine/split.py): a process death loses single
  peers, surviving quorums keep serving;
* :class:`SplitShardProcessCluster` — the sharded stack with split
  peer slots (engine/split_shard.py): per-process failure domains
  WHILE shard migration continues.

Launch/readiness plumbing lives in launch.py; the blocking clerk
facades here wrap the engine clerks.  Every cluster's processes run
their engines on ``device``: ``"cuda"`` (the default) owns the card,
and a child without one fails before its readiness line; ``"cpu"`` is
for tests.
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import Any, Dict, List, Optional, Sequence

from ..sim.scheduler import TIMEOUT
from .launch import (
    BlockingClerkBase as _BlockingClerkBase,
    check_ready as _check_ready,
    launch_server as _launch_server,
    reserve_ports as _reserve_ports,
)
from .tcp import RpcNode

__all__ = [
    "EngineProcessCluster",
    "EngineFleetCluster",
    "SplitProcessCluster",
    "SplitShardProcessCluster",
    "BlockingEngineClerk",
    "BlockingFleetClerk",
    "BlockingSplitClerk",
    "BlockingSplitShardClerk",
]


class EngineProcessCluster:
    """One card-owning engine server process (kind ``engine_kv`` or
    ``engine_shardkv``) + blocking clerks — the engine-backed network
    cluster (SURVEY §2.2's sidecar story, step 1: a single front door
    coalescing clerk RPCs into device ticks).  Unlike the per-replica
    ``KVProcessCluster``, consensus replication happens ON THE CARD across
    the engine's (G, P) lanes; the network carries client traffic only.
    """

    def __init__(
        self,
        kind: str = "engine_kv",
        groups: int = 64,
        host: str = "127.0.0.1",
        seed: int = 0,
        join_gids: Optional[List[int]] = None,
        data_dir: Optional[str] = None,
        checkpoint_every_s: float = 30.0,
        mesh_devices: int = 0,
        chaos_seed: Optional[int] = None,
        device: str = "cuda",
    ) -> None:
        assert kind in ("engine_kv", "engine_shardkv")
        self.kind = kind
        self.host = host
        self.spec = {
            "kind": kind,
            "ports": _reserve_ports(1, host),
            "groups": groups,
            "seed": seed,
            "device": device,
        }
        if chaos_seed is not None:
            # Fault-injection mode: the server installs chaos hooks +
            # the "Chaos" control RPC (harness/nemesis.py drives it).
            self.spec["chaos_seed"] = int(chaos_seed)
        if join_gids is not None:
            self.spec["join_gids"] = list(join_gids)
        if data_dir is not None:
            # Durable mode: checkpoint + WAL under data_dir; kill() +
            # start() then recovers every acknowledged op.
            self.spec["data_dir"] = data_dir
            self.spec["checkpoint_every_s"] = checkpoint_every_s
        if mesh_devices:
            # Multi-card mode: the engine splits its groups over this
            # many shards (CPU shards when device is "cpu").
            self.spec["mesh_devices"] = mesh_devices
        self.proc: Optional[subprocess.Popen] = None

    @property
    def port(self) -> int:
        return self.spec["ports"][0]

    def start(self) -> None:
        assert self.proc is None or self.proc.poll() is not None
        self.proc = _launch_server(self.spec, "engine")
        _check_ready(self.proc, "engine", timeout=300.0)

    def kill(self) -> None:
        """SIGKILL the server process (literal crash; restart with
        :meth:`start` — durable mode recovers from data_dir)."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def clerk(self, lane: str = "") -> "BlockingEngineClerk":
        """``lane="verify"`` marks the clerk's traffic for the server's
        admission exemption (porcupine samplers must keep sampling
        while user traffic sheds)."""
        return BlockingEngineClerk(
            self.port, host=self.host,
            service="EngineKV" if self.kind == "engine_kv"
            else "EngineShardKV",
            lane=lane,
        )

    def shutdown(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.proc = None


class _SplitClusterBase:
    """Shared driver for the split deployments (plain KV and sharded):
    spec construction, the durable-vs-stay-dead crash discipline, and
    process lifecycle live exactly once here; subclasses pin the server
    kind, the label, and the clerk.

    ``owners[g][p]`` = process index owning peer slot ``p`` of group
    ``g`` (same map for every process).  ``delay_elections[i]`` biases
    process ``i``'s first election deadlines later — tests use it to
    park initial leadership on a chosen process.  Without ``data_dir``,
    replication across surviving quorums IS the durability and a
    killed member must stay dead (a fresh-state restart under an old
    peer identity can double-vote, engine/split.py's crash-model
    note); with it, each process is durable under its peer identity
    (SplitPersistence) and ``kill(i)`` + ``start(i)`` REJOINS from the
    persisted term/vote/log + service redo log."""

    KIND: str
    LABEL: str

    def __init__(
        self,
        owners: Dict[int, Sequence[int]],
        n_procs: int,
        groups: int,
        host: str = "127.0.0.1",
        seed: int = 0,
        delay_elections: Optional[Sequence[int]] = None,
        data_dir: Optional[str] = None,
        snapshot_every_s: float = 30.0,
        chaos_seed: Optional[int] = None,
        device: str = "cuda",
    ) -> None:
        from . import engine_server  # noqa: F401  (codec registration)
        from . import split_server  # noqa: F401
        from . import split_shard_server  # noqa: F401

        self.host = host
        self.ports = _reserve_ports(n_procs, host)
        self.specs = []
        for i in range(n_procs):
            spec = {
                "kind": self.KIND,
                "me": i,
                "host": host,
                "ports": self.ports,
                "owners": {str(g): list(o) for g, o in owners.items()},
                "groups": groups,
                "seed": seed + i,
                "delay_elections": (
                    int(delay_elections[i]) if delay_elections else 0
                ),
                "device": device,
            }
            if data_dir is not None:
                spec["data_dir"] = os.path.join(data_dir, f"proc-{i}")
                spec["snapshot_every_s"] = snapshot_every_s
            if chaos_seed is not None:
                # Distinct per-process streams from one harness seed.
                spec["chaos_seed"] = int(chaos_seed) + i
            self.specs.append(spec)
        self.durable = data_dir is not None
        self._killed: set = set()
        self.procs: List[Optional[subprocess.Popen]] = [None] * n_procs

    def start(self, i: int) -> None:
        assert self.procs[i] is None or self.procs[i].poll() is not None
        # Restarting a previously-killed member is only safe in durable
        # mode (the double-vote hazard — see the class docstring).
        assert self.durable or i not in self._killed, (
            f"process {i} was killed; a non-durable split peer must "
            "stay dead (pass data_dir= for safe rejoin)"
        )
        self.procs[i] = _launch_server(self.specs[i], f"{self.LABEL}-{i}")
        _check_ready(self.procs[i], f"{self.LABEL}-{i}", timeout=300.0)

    def start_all(self) -> None:
        assert self.durable or not self._killed, (
            f"processes {sorted(self._killed)} were killed; a "
            "non-durable split peer must stay dead (pass data_dir= "
            "for safe rejoin)"
        )
        for i, spec in enumerate(self.specs):
            self.procs[i] = _launch_server(spec, f"{self.LABEL}-{i}")
        for i, p in enumerate(self.procs):
            _check_ready(p, f"{self.LABEL}-{i}", timeout=300.0)

    def kill(self, i: int) -> None:
        """SIGKILL process ``i``.  Durable mode: :meth:`start` rejoins
        it from its data_dir; non-durable: it must stay dead."""
        p = self.procs[i]
        if p is not None and p.poll() is None:
            p.kill()
            p.wait()
        self.procs[i] = None
        self._killed.add(i)

    def shutdown(self) -> None:
        for i in range(len(self.procs)):
            self.kill(i)


class SplitProcessCluster(_SplitClusterBase):
    """Several engine processes SHARING each replica group's peer slots
    (engine/split.py + distributed/split_server.py) — one process's
    death loses only its owned peer slots; any group whose surviving
    slots hold a quorum keeps serving with every acknowledged write
    intact.  Contrast :class:`EngineFleetCluster`, which partitions
    whole gids per process.  Crash/durability discipline:
    :class:`_SplitClusterBase`."""

    KIND = "split_kv"
    LABEL = "split"

    def __init__(self, owners, n_procs, groups: int = 8, **kw) -> None:
        super().__init__(owners, n_procs, groups, **kw)

    def clerk(self) -> "BlockingSplitClerk":
        return BlockingSplitClerk(self.ports, host=self.host)


class BlockingSplitClerk(_BlockingClerkBase):
    """Blocking client of a :class:`SplitProcessCluster`."""

    def __init__(
        self, ports: Sequence[int], host: str = "127.0.0.1"
    ) -> None:
        from .split_server import SplitNetClerk

        self.node = RpcNode()
        self.sched = self.node.sched
        ends = [self.node.client_end(host, p) for p in ports]
        self._clerk = SplitNetClerk(self.sched, ends)


class SplitShardProcessCluster(_SplitClusterBase):
    """Several engine processes SHARING the sharded stack's peer slots
    (engine/split_shard.py + distributed/split_shard_server.py): the
    config RSM and every replica group survive any minority-owner
    process death — including mid-migration (the reference shardkv
    failure model, shardkv/config.go:204-262, at the process level).
    Crash/durability discipline: :class:`_SplitClusterBase`."""

    KIND = "split_shardkv"
    LABEL = "splitshard"

    def __init__(self, owners, n_procs, groups: int = 3, **kw) -> None:
        super().__init__(owners, n_procs, groups, **kw)

    def clerk(self) -> "BlockingSplitShardClerk":
        return BlockingSplitShardClerk(self.ports, host=self.host)


class BlockingSplitShardClerk(_BlockingClerkBase):
    """Blocking client of a :class:`SplitShardProcessCluster`, with
    the admin (join/leave/move) and status probes exposed."""

    def __init__(
        self, ports: Sequence[int], host: str = "127.0.0.1"
    ) -> None:
        from .split_shard_server import SplitShardNetClerk

        self.node = RpcNode()
        self.sched = self.node.sched
        ends = [self.node.client_end(host, p) for p in ports]
        self._clerk = SplitShardNetClerk(self.sched, ends)

    def admin(self, kind: str, payload, timeout: float = 60.0) -> None:
        self._run(self._clerk.admin(kind, payload), timeout)

    def status(self, proc: int, timeout: float = 10.0):
        return self._run(self._clerk.status(proc), timeout)


class EngineFleetCluster:
    """Several card-owning engine shard processes splitting one global
    gid space — SURVEY §2.2's end state at the process level: clerk
    traffic and shard migration ride the real network BETWEEN engines,
    consensus stays on each process's device.

    ``assignment[i]`` is the gid list process ``i`` hosts.  Admin ops
    are mirrored to every process in issue order with an explicit
    command id, so retries cannot fork the fleet's config histories.
    """

    def __init__(
        self,
        assignment: Sequence[Sequence[int]],
        host: str = "127.0.0.1",
        seed: int = 0,
        data_dir: Optional[str] = None,
        checkpoint_every_s: float = 30.0,
        mesh_devices: int = 0,
        chaos_seed: Optional[int] = None,
        spare_slots: int = 0,
        replicas: int = 3,
        voters: Optional[Sequence[int]] = None,
        shipping: bool = False,
        ship_sync: Optional[bool] = None,
        ship_window_s: Optional[float] = None,
        device: str = "cuda",
    ) -> None:
        # Registers the wire dataclasses (EngineCmdArgs/Reply) with the
        # codec — admin replies are refused as unregistered otherwise.
        from . import engine_server  # noqa: F401

        self.host = host
        self.assignment = [list(g) for g in assignment]
        self.ports = _reserve_ports(len(self.assignment), host)
        self.owner_addrs = {}
        for i, gl in enumerate(self.assignment):
            for g in gl:
                self.owner_addrs[g] = (host, self.ports[i])
        self.specs = []
        for i, gl in enumerate(self.assignment):
            spec = {
                "kind": "engine_fleet",
                "ports": [self.ports[i]],
                "gids": gl,
                "peer_addrs": {
                    str(g): list(a) for g, a in self.owner_addrs.items()
                    if g not in gl
                },
                "seed": seed + i,
                "device": device,
            }
            if spare_slots:
                # Idle engine groups the placement controller adopts
                # migrated gids into (harness/fleet.py).
                spec["spare_slots"] = int(spare_slots)
            if replicas != 3 or voters is not None:
                # Spare engine REPLICA slots (self-healing replica
                # sets): P=replicas rows per group, only ``voters``
                # vote; the controller replaces a permanently dead
                # voter by seating a learner in a spare row.
                spec["replicas"] = int(replicas)
                if voters is not None:
                    spec["voters"] = [int(q) for q in voters]
            if data_dir is not None:
                spec["data_dir"] = os.path.join(data_dir, f"proc-{i}")
                spec["checkpoint_every_s"] = checkpoint_every_s
            if mesh_devices:
                # Each process splits its engine over this many shards.
                spec["mesh_devices"] = mesh_devices
            if chaos_seed is not None:
                # Distinct per-process streams from one harness seed.
                spec["chaos_seed"] = int(chaos_seed) + i
            if shipping:
                # Durable state plane (distributed/stateplane.py): each
                # process ships hosted-group snapshots+tails to standby
                # processes, bounding failover data loss to the shipping
                # window (MRT_SHIP_WINDOW_S; ship_sync=True → zero
                # acknowledged-write loss).
                spec["fleet_addrs"] = {
                    str(j): [host, self.ports[j]]
                    for j in range(len(self.assignment))
                }
                spec["me"] = i
                if ship_sync is not None:
                    spec["ship_sync"] = bool(ship_sync)
                if ship_window_s is not None:
                    spec["ship_window_s"] = float(ship_window_s)
            self.specs.append(spec)
        self.procs: List[Optional[subprocess.Popen]] = [None] * len(self.specs)
        self._admin_node: Optional[RpcNode] = None
        self._admin_cmd = 0
        self._admin_inflight = None  # ((kind, repr(arg)), cmd) being retried

    def start_all(self) -> None:
        # Launch all processes first (start-up and warm-up run in
        # parallel), then collect readiness lines.
        for i, spec in enumerate(self.specs):
            self.procs[i] = _launch_server(spec, f"fleet-{i}")
        for i, p in enumerate(self.procs):
            _check_ready(p, f"fleet-{i}", timeout=300.0)

    def kill(self, i: int) -> None:
        """SIGKILL fleet process ``i`` (its gids go dark until
        :meth:`start` revives it — from its data_dir in durable mode)."""
        p = self.procs[i]
        if p is not None and p.poll() is None:
            p.kill()
            p.wait()

    def start(self, i: int) -> None:
        """(Re)start fleet process ``i`` on its original spec/ports."""
        assert self.procs[i] is None or self.procs[i].poll() is not None
        self.procs[i] = _launch_server(self.specs[i], f"fleet-{i}")
        _check_ready(self.procs[i], f"fleet-{i}", timeout=300.0)

    def admin(self, kind: str, arg: Any, timeout: float = 60.0) -> None:
        """Mirror one config op to every process (same order, same
        command id → identical config histories; see the service's
        ``admin`` docstring for why the id is mandatory here).

        Retryable after a TimeoutError: re-issuing the SAME (kind, arg)
        reuses the interrupted attempt's command id, so processes that
        already applied it dedup instead of applying twice (a fresh id
        on retry would fork the fleet's config numbering)."""
        if self._admin_node is None:
            self._admin_node = RpcNode()
        op_key = (kind, repr(arg))
        if self._admin_inflight and self._admin_inflight[0] == op_key:
            cmd = self._admin_inflight[1]  # resume the interrupted op
        else:
            self._admin_cmd += 1
            cmd = self._admin_cmd
            self._admin_inflight = (op_key, cmd)
        sched = self._admin_node.sched
        deadline = time.monotonic() + timeout
        for i, port in enumerate(self.ports):
            # Skip processes that are not running: mirroring an admin op
            # to a killed process would spin until the deadline, and a
            # placed fleet keeps serving while the controller re-places
            # the dead process's gids.
            p = self.procs[i]
            if p is None or p.poll() is not None:
                continue
            end = self._admin_node.client_end(self.host, port)
            while True:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"fleet admin {kind} timed out")
                reply = sched.wait(
                    end.call("EngineShardKV.admin", (kind, arg, cmd)),
                    6.0,
                )
                if (
                    reply is not None
                    and reply is not TIMEOUT
                    and getattr(reply, "err", None) == "OK"
                ):
                    break  # committed on this process; next one
        self._admin_inflight = None

    def clerk(self) -> "BlockingFleetClerk":
        return BlockingFleetClerk(self.owner_addrs)

    def shutdown(self) -> None:
        if self._admin_node is not None:
            self._admin_node.close()
            self._admin_node = None
        for i, p in enumerate(self.procs):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
            self.procs[i] = None


class BlockingFleetClerk(_BlockingClerkBase):
    """Blocking client of an :class:`EngineFleetCluster`."""

    def __init__(self, owner_addrs: dict) -> None:
        from .engine_server import EngineFleetClerk

        self.node = RpcNode()
        self.sched = self.node.sched
        ends = {
            g: self.node.client_end(h, p)
            for g, (h, p) in owner_addrs.items()
        }
        # make_end: the clerk re-derives gid→end from the fleet's
        # placement view after ErrWrongGroup (a controller may have
        # MOVED the gid to another process).
        self._clerk = EngineFleetClerk(
            self.sched, ends, make_end=self.node.client_end
        )

    @property
    def client_id(self) -> int:
        return self._clerk.client_id


class BlockingEngineClerk(_BlockingClerkBase):
    """Blocking client of an :class:`EngineProcessCluster`."""

    def __init__(
        self, port: int, host: str = "127.0.0.1",
        service: str = "EngineKV", lane: str = "",
    ) -> None:
        from .engine_server import EngineClerk

        self.node = RpcNode()
        self.sched = self.node.sched
        end = self.node.client_end(host, port)
        self._clerk = EngineClerk(self.sched, end, service=service, lane=lane)

    @property
    def client_id(self) -> int:
        return self._clerk.client_id


