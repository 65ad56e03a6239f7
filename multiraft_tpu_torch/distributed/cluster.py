"""Multi-process cluster deployment.

PyTorch port of ``multiraft_tpu/distributed/cluster.py``.  Each server
runs in its own OS process on a ``RealtimeScheduler`` + TCP
``RpcNode``; the cluster drivers here and in :mod:`.engine_cluster`
launch it as ``python -m multiraft_tpu_torch.distributed.cluster <spec
json>`` (see :mod:`.launch`) and wait for its ``ready <port>`` line.

Two halves:

* the per-replica kinds (``kv``, ``ctrler``, ``shardkv``): one Raft
  replica of the simulated services (``services.kvraft``,
  ``shardctrler``, ``shardkv``) per process over TCP with a
  crash-atomic ``DiskPersister`` — host-only, they touch no device.
  :class:`KVProcessCluster` and :class:`ShardKVProcessCluster` drive
  them; clients talk through the unmodified service clerks over
  ``TcpClientEnd``\\ s (:class:`BlockingClerk`,
  :class:`BlockingShardClerk`);
* the engine kinds, whose spec's ``device`` (default ``"cuda"``) is
  where the engine lives: a child without a card exits non-zero before
  its readiness line, never quietly on the CPU; tests pass ``"cpu"``.

Crash/restart testing is *literal*: ``kill -9`` the process, start a
new one on the same data directory, and Raft (or the engine) recovers
from disk.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import TYPE_CHECKING, Any, List, Optional, Sequence

from ..sim.scheduler import TIMEOUT
from ..utils.knobs import knob_bool
from .disk import DiskPersister
from .launch import (
    BlockingClerkBase as _BlockingClerkBase,
    check_ready as _check_ready,
    launch_server as _launch_server,
    reserve_ports as _reserve_ports,
)
from .tcp import RpcNode

if TYPE_CHECKING:
    from .realtime import RealtimeScheduler

__all__ = [
    "serve_kv",
    "serve_ctrler",
    "serve_shardkv",
    "EngineProcessCluster",
    "EngineFleetCluster",
    "SplitProcessCluster",
    "SplitShardProcessCluster",
    "BlockingEngineClerk",
    "BlockingFleetClerk",
    "BlockingSplitClerk",
    "BlockingSplitShardClerk",
    "KVProcessCluster",
    "ShardKVProcessCluster",
    "BlockingClerk",
    "BlockingShardClerk",
]


def _addr_end(node: RpcNode, name: str):
    """Resolve a ``"host:port"`` group-server name to a TcpClientEnd —
    the deployment's ``make_end`` (the sim passes opaque endnames;
    here the controller's group tables carry real addresses)."""
    host, port = name.rsplit(":", 1)
    return node.client_end(host, int(port))

def serve_kv(
    me: int,
    ports: Sequence[int],
    data_dir: str,
    host: str = "127.0.0.1",
    maxraftstate: int = -1,
) -> RpcNode:
    """Bring up one KV server process component: RealtimeScheduler +
    listening RpcNode + KVServer/RaftNode on a DiskPersister.  Returns
    the RpcNode (caller keeps the process alive)."""
    from ..services.kvraft import KVServer

    node = RpcNode(listen=True, host=host, port=ports[me])
    sched = node.sched
    ends = [node.client_end(host, p) for p in ports]
    persister = DiskPersister(os.path.join(data_dir, f"server-{me}"))

    # KVServer mutates consensus state from RPC handlers; construct it on
    # the loop thread so initialization obeys the single-mutator rule.
    srv = sched.run_call(
        lambda: KVServer(
            sched, ends, me, persister, maxraftstate=maxraftstate, seed=me
        )
    )
    node.add_service("KVServer", srv)
    node.add_service("Raft", srv.rf)
    if knob_bool("MRT_DEBUG"):
        def _dump() -> None:
            print(f"[{time.monotonic():.2f}] {srv.rf!r}", file=sys.stderr, flush=True)
            sched.call_after(1.0, _dump)
        sched.call_soon(_dump)
    return node


def serve_ctrler(
    me: int, ports: Sequence[int], data_dir: str, host: str = "127.0.0.1"
) -> RpcNode:
    """One shard-controller replica process (the config RSM,
    reference: shardctrler/server.go:164-182 — over real sockets)."""
    from ..services.shardctrler import ShardCtrler

    node = RpcNode(listen=True, host=host, port=ports[me])
    sched = node.sched
    ends = [node.client_end(host, p) for p in ports]
    persister = DiskPersister(os.path.join(data_dir, f"ctrler-{me}"))
    srv = sched.run_call(
        lambda: ShardCtrler(sched, ends, me, persister, seed=1000 + me)
    )
    node.add_service("ShardCtrler", srv)
    node.add_service("Raft", srv.rf)
    return node


def serve_shardkv(
    me: int,
    gid: int,
    group_ports: Sequence[int],
    ctrler_ports: Sequence[int],
    data_dir: str,
    host: str = "127.0.0.1",
    maxraftstate: int = -1,
) -> RpcNode:
    """One replica of one shard group (the full migration-capable
    server, reference: shardkv/server.go:77-98 wiring — raft +
    controller clerk + make_end, here resolving "host:port" names to
    TCP ends so groups pull shards from each other across processes)."""
    from ..services.shardkv import ShardKVServer

    node = RpcNode(listen=True, host=host, port=group_ports[me])
    sched = node.sched
    ends = [node.client_end(host, p) for p in group_ports]
    ctrler_ends = [node.client_end(host, p) for p in ctrler_ports]
    persister = DiskPersister(os.path.join(data_dir, f"g{gid}-{me}"))
    srv = sched.run_call(
        lambda: ShardKVServer(
            sched, ends, me, persister, gid, ctrler_ends,
            lambda name: _addr_end(node, name),
            maxraftstate=maxraftstate, seed=gid * 100 + me,
        )
    )
    node.add_service("ShardKV", srv)
    node.add_service("Raft", srv.rf)
    return node



def _server_main() -> None:  # pragma: no cover - subprocess entry
    import json

    spec = json.loads(sys.argv[2])
    kind = spec.get("kind", "kv")
    device = spec.get("device", "cuda")
    if kind == "kv":
        node = serve_kv(
            me=spec["me"],
            ports=spec["ports"],
            data_dir=spec["data_dir"],
            maxraftstate=spec.get("maxraftstate", -1),
        )
    elif kind == "ctrler":
        node = serve_ctrler(spec["me"], spec["ports"], spec["data_dir"])
    elif kind == "shardkv":
        node = serve_shardkv(
            me=spec["me"],
            gid=spec["gid"],
            group_ports=spec["ports"],
            ctrler_ports=spec["ctrler_ports"],
            data_dir=spec["data_dir"],
            maxraftstate=spec.get("maxraftstate", -1),
        )
    elif kind == "engine_kv":
        from .engine_server import serve_engine_kv

        node = serve_engine_kv(
            port=spec["ports"][0],
            G=spec.get("groups", 64),
            seed=spec.get("seed", 0),
            data_dir=spec.get("data_dir"),
            checkpoint_every_s=spec.get("checkpoint_every_s", 30.0),
            mesh_devices=spec.get("mesh_devices", 0),
            device=device,
        )
    elif kind == "engine_shardkv":
        from .engine_server import serve_engine_shardkv

        node = serve_engine_shardkv(
            port=spec["ports"][0],
            G=spec.get("groups", 4),
            seed=spec.get("seed", 0),
            join_gids=spec.get("join_gids"),
            data_dir=spec.get("data_dir"),
            checkpoint_every_s=spec.get("checkpoint_every_s", 30.0),
            mesh_devices=spec.get("mesh_devices", 0),
            device=device,
        )
    elif kind == "engine_fleet":
        from .engine_server import serve_engine_shardkv

        node = serve_engine_shardkv(
            port=spec["ports"][0],
            seed=spec.get("seed", 0),
            gids=spec["gids"],
            # JSON round trip stringifies gid keys and listifies tuples.
            peer_addrs={
                int(g): (a[0], int(a[1]))
                for g, a in spec["peer_addrs"].items()
            },
            data_dir=spec.get("data_dir"),
            checkpoint_every_s=spec.get("checkpoint_every_s", 30.0),
            mesh_devices=spec.get("mesh_devices", 0),
            spare_slots=spec.get("spare_slots", 0),
            replicas=spec.get("replicas", 3),
            voters=spec.get("voters"),
            # State plane (distributed/stateplane.py): the full fleet
            # roster + own index turn snapshot/tail shipping on.
            fleet_addrs=(
                {
                    int(p): (a[0], int(a[1]))
                    for p, a in spec["fleet_addrs"].items()
                }
                if spec.get("fleet_addrs") else None
            ),
            me=spec.get("me"),
            ship_sync=spec.get("ship_sync"),
            ship_window_s=spec.get("ship_window_s"),
            device=device,
        )
    elif kind == "split_kv":
        from .split_server import serve_split_kv

        node = serve_split_kv(
            port=spec["ports"][spec["me"]],
            me=spec["me"],
            # JSON stringifies the group keys and listifies slot lists.
            owners={int(g): list(o) for g, o in spec["owners"].items()},
            peer_addrs={
                i: (spec.get("host", "127.0.0.1"), p)
                for i, p in enumerate(spec["ports"])
            },
            G=spec.get("groups", 8),
            host=spec.get("host", "127.0.0.1"),
            seed=spec.get("seed", 0),
            delay_elections=spec.get("delay_elections", 0),
            data_dir=spec.get("data_dir"),
            snapshot_every_s=spec.get("snapshot_every_s", 30.0),
            device=device,
        )
    elif kind == "split_shardkv":
        from .split_shard_server import serve_split_shardkv

        node = serve_split_shardkv(
            port=spec["ports"][spec["me"]],
            me=spec["me"],
            # JSON stringifies the group keys and listifies slot lists.
            owners={int(g): list(o) for g, o in spec["owners"].items()},
            peer_addrs={
                i: (spec.get("host", "127.0.0.1"), p)
                for i, p in enumerate(spec["ports"])
            },
            G=spec.get("groups", 3),
            host=spec.get("host", "127.0.0.1"),
            seed=spec.get("seed", 0),
            delay_elections=spec.get("delay_elections", 0),
            data_dir=spec.get("data_dir"),
            snapshot_every_s=spec.get("snapshot_every_s", 30.0),
            device=device,
        )
    else:
        raise ValueError(f"unknown server kind {kind!r}")
    if spec.get("chaos_seed") is not None:
        # Fault-injection hooks + the "Chaos" control RPC, for every
        # server kind — a harness reconfigures the live fleet over the
        # same sockets it serves on (chaos.py).
        from .chaos import install_chaos

        install_chaos(node, int(spec["chaos_seed"]))
    print(f"ready {node.port}", flush=True)
    while True:
        time.sleep(3600)


class BlockingClerk(_BlockingClerkBase):
    """Blocking client of a :class:`KVProcessCluster`."""

    def __init__(
        self, ports: Sequence[int], host: str = "127.0.0.1",
        node: Optional[RpcNode] = None,
    ) -> None:
        from ..services.kvraft import Clerk

        self.node = node or RpcNode()
        self.sched = self.node.sched
        ends = [self.node.client_end(host, p) for p in ports]
        self._clerk = Clerk(self.sched, ends)


class BlockingShardClerk(_BlockingClerkBase):
    """Blocking client of a sharded process cluster: drives the
    unmodified :class:`~multiraft_tpu_torch.services.shardkv.ShardClerk`
    (config-tracking, per-group retry) over TCP ends."""

    def __init__(
        self, ctrler_ports: Sequence[int], host: str = "127.0.0.1"
    ) -> None:
        from ..services.shardkv import ShardClerk

        self.node = RpcNode()
        self.sched = self.node.sched
        ctrler_ends = [self.node.client_end(host, p) for p in ctrler_ports]
        self._clerk = ShardClerk(
            self.sched, ctrler_ends, lambda name: _addr_end(self.node, name)
        )


class KVProcessCluster:
    """Launch and manage ``n`` KV server OS processes (test/ops driver)."""

    def __init__(
        self,
        n: int,
        data_dir: str,
        host: str = "127.0.0.1",
        maxraftstate: int = -1,
    ) -> None:
        self.n = n
        self.host = host
        self.data_dir = data_dir
        self.maxraftstate = maxraftstate
        # Reserve n distinct ephemeral ports by bind/close.  There is a
        # small window where another process could grab one before the
        # child listens — in that case start() raises and the caller
        # builds a fresh cluster; acceptable for a test/ops driver.
        self.ports: List[int] = _reserve_ports(n, host)
        self.procs: List[Optional[subprocess.Popen]] = [None] * n

    def start(self, i: int) -> None:
        assert self.procs[i] is None or self.procs[i].poll() is not None
        spec = {
            "me": i,
            "ports": self.ports,
            "data_dir": self.data_dir,
            "maxraftstate": self.maxraftstate,
        }
        # Register before the readiness check so shutdown() can reap a
        # half-started server even when the check raises.
        self.procs[i] = _launch_server(spec, i)
        _check_ready(self.procs[i], i)

    def start_all(self) -> None:
        for i in range(self.n):
            self.start(i)

    def kill(self, i: int) -> None:
        """SIGKILL — a real crash; durable state must carry the restart."""
        p = self.procs[i]
        if p is not None and p.poll() is None:
            p.kill()
            p.wait()
        self.procs[i] = None

    def clerk(self) -> BlockingClerk:
        return BlockingClerk(self.ports, host=self.host)

    def shutdown(self) -> None:
        for i in range(self.n):
            self.kill(i)


class ShardKVProcessCluster:
    """The full sharded stack as OS processes: ``nctrlers`` controller
    replicas plus ``n`` replicas per group, all over TCP with disk
    persistence — the deployment form of the reference's shardkv
    harness (reference: shardkv/config.go:338-382, which only ever
    builds one in-process simulated network)."""

    def __init__(
        self,
        data_dir: str,
        gids: Sequence[int] = (100, 101),
        n: int = 3,
        nctrlers: int = 3,
        host: str = "127.0.0.1",
        maxraftstate: int = -1,
    ) -> None:
        self.host = host
        self.data_dir = data_dir
        self.maxraftstate = maxraftstate
        self.gids = list(gids)
        self.n = n
        self.ctrler_ports = _reserve_ports(nctrlers, host)
        self.group_ports = {g: _reserve_ports(n, host) for g in self.gids}
        self.procs: dict = {}  # ("ctrler", i) | (gid, i) -> Popen
        self._admin_sched: Optional[RealtimeScheduler] = None
        self._admin_node: Optional[RpcNode] = None
        self._admin_ck: Any = None

    # -- process management -----------------------------------------------

    def _spawn(self, key, spec) -> None:
        old = self.procs.get(key)
        assert old is None or old.poll() is not None
        # Register before the readiness check so shutdown() can reap a
        # half-started server even when the check raises.
        self.procs[key] = _launch_server(spec, key)
        _check_ready(self.procs[key], key)

    def start_ctrler(self, i: int) -> None:
        self._spawn(("ctrler", i), {
            "kind": "ctrler", "me": i, "ports": self.ctrler_ports,
            "data_dir": self.data_dir,
        })

    def start_server(self, gid: int, i: int) -> None:
        self._spawn((gid, i), {
            "kind": "shardkv", "me": i, "gid": gid,
            "ports": self.group_ports[gid],
            "ctrler_ports": self.ctrler_ports,
            "data_dir": self.data_dir,
            "maxraftstate": self.maxraftstate,
        })

    def start_all(self) -> None:
        for i in range(len(self.ctrler_ports)):
            self.start_ctrler(i)
        for g in self.gids:
            for i in range(self.n):
                self.start_server(g, i)

    def kill(self, key) -> None:
        """SIGKILL ("ctrler", i) or (gid, i); disk carries the restart."""
        p = self.procs.get(key)
        if p is not None and p.poll() is None:
            p.kill()
            p.wait()
        self.procs[key] = None

    def shutdown(self) -> None:
        for key in list(self.procs):
            self.kill(key)
        if self._admin_sched is not None:
            self._admin_node.close()
            self._admin_sched.stop()
            self._admin_sched = self._admin_node = self._admin_ck = None

    # -- admin (controller ops over TCP) ----------------------------------

    def _group_names(self, gid: int) -> List[str]:
        return [f"{self.host}:{p}" for p in self.group_ports[gid]]

    def _admin(self, fn, timeout: float = 30.0) -> Any:
        """Run a controller-clerk op on a lazily-created persistent
        admin client (one scheduler thread + node for the cluster's
        lifetime — callers poll query() in loops)."""
        from ..services.shardctrler import CtrlerClerk

        if self._admin_sched is None:
            self._admin_node = RpcNode()
            self._admin_sched = self._admin_node.sched
            self._admin_ck = CtrlerClerk(
                self._admin_sched,
                [self._admin_node.client_end(self.host, p)
                 for p in self.ctrler_ports],
            )
        sched = self._admin_sched
        fut = sched.spawn(fn(self._admin_ck))
        value = sched.wait(fut, timeout)
        if value is TIMEOUT:
            sched.post(fut.resolve, TIMEOUT)
            raise TimeoutError("controller did not answer in time")
        return value

    def join(self, gid: int) -> None:
        self._admin(lambda ck: ck.join({gid: self._group_names(gid)}))

    def leave(self, gid: int) -> None:
        self._admin(lambda ck: ck.leave([gid]))

    def query(self):
        return self._admin(lambda ck: ck.query(-1))

    def clerk(self) -> BlockingShardClerk:
        return BlockingShardClerk(self.ctrler_ports, host=self.host)


if __name__ == "__main__":  # pragma: no cover - subprocess entry
    sys.argv = [sys.argv[0], "serve", sys.argv[1]]
    _server_main()


# The engine-backed clusters live in engine_cluster.py; callers import
# them from here too, as from the reference's cluster module.
from .engine_cluster import (  # noqa: E402,F401
    BlockingEngineClerk,
    BlockingFleetClerk,
    BlockingSplitClerk,
    BlockingSplitShardClerk,
    EngineFleetCluster,
    EngineProcessCluster,
    SplitProcessCluster,
    SplitShardProcessCluster,
)
