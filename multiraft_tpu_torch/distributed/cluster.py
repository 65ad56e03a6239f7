"""Multi-process cluster deployment: the server-process entry point.

PyTorch port of the engine half of ``multiraft_tpu/distributed/
cluster.py``.  Each server runs in its own OS process on a
``RealtimeScheduler`` + TCP ``RpcNode``; the cluster drivers in
:mod:`.engine_cluster` launch it as ``python -m
multiraft_tpu_torch.distributed.cluster <spec json>`` (see
:mod:`.launch`) and wait for its ``ready <port>`` line.

Crash/restart testing is *literal*: ``kill -9`` the process, start a
new one on the same data directory, and the engine recovers from disk.

The spec's ``device`` (default ``"cuda"``) is where the engine lives:
a child without a card exits non-zero before its readiness line, never
quietly on the CPU; tests pass ``"cpu"``.  The reference's per-replica
kinds (``kv``, ``ctrler``, ``shardkv``) serve the simulated services
(``services.kvraft``, ``shardctrler``, ``shardkv``) over TCP through
``serve_kv``, ``serve_ctrler`` and ``serve_shardkv``, which this package
does not have yet (ROADMAP queue A): they raise ``NotImplementedError``.
"""

from __future__ import annotations

import sys
import time

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

# The reference's server kinds that run the per-replica Raft stack.
PER_REPLICA_KINDS = ("kv", "ctrler", "shardkv")


def _server_main() -> None:  # pragma: no cover - subprocess entry
    import json

    spec = json.loads(sys.argv[2])
    kind = spec.get("kind", "kv")
    device = spec.get("device", "cuda")
    if kind in PER_REPLICA_KINDS:
        raise NotImplementedError(
            f"server kind {kind!r} serves a per-replica service over TCP, "
            f"which multiraft_tpu_torch does not do yet (ROADMAP queue A)"
        )
    if kind == "engine_kv":
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
