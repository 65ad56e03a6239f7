"""Command-line entry: serve the engines and talk to them.

The PyTorch port of ``multiraft_tpu/__main__.py``.  The CLI wraps the
server entry point (``distributed.engine_server``) and a one-shot
client so an operator can stand up a card-owning KV service and poke it
without writing code:

    python -m multiraft_tpu_torch serve-kv --port 7000 --groups 64 \
        --data-dir /var/lib/mrt
    python -m multiraft_tpu_torch kv put  --addr 127.0.0.1:7000 greeting hello
    python -m multiraft_tpu_torch kv get  --addr 127.0.0.1:7000 greeting

Sharded/fleet serving (``serve-shardkv``) takes the same flags plus
--join/--gids/--peer.  Both servers run the engine on the card
(``--device cuda``, the default) and exit non-zero, before they print
``ready``, on a host without one; ``--device cpu`` asks for the CPU.  The wire is the
reference package's, so either package's ``kv`` client talks to either
package's server.  Process supervision (restart-on-crash) belongs to
the operator's init system — a restarted durable server recovers from
--data-dir.
"""

from __future__ import annotations

import argparse
import sys


def _serve_forever(args, build) -> int:
    """Shared serve scaffold: build the node, print the readiness
    line, park the main thread.

    SIGTERM/SIGINT shut down gracefully: a durable server writes a
    final checkpoint (rotating the WAL away), so the next start
    recovers instantly instead of replaying — kill -9 remains the
    crash path and recovers via WAL replay."""
    import signal
    import threading

    node = build()
    stop = threading.Event()

    def _on_signal(*_):
        if stop.is_set():
            # Second signal: the graceful path is wedged (e.g. a stalled
            # device mid-checkpoint) — force-exit instead of sitting out
            # the run_call timeout.
            import os as _os

            _os._exit(130)
        stop.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _on_signal)
    print(f"ready {node.port}", flush=True)
    stop.wait()
    svc = getattr(node, "engine_service", None)
    if svc is not None:
        # On the loop thread: stop the pump (no new batch; the pump
        # thread drains its fetches and exits, so no thread is inside a
        # device copy when the interpreter exits), then checkpoint at a
        # tick boundary, not mid-pump.
        def _last():
            svc.stop()
            return svc.final_checkpoint()

        node.sched.run_call(_last, timeout=600.0)
    node.close()
    return 0


def _cmd_serve_kv(args) -> int:
    def build():
        from .distributed.engine_server import serve_engine_kv

        return serve_engine_kv(
            port=args.port,
            G=args.groups,
            host=args.host,
            seed=args.seed,
            data_dir=args.data_dir,
            checkpoint_every_s=args.checkpoint_every,
            mesh_devices=args.mesh_devices,
            device=args.device,
        )

    return _serve_forever(args, build)


def _cmd_serve_shardkv(args) -> int:
    def build():
        from .distributed.engine_server import serve_engine_shardkv

        peer_addrs = {}
        for spec in args.peer or []:
            gid, addr = spec.split("=", 1)
            h, p = addr.rsplit(":", 1)
            peer_addrs[int(gid)] = (h, int(p))
        gids = [int(g) for g in args.gids.split(",")] if args.gids else None
        return serve_engine_shardkv(
            port=args.port,
            G=args.groups,
            host=args.host,
            seed=args.seed,
            join_gids=(
                [int(g) for g in args.join.split(",")] if args.join else None
            ),
            gids=gids,
            peer_addrs=peer_addrs or None,
            data_dir=args.data_dir,
            checkpoint_every_s=args.checkpoint_every,
            mesh_devices=args.mesh_devices,
            device=args.device,
        )

    return _serve_forever(args, build)


def _cmd_kv(args) -> int:
    from .distributed.engine_clerks import EngineClerk
    from .distributed.tcp import RpcNode
    from .sim.scheduler import TIMEOUT

    if args.op != "get" and args.value is None:
        # Silently writing "" on a forgotten value would be data
        # destruction with exit code 0.
        print(f"error: kv {args.op} requires a VALUE", file=sys.stderr)
        return 2
    h, p = args.addr.rsplit(":", 1)
    node = RpcNode()
    try:
        end = node.client_end(h, int(p))
        ck = EngineClerk(node.sched, end, service=args.service)
        if args.op == "get":
            gen = ck.get(args.key)
        elif args.op == "put":
            gen = ck.put(args.key, args.value)
        else:
            gen = ck.append(args.key, args.value)
        out = node.sched.wait(node.sched.spawn(gen), args.timeout)
        if out is TIMEOUT:
            print("error: server did not answer", file=sys.stderr)
            return 1
        if args.op == "get":
            print(out)
        return 0
    finally:
        node.close()


def _add_serve_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--port", type=int, default=0,
                   help="listen port (0 = ephemeral, printed on ready)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--groups", type=int, default=64,
                   help="engine consensus groups (G)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data-dir", default=None,
                   help="enable durability (checkpoints + WAL) here")
    p.add_argument("--checkpoint-every", type=float, default=30.0,
                   metavar="SECONDS")
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="split the groups over this many local cards "
                        "(CPU shards with --device cpu; G must divide "
                        "evenly)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (cuda = own the card; "
                        "cpu for tests)")


def main(argv=None) -> int:
    top = argparse.ArgumentParser(prog="multiraft_tpu_torch", description=__doc__)
    sub = top.add_subparsers(dest="cmd", required=True)

    s1 = sub.add_parser("serve-kv", help="card-owning engine KV server")
    _add_serve_flags(s1)
    s1.set_defaults(fn=_cmd_serve_kv)

    s2 = sub.add_parser("serve-shardkv",
                        help="sharded engine server (standalone or fleet)")
    _add_serve_flags(s2)
    s2.add_argument("--join", default=None, metavar="GID,GID",
                    help="bootstrap-join these gids before readiness")
    s2.add_argument("--gids", default=None, metavar="GID,GID",
                    help="fleet mode: the global gids THIS process hosts")
    s2.add_argument("--peer", action="append", metavar="GID=HOST:PORT",
                    help="fleet mode: owner address of a remote gid")
    s2.set_defaults(fn=_cmd_serve_shardkv)

    s3 = sub.add_parser("kv", help="one-shot client op")
    s3.add_argument("op", choices=("get", "put", "append"))
    s3.add_argument("key")
    s3.add_argument("value", nargs="?", default=None)
    s3.add_argument("--addr", required=True, metavar="HOST:PORT")
    s3.add_argument("--service", default="EngineKV",
                    choices=("EngineKV", "EngineShardKV"))
    s3.add_argument("--timeout", type=float, default=30.0)
    s3.set_defaults(fn=_cmd_kv)

    args = top.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
