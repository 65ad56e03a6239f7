"""The split-group path, measured (the PyTorch port of
``benchmarks/split_bench.py``; engine/split.py warns slab extraction
costs a per-tick host readback and caps split deployments at "a few
hundred groups" — this rig puts numbers on all three costs):

1. **Slab-exchange overhead** — ms/tick for two in-process split sides
   (pump + extract + inject, the SplitKVService loop minus sockets)
   vs the SAME shapes pumped whole-chip on one driver.  The ratio IS
   the price of per-process failure domains.
2. **Serving throughput** — ops/s through real ``serve_split_kv``
   processes over sockets, per-op and framed (``SplitKV.batch``).
3. **Failover unavailability window** — kill -9 the process owning
   every group's leader while a clerk hammers one key; report the gap
   between the last pre-kill ack and the first post-failover ack (the
   client-observed outage, election + re-route inclusive).

Usage::

    python -m multiraft_tpu_torch.benchmarks.split_bench [G] [n_ops]
        [--device cpu]

One JSON line with every measurement.  Every engine, in process or in a
server process, runs on the card unless ``--device cpu``
(``device="cpu"``) asks for the CPU; on one card the two split sides
share it, so (1) times the slab exchange, not two failure domains.
"""

from __future__ import annotations

import json
import sys
import time


def bench_slab_overhead(G: int = 8, ticks: int = 400,
                        device: str = "cuda") -> dict:
    """In-process: two split sides shuttling slabs vs one whole-chip
    driver, same shapes, same tick count, every driver on ``device``."""
    from ..engine.core import EngineConfig
    from ..engine.host import EngineDriver
    from ..engine.kv import BatchedKV, KVOp
    from ..engine.split import SplitKV, SplitPeering, SplitSpec
    from ..porcupine.kv import OP_PUT

    def mkcfg():
        return EngineConfig(G=G, P=3, L=64, E=8, INGEST=8,
                            host_paced_compaction=True)

    # Whole-chip baseline: one driver hosting all peers.
    drv = EngineDriver(mkcfg(), seed=5, device=device)
    kv = BatchedKV(drv)
    for _ in range(120):
        kv.pump(1)
    for g in range(G):
        kv.submit(g, KVOp(op=OP_PUT, key="w", value="x"))
    t0 = time.perf_counter()
    for _ in range(ticks):
        kv.pump(1)
    whole_ms = (time.perf_counter() - t0) / ticks * 1e3

    # Split pair: every group's slots spread 1/2 across two drivers.
    owners = {g: [0, 1, 1] for g in range(G)}
    sides = []
    for me in (0, 1):
        d = EngineDriver(mkcfg(), seed=11 + me, device=device)
        s = SplitKV(d)
        p = SplitPeering(d, s, SplitSpec(me=me, owners=owners))
        sides.append((s, p))

    def shuttle():
        for i, (s, p) in enumerate(sides):
            s.pump(1)
            for proc, slab in p.extract().items():
                sides[proc][1].inject(slab)

    for _ in range(400):  # settle elections
        shuttle()
    t0 = time.perf_counter()
    for _ in range(ticks):
        shuttle()
    # One shuttle round pumps BOTH sides once — per-side tick cost:
    split_ms = (time.perf_counter() - t0) / ticks / 2 * 1e3
    return {
        "slab_G": G,
        "whole_chip_ms_per_tick": round(whole_ms, 3),
        "split_ms_per_tick_per_side": round(split_ms, 3),
        "slab_overhead_x": round(split_ms / whole_ms, 2),
    }


def bench_serving(G: int = 8, n_ops: int = 400, frame: int = 64,
                  device: str = "cuda") -> dict:
    """Real sockets: per-op and framed ops/s through serve_split_kv
    processes whose engines run on ``device``."""
    from ..distributed.engine_cluster import SplitProcessCluster
    from ..distributed.split_server import SplitNetClerk
    from ..distributed.tcp import RpcNode
    from ..sim.scheduler import TIMEOUT

    owners = {g: [0, 1, 1] for g in range(G)}
    cluster = SplitProcessCluster(owners, n_procs=2, groups=G,
                                  delay_elections=[0, 300], device=device)
    node = None
    try:
        cluster.start_all()
        node = RpcNode()
        sched = node.sched
        ends = [node.client_end(cluster.host, p) for p in cluster.ports]
        ck = SplitNetClerk(sched, ends)

        def warm():
            yield from ck.put("warm", "1")

        assert sched.wait(sched.spawn(warm()), 60.0) is not TIMEOUT

        ops = [
            ("Put" if i % 3 else "Get", f"k{i % 13}", f"v{i}")
            for i in range(n_ops)
        ]

        def per_op():
            for op, key, value in ops:
                if op == "Get":
                    yield from ck.get(key)
                else:
                    yield from ck.put(key, value)

        t0 = time.perf_counter()
        assert sched.wait(sched.spawn(per_op()), 600.0) is not TIMEOUT
        per_op_rate = n_ops / (time.perf_counter() - t0)

        def framed():
            for s in range(0, len(ops), frame):
                yield from ck.run_batch(ops[s:s + frame])

        t0 = time.perf_counter()
        assert sched.wait(sched.spawn(framed()), 600.0) is not TIMEOUT
        framed_rate = n_ops / (time.perf_counter() - t0)
        return {
            "serving_G": G,
            "serving_ops": n_ops,
            "per_op_ops_per_sec": round(per_op_rate, 1),
            "framed_ops_per_sec": round(framed_rate, 1),
            "frame": frame,
        }
    finally:
        if node is not None:
            node.close()
        cluster.shutdown()


def bench_failover(G: int = 8, device: str = "cuda") -> dict:
    """Client-observed unavailability: kill -9 the leader-owning
    process mid-stream; gap = last pre-kill ack → first post-kill ack.
    Then every acknowledged append must read back exactly once, in
    order (the port's addition: ``acked_writes`` and
    ``lost_acked_writes``, which must be 0)."""
    from ..distributed.engine_cluster import SplitProcessCluster
    from ..distributed.split_server import SplitNetClerk
    from ..distributed.tcp import RpcNode
    from ..sim.scheduler import TIMEOUT

    owners = {g: [0, 1, 1] for g in range(G)}
    cluster = SplitProcessCluster(owners, n_procs=2, groups=G,
                                  delay_elections=[0, 300], device=device)
    node = None
    try:
        cluster.start_all()
        node = RpcNode()
        sched = node.sched
        ends = [node.client_end(cluster.host, p) for p in cluster.ports]
        ck = SplitNetClerk(sched, ends)
        acks = []
        tags = []

        def stream(n):
            for i in range(n):
                yield from ck.append("hot", f"[{i}]")
                acks.append(time.perf_counter())
                tags.append(f"[{i}]")

        # Pre-kill stream (leaders parked on proc 0).
        assert sched.wait(sched.spawn(stream(20)), 120.0) is not TIMEOUT
        t_kill = time.perf_counter()
        cluster.kill(0)
        # Post-kill stream: the first ack bounds the outage window.
        assert sched.wait(sched.spawn(stream(20)), 120.0) is not TIMEOUT
        post = [t for t in acks if t > t_kill]
        window_ms = (post[0] - t_kill) * 1e3
        # Steady-state post-failover op time, for contrast.
        steady_ms = (post[-1] - post[0]) / max(len(post) - 1, 1) * 1e3
        box = {}

        def read():
            box["v"] = yield from ck.get("hot")

        assert sched.wait(sched.spawn(read()), 120.0) is not TIMEOUT
        want = "".join(tags)
        assert box["v"] == want, (
            f"split failover: read {box['v']!r}, acknowledged {want!r}"
        )
        return {
            "failover_window_ms": round(window_ms, 1),
            "post_failover_ms_per_op": round(steady_ms, 2),
            "acked_writes": len(tags),
            "lost_acked_writes": 0,
        }
    finally:
        if node is not None:
            node.close()
        cluster.shutdown()


def main(argv) -> None:
    # The reference picks its engine platform from an environment
    # variable (default cpu); the port takes --device, the card by
    # default.
    from .serving_throughput import _take_device

    argv, device = _take_device(argv)
    G = int(argv[1]) if len(argv) > 1 else 8
    n_ops = int(argv[2]) if len(argv) > 2 else 400
    out = {}
    out.update(bench_slab_overhead(G, device=device))
    out.update(bench_serving(G, n_ops, device=device))
    out.update(bench_failover(G, device=device))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv)
