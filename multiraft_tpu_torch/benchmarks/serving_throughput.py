"""Served-engine throughput: concurrent clerks over real sockets (the
PyTorch port of ``benchmarks/serving_throughput.py``).

The transport echo bench (transport_echo.py) measures serial RPC
latency; this measures the serving dimension that actually matters for
the sidecar story — how many client ops/s one chip-owning engine
server sustains when many clerks pipeline into the pump loop.  Each
pump coalesces every command that arrived since the last one into a
single device step, so throughput scales with concurrency until the
pump (or the box) saturates, while per-op latency stays ~pump-bounded.

Two modes, both measured by default:

* per-op (``frame=0``): every op is its own RPC — the reference
  clerk's serial loop shape (kvraft/client.go:47-71);
* framed (``frame=B``): each clerk ships B ops per ``batch`` RPC
  (PipelinedClerk) and the server applies the frame in one pump —
  the multi-op-frames fix for per-op RPC overhead.

Usage::

    python -m multiraft_tpu_torch.benchmarks.serving_throughput
        [n_clerks] [ops_per_clerk] [frame] [--device cpu]
    python -m multiraft_tpu_torch.benchmarks.serving_throughput firehose
        [--device cpu]

One JSON line: {"clerks": K, "ops": N, "ops_per_sec": R,
"mean_latency_ms": L, "framed_ops_per_sec": ..., "frame": B}.  Every
engine, in process or in a server process, runs on the card unless
``--device cpu`` (``device="cpu"``) asks for the CPU; the served
engines run the plain tick, as the reference serves.
"""

from __future__ import annotations

import json
import sys
import time


def bench(
    n_clerks: int = 16, ops_per_clerk: int = 50, frame: int = 0,
    data_dir=None, device: str = "cuda",
) -> dict:
    from ..distributed.engine_cluster import EngineProcessCluster
    from ..distributed.engine_server import (
        EngineClerk,
        PipelinedClerk,
    )
    from ..distributed.tcp import RpcNode
    from ..sim.scheduler import TIMEOUT

    cluster = EngineProcessCluster(
        kind="engine_kv", groups=64, seed=41, data_dir=data_dir,
        device=device,
    )
    node = None
    try:
        cluster.start()
        node = RpcNode()
        end = node.client_end(cluster.host, cluster.port)
        sched = node.sched

        # Warm up the connection + both server tick variants.
        warm = EngineClerk(sched, end)
        assert sched.wait(sched.spawn(warm.put("warm", "1")), 30.0) is not TIMEOUT

        lat_acc = []

        def ops_for(i):
            out = []
            for j in range(ops_per_clerk):
                if j % 3 == 2:
                    out.append(("Get", f"k{i}-{j % 5}", ""))
                else:
                    out.append(("Put", f"k{i}-{j % 5}", f"v{j}"))
            return out

        def clerk_driver(i):
            ck = EngineClerk(sched, end)
            for op, key, value in ops_for(i):
                t0 = time.perf_counter()
                if op == "Get":
                    yield from ck.get(key)
                else:
                    yield from ck.put(key, value)
                lat_acc.append(time.perf_counter() - t0)

        def framed_driver(i):
            ck = PipelinedClerk(sched, end)
            ops = ops_for(i)
            for s in range(0, len(ops), frame):
                t0 = time.perf_counter()
                yield from ck.run_batch(ops[s:s + frame])
                # Frame latency covers every op in it.
                lat_acc.append(time.perf_counter() - t0)

        driver = framed_driver if frame else clerk_driver
        t0 = time.perf_counter()
        futs = [sched.spawn(driver(i)) for i in range(n_clerks)]
        for f in futs:
            assert sched.wait(f, 600.0) is not TIMEOUT
        elapsed = time.perf_counter() - t0
        total = n_clerks * ops_per_clerk
        # N clerks share ONE connection here, so the server's
        # per-iteration flush is where their replies coalesce — the
        # mean below is the bench's coalescing factor.
        wire = {}
        snap = sched.wait(end.call("Obs.snapshot", None), 30.0)
        if isinstance(snap, dict):
            met = snap.get("metrics", {})
            flushes = met.get("rpc.flushes", 0)
            replies = met.get("rpc.flush_replies", 0)
            wire = {
                "rpc_flushes": flushes,
                "frames_per_flush_mean": (
                    round(replies / flushes, 2) if flushes else None
                ),
                "rpc_oob_buffers": met.get("rpc.oob_buffers", 0),
            }
        return {
            "clerks": n_clerks,
            "ops": total,
            "frame": frame,
            "ops_per_sec": round(total / elapsed, 1),
            "mean_latency_ms": round(
                1e3 * sum(lat_acc) / max(1, len(lat_acc)), 2
            ),
            "wire": wire,
        }
    finally:
        if node is not None:
            node.close()
        cluster.shutdown()


def _pack_clerk_frames(G, clerk_id, n_frames, frame, keyspace=61):
    """Pre-packed columnar frames for one logical clerk (client cost
    excluded from the server-capability measure; the FirehoseClerk
    path measures the per-op client loop separately)."""
    import numpy as np

    from ..distributed.engine_wire import route_group
    from ..engine.firehose import pack_request
    from ..porcupine.kv import OP_APPEND, OP_PUT

    out = []
    cmd = 0
    # Group column must agree with the service's key-hash routing —
    # the server rejects frames that disagree (route_check).
    key_groups = np.array(
        [route_group(f"c{clerk_id}-k{i}", G) for i in range(keyspace)],
        np.uint32,
    )
    for fi in range(n_frames):
        n = frame
        ops = np.full(n, OP_APPEND, np.uint8)
        ops[::3] = OP_PUT
        groups = key_groups[np.arange(n) % keyspace]
        clients = groups.astype(np.uint64) * 64 + clerk_id
        commands = np.arange(cmd + 1, cmd + n + 1, dtype=np.uint64)
        cmd += n
        keys = [b"c%d-k%d" % (clerk_id, i % keyspace) for i in range(n)]
        vals = [b"v%d," % (fi * n + i) for i in range(n)]
        out.append(pack_request(ops, groups, clients, commands, keys, vals))
    return out


def bench_firehose_inprocess(
    G: int = 256, ingest: int = 24, clerks: int = 3,
    frames_per_clerk: int = 8, frame: int = 12288,
    device: str = "cuda",
) -> dict:
    """In-process service ceiling of the COLUMNAR path: the real
    EngineKVService.firehose handler + BatchedKV slice apply + pump
    loop on a RealtimeScheduler — everything the served path does
    except sockets.  The engine runs on ``device`` (the reference pins
    its platform to the CPU here) with the plain tick, as the
    server's."""
    import os

    # The hot pump is the right mode for THIS measure: clerks are
    # coroutines on the server's own scheduler (no co-located client
    # process to starve — the reason the 1-CPU default gates it off).
    # Saved/restored so it cannot leak into later measures or spawned
    # server children in the same process (the raw string is kept to be
    # put back verbatim, not read as the knob's value).
    saved_hot = os.environ.get("MRT_PUMP_HOT")  # graftlint: disable=env-knob
    os.environ.setdefault("MRT_PUMP_HOT", "1")

    import numpy as np

    from ..distributed.engine_server import EngineKVService
    from ..distributed.realtime import RealtimeScheduler
    from ..engine.core import EngineConfig
    from ..engine.firehose import FH_OK, unpack_reply
    from ..engine.host import EngineDriver
    from ..engine.kv import BatchedKV

    sched = RealtimeScheduler()
    box = {}

    def build():
        cfg = EngineConfig(G=G, P=3, L=max(4 * ingest, 64),
                           E=ingest, INGEST=ingest)
        driver = EngineDriver(cfg, seed=11, device=device)
        driver.run_until_quiet_leaders(4000)
        kv = BatchedKV(driver)
        kv.pump(4)
        # ticks_per_pump=4: the reference's choice for 12k-row frames
        # at INGEST=24 (measured on its CPU host, not on the card).
        box["svc"] = EngineKVService(sched, kv, ticks_per_pump=4)

    try:
        sched.run_call(build, timeout=600.0)
        svc = box["svc"]
        all_frames = [
            _pack_clerk_frames(G, ci + 1, frames_per_clerk, frame)
            for ci in range(clerks)
        ]
        # Warm both tick variants + the handler path.
        warm = _pack_clerk_frames(G, 99, 1, frame)[0]
        from ..sim.scheduler import TIMEOUT
        assert sched.wait(sched.spawn(svc.firehose(warm)), 120.0) is not TIMEOUT

        results = []

        def clerk_driver(ci):
            for blob in all_frames[ci]:
                reply = yield sched.spawn(svc.firehose(blob))
                err, _ = unpack_reply(reply)
                results.append(int((err == FH_OK).sum()))

        t0 = time.perf_counter()
        futs = [sched.spawn(clerk_driver(ci)) for ci in range(clerks)]
        for f in futs:
            assert sched.wait(f, 600.0) is not TIMEOUT
        elapsed = time.perf_counter() - t0
        total_ok = int(np.sum(results))
        total = clerks * frames_per_clerk * frame
    finally:
        # Tear the engine down even on failure (including a failed
        # build): a leftover pump thread (and a leaked MRT_PUMP_HOT)
        # would contend with / reconfigure any measurement that
        # follows in this process.
        if box.get("svc") is not None:
            box["svc"].stop()
        sched.stop()
        if saved_hot is None:
            os.environ.pop("MRT_PUMP_HOT", None)
        else:
            os.environ["MRT_PUMP_HOT"] = saved_hot
    return {
        "mode": "firehose-inprocess",
        "G": G,
        "ingest": ingest,
        "clerks": clerks,
        "frame": frame,
        "ops": total,
        "ops_ok": total_ok,
        "ops_per_sec": round(total_ok / elapsed, 1),
        "frame_latency_ms": round(1e3 * elapsed / frames_per_clerk, 2),
    }


def bench_firehose_sockets(
    n_clients: int = 3, frames_per_client: int = 12, frame: int = 12288,
    G: int = 256, ingest: int = 24, verify: bool = True,
    device: str = "cuda",
) -> dict:
    """Multi-client socket throughput of the columnar path: each
    client owns its own TCP connection (separate RpcNode) and ships
    pre-packed frames, counting only rows the server acked OK (no
    client-side retry in the throughput driver — row-retry semantics
    are FirehoseClerk's job, exercised by the verifier clerks and the
    test suite); two verifier clerks interleave ops on SHARED keys
    through the real FirehoseClerk, recording wall-clock histories
    porcupine-checked at the end — the check-the-actual-run pattern
    across real sockets."""
    import os
    import threading

    import numpy as np

    from ..distributed.engine_cluster import EngineProcessCluster
    from ..distributed.engine_server import (
        EngineClerk,
        FirehoseClerk,
    )
    from ..distributed.tcp import RpcNode
    from ..engine.firehose import FH_OK, unpack_reply
    from ..porcupine.checker import check_operations
    from ..porcupine.kv import (
        OP_APPEND,
        OP_GET,
        KvInput,
        KvOutput,
        kv_model,
    )
    from ..porcupine.model import CheckResult, Operation
    from ..sim.scheduler import TIMEOUT

    overrides = {
        "MULTIRAFT_SERVE_INGEST": str(ingest),
        "MULTIRAFT_SERVE_E": str(ingest),
        "MULTIRAFT_SERVE_L": str(max(4 * ingest, 64)),
        "MULTIRAFT_SERVE_TICKS_PER_PUMP": "4",
    }
    saved = {k: os.environ.get(k) for k in overrides}
    os.environ.update(overrides)
    cluster = EngineProcessCluster(kind="engine_kv", groups=G, seed=42,
                                   device=device)
    nodes = []
    try:
        cluster.start()
        # Warm the server's tick variants once.
        node0 = RpcNode()
        nodes.append(node0)
        warm = EngineClerk(node0.sched, node0.client_end(cluster.host, cluster.port))
        assert sched_wait(node0, warm.put("warm", "1"))

        frames = [
            _pack_clerk_frames(G, ci + 1, frames_per_client, frame)
            for ci in range(n_clients)
        ]
        ok_counts = [0] * n_clients

        def client_main(ci):
            node = RpcNode()
            nodes.append(node)
            end = node.client_end(cluster.host, cluster.port)
            sched = node.sched

            def driver():
                ok = 0
                for blob in frames[ci]:
                    reply = yield sched.with_timeout(
                        end.call("EngineKV.firehose", blob), 60.0
                    )
                    if reply is None or reply is TIMEOUT:
                        continue
                    if not isinstance(reply, (bytes, bytearray, memoryview)):
                        # ("err", reason) — count nothing, keep going
                        # (a crashed driver coroutine would wedge the
                        # whole measurement window).
                        continue
                    err, _ = unpack_reply(reply)
                    ok += int((err == FH_OK).sum())
                return ok

            fut = sched.spawn(driver())
            out = sched.wait(fut, 600.0)
            ok_counts[ci] = 0 if out is TIMEOUT else int(out)

        history = []
        hist_lock = threading.Lock()

        def verifier_main(vi):
            node = RpcNode()
            nodes.append(node)
            sched = node.sched
            end = node.client_end(cluster.host, cluster.port)
            ck = FirehoseClerk(sched, end)

            def driver():
                for j in range(30):
                    key = f"shared{j % 2}"
                    t0 = time.monotonic()
                    if j % 3 == 2:
                        vals = yield from ck.run_batch([("Get", key, "")])
                        inp = KvInput(op=OP_GET, key=key)
                        out = KvOutput(value=vals[0])
                    else:
                        tag = f"({vi}.{j})"
                        yield from ck.run_batch([("Append", key, tag)])
                        inp = KvInput(op=OP_APPEND, key=key, value=tag)
                        out = KvOutput(value="")
                    with hist_lock:
                        history.append(Operation(
                            client_id=vi, input=inp, call=t0,
                            output=out, ret=time.monotonic(),
                        ))

            sched.wait(sched.spawn(driver()), 600.0)

        threads = [
            threading.Thread(target=client_main, args=(ci,),
                             name=f"firehose-client-{ci}")
            for ci in range(n_clients)
        ]
        vthreads = [
            threading.Thread(target=verifier_main, args=(vi,),
                             name=f"firehose-verifier-{vi}")
            for vi in range(2)
        ] if verify else []
        t0 = time.perf_counter()
        for t in threads + vthreads:
            t.start()
        for t in threads + vthreads:
            t.join()
        wall = time.perf_counter() - t0

        total_ok = int(sum(ok_counts))
        porc = "skipped"
        if verify:
            verdict = check_operations(kv_model, history, timeout=60.0)
            assert verdict is not CheckResult.ILLEGAL, (
                "served firehose history not linearizable"
            )
            porc = verdict.value
        # Scrape the server's wire fast-path counters: how often the
        # per-iteration flush ran, how many replies each flush
        # coalesced, and how many payload segments shipped out-of-band.
        wire = {}
        snap = node0.sched.wait(
            node0.client_end(cluster.host, cluster.port).call(
                "Obs.snapshot", None
            ),
            30.0,
        )
        if isinstance(snap, dict):
            met = snap.get("metrics", {})
            flushes = met.get("rpc.flushes", 0)
            replies = met.get("rpc.flush_replies", 0)
            wire = {
                "rpc_flushes": flushes,
                "rpc_flush_replies": replies,
                "frames_per_flush_mean": (
                    round(replies / flushes, 2) if flushes else None
                ),
                "frames_per_flush_p99": met.get("rpc.frames_per_flush_p99"),
                "rpc_oob_buffers": met.get("rpc.oob_buffers", 0),
                "wal_write_batches": met.get("wal.write_batches", 0),
            }
        return {
            "wire": wire,
            "mode": "firehose-sockets",
            "clients": n_clients,
            "G": G,
            "ingest": ingest,
            "frame": frame,
            "ops_ok": total_ok,
            "ops_per_sec": round(total_ok / wall, 1),
            "wall_s": round(wall, 2),
            "porcupine": porc,
            "verifier_ops": len(history),
        }
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for n in nodes:
            n.close()
        cluster.shutdown()


def sched_wait(node, gen, timeout=60.0):
    from ..sim.scheduler import TIMEOUT

    return node.sched.wait(node.sched.spawn(gen), timeout) is not TIMEOUT


def _take_device(argv) -> tuple:
    """``argv`` without ``--device X``, and X (default ``"cuda"``)."""
    argv = list(argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    return argv, device


def main(argv) -> None:
    argv, device = _take_device(argv)
    mode = argv[1] if len(argv) > 1 and not argv[1].isdigit() else ""
    if mode == "firehose":
        # Median-of-3 for the in-process ceiling (same shared-box
        # discipline as bench.py's cross-run statistics); one long
        # multi-client socket window.
        reps = sorted(
            bench_firehose_inprocess(device=device)["ops_per_sec"]
            for _ in range(3)
        )
        socks = bench_firehose_sockets(device=device)
        print(json.dumps({
            "firehose_inprocess_ops_per_sec": reps[1],
            "inprocess_min": reps[0],
            "inprocess_max": reps[2],
            "firehose_sockets_ops_per_sec": socks["ops_per_sec"],
            # The serving gap the wire fast path is chasing: fraction
            # of the in-process ceiling the socketed path sustains.
            "sockets_over_inprocess": round(
                socks["ops_per_sec"] / reps[1], 3
            ) if reps[1] else None,
            "porcupine": socks["porcupine"],
            "sockets": socks,
        }), flush=True)
        return
    n_clerks = int(argv[1]) if len(argv) > 1 else 16
    ops = int(argv[2]) if len(argv) > 2 else 50
    frame = int(argv[3]) if len(argv) > 3 else 64
    per_op = bench(n_clerks, ops, frame=0, device=device)
    framed = bench(n_clerks, ops, frame=frame, device=device)
    print(
        json.dumps({
            **per_op,
            "framed_ops_per_sec": framed["ops_per_sec"],
            "framed_mean_latency_ms": framed["mean_latency_ms"],
            "frame": frame,
        }),
        flush=True,
    )


if __name__ == "__main__":
    main(sys.argv)
