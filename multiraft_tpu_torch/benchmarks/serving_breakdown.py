"""Where a framed serving op's time goes — the measured breakdown
behind the serving-throughput numbers (the PyTorch port of
``benchmarks/serving_breakdown.py``): the frame-granularity breakdown
that decides whether moving frame decode into the C++ reactor would
pay.

Components measured per 64-op frame, in isolation on this host:

* ``codec``     — encode+decode of the request frame (64 EngineCmdArgs)
                  and the 64-reply frame, as the wire does it;
* ``service``   — the in-process ceiling: EngineKVService.batch chain
                  logic + BatchedKV submit/ticket/apply + pump loop,
                  driven WITHOUT sockets on a RealtimeScheduler;
* ``served``    — the full stack over real sockets (client + server
                  processes on this box), from serving_throughput.

If ``service`` >> ``codec`` the bottleneck is Python service logic and
a native frame decoder cannot move the headline; if ``codec``
dominates, the reactor-side decode is the right next lever.

Usage::

    python -m multiraft_tpu_torch.benchmarks.serving_breakdown
        [n_frames] [frame] [--device cpu]

One JSON line.  The service's engine runs on the card unless
``--device cpu`` (``device="cpu"``) asks for the CPU.
"""

from __future__ import annotations

import json
import sys
import time


def bench_codec(frame: int = 64, reps: int = 200) -> dict:
    from ..distributed.engine_wire import (
        EngineCmdArgs,
        EngineCmdReply,
    )
    from ..transport import codec

    args = [
        EngineCmdArgs(op="Put" if i % 3 else "Get", key=f"k{i % 13}",
                      value=f"v{i}", client_id=7, command_id=i + 1)
        for i in range(frame)
    ]
    req = ("req", 1, "EngineKV.batch", args)
    t0 = time.perf_counter()
    for _ in range(reps):
        wire = codec.encode(req)
        codec.decode(wire)
    req_ms = (time.perf_counter() - t0) / reps * 1e3
    reps_frame = ("rep", 1, [EngineCmdReply(err="OK", value="x") for _ in range(frame)])
    t0 = time.perf_counter()
    for _ in range(reps):
        wire = codec.encode(reps_frame)
        codec.decode(wire)
    rep_ms = (time.perf_counter() - t0) / reps * 1e3
    return {
        "codec_req_frame_ms": round(req_ms, 3),
        "codec_rep_frame_ms": round(rep_ms, 3),
        "codec_us_per_op": round((req_ms + rep_ms) / frame * 1e3, 2),
    }


def bench_service(frame: int = 64, n_frames: int = 40,
                  clerks: int = 8, device: str = "cuda") -> dict:
    """In-process ceiling: the real EngineKVService.batch handler on a
    real RealtimeScheduler pump loop — everything the served path does
    except sockets and codec.  The engine runs on ``device`` (the
    reference pins its platform to the CPU here) with the plain tick,
    as the server's."""
    from ..distributed.engine_server import EngineKVService
    from ..distributed.engine_wire import EngineCmdArgs
    from ..distributed.realtime import RealtimeScheduler
    from ..engine.core import EngineConfig
    from ..engine.host import EngineDriver
    from ..engine.kv import BatchedKV

    # Validate BEFORE the expensive engine build (both checks depend
    # only on the args and a class constant).
    if frame > EngineKVService.MAX_BATCH:
        raise ValueError(
            f"frame={frame} exceeds the service cap "
            f"{EngineKVService.MAX_BATCH} — oversized frames answer "
            "ErrBatchTooLarge instantly and would inflate the measurement"
        )
    if n_frames < clerks:
        raise ValueError(f"n_frames={n_frames} must be >= clerks={clerks}")

    sched = RealtimeScheduler()
    done = {"svc": None}

    def build():
        driver = EngineDriver(EngineConfig(G=64, P=3, L=64, E=8, INGEST=8),
                              seed=9, device=device)
        driver.run_until_quiet_leaders(2000)
        kv = BatchedKV(driver)
        kv.pump(4)
        done["svc"] = EngineKVService(sched, kv)

    sched.run_call(build, timeout=600.0)
    svc = done["svc"]

    results = []

    def one_clerk(ci):
        for fi in range(n_frames // clerks):
            args = [
                EngineCmdArgs(
                    op="Put" if i % 3 else "Get",
                    key=f"c{ci}-k{i % 13}", value=f"v{i}",
                    client_id=1000 + ci,
                    command_id=fi * frame + i + 1,
                )
                for i in range(frame)
            ]
            reply = yield sched.spawn(svc.batch(args))
            results.append(reply)

    t0 = time.perf_counter()
    futs = [sched.spawn(one_clerk(c)) for c in range(clerks)]
    for f in futs:
        sched.wait(f, 600.0)
    elapsed = time.perf_counter() - t0
    # Stop the service's pump pipeline too (the reference stops only the
    # loop): a leftover pump thread would contend with what follows in
    # this process.
    svc.stop()
    sched.stop()
    # A timed-out or error reply counted as a completed op would
    # silently inflate the ceiling — demand a fully-OK run.
    bad = sum(
        1 for reply in results for r in reply if r.err != "OK"
    )
    assert bad == 0, f"{bad} ops did not complete OK — rerun on a quieter box"
    total_ops = (n_frames // clerks) * clerks * frame
    return {
        "service_frames": (n_frames // clerks) * clerks,
        "service_ops_per_sec": round(total_ops / elapsed, 1),
        "service_ms_per_frame": round(elapsed / max(
            (n_frames // clerks) * clerks, 1) * 1e3, 2),
    }


def main(argv) -> None:
    from .serving_throughput import _take_device

    argv, device = _take_device(argv)
    n_frames = int(argv[1]) if len(argv) > 1 else 40
    frame = int(argv[2]) if len(argv) > 2 else 64
    out = {"frame": frame}
    out.update(bench_codec(frame))
    out.update(bench_service(frame, n_frames, device=device))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv)
