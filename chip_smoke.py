#!/usr/bin/env python3
"""End-to-end smoke run of the PyTorch/CUDA engine on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` (``$CUDA_HOME/bin`` or ``PATH``) and the
repository's ``multiraft_tpu_torch`` package beside this file.  Phases,
each of which raises on any failed check (so the script exits non-zero
and prints no result line):

1. Card and build: the card's name and power limit from ``nvidia-smi``;
   the hand-written kernels built from ``multiraft_tpu_torch/engine/csrc``,
   with what ``nvcc -Xptxas -v`` says of each (registers, shared memory,
   stack frame, spills); a kernel with a stack frame or spills fails.
2. Kernels: each kernel's output equals its plain PyTorch version on the
   card, exactly, on seeded inputs in the engine's ranges at the headline
   shape (G=10,000, P=3, L=192) and at G=100,000, P=5, L=192; the
   kernel, its plain version and its memory/operation bound are timed,
   beside the bytes the kernel's design moves and the launch floor: an
   empty kernel launched by the same route with the same grid.
   (b) The draw kernel (``csrc/threefry.cu``) through ``prng.randint``,
   ``random_bits`` and ``uniform`` on the card equals the plain int64
   draw on the card, exactly, one launch a draw, at each cell's jitter
   shape (600,000 x 3 and 600,000 x 4 with span 10, 100,000 x 5 with span
   30), at offset 0 and at an offset whose counters cross 2**32; kernel
   and plain draw timed beside the bound of its integer operations and
   stored bytes.
3. Serving at full width (the main path, with the launch counters reset
   just before and read just after): an ``EngineDriver`` at the headline
   deployment elects one leader in every group, a ``BatchedKV`` answers
   a few hundred Put/Append/Get requests across many groups (every value
   held against a plain dict model of the same operations), and a fused
   firehose batch runs; both kernels and the draw kernel must have
   launched.
4. Whole engine, kernels against plain versions: 200 ticks from one seed
   with the kernels on and off, all planes equal; and a small engine on
   the card against the same engine on the CPU under message drops.
5. The operations surface, each sub-phase with the launch counters reset
   just before it and read just after:
   (a) the headline deployment under a firehose backlog and 1% drops,
   100 replicas crashed and 100 cut at tick 50, restarted and healed at
   tick 100, an ``InvariantMonitor`` observing every 50 ticks; commits
   must advance after the heal and every group end with one leader;
   (b) at tick 200 a checkpoint, restored on the card and on the CPU;
   all three drivers step 30 more faulted ticks and must be equal on
   every plane, on ``commits_total`` and on ``content_fingerprint``;
   (c) G=256 under 2/3 reorder, crashes, restarts, a slot reset and 10%
   drops: the card equals the CPU on every plane, the delay queue and
   the reorder RNG after 150 ticks;
   (d) joint consensus on the plain path at G=10,000 x P=5: slot 3
   replaces voter 2 in 8 groups; the kernel path refuses ``add_learner``;
   (e) the tracer on run (a): one ``tick`` span per tick, whose commits
   sum to the ``commits_total`` delta, and ``tick_wall_s`` percentiles.
6. The sharded engine, each sub-phase with the launch counters reset
   just before it and read just after:
   (a) ``BatchedShardKV`` at the headline deployment, kernels on: engine
   group 0 is the config RSM and gids 1..9,999 join in one admin op; a
   firehose of 8 frames of 4,096 Put rows (some for gids not hosted,
   which resolve WRONG_GROUP) through ``submit_frame``, routed on the
   card by ``route_keys``; the shard owners leave under that traffic and
   a shard moves to a named gid while the others keep serving; every
   shard ends SERVING at exactly one replica with no copy left at its
   old owners, and every acknowledged write reads back through
   ``get_fast`` and a logged Get; ``route_keys`` on the card equals host
   routing for 1M hashes, negative ones included;
   (b) two split drivers on one card (G=64, host-paced compaction,
   owners ``[0, 1, 1]``), slabs exchanged every pump: a ``SplitKV`` pair
   elects and commits; a ``SplitShardKV`` pair joins gid 1, takes writes,
   joins gid 2, and driver 0 is killed mid-migration; driver 1 finishes
   the migration alone and serves every acknowledged write;
   (c) a seeded sharded script (join, writes, leave, move) at G=64 on
   the card and on the CPU, equal at every admin point; then the
   ``*_gid`` membership facades replace a dead voter at G=64 x P=5 on
   the plain path, each leg twice.

7. The durable engine KV server, served from the card: ``python -m
   multiraft_tpu_torch serve-kv --groups 10000`` as a child process at
   the headline widths the reference's serve knobs set (L=192, E=48,
   INGEST=48; P=3; the plain tick, as the reference serves it), with its
   data directory in ``build/smoke/serve``:
   (a) seconds to ``ready <port>``, and the card memory the server holds;
   (b) 8 port ``EngineClerk`` threads of 40 Put/Append/Get ops on
   single-writer keys, one ``PipelinedClerk`` frame of 1,024 ops and 16
   ``FirehoseClerk`` frames of 4,096 rows, every answer held against a
   dict model; op latency p50/p99, ops/s, firehose rows acknowledged per
   second, and the server's ``pump.wall_s``/``pump.cpu_s`` percentiles
   from a raw ``Obs.hist`` call;
   (c) ``kill -9`` in the middle of a firehose, a restart on the same
   directory (seconds to ``ready``: checkpoint restore plus WAL replay);
   every acknowledged write reads back, every acknowledged append tag
   exactly once;
   (d) SIGTERM (exit 0, final checkpoint), a restart that replays
   nothing, everything read back again;
   (e) one ``kv put/append/get`` round trip through the command line.
8. The sharded engine served over TCP, each sub-phase with the launch
   counters reset just before it and read just after (the servers are
   child processes that build their engines as the reference's do, P=3,
   L=64, E=8, INGEST=8, kernels off; this process launches nothing):
   (a) ``serve-shardkv --groups 10000`` (group 0 the config RSM): seconds
   to ``ready`` and card memory; gids 1..9,999 joined by one admin RPC,
   ticks and seconds until a Get answers on every shard; 9,000 keys
   loaded as single-op sessions in firehose frames; 8
   ``EngineShardNetClerk`` threads of appends and Gets across a live
   ``move`` and ``leave``, their wall-clock history checked by the
   port's native porcupine and every append tag once; a
   ``ShardFirehoseClerk`` firehose cut by ``kill -9``, the restart
   replaying the WAL through ``ShardWalReplay`` with every acknowledged
   write read back; SIGTERM (exit 0) and a restart replaying nothing;
   ``kv --service EngineShardKV`` put/append/get;
   (b) two ``serve-shardkv --gids ... --peer ...`` fleet processes of
   5,000 and 4,999 gids: fleet clerks across a join that moves shards
   between the processes (porcupine-checked), then a leave that moves
   the rest, the pulling process killed mid-migration and restarted,
   every acknowledged write read back, SIGTERM exit 0 for both;
   (c) ``SplitProcessCluster`` and ``SplitShardProcessCluster`` at G=64
   per process, two processes each (the two clusters at once): the
   minority owner killed under load (mid-migration in the sharded
   form), the survivors serving, a durable restart, every acknowledged
   append read back once.
9. Verification, each sub-phase with the launch counters reset just
   before it and read just after:
   (a) ``bench.py``'s verified run at the headline deployment (kernels
   on, seed 7): 200 warm-up ticks, 200 at INGEST and one traced chunk,
   then 3 traced chunks of 200 ticks (``bench.py`` runs 3 such runs;
   one here) with the leaders of 48 groups killed at each interior
   boundary by ``multiraft_tpu_torch.bench``'s ``apply_leader_kills``
   (``traced_run`` and ``verify_run`` from there too); the records go through
   ``engine.bench_verify`` (commit latency of every entry, porcupine
   over 128 sampled groups, the native DFS on 8 of them), which must
   find OK with 0 entries unaccounted and each kernel launched at least
   once a tick; the same script at G=64 gives equal records and results
   on the card and on the CPU;
   (b) every ``conformance`` scenario (seed 7) and fuzz seeds 101, 202
   and 303 through ``run_both`` with the engine on the card, each card
   stream equal to the sim's and to the CPU engine's; then ``cocktail``
   at G=256. 9(b) and 10(c) run in a spawned side process (its own
   launch counters, reset before each and read after) while phase 8
   waits on its servers; phase 9 starts once that process has sent
   both results, so 9(a) and 10(a)-(b) time the card alone.
10. The placed, self-healing fleet (``harness/fleet.py`` over the
   ``serve-shardkv`` fleet processes, P=3, L=64, E=8, INGEST=8, kernels
   off), each sub-phase with the launch counters reset just before it
   and read just after:
   (a) ``PlacedFleet`` of 3 processes x 256 gids with 160 spare slots
   each (cut from 1,000, PERF.md section 4), sync shipping to a data
   dir, the controller at the reference's chaos knobs throughout: one
   join of all 768 gids; skewed closed-loop appends
   (hot factor 6) on 6 shard owners of process 0 until the controller
   rebalances (spread before and after); a ``make_schedule`` nemesis
   (seed 7, delay/drop/sever/partition, ~20 s) under ``run_clerk_load``,
   ending in a ``kill_mesh_process`` of the process then hosting the most
   groups; every victim gid re-placed (durably) and led on a survivor,
   each shard owner among them serving a Put/Get; no acknowledged write
   lost; the whole clerk history linearizable (native porcupine); every
   window verified; then ``collect_bundle`` and the doctor, which must
   name the killed process an UNCLEAN DEATH, hold a PLACE failover
   record for every victim gid and find no placement thrash;
   (b) 3 processes x 64 gids, P=4 with voters {0,1,2}: a group's leader
   replica killed under acknowledged writes and healed (learner,
   catch-up, joint, promote), then again with the controller crashed
   mid-reconfig and a fresh one resuming from the replicated intent;
   (c) ``InProcessFleet`` at 3 x 2 and 3 x 32 gids, the same seed and
   script of legs through ``LocalFleetTransport`` (a live migration, a
   replica replacement, a durable recovery from a standby, an empty
   adoption after the kill) on the card and on the CPU, equal planes,
   data, dedup tables and placement map after every leg.

11. The groups-sharded engine (``engine/mesh.py``), each sub-phase with
   the launch counters reset just before it and read just after; the
   mesh runs the plain tick (the reference's mesh runs without its
   Pallas kernels), so both counts stay 0:
   (a) ``EngineDriver(mesh=make_mesh(1))`` at the headline widths:
   elections, 400 ``BatchedKV`` requests against a dict model, 5(a)'s
   fault script under an invariant monitor, a checkpoint refused without
   a mesh and restored onto a 1-card mesh and a 1-shard CPU mesh, all
   three equal on every plane after 30 more faulted ticks;
   (b) ``Mesh(["cuda:0"] * 4)`` at G=64 equal to 4 CPU shards after each
   of 300 ticks of drops, crashes, partitions and reorder; the 4-shard
   mesh at the headline widths through 100 firehose ticks audited by
   ``assert_zero_collectives``, and its firehose ms per tick beside a
   1-shard mesh's (shards sharing one card measure the partitioning,
   not multi-card scaling);
   (c) ``serve-kv --groups 10000 --mesh-devices 1``, durable: ``ready``
   and card memory, 8 clerks against a dict model, ``kill -9`` in a
   firehose and a restart that restores onto the mesh with every
   acknowledged write read back, SIGTERM exit 0; then two ``serve-shardkv
   --mesh-devices 1`` fleet processes migrating shards between them.

12. The guided tour and the soak, side by side, with the launch counters
   reset just before and read just after (the children build their
   engines without the kernels, as the reference's examples and soak do;
   this process launches nothing) and the card's memory sampled
   throughout:
   (a) the 13 examples of ``multiraft_tpu_torch/examples/``, each a child
   process with the default device (the card) in its own directory of
   ``build/smoke/tour``, all started at once: each must exit 0 (exit
   code, seconds and last line printed; 04's leader tick, commit count
   and commits/s on the card);
   (b) ``python -m multiraft_tpu_torch.soak 2``: the six fault regimes
   of 20 s once each, every Raft invariant checked on every tick, then
   the heal; each regime's ticks, commits, dead and cut replicas and ms
   a tick, and ``soak OK`` required.

13. BASELINE config #5 end to end, with the launch counters reset just
   before and read just after: ``multiraft_tpu_torch.bench.run_config5``
   on the card with both kernels at G=100,000 x P=5 (L=112, E=INGEST=28;
   200 boot ticks, a 100-tick warm chunk, 3 rounds of 100 traced ticks,
   10% hot groups at the full ingest, 1% of the leaders killed a round):
   ms a tick and ticks/s, commits/s (hot and cold), commit latency
   p50/p99, the card's memory; 0 entries unaccounted, each kernel
   launched once a tick, the draw kernel more often than that (the
   jitter a tick and the initial deadlines), and at least 90% of the
   revived hot ex-leaders rebased past the last index they held when
   they died (the snapshot
   fast-forward); each kernel against its plain version on the run's
   final state (timed, with its bound, grid and tail tile), the jitter
   draw at 100,000 x 5 against the CPU's, and the tick's roofline bound
   (``benchmarks/roofline.py``) beside the measured tick and 9(a)'s.

14. The served-path rigs (``multiraft_tpu_torch/benchmarks`` and
   ``multiraft_tpu_torch/scripts``), each sub-phase with the launch
   counters reset just before it and read just after (the servers, the
   split drivers and the fleet build their engines without the kernels,
   as the reference's serve, so each count stays 0):
   (a) ``bench_firehose_sockets`` against ``serve-kv --groups 10000`` at
   phase 7's serve widths (3 clients x 12 frames of 12,288 rows, two
   verifier clerks): every row acknowledged, porcupine ok, the wire fast
   path engaged; ``bench_firehose_inprocess`` at the reference's defaults
   on the card (one run, not ``main``'s median of 3) and the socket over
   in-process ratio;
   (b) ``openloop.sweep`` at G=10,000, the same widths, Poisson, seed 7,
   keyspace 512, the reference's ladder of 250-8,000 ops/s in steps of
   2 s (cut from 4), a 50 ms p99 target, the porcupine sampler
   throughout (ok required): max sustainable rate, the knee and the
   stages there; the report (``build/smoke/loadcurve.json``) gated by
   ``python -m multiraft_tpu_torch.scripts.bench_compare --family
   loadcurve`` against itself as the only round (exit 0, its table);
   (c) ``serving_throughput.bench`` per-op and framed (16 clerks x 50
   ops, frame 64, G=64) and ``serving_breakdown`` at its defaults;
   (d) ``split_bench`` at G=8: the slab exchange's overhead on one card
   (100 ticks, cut from 400), split serving per-op and framed (100 ops,
   cut from 400), the failover window, every acknowledged append read
   back;
   (e) ``transport_echo``'s sim, native, two-process and C-floor lines
   and the gap (host only);
   (f) ``placement_scenario --durable --quick``: exit 0, no
   acknowledged write lost, the failover inside 60 s.
   Phase 14 runs mostly in spawned processes, each with its own launch
   counters: 14(b) beside phases 11 and 12, 14(a) and (c) in one process
   and 14(d) and (f) in another beside phase 12; phase 13 runs after
   them all, alone on the card, and 14(e) last, alone.

The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --only 2b 10a 10b 10c 11a 11b 11c 12a 12b 13 14a 14b
14c 14d 14e 14f`` runs the named sub-phases alone (phase 10's with the
controller's time in each transport and map verb; 14(e) in this process)
and prints no contract lines.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HEADLINE = dict(G=10_000, P=3, L=192, E=48, INGEST=48, HB_TICKS=9)
CONFIG5 = dict(G=100_000, P=5, L=192)
H100_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
H100_SCALAR_OPS_PER_S = 67e12  # H100 SXM non-tensor FP32/INT32 issue rate
# Where phase 5 writes its checkpoint (inside the checkout, gitignored).
SCRATCH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke")
REPLACES = {
    "quorum_commit": "multiraft_tpu/engine/pallas_ops.py:37",
    "vote_tally": "multiraft_tpu/engine/pallas_ops.py:132",
}


# In the side process (``Beside``) the log is kept and handed back with
# each result, so its lines print where the result is read.
_LOG_BUFFER = None


def log(msg: str) -> None:
    if _LOG_BUFFER is not None:
        _LOG_BUFFER.append(msg)
        return
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> dict:
    """Per-call times of ``fn`` in ms.

    ``host``: wall time of ``iters`` calls ending in a synchronise, what
    a caller pays when the host sets the pace.  ``warm`` and ``cold``
    are device times from CUDA events, with the calls queued behind a
    device-side sleep longer than it takes the host to queue them, so
    the events see the device alone: ``warm`` over back-to-back calls
    (inputs left in the 50 MB L2 by the call before), ``cold`` around
    each call after a 64 MB write has evicted the L2 (the case the
    device-memory bound describes)."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / iters
    # ~2 GHz SM clock; twice the host's queueing time, plus the flushes.
    sleep = lambda: torch.cuda._sleep(int((host_s + 50e-6) * iters * 4e9))
    ev = lambda: torch.cuda.Event(enable_timing=True)

    a, b = ev(), ev()
    sleep()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    warm = a.elapsed_time(b) / iters

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    pairs = [(ev(), ev()) for _ in range(iters)]
    sleep()
    for a, b in pairs:
        flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    cold = sum(a.elapsed_time(b) for a, b in pairs) / iters
    return {"host": host_s * 1e3, "warm": warm, "cold": cold}


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def commit_inputs(G: int, P: int, L: int, seed: int):
    """Seeded inputs in the engine's ranges: last = base + log_len with
    log_len below the compaction threshold, eff_match in [base-2, last]
    with the diagonal at last, commit in [base, last], ring terms at most
    the current term (mostly equal to it), about one leader per group."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    ri = lambda lo, hi, shape: torch.randint(
        lo, hi, shape, generator=g, device=dev, dtype=torch.int32
    )
    term = ri(1, 50, (G, P))
    base = ri(0, 100_000, (G, P))
    log_len = ri(0, L - 2 * 48 - 2, (G, P))
    last = base + log_len
    span = (log_len + 3)[..., None]
    eff_match = last[..., None] - (
        torch.rand((G, P, P), generator=g, device=dev) * span
    ).to(torch.int32)
    eye = torch.eye(P, dtype=torch.bool, device=dev)
    eff_match = torch.where(eye, last[..., None], eff_match)
    commit = base + (torch.rand((G, P), generator=g, device=dev) * (log_len + 1)).to(torch.int32)
    base_term = torch.minimum(ri(1, 50, (G, P)), term)
    older = torch.minimum(ri(1, 50, (G, P, L)), term[..., None])
    log_term = torch.where(
        torch.rand((G, P, L), generator=g, device=dev) < 0.7, term[..., None], older
    )
    is_leader = torch.rand((G, P), generator=g, device=dev) < (1.0 / P)
    return (eff_match.contiguous(), term, commit, base, base_term,
            log_term.contiguous(), is_leader)


def tally_inputs(G: int, P: int, seed: int):
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    votes = torch.rand((G, P, P), generator=g, device=dev) < 0.5
    role = torch.randint(0, 3, (G, P), generator=g, device=dev, dtype=torch.int32)
    alive = torch.rand((G, P), generator=g, device=dev) < 0.9
    return votes, role, alive


def _sector_bytes(index, itemsize: int = 4) -> int:
    """Bytes in the 32-byte sectors that hold the elements at ``index``
    of a contiguous array of ``itemsize``-byte elements."""
    import torch

    return torch.unique(index.reshape(-1) * itemsize // 32).numel() * 32


def commit_bound(args, quorum: int) -> tuple:
    """(bound_ms, bound_by, bytes) of one quorum-commit call on these
    inputs: is_leader and commit read and the output written in full,
    and of the other inputs only the 32-byte sectors holding the words
    this data needs: a leader's eff_match row, and where a leader's
    quorum index q passes its commit, its term and base words and the
    term of q (base_term when q is the snapshot base, else the ring)."""
    import torch

    eff_match, term, commit, base, base_term, log_term, is_leader = args
    G, P, _ = eff_match.shape
    L = log_term.shape[-1]
    q = torch.sort(eff_match, dim=-1).values[..., P - quorum]
    rows = torch.arange(G * P, device=q.device, dtype=torch.int64).reshape(G, P)
    lead = rows[is_leader]
    adv = is_leader & (q > commit)
    at_base = adv & (q == base)
    in_ring = adv & (q != base)
    ring_words = rows[in_ring] * L + torch.remainder(q[in_ring], L).long()
    nbytes = (
        is_leader.numel() + commit.numel() * 4 + commit.numel() * 4
        + _sector_bytes(lead[:, None] * P + torch.arange(P, device=q.device))
        + 2 * _sector_bytes(rows[adv]) + _sector_bytes(rows[at_base])
        + _sector_bytes(ring_words)
    )
    ops = G * P * 4 + lead.numel() * (P * P + 12)
    return _bound(nbytes, ops) + (nbytes,)


def tally_bound(args) -> tuple:
    """As :func:`commit_bound`: role and alive read and the output written
    in full, and the 32-byte sectors of the vote rows of live candidates."""
    import torch

    votes, role, alive = args
    G, P, _ = votes.shape
    rows = torch.arange(G * P, device=votes.device, dtype=torch.int64)
    cand = rows[((role == 1) & alive).reshape(-1)]
    votes_read = cand[:, None] * P + torch.arange(P, device=votes.device)
    nbytes = (role.numel() * 4 + alive.numel() + G * P
              + _sector_bytes(votes_read, itemsize=1))
    ops = G * P * 4 + cand.numel() * (P + 2)
    return _bound(nbytes, ops) + (nbytes,)


def commit_design_bytes(args, quorum: int) -> int:
    """Bytes the quorum-commit kernel moves on these inputs: every row's
    staged planes (eff_match, commit, is_leader: 4P + 5 bytes), the
    output, and for each leader whose quorum index q passes its commit
    the 32-byte sectors of its term and base words and of the ring word
    of q (read even where q is the snapshot base), and of base_term where
    it is."""
    import torch

    eff_match, term, commit, base, base_term, log_term, is_leader = args
    G, P, _ = eff_match.shape
    L = log_term.shape[-1]
    q = torch.sort(eff_match, dim=-1).values[..., P - quorum]
    rows = torch.arange(G * P, device=q.device, dtype=torch.int64).reshape(G, P)
    adv = is_leader & (q > commit)
    ring_words = rows[adv] * L + torch.remainder(q[adv], L).long()
    return (G * P * (4 * P + 5) + G * P * 4 + 2 * _sector_bytes(rows[adv])
            + _sector_bytes(ring_words) + _sector_bytes(rows[adv & (q == base)]))


def tally_design_bytes(args) -> int:
    """Bytes the vote-tally kernel moves: every row's staged planes
    (votes, role, alive: P + 5 bytes) and the output."""
    votes = args[0]
    G, P, _ = votes.shape
    return G * P * (P + 5) + G * P


# The kernels whose ptxas facts phase 1 checks; the draw kernel once for
# each sampler (``threefry_kernel<S>``, S as ``prng.BITS``, ``RANDINT``,
# ``UNIFORM``).
PTXAS_KERNELS = ("quorum_commit_kernel", "vote_tally_kernel", "threefry_kernel<0>",
                 "threefry_kernel<1>", "threefry_kernel<2>")


def _kernel_name(mangled: str):
    """The name in ``PTXAS_KERNELS`` of a mangled kernel name, or None."""
    import re

    m = re.search(r"threefry_kernelILi(\d+)EE", mangled)
    if m:
        return f"threefry_kernel<{m.group(1)}>"
    return next((k for k in PTXAS_KERNELS[:2] if k in mangled), None)


def ptxas_facts(text: str) -> dict:
    """Registers, stack frame and spill bytes of each kernel, from
    ``nvcc -Xptxas -v`` output ("Function properties for <name>" comes
    before the lines that give them)."""
    import re

    facts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = _kernel_name(m.group(1))
            continue
        if name is None:
            continue
        f = facts.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            f.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                     spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            f["registers"] = int(m.group(1))
    return facts


def phase_build(kernels) -> None:
    t0 = time.perf_counter()
    lib = kernels.build_library()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s")
    report = kernels.ptxas_report()
    for line in report.splitlines():
        if "ptxas" in line or "stack frame" in line:
            log(f"ptxas: {line.strip()}")
    facts = ptxas_facts(report)
    for name in PTXAS_KERNELS:
        f = facts.get(name, {})
        log(f"ptxas {name}: {json.dumps(f, sort_keys=True)}")
        if "stack" not in f:
            raise AssertionError(f"ptxas printed no stack frame line for {name}")
        if f["stack"] or f["spill_stores"] or f["spill_loads"]:
            raise AssertionError(f"{name} uses local memory: {f}")


def launch_floor(kernels, G: int, P: int, kernel: str) -> dict:
    """Times an empty kernel launched by the kernels' route with the grid,
    block and shared memory of ``kernel``'s tile plan at G x P."""
    import torch

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = kernels.tile_plan(G * P, P, kernel, sms=sms)
    t = cuda_ms(lambda: kernels.empty_launch(plan, dev), 200)
    return dict(grid=plan.grid, threads=plan.tile, smem_bytes=plan.smem_bytes,
                **t)


def _bound(nbytes: int, ops: int) -> tuple:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_SCALAR_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(kernels) -> dict:
    import torch

    results = {}
    shapes = [("headline", HEADLINE["G"], HEADLINE["P"], HEADLINE["L"]),
              ("config5", CONFIG5["G"], CONFIG5["P"], CONFIG5["L"])]
    for tag, G, P, L in shapes:
        quorum = P // 2 + 1
        c_args = commit_inputs(G, P, L, seed=G + P)
        t_args = tally_inputs(G, P, seed=G + P + 1)
        checks = (
            ("quorum_commit",
             lambda: kernels.quorum_commit(*c_args, quorum),
             lambda: kernels.quorum_commit_plain(*c_args, quorum),
             commit_bound(c_args, quorum),
             commit_design_bytes(c_args, quorum)),
            ("vote_tally",
             lambda: kernels.vote_tally(*t_args, quorum),
             lambda: kernels.vote_tally_plain(*t_args, quorum),
             tally_bound(t_args),
             tally_design_bytes(t_args)),
        )
        for name, kern, plain, bound, design_bytes in checks:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise AssertionError(f"{name} kernel != plain version at {tag}")
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            k_t = cuda_ms(kern, 200)
            p_t = cuda_ms(plain, 50)
            floor = launch_floor(kernels, G, P, name)
            bound_ms, bound_by, nbytes = bound
            results[(name, tag)] = dict(
                max_abs_err=err, ms=k_t["cold"], plain_ms=p_t["cold"],
                bound_ms=bound_ms, bound_by=bound_by, shape=[G, P, L],
                warm_ms=k_t["warm"], host_ms=k_t["host"],
                plain_warm_ms=p_t["warm"], plain_host_ms=p_t["host"],
                floor_ms=floor["cold"], floor_warm_ms=floor["warm"],
                floor_host_ms=floor["host"],
            )
            log(f"launch floor {name} {tag}: empty kernel, grid "
                f"{floor['grid']} x {floor['threads']} threads, "
                f"{floor['smem_bytes']} B shared memory: device cold "
                f"{floor['cold'] * 1e3:.2f} us, warm {floor['warm'] * 1e3:.2f} us, "
                f"host-paced {floor['host'] * 1e3:.2f} us")
            # How many rows the check decides non-trivially.
            moved = got != c_args[2] if name == "quorum_commit" else got
            log(f"kernel {name} {tag} G={G} P={P} L={L}: equal "
                f"({int(moved.sum())} rows set); device cold "
                f"{k_t['cold'] * 1e3:.2f} us, warm {k_t['warm'] * 1e3:.2f} us, "
                f"host-paced {k_t['host'] * 1e3:.2f} us; plain cold "
                f"{p_t['cold'] * 1e3:.2f} us, warm {p_t['warm'] * 1e3:.2f} us, "
                f"host-paced {p_t['host'] * 1e3:.2f} us; bound "
                f"{bound_ms * 1e3:.3f} us by {bound_by} ({nbytes} B); "
                f"design_bytes {design_bytes} B")
    return results


# Phase 2(b)'s draws: each cell's [G, P] election jitter and ELECT range.
DRAWS = (("r3", (600_000, 3), 10, 20), ("j3", (600_000, 4), 10, 20),
         ("c5", (100_000, 5), 30, 60))
# Integer operations of one threefry block: 2 key adds, 20 rounds of an
# add, a rotate and an xor, 5 key injections of 2 adds, the output xor.
THREEFRY_BLOCK_OPS = 2 + 20 * 3 + 5 * 2 + 1
# An element's operations by sampler: randint's two blocks and its combine
# (3 remainders, a multiply, 2 adds); uniform's shift, or and subtract.
DRAW_OPS = {"random_bits": THREEFRY_BLOCK_OPS, "randint": 2 * THREEFRY_BLOCK_OPS + 6,
            "uniform": THREEFRY_BLOCK_OPS + 3}


def draw_bound(sampler: str, n: int, itemsize: int) -> tuple:
    """(bound_ms, bound_by, bytes, ops) of one draw of ``n`` elements: its
    integer operations at the scalar rate beside the bytes it stores (it
    reads nothing)."""
    nbytes, ops = n * itemsize, n * DRAW_OPS[sampler]
    return _bound(nbytes, ops) + (nbytes, ops)


def phase_draw(kernels) -> dict:
    """Phase 2(b): the draw kernel through ``prng.random_bits``,
    ``randint`` and ``uniform`` on the card, held exactly to the plain
    int64 draw on the card (``prng.*_plain``) at each cell's jitter shape,
    at offset 0 and at an offset whose counters cross 2**32, then timed
    beside the plain draw and its bound."""
    import torch

    from multiraft_tpu_torch.utils import prng

    dev = torch.device("cuda")
    key = prng.fold_in(prng.fold_in(prng.PRNGKey(20), 1), 7)
    results = {}
    for tag, shape, lo, hi in DRAWS:
        n = shape[0] * shape[1]
        draws = (
            ("randint", lambda o: prng.randint(key, shape, lo, hi, dev),
             lambda o: prng.randint_plain(key, shape, lo, hi, dev)),
            ("random_bits", lambda o: prng.random_bits(key, shape, dev, o),
             lambda o: prng.random_bits_plain(key, shape, dev, o)),
            ("uniform", lambda o: prng.uniform(key, shape, dev, o),
             lambda o: prng.uniform_plain(key, shape, dev, o)),
        )
        for name, kern, plain in draws:
            offsets = (0,) if name == "randint" else (0, 2**32 - n // 2)
            for offset in offsets:
                kernels.reset_launches()
                got, want = kern(offset), plain(offset)
                torch.cuda.synchronize()
                if prng.KERNEL_LAUNCHES != 1 or max(kernels.LAUNCHES.values()) > 0:
                    raise AssertionError(
                        f"draw {name} {tag}: {prng.KERNEL_LAUNCHES} draw launches, "
                        f"{kernels.LAUNCHES}")
                if got.dtype != want.dtype or not torch.equal(got, want):
                    raise AssertionError(f"draw {name} {tag} offset {offset}: kernel != "
                                         f"plain draw")
            k_t = cuda_ms(lambda: kern(0), 200)
            p_t = cuda_ms(lambda: plain(0), 20)
            bound_ms, bound_by, nbytes, ops = draw_bound(name, n, got.element_size())
            results[(name, tag)] = dict(
                max_abs_err=0, ms=k_t["cold"], warm_ms=k_t["warm"], host_ms=k_t["host"],
                plain_ms=p_t["cold"], plain_warm_ms=p_t["warm"], plain_host_ms=p_t["host"],
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=ops,
                shape=list(shape), span=hi - lo if name == "randint" else None,
            )
            log(f"draw {name} {tag} {shape[0]} x {shape[1]}"
                f"{f', span {hi - lo}' if name == 'randint' else ''}: equal to the plain "
                f"draw (offsets {', '.join(map(str, offsets))}), one launch a draw; device cold "
                f"{k_t['cold'] * 1e3:.2f} us, warm {k_t['warm'] * 1e3:.2f} us, host-paced "
                f"{k_t['host'] * 1e3:.2f} us; plain cold {p_t['cold'] * 1e3:.2f} us, warm "
                f"{p_t['warm'] * 1e3:.2f} us, host-paced {p_t['host'] * 1e3:.2f} us; bound "
                f"{bound_ms * 1e3:.3f} us by {bound_by} ({ops} operations, {nbytes} B)")
    return results


# ---------------------------------------------------------------------------
# Phase 3: the main path at full width
# ---------------------------------------------------------------------------


def phase_serving(card: str) -> dict:
    import numpy as np

    from multiraft_tpu_torch.engine.core import EngineConfig
    from multiraft_tpu_torch.engine.host import EngineDriver
    from multiraft_tpu_torch.engine.kv import BatchedKV

    G = HEADLINE["G"]
    cfg = EngineConfig(use_kernels=True, **HEADLINE)
    d = EngineDriver(cfg, seed=0, device="cuda")
    t0 = time.perf_counter()
    if not d.run_until_quiet_leaders(500):
        raise AssertionError("not every group elected a leader in 500 ticks")
    lead = d.leaders_per_group()
    if not (lead == 1).all():
        raise AssertionError(f"leaders per group: min {lead.min()} max {lead.max()}")
    log(f"serving: one leader in all {G} groups after {d.tick} ticks "
        f"({time.perf_counter() - t0:.2f} s)")

    kv = BatchedKV(d, record_groups=[0, 1])
    n, groups, pumps, wall, reads = _kv_against_model(kv, G)
    log(f"serving: {n} logged requests over {len(groups)} groups "
        f"answered in {pumps} pumps ({wall:.2f} s), {reads} reads match the "
        f"dict model")
    for g in (0, int(groups[0])):
        d.check_log_matching(g)

    # A fused firehose batch: every group's leader ingests INGEST a tick.
    n = 100
    d.start_bulk(np.full(G, HEADLINE["INGEST"] * n, np.int64))
    c0 = d.commits_total  # a readback: the device is idle here
    t0 = time.perf_counter()
    d.step(n)  # ends in the batch's readback
    wall = time.perf_counter() - t0
    commits = d.commits_total - c0
    if commits <= 0:
        raise AssertionError("the firehose committed nothing")
    fh = dict(ticks=n, commits=commits, ms_per_tick=wall / n * 1e3,
              commits_per_s=commits / wall)
    log(f"firehose: {n} fused ticks, {commits} commits, "
        f"{fh['ms_per_tick']:.3f} ms/tick, {fh['commits_per_s']:.0f} commits/s "
        f"[{card}]")
    return fh


def _kv_against_model(kv, G: int, seed: int = 7, n: int = 400, n_groups: int = 120):
    """``n`` logged Get/Put/Append requests over ``n_groups`` groups of a
    ``BatchedKV``, each answer and then three reads per group held
    against a dict model.  Returns (requests, groups, pumps, s, reads)."""
    import numpy as np

    from multiraft_tpu_torch.engine.kv import KVOp

    rng = np.random.default_rng(seed)
    model = [dict() for _ in range(G)]
    expect = []  # (ticket, expected value or None)
    cmd = {}
    groups = rng.choice(G, size=min(n_groups, G), replace=False)
    for i in range(n):
        g = int(groups[i % len(groups)])
        key = f"k{int(rng.integers(0, 3))}"
        op = int(rng.choice([0, 1, 2, 2]))  # Get / Put / Append via the log
        client = int(rng.integers(1, 5))
        cmd[client] = cmd.get(client, 0) + 1
        val = f"{i}:{client};"
        if op == 0:
            want = model[g].get(key, "")
        elif op == 1:
            model[g][key] = val
            want = ""
        else:
            model[g][key] = model[g].get(key, "") + val
            want = ""
        t = kv.submit(g, KVOp(op=op, key=key, value=val, client_id=client,
                              command_id=cmd[client]))
        expect.append((t, want))
    t0 = time.perf_counter()
    pumps = 0
    while not all(t.done for t, _ in expect):
        kv.pump(2)
        pumps += 1
        if pumps > 200:
            raise AssertionError("KV tickets still pending after 200 pumps")
    wall = time.perf_counter() - t0
    for t, want in expect:
        if t.failed or t.value != want:
            raise AssertionError(
                f"group {t.group}: ticket failed={t.failed} value {t.value!r} "
                f"!= model {want!r}"
            )
    reads = 0
    for g in groups.tolist():
        for key in ("k0", "k1", "k2"):
            got = kv.get(g, key)
            if got.value != model[g].get(key, ""):
                raise AssertionError(f"read {g}/{key}: {got.value!r}")
            reads += 1
    return len(expect), groups, pumps, wall, reads


# ---------------------------------------------------------------------------
# Phase 4: whole engine, kernels against plain versions; card against CPU
# ---------------------------------------------------------------------------


def _run(cfg, device, ticks: int, drop_prob: float, seed: int):
    import numpy as np

    from multiraft_tpu_torch import convert
    from multiraft_tpu_torch.engine.host import EngineDriver

    d = EngineDriver(cfg, seed=seed, device=device)
    d.start_bulk(np.full(cfg.G, 20 * ticks, np.int64))
    d.step(ticks // 2)
    d.drop_prob = drop_prob
    d.set_edge(0, 0, 1, False)
    d.step(ticks - ticks // 2)
    return d.np_state(), convert.mailbox_to_numpy(d.inbox), d.commits_total


def _assert_same(a, b, what: str) -> None:
    import numpy as np

    for part_a, part_b in zip(a[:2], b[:2]):
        for k in part_a:
            if part_a[k].dtype != part_b[k].dtype or not np.array_equal(
                part_a[k], part_b[k]
            ):
                raise AssertionError(f"{what}: plane {k} differs")
    if a[2] != b[2]:
        raise AssertionError(f"{what}: commits {a[2]} != {b[2]}")


def phase_whole_engine() -> None:
    from multiraft_tpu_torch.engine.core import EngineConfig

    t0 = time.perf_counter()
    with_k = _run(EngineConfig(use_kernels=True, **HEADLINE), "cuda", 200, 0.01, 3)
    plain = _run(
        EngineConfig(use_kernels=False, membership=False, **HEADLINE),
        "cuda", 200, 0.01, 3,
    )
    _assert_same(with_k, plain, "kernels vs plain versions")
    log(f"whole engine: 200 ticks at G={HEADLINE['G']}, kernels and plain "
        f"versions equal on every plane ({with_k[2]} commits, "
        f"{time.perf_counter() - t0:.2f} s)")
    small = EngineConfig(G=64, P=5, L=64, E=8, INGEST=8, use_kernels=True)
    on_card = _run(small, "cuda", 120, 0.1, 5)
    on_cpu = _run(small, "cpu", 120, 0.1, 5)
    _assert_same(on_card, on_cpu, "card vs CPU")
    log(f"whole engine: G=64 P=5 under 10% drops, card equals CPU on every "
        f"plane ({on_card[2]} commits)")


# ---------------------------------------------------------------------------
# Phase 5: the operations surface (faults, checkpoint, reorder, membership,
# tracer)
# ---------------------------------------------------------------------------


def _world(d):
    from multiraft_tpu_torch import convert

    return d.np_state(), convert.mailbox_to_numpy(d.inbox), d.commits_total


def _same_delayed(a: list, b: list) -> bool:
    import numpy as np

    if len(a) != len(b):
        return False
    for (ra, pa, ea, fa), (rb, pb, eb, fb) in zip(a, b):
        if (ra, pa, ea) != (rb, pb, eb) or list(fa) != list(fb):
            return False
        for k in fa:
            x, y = np.asarray(fa[k]), np.asarray(fb[k])
            if x.dtype != y.dtype or not np.array_equal(x, y):
                return False
    return True


def _pick_replicas(rng, G: int, P: int, n: int):
    """2n replicas (g, p) in 2n distinct groups: the first n, the rest."""
    groups = rng.choice(G, 2 * n, replace=False).tolist()
    picks = [(g, int(rng.integers(P))) for g in groups]
    return picks[:n], picks[n:]


def ops_faults(card: str) -> dict:
    """5(a), 5(b) and 5(e): the headline deployment under a firehose
    backlog and 1% drops, with an invariant monitor every 50 ticks and a
    tracer attached; crashes and cuts at tick 50, restarts and heals at
    tick 100; at tick 200 a checkpoint restored on the card and on the
    CPU, and all three drivers stepped 30 more ticks under the same
    faults and compared."""
    import numpy as np

    from multiraft_tpu_torch.bench import full_ring_stalls
    from multiraft_tpu_torch.engine.core import LEADER, EngineConfig
    from multiraft_tpu_torch.engine.host import EngineDriver
    from multiraft_tpu_torch.engine.invariants import InvariantMonitor
    from multiraft_tpu_torch.engine.state_planes import content_fingerprint
    from multiraft_tpu_torch.utils.trace import Tracer

    G, P, block, n_faults = HEADLINE["G"], HEADLINE["P"], 50, 100
    cfg = EngineConfig(use_kernels=True, **HEADLINE)
    d = EngineDriver(cfg, seed=11, device="cuda")
    if not d.run_until_quiet_leaders(500):
        raise AssertionError("faults: not every group elected a leader")
    d.tracer = Tracer()
    mon = InvariantMonitor(d)
    observe_s = []

    def observe() -> None:
        t0 = time.perf_counter()
        mon.observe()
        mon.prune_below_snapshot_floor()
        observe_s.append(time.perf_counter() - t0)

    observe()
    d.start_bulk(np.full(G, HEADLINE["INGEST"] * 300, np.int64))
    d.drop_prob = 0.01
    crashed, cut = _pick_replicas(np.random.default_rng(5), G, P, n_faults)
    tick0, c0 = d.tick, d.commits_total
    ms_per_tick = []
    for b in range(4):  # ticks 0-50-100-150-200 of the run
        if b == 1:
            for g, p in crashed:
                d.set_alive(g, p, False)
            for g, p in cut:
                d.partition_replica(g, p, False)
        if b == 2:
            for g, p in crashed:
                d.restart_replica(g, p)
                mon.note_restart(g, p)
            for g, p in cut:
                d.partition_replica(g, p, True)
            at_heal = d.np_state()["commit"].max(axis=1)
        t0 = time.perf_counter()
        d.step(block)
        ms_per_tick.append((time.perf_counter() - t0) / block * 1e3)
        observe()
    st = d.np_state()
    advanced = st["commit"].max(axis=1) > at_heal
    stalled = full_ring_stalls(st, cfg) & ~advanced
    if not (advanced | stalled).all():
        raise AssertionError(
            f"faults: groups {np.nonzero(~(advanced | stalled))[0].tolist()[:10]} "
            f"committed nothing after the heal")
    log(f"faults: G={G} P={P}, {n_faults} replicas crashed and {n_faults} "
        f"cut at tick 50, restarted and healed at tick 100, 1% drops, "
        f"firehose backlog; ms/tick per 50-tick block "
        f"{[round(x, 3) for x in ms_per_tick]}; monitor "
        f"{len(observe_s)} observes, s/observe {[round(x, 3) for x in observe_s]}; "
        f"commits advanced after the heal in {int(advanced.sum())} of {G} "
        f"groups; {int(stalled.sum())} groups stalled with a full ring of "
        f"older-term entries {np.nonzero(stalled)[0].tolist()[:10]} [{card}]")

    # 5(b): checkpoint at tick 200, restored on the card and on the CPU.
    os.makedirs(SCRATCH, exist_ok=True)
    path = os.path.join(SCRATCH, "ops.ckpt")
    t0 = time.perf_counter()
    d.save(path)
    save_s = time.perf_counter() - t0
    nbytes = os.path.getsize(path)
    t0 = time.perf_counter()
    on_card = EngineDriver.restore(path, device="cuda")
    restore_card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = EngineDriver.restore(path, device="cpu")
    restore_cpu_s = time.perf_counter() - t0
    os.remove(path)
    st = d.np_state()
    followers = [(g, int(np.nonzero(st["role"][g] != LEADER)[0][0]))
                 for g in range(0, G, max(1, G // 5))][:5]
    drivers = (d, on_card, on_cpu)
    step_s = [0.0] * len(drivers)  # each driver's 30 ticks
    for b in range(3):  # ticks 200-230, the same faults on all three
        for i, x in enumerate(drivers):
            if b == 1:
                for g, p in followers:
                    x.set_alive(g, p, False)
            if b == 2:
                for g, p in followers:
                    x.restart_replica(g, p)
            t0 = time.perf_counter()
            x.step(10)
            step_s[i] += time.perf_counter() - t0
    ref = _world(d)
    for name, x in (("card", on_card), ("cpu", on_cpu)):
        _assert_same(ref, _world(x), f"checkpoint restored on the {name}")
        for a, b in ((d.state, x.state), (d.inbox, x.inbox)):
            if content_fingerprint(a) != content_fingerprint(b):
                raise AssertionError(f"checkpoint ({name}): fingerprints differ")
    log(f"checkpoint: {nbytes} B saved in {save_s:.3f} s (fsync included) "
        f"at engine tick {d.tick - 30} (tick 200 of the run); restored in {restore_card_s:.3f} s on the "
        f"card and {restore_cpu_s:.3f} s on the CPU; after 30 more faulted "
        f"ticks all three equal on every plane and commits_total "
        f"({ref[2]}), fingerprint {content_fingerprint(d.state)}; the 30 "
        f"ticks took {step_s[0]:.2f} s (uninterrupted), {step_s[1]:.2f} s "
        f"(restored on the card), {step_s[2]:.2f} s (restored on the CPU) "
        f"[{card}]")

    # 5(e): the tracer's spans over the same run.
    ticks = d.tick - tick0
    spans = [e for e in d.tracer.events if e["ph"] == "X" and e["name"] == "tick"]
    if len(spans) != ticks or [e["args"]["tick"] for e in spans] != list(
            range(tick0 + 1, d.tick + 1)):
        raise AssertionError(f"tracer: {len(spans)} tick spans for {ticks} ticks")
    span_commits = sum(e["args"]["commits"] for e in spans)
    if span_commits != d.commits_total - c0:
        raise AssertionError(f"tracer: span commits {span_commits} != "
                             f"{d.commits_total - c0}")
    h = d.metrics.hist("tick_wall_s")
    log(f"tracer: {len(spans)} tick spans for {ticks} fused ticks, span "
        f"commits {span_commits} equal the commits_total delta; tick_wall_s "
        f"p50 {h.percentile(0.5) * 1e3:.3f} ms p99 "
        f"{h.percentile(0.99) * 1e3:.3f} ms ({h.count} samples) [{card}]")

    lacking = int((d.leaders_per_group() != 1).sum())
    if not d.run_until_quiet_leaders(300):
        raise AssertionError("faults: not every group has one leader at the end")
    log(f"faults: one leader in every group at tick {d.tick} "
        f"({lacking} groups were between leaders at tick {d.tick - 5})")
    return dict(ms_per_tick=ms_per_tick, observe_s=observe_s,
                stalled=int(stalled.sum()),
                ckpt_bytes=nbytes, save_s=save_s,
                restore_card_s=restore_card_s, restore_cpu_s=restore_cpu_s,
                step30_s=step_s,
                tick_wall_p50_ms=h.percentile(0.5) * 1e3,
                tick_wall_p99_ms=h.percentile(0.99) * 1e3)


def ops_reorder(card: str) -> dict:
    """5(c): labrpc's 2/3 long reordering with crashes, restarts, a slot
    reset and 10% drops; the card against the CPU, tick for tick."""
    import numpy as np

    from multiraft_tpu_torch.engine.core import EngineConfig
    from multiraft_tpu_torch.engine.host import EngineDriver

    G, ticks = 256, 150
    cfg = EngineConfig(use_kernels=True, **dict(HEADLINE, G=G))
    ds = [EngineDriver(cfg, seed=17, device=dev) for dev in ("cuda", "cpu")]
    crashed, _ = _pick_replicas(np.random.default_rng(3), G, cfg.P, 8)
    held = 0
    t0 = time.perf_counter()
    for d in ds:
        d.set_reorder(2.0 / 3.0, 2, 10)
        d.drop_prob = 0.1
        d.start_bulk(np.full(G, 8 * ticks, np.int64))
    for t in range(ticks):
        for d in ds:
            if t == 60:
                for g, p in crashed:
                    d.set_alive(g, p, False)
            if t == 90:
                for g, p in crashed:
                    d.restart_replica(g, p)
            if t == 100:
                d.reset_replica(*crashed[0])
            d.step()
        held = max(held, len(ds[0]._delayed))
    wall = time.perf_counter() - t0
    a, b = ds
    _assert_same(_world(a), _world(b), "reorder: card vs CPU")
    if not _same_delayed(a._delayed, b._delayed):
        raise AssertionError("reorder: the delay queues differ")
    if a._np_rng.bit_generator.state != b._np_rng.bit_generator.state:
        raise AssertionError("reorder: the reorder RNG states differ")
    if held == 0 or a.commits_total <= 0:
        raise AssertionError(f"reorder: held {held}, commits {a.commits_total}")
    log(f"reorder: G={G} P={cfg.P}, 2/3 reorder over 2-10 ticks, 10% drops, "
        f"8 crashes and restarts, a slot reset: card equals CPU on every "
        f"plane, the delay queue ({len(a._delayed)} held, at most {held}) and "
        f"the RNG after {ticks} ticks ({a.commits_total} commits, {wall:.2f} s "
        f"for both) [{card}]")
    return dict(seconds=wall, held_max=held)


def ops_membership(card: str) -> dict:
    """5(d): joint consensus on the plain path at full width: in 8
    groups, voter 2 is replaced by slot 3 (learner, catch-up, joint
    change, exit); the kernel path refuses the same call."""
    import numpy as np

    from multiraft_tpu_torch.engine.core import EngineConfig
    from multiraft_tpu_torch.engine.host import EngineDriver

    G = HEADLINE["G"]
    cfg = EngineConfig(use_kernels=False, membership=True, **dict(HEADLINE, P=5))
    t_start = time.perf_counter()
    d = EngineDriver(cfg, seed=19, device="cuda")
    d.seed_config([0, 1, 2])
    if not d.run_until_quiet_leaders(600):
        raise AssertionError("membership: not every group elected a leader")
    t_elected = time.perf_counter()
    d.start_bulk(np.full(G, 20, np.int64))
    d.step(10)
    n_groups = 8
    groups = list(range(0, G, G // n_groups))[:n_groups]
    for g in groups:
        d.add_learner(g, 3)
    waiting = set(groups)
    for _ in range(100):
        d.step(5)
        for g in sorted(waiting):
            match, last = d.learner_match(g, 3)
            if match >= last:
                waiting.discard(g)
        if not waiting:
            break
    if waiting:
        raise AssertionError(f"membership: learners of {sorted(waiting)} "
                             f"never caught up")
    t_caught = time.perf_counter()
    for g in groups:
        d.begin_joint(g, [0, 1, 3])
    waiting = set(groups)
    for _ in range(200):
        d.step(5)
        for g in sorted(waiting):
            if d.leader_of(g) is None:
                continue
            c = d.config_of(g)
            if not c["joint"] and c["voters_old"] == c["voters_new"] == [0, 1, 3]:
                waiting.discard(g)
        if not waiting:
            break
    if waiting:
        raise AssertionError(f"membership: groups {sorted(waiting)} never "
                             f"reached [0, 1, 3]")
    t_done = time.perf_counter()
    kd = EngineDriver(EngineConfig(use_kernels=True, **dict(HEADLINE, G=8, P=5)),
                      seed=0, device="cuda")
    try:
        kd.add_learner(0, 3)
    except RuntimeError:
        pass
    else:
        raise AssertionError("membership: add_learner ran on the kernel path")
    log(f"membership: G={G} P=5 plain path, slot 3 replaced voter 2 in "
        f"{n_groups} groups by tick {d.tick}; {time.perf_counter() - t_start:.2f} s "
        f"(election {t_elected - t_start:.2f} s, learner catch-up "
        f"{t_caught - t_elected:.2f} s, joint change {t_done - t_caught:.2f} s); "
        f"the kernel path refuses add_learner [{card}]")
    return dict(seconds=t_done - t_start, election_s=t_elected - t_start,
                catch_up_s=t_caught - t_elected, joint_s=t_done - t_caught)


def phase_operations(card: str, kernels) -> dict:
    """Phase 5: every sub-phase driven with the launch counts set to 0
    just before it and read just after."""
    out = {}
    for name, fn, want in (("faults", ops_faults, "launched"),
                           ("reorder", ops_reorder, "launched"),
                           ("membership", ops_membership, "none")):
        kernels.reset_launches()
        t0 = time.perf_counter()
        out[name] = fn(card)
        out[name]["phase_s"] = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        out[name]["launches"] = launches
        log(f"{name}: launches {launches}, {out[name]['phase_s']:.2f} s")
        if want == "launched" and min(launches.values()) <= 0:
            raise AssertionError(f"{name}: a kernel never launched: {launches}")
        if want == "none" and max(launches.values()) > 0:
            raise AssertionError(f"{name}: the plain path launched {launches}")
    return out


# ---------------------------------------------------------------------------
# Phase 6: the sharded engine (BatchedShardKV, SplitKV, SplitShardKV)
# ---------------------------------------------------------------------------


class _Pumps:
    """Wall time of every pump of a sharded service (ending in the
    pump's own readbacks) and of its orchestration sweeps."""

    def __init__(self, skv) -> None:
        self.pump_s, self.sweep_s = [], []
        inner_pump, inner_sweep = skv.pump, skv._orchestrate

        def pump(*a, **k):
            t0 = time.perf_counter()
            inner_pump(*a, **k)
            self.pump_s.append(time.perf_counter() - t0)

        def sweep():
            t0 = time.perf_counter()
            inner_sweep()
            self.sweep_s.append(time.perf_counter() - t0)

        skv.pump, skv._orchestrate = pump, sweep

    def summary(self) -> dict:
        import numpy as np

        out = {}
        for name, xs in (("pump_ms", self.pump_s), ("sweep_ms", self.sweep_s)):
            a = np.asarray(xs) * 1e3
            out[name] = dict(n=len(a), p50=float(np.percentile(a, 50)),
                             p90=float(np.percentile(a, 90)), max=float(a.max()))
        return out


def _settled(skv) -> bool:
    """Every hosted replica at the latest config with every slot SERVING."""
    from multiraft_tpu_torch.services.shardkv import SERVING

    n = skv.configs[-1].num
    return all(r.cur.num == n and all(sl.state == SERVING for sl in r.shards.values())
               for r in skv.reps.values())


def _pump_until(skv, pred, max_pumps: int, n: int = 5, what: str = "") -> None:
    for _ in range(max_pumps):
        if pred():
            return
        skv.pump(n)
    if not pred():
        raise AssertionError(f"sharded: {what} not reached in {max_pumps} pumps of {n}")


def _frame_blob(rows) -> bytes:
    """A firehose request from (op, gid, client, command, key, value) rows."""
    import numpy as np

    from multiraft_tpu_torch.engine.firehose import pack_request

    ops, gids, clients, cmds, keys, vals = zip(*rows)
    return pack_request(np.array(ops, np.uint8), np.array(gids, np.uint32),
                        np.array(clients, np.uint64), np.array(cmds, np.uint64),
                        [k.encode() for k in keys], [v.encode() for v in vals])


def sharded_headline(card: str) -> dict:
    """6(a): BatchedShardKV at the headline widths, kernels on: every gid
    joined in one admin op, a firehose of Put rows through submit_frame
    (rows for unhosted gids resolve WRONG_GROUP), the shard owners leave
    under that traffic, one shard moves to a named gid; every shard ends
    SERVING at exactly one replica, old owners hold no copy, and every
    acknowledged write reads back through get_fast and a logged Get."""
    import numpy as np
    import torch

    from multiraft_tpu_torch.engine.core import EngineConfig
    from multiraft_tpu_torch.engine.firehose import FH_OK, FH_WRONG_GROUP
    from multiraft_tpu_torch.engine.host import EngineDriver
    from multiraft_tpu_torch.engine.shardkv import OK, BatchedShardKV, route_keys
    from multiraft_tpu_torch.services.shardctrler import NSHARDS
    from multiraft_tpu_torch.services.shardkv import key2shard

    G = HEADLINE["G"]
    d = EngineDriver(EngineConfig(use_kernels=True, **HEADLINE), seed=23, device="cuda")
    t0 = time.perf_counter()
    if not d.run_until_quiet_leaders(500):
        raise AssertionError("sharded: not every group elected a leader")
    elect_s = time.perf_counter() - t0
    skv = BatchedShardKV(d)
    stats = _Pumps(skv)
    admin = {}

    tick0, t0 = d.tick, time.perf_counter()
    skv.admin_sync("join", list(range(1, G)))
    admin["join"] = dict(commit_ticks=d.tick - tick0, commit_s=time.perf_counter() - t0)
    _pump_until(skv, lambda: _settled(skv), 400, what="join settled")
    admin["join"].update(serving_ticks=d.tick - tick0, serving_s=time.perf_counter() - t0)
    if len(skv.configs[-1].groups) != G - 1:
        raise AssertionError("sharded: the join did not name every gid")
    owners1 = sorted(set(skv.configs[-1].shards))

    # The firehose: distinct keys whose first bytes cover every shard,
    # one session per row (a resent row dedups against itself only).
    n_frames, frame_rows, stray = 8, 4096, 64
    n_keys = n_frames * (frame_rows - stray)
    keys = [f"{chr(33 + i % 94)}{i}" for i in range(n_keys)]
    if len({key2shard(k) for k in keys}) != NSHARDS:
        raise AssertionError("sharded: the keys miss a shard")
    first = torch.tensor([ord(k[0]) for k in keys], dtype=torch.int32)
    model, pending, frames = {}, [], []
    frame_ms = []

    def send(idx, extra):
        table = skv.shard_table()
        h = first[torch.from_numpy(idx)]
        routed = route_keys(table, h).cpu().numpy()
        host = np.array(skv.configs[-1].shards)[h.numpy() % NSHARDS]
        if not np.array_equal(routed, host):
            raise AssertionError("sharded: device routing != host routing")
        rows = [(1, int(g), 1 + i, 1, keys[i], f"v{i}") for i, g in zip(idx.tolist(), routed)]
        rows += extra
        blob = _frame_blob(rows)
        t0 = time.perf_counter()
        f = skv.submit_frame(blob)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if not (f.err[len(idx):] == FH_WRONG_GROUP).all():
            raise AssertionError("sharded: rows for unhosted gids did not resolve WRONG_GROUP")
        frames.append((idx, f))

    def drain():
        _pump_until(skv, lambda: all(f.done for _, f in frames), 400, n=3,
                    what="firehose frames resolved")
        for idx, f in frames:
            err = f.err[:len(idx)]
            for i in idx[err == FH_OK].tolist():
                model[keys[i]] = f"v{i}"
            pending.extend(idx[err != FH_OK].tolist())
        frames.clear()

    def ctrl(make):
        """Poll a ctrler op to its commit, retrying a lost slot under the
        same dedup id (admin_sync's loop, one poll per call)."""
        t = make(None)

        def committed() -> bool:
            nonlocal t
            if t.done and t.failed:
                t = make(t.command_id)
            return t.done and not t.failed

        return committed

    c0, t_fh = d.commits_total, time.perf_counter()
    order = np.arange(n_keys)
    per = frame_rows - stray
    strays = lambda j: [(1, G + 1000 + s, 10**6 + j * stray + s, 1, f"~{j}.{s}", "x")
                        for s in range(stray)]
    leave_tick0 = None
    for j in range(n_frames):
        send(order[j * per:(j + 1) * per], strays(j))
        skv.pump(3)
        if j == n_frames // 2 - 1:
            # The owners leave under the firehose: every shard migrates.
            leave_tick0, leave_t0 = d.tick, time.perf_counter()
            left = ctrl(lambda cid: skv.leave(owners1, command_id=cid))
    _pump_until(skv, left, 200, what="leave commit")
    drain()
    rounds = 0
    while pending:
        rounds += 1
        if rounds > 80:
            raise AssertionError(f"sharded: {len(pending)} rows never acknowledged")
        idx = np.array(pending[:frame_rows])
        del pending[:frame_rows]
        send(idx, [])
        skv.pump(3)
        drain()
    fh_s = time.perf_counter() - t_fh
    fh_commits = d.commits_total - c0
    _pump_until(skv, lambda: _settled(skv), 400, what="leave settled")
    admin["leave"] = dict(serving_ticks=d.tick - leave_tick0,
                          serving_s=time.perf_counter() - leave_t0)
    owners2 = sorted(set(skv.configs[-1].shards))
    if set(owners2) & set(owners1):
        raise AssertionError("sharded: a leaving gid still owns a shard")

    # Move one shard to a named gid; the others keep serving meanwhile.
    named, moved = G // 2, 0
    probe = {key2shard(k): k for k in model}
    tick0, t0 = d.tick, time.perf_counter()
    committed = ctrl(lambda cid: skv.move(moved, named, command_id=cid))
    unaffected_reads = 0
    while not (committed() and _settled(skv)):
        skv.pump(5)
        if d.tick - tick0 > 2000:
            raise AssertionError("sharded: the move never settled")
        for s, k in probe.items():
            if s == moved:
                continue
            t = skv.get_fast(k)
            if t.err != OK or t.value != model[k]:
                raise AssertionError(f"sharded: shard {s} stopped serving during the move")
            unaffected_reads += 1
    admin["move"] = dict(serving_ticks=d.tick - tick0, serving_s=time.perf_counter() - t0)

    latest = skv.configs[-1]
    if latest.shards[moved] != named:
        raise AssertionError("sharded: the moved shard is not at the named gid")
    if skv.shard_table().cpu().tolist() != latest.shards:
        raise AssertionError("sharded: shard_table() != configs[-1].shards")
    former = {s: {c.shards[s] for c in skv.configs[1:-1]} - {latest.shards[s]}
              for s in range(NSHARDS)}
    for s in range(NSHARDS):
        serving = [g for g, r in skv.reps.items() if r.can_serve(s)]
        if serving != [latest.shards[s]]:
            raise AssertionError(f"sharded: shard {s} serves at {serving[:5]}")
        for g in former[s]:
            if skv.reps[g].shards[s].data:
                raise AssertionError(f"sharded: gid {g} kept shard {s} (Challenge 1)")

    # Read back every acknowledged write: fast reads, then logged Gets.
    for k, v in model.items():
        t = skv.get_fast(k)
        if t.err != OK or t.value != v:
            raise AssertionError(f"sharded: get_fast({k!r}) = {t.err} {t.value!r}")
    gets = {k: skv.submit(latest.shards[key2shard(k)], "Get", k) for k in model}
    t0, rounds = time.perf_counter(), 0
    while True:
        skv.pump(5)
        rounds += 1
        redo = [k for k, t in gets.items() if t.done and t.failed]
        for k in redo:
            gets[k] = skv.submit(latest.shards[key2shard(k)], "Get", k)
        if all(t.done for t in gets.values()):
            break
        if rounds > 400:
            raise AssertionError("sharded: logged Gets still pending after 400 pumps")
    for k, t in gets.items():
        if t.err != OK or t.value != model[k]:
            raise AssertionError(f"sharded: logged Get({k!r}) = {t.err} {t.value!r}")
    gets_s = time.perf_counter() - t0

    # route_keys on the card against host routing, negative hashes too.
    rng = np.random.default_rng(6)
    h = rng.integers(-2**31, 2**31, 1_000_000, dtype=np.int64).astype(np.int32)
    dev = route_keys(skv.shard_table(), torch.from_numpy(h).cuda()).cpu().numpy()
    if not np.array_equal(dev, np.array(latest.shards, np.int32)[np.mod(h.astype(np.int64), NSHARDS)]):
        raise AssertionError("sharded: route_keys on the card != host routing")
    timing = stats.summary()
    out = dict(G=G, elect_s=elect_s, admin=admin, keys_acked=len(model),
               frames=len(frame_ms), submit_frame_ms=dict(
                   p50=float(np.percentile(frame_ms, 50)), max=float(max(frame_ms))),
               firehose_s=fh_s, firehose_commits=fh_commits,
               commits_per_s=fh_commits / fh_s, retry_rounds=rounds,
               unaffected_reads=unaffected_reads, logged_gets_s=gets_s,
               ticks=d.tick, **timing)
    log(f"sharded: G={G} P={HEADLINE['P']} L={HEADLINE['L']} kernels on; join of "
        f"{G - 1} gids {admin['join']}; {len(model)} acked Put rows in "
        f"{len(frame_ms)} frames (8 of 4,096 rows with {stray} for unhosted gids "
        f"each, then resends), submit_frame p50 {out['submit_frame_ms']['p50']:.2f} ms "
        f"max {out['submit_frame_ms']['max']:.2f} ms, {fh_commits} commits in "
        f"{fh_s:.2f} s ({out['commits_per_s']:.0f} commits/s); leave of the owners "
        f"{owners1} {admin['leave']}; move of shard {moved} to gid {named} "
        f"{admin['move']} with {unaffected_reads} fast reads of unaffected shards "
        f"all OK; every key read back by get_fast and by a logged Get "
        f"({gets_s:.2f} s); pump ms {timing['pump_ms']}; sweep ms "
        f"{timing['sweep_ms']} [{card}]")
    return out


def _split_rig(sides):
    """The port's split harness (``harness/split_harness.SplitShardRig``:
    every pump extracts each live side's slabs and injects them into
    the other live side; a killed side stops pumping and its slabs are
    dropped), timing each shuttle round and counting its slab bytes."""
    import pickle

    from multiraft_tpu_torch.harness.split_harness import SplitShardRig

    class _SplitRig(SplitShardRig):
        def __init__(self, sides) -> None:
            super().__init__(sides, on_slab=self._count)
            self.pump_s, self.slab_bytes, self._bytes = [], [], 0

        def _count(self, slab) -> None:
            self._bytes += len(pickle.dumps(slab, protocol=pickle.HIGHEST_PROTOCOL))

        def shuttle(self, rounds: int = 1) -> None:
            for _ in range(rounds):
                t0, self._bytes = time.perf_counter(), 0
                super().shuttle(1)
                self.pump_s.append(time.perf_counter() - t0)
                self.slab_bytes.append(self._bytes)

    return _SplitRig(sides)


def _shuttle_until(rig, pred, max_rounds: int, what: str) -> None:
    for _ in range(max_rounds):
        if pred():
            return
        rig.shuttle()
    raise AssertionError(f"split: {what} not reached in {max_rounds} rounds")


def _split_sides(cls, device, owners, cfg, delay_on=None, delay=300):
    from multiraft_tpu_torch.engine.host import EngineDriver
    from multiraft_tpu_torch.engine.split import SplitPeering, SplitSpec

    sides = []
    for me, seed in ((0, 11), (1, 22)):
        d = EngineDriver(cfg, seed=seed, device=device)
        svc = cls(d)
        peering = SplitPeering(d, svc, SplitSpec(me=me, owners=owners))
        if delay_on == me:
            d.state = d.state._replace(elect_dl=d.state.elect_dl + delay)
        sides.append((svc, peering))
    return sides


SPLIT = dict(G=64, P=3, L=64, E=8, INGEST=8, host_paced_compaction=True)


def sharded_split(card: str) -> dict:
    """6(b): two split drivers on one card, slabs shuttled every pump:
    a SplitKV pair elects and commits; a SplitShardKV pair runs the
    kill-mid-migration scenario and the survivor finishes alone."""
    import numpy as np

    from multiraft_tpu_torch.bench import full_ring_stalls
    from multiraft_tpu_torch.engine.core import EngineConfig
    from multiraft_tpu_torch.engine.kv import KVOp
    from multiraft_tpu_torch.engine.split import SplitKV
    from multiraft_tpu_torch.engine.split_shard import SplitShardKV
    from multiraft_tpu_torch.porcupine.types import OP_APPEND
    from multiraft_tpu_torch.services.shardkv import key2shard

    cfg = EngineConfig(use_kernels=True, **SPLIT)
    G = cfg.G
    owners = {g: [0, 1, 1] for g in range(G)}
    t0 = time.perf_counter()
    kv = _split_rig(_split_sides(SplitKV, "cuda", owners, cfg))
    kv.settle(G, max_rounds=800)
    acked = {}
    for i, g in enumerate(range(0, G, 8)):
        for r in range(3):
            side = next(s for i, (s, _) in enumerate(kv.sides)
                        if kv.alive[i] and s.local_leader(g) is not None)
            t = side.submit_local(g, KVOp(op=OP_APPEND, key=f"k{g}", value=f"[{r}]",
                                          client_id=5, command_id=i * 3 + r + 1))
            _shuttle_until(kv, lambda: t.done, 300, "a split KV commit")
            if t.failed:
                raise AssertionError("split: a KV append lost its slot")
            acked[g] = acked.get(g, "") + f"[{r}]"
    _shuttle_until(kv, lambda: all(s.data[g].get(f"k{g}") == v for s, _ in kv.sides
                        for g, v in acked.items()), 200, "both sides applied")
    kv_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    rig = _split_rig(_split_sides(SplitShardKV, "cuda", owners, cfg, delay_on=1))
    rig.settle(G, max_rounds=800)
    lead0 = sum(rig.sides[0][0].driver.leader_of(g) is not None for g in range(G))
    rig.admin("join", {1: ["p1"]})
    keys = [chr(ord("a") + i) + "key" for i in range(10)]
    model = {}
    for k in keys:
        rig.client_op("Append", k, f"[a-{k}]")
        model[k] = f"[a-{k}]"
    rig.admin("join", {2: ["p2"]})
    if not rig.wait_migrating(1500):
        raise AssertionError("split: migration in flight not reached in 1500 rounds")
    kill_tick = rig.sides[1][0].driver.tick
    rig.alive[0] = False  # driver 0 stops pumping; its slabs are dropped
    survivor = rig.sides[1][0]
    stay = next(k for k in keys if survivor.configs[-1].shards[key2shard(k)] == 1)
    rig.client_op("Append", stay, "[during]")
    model[stay] += "[during]"
    try:
        rig.wait_migrated([1, 2], 4000)
    except TimeoutError:
        st = survivor.driver.np_state()
        stalled = np.nonzero(full_ring_stalls(st, cfg))[0].tolist()
        raise AssertionError(f"split: migration did not finish on the survivor; groups "
                             f"stalled by the full-ring predicate: {stalled}")
    for k in keys:
        got = rig.client_op("Get", k)
        if got != model[k]:
            raise AssertionError(f"split: lost {k}: {got!r} != {model[k]!r}")
    latest = survivor.configs[-1]
    for s, g in enumerate(latest.shards):
        if g == 2 and survivor.reps[1].shards[s].data:
            raise AssertionError(f"split: gid 1 kept shard {s} after the migration")
    stalls = int(full_ring_stalls(survivor.driver.np_state(), cfg).sum())
    shard_s = time.perf_counter() - t0
    pumps = np.asarray(rig.pump_s) * 1e3
    slab = np.asarray(rig.slab_bytes)
    out = dict(G=G, kv_s=kv_s, shard_s=shard_s, leaders_on_side0=lead0,
               kill_tick=kill_tick, survivor_ticks=survivor.driver.tick - kill_tick,
               pump_ms=dict(p50=float(np.percentile(pumps, 50)),
                            p90=float(np.percentile(pumps, 90)), n=len(pumps)),
               slab_bytes=dict(p50=float(np.percentile(slab, 50)), max=int(slab.max())),
               kv_pump_ms_p50=float(np.percentile(np.asarray(kv.pump_s) * 1e3, 50)),
               stalled=stalls)
    log(f"split: G={G} P=3 L=64 E=8 INGEST=8, host-paced compaction, kernels on, "
        f"owners [0, 1, 1]: SplitKV pair committed {sum(len(v) // 3 for v in acked.values())} "
        f"appends in {len(acked)} groups, both sides applied them ({kv_s:.2f} s); "
        f"SplitShardKV pair: {lead0} of {G} leaders on driver 0, join 1, 10 appends, "
        f"join 2, driver 0 killed mid-migration at tick {kill_tick}; driver 1 finished "
        f"the pull and the GC handshake alone in {out['survivor_ticks']} ticks and "
        f"served every acked write ({shard_s:.2f} s); ms per pump with slab exchange "
        f"p50 {out['pump_ms']['p50']:.2f} p90 {out['pump_ms']['p90']:.2f} "
        f"(SplitKV pair p50 {out['kv_pump_ms_p50']:.2f}), slab bytes per pump p50 "
        f"{out['slab_bytes']['p50']:.0f} max {out['slab_bytes']['max']}; "
        f"{stalls} groups stalled by the full-ring predicate [{card}]")
    return out


def _sharded_state(skv, tickets) -> dict:
    """The sharded service and its engine, as plain Python and numpy:
    every state and inbox plane, the configs, every replica's configs,
    shard states, data and dedup tables, and the tickets' outcomes."""
    import dataclasses

    d = skv.driver
    out = {"s." + k: v for k, v in d.np_state().items()}
    out.update({"i." + k: v.detach().cpu().numpy() for k, v in d.inbox._asdict().items()})
    out["configs"] = [dataclasses.asdict(c) for c in skv.configs]
    out["reps"] = {g: (dataclasses.asdict(r.cur), dataclasses.asdict(r.prev),
                       {s: (sl.state, sl.data, sl.latest) for s, sl in r.shards.items()})
                   for g, r in skv.reps.items()}
    out["route"] = skv.shard_table().cpu().tolist()
    out["tickets"] = [dataclasses.astuple(t) for t in tickets]
    out["applied_upto"] = list(skv.applied_upto)
    return out


def _same_state(a: dict, b: dict, where: str) -> None:
    import numpy as np

    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray):
            same = x.dtype == y.dtype and np.array_equal(x, y)
        else:
            same = x == y
        if not same:
            raise AssertionError(f"card vs CPU at {where}: {k} differs")


def _sharded_script(skv, tickets: list, mark) -> None:
    """A seeded sharded run: join, writes, leave, move; each write's
    ticket goes into ``tickets``, and ``mark(tag)`` is called at each
    admin point and at the end."""
    import numpy as np

    from multiraft_tpu_torch.services.shardkv import key2shard

    rng = np.random.default_rng(29)

    def writes(n, rnd):
        for i in range(n):
            k = f"{chr(40 + int(rng.integers(0, 80)))}{int(rng.integers(0, 50))}"
            gid = skv.configs[-1].shards[key2shard(k)]
            if gid:
                tickets.append(skv.submit(gid, "Append" if i % 3 else "Put", k,
                                          f"<{rnd}.{i}>", client_id=1 + i % 7,
                                          command_id=rnd * 100 + i + 1))
        for _ in range(6):
            skv.pump(5)

    G = skv.driver.cfg.G
    skv.admin_sync("join", list(range(1, G // 2)))
    mark("join")
    for rnd in range(4):
        writes(40, rnd)
    skv.admin_sync("leave", list(range(1, G // 8)))
    mark("leave")
    for rnd in range(4, 8):
        writes(40, rnd)
    skv.admin_sync("move", (3, G - 2))
    mark("move")
    writes(40, 8)
    for _ in range(60):
        if _settled(skv) and all(t.done for t in tickets):
            break
        skv.pump(5)
    mark("end")


def sharded_card_vs_cpu(card: str) -> dict:
    """6(c), first half: the same seeded sharded script at G=64 on a
    card driver (kernels) and on a CPU driver (their plain versions);
    the engine planes and the whole service state are equal at every
    admin point and at the end."""
    from multiraft_tpu_torch.engine.core import EngineConfig
    from multiraft_tpu_torch.engine.host import EngineDriver
    from multiraft_tpu_torch.engine.shardkv import BatchedShardKV

    cfg = EngineConfig(G=64, P=3, L=64, E=8, INGEST=8, use_kernels=True)
    runs, secs = [], []
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        d = EngineDriver(cfg, seed=31, device=dev)
        if not d.run_until_quiet_leaders(1000):
            raise AssertionError(f"card vs CPU: no leaders on {dev}")
        skv = BatchedShardKV(d)
        seen, tickets = [], []
        _sharded_script(skv, tickets,
                        lambda tag: seen.append((tag, _sharded_state(skv, tickets))))
        runs.append(seen)
        secs.append(time.perf_counter() - t0)
    for (tag, a), (_, b) in zip(*runs):
        _same_state(a, b, tag)
    end = runs[0][-1][1]
    if not all(t[1] and not t[2] for t in end["tickets"]):
        raise AssertionError("card vs CPU: a write did not resolve")
    log(f"card vs CPU: G=64 P=3 L=64 sharded script (join, {len(end['tickets'])} "
        f"writes, leave, move) equal on every plane, config, replica and ticket at "
        f"{[t for t, _ in runs[0]]}; config {end['configs'][-1]['num']}, "
        f"{runs[0][-1][1]['s.tick_no']} ticks; card {secs[0]:.2f} s, CPU "
        f"{secs[1]:.2f} s [{card}]")
    return dict(card_s=secs[0], cpu_s=secs[1], writes=len(end["tickets"]))


def sharded_facades(card: str) -> dict:
    """6(c), second half: the placement controller's replace-dead-voter
    legs through the ``*_gid`` facades, at serve-shardkv's shape with
    spares (G=64 x P=5, three voters seeded), on the plain path; each
    leg runs twice to show it is idempotent."""
    from multiraft_tpu_torch.engine.core import EngineConfig
    from multiraft_tpu_torch.engine.host import EngineDriver
    from multiraft_tpu_torch.engine.shardkv import BatchedShardKV

    cfg = EngineConfig(G=64, P=5, L=64, E=8, INGEST=8, use_kernels=False,
                       membership=True)
    d = EngineDriver(cfg, seed=37, device="cuda")
    d.seed_config([0, 1, 2])
    if not d.run_until_quiet_leaders(2000):
        raise AssertionError("facades: no leaders")
    skv = BatchedShardKV(d)
    skv.admin_sync("join", list(range(1, 64)))
    gid = 7
    lead = d.leader_of(gid)
    dead = next(q for q in (0, 1, 2) if q != lead)
    spare = 3
    target = sorted({0, 1, 2, spare} - {dead})
    legs = {}

    def leg(name, fn, want=None):
        t0 = time.perf_counter()
        got = [fn(), fn()]
        legs[name] = time.perf_counter() - t0
        if got[0] != got[1] or (want is not None and got[0] != want):
            raise AssertionError(f"facades: {name} answered {got}")
        return got[0]

    leg("kill_replica_gid", lambda: skv.kill_replica_gid(gid, dead), True)
    health = leg("replica_health", lambda: skv.replica_health(gid))
    if health["alive"][dead] or health["voters_old"] != [0, 1, 2]:
        raise AssertionError(f"facades: health {health}")
    leg("add_learner_gid", lambda: skv.add_learner_gid(gid, spare), True)
    t0 = time.perf_counter()
    for _ in range(200):
        skv.pump(5)
        m = skv.learner_match_gid(gid, spare)
        if m is not None and m[0] >= m[1]:
            break
    catch_up = time.perf_counter() - t0
    m = leg("learner_match_gid", lambda: skv.learner_match_gid(gid, spare))
    if m is None or m[0] < m[1]:
        raise AssertionError(f"facades: the learner did not catch up: {m}")
    leg("begin_joint_gid", lambda: skv.begin_joint_gid(gid, target), True)
    t0 = time.perf_counter()
    for _ in range(200):
        skv.pump(5)
        c = skv.config_of_gid(gid)
        if c is not None and not c["joint"] and c["voters_old"] == target:
            break
    joint = time.perf_counter() - t0
    c = skv.config_of_gid(gid)
    if c is None or c["joint"] or c["voters_old"] != target or c["voters_new"] != target:
        raise AssertionError(f"facades: the dead voter was not replaced: {c}")
    if not skv.begin_joint_gid(gid, target):
        raise AssertionError("facades: begin_joint_gid at the settled target refused")
    log(f"facades: G=64 P=5 plain path, voters [0, 1, 2]; gid {gid}: voter {dead} "
        f"killed and replaced by slot {spare}, voters now {target}; seconds per "
        f"leg (each run twice) { {k: round(v, 4) for k, v in legs.items()} }, "
        f"learner catch-up {catch_up:.2f} s, joint change {joint:.2f} s [{card}]")
    return dict(legs_s=legs, catch_up_s=catch_up, joint_s=joint)


def phase_sharded(card: str, kernels) -> dict:
    """Phase 6: every sub-phase driven with the launch counts set to 0
    just before it and read just after."""
    out = {}
    for name, fn, want in (("sharded", sharded_headline, "launched"),
                           ("split", sharded_split, "launched"),
                           ("card_vs_cpu", sharded_card_vs_cpu, "launched"),
                           ("facades", sharded_facades, "none")):
        kernels.reset_launches()
        t0 = time.perf_counter()
        out[name] = fn(card)
        out[name]["phase_s"] = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        out[name]["launches"] = launches
        log(f"{name}: launches {launches}, {out[name]['phase_s']:.2f} s [{card}]")
        if want == "launched" and min(launches.values()) <= 0:
            raise AssertionError(f"{name}: a kernel never launched: {launches}")
        if want == "none" and max(launches.values()) > 0:
            raise AssertionError(f"{name}: the plain path launched {launches}")
    return out


# ---------------------------------------------------------------------------
# Phase 7: the durable engine KV server, served from the card
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
# The reference's serve knobs at the headline widths (P=3 is fixed by
# serve_engine_kv; HB_TICKS has no serve knob and keeps its default).
SERVE_ENV = {"MULTIRAFT_SERVE_L": "192", "MULTIRAFT_SERVE_E": "48",
             "MULTIRAFT_SERVE_INGEST": "48"}
FH_ROWS = 4096


def _pct(xs, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(xs, dtype=float), q))


class _Server:
    """``python -m multiraft_tpu_torch <cmd>`` (``serve-kv`` unless
    told) as a child process on the card, or on the device ``extra``
    names; its stderr goes to ``build/smoke/<log>``."""

    def __init__(self, data_dir: str, groups: int, cmd: str = "serve-kv",
                 extra=(), env=None, log: str = "serve.log"):
        self.data_dir, self.groups = data_dir, groups
        self.cmd, self.extra, self.log_name = cmd, list(extra), log
        self.env = SERVE_ENV if env is None else env
        self.proc = None
        self.port = None
        self._log = None

    def start(self, timeout: float = 240.0) -> float:
        """Start and wait for ``ready <port>``; returns the seconds."""
        self.launch()
        return self.wait_ready(timeout)

    def launch(self) -> None:
        env = dict(os.environ, **self.env)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        self._log = open(os.path.join(SCRATCH, self.log_name), "ab")
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "multiraft_tpu_torch", self.cmd,
             "--groups", str(self.groups), "--data-dir", self.data_dir,
             *self.extra],
            stdout=subprocess.PIPE, stderr=self._log, env=env, cwd=ROOT,
        )
        self._t0 = t0

    def wait_ready(self, timeout: float = 240.0) -> float:
        """Wait for ``ready <port>``; returns the seconds since launch."""
        import select

        t0 = self._t0
        buf = b""
        while b"\n" not in buf:
            left = timeout - (time.perf_counter() - t0)
            if left <= 0 or self.proc.poll() is not None:
                raise AssertionError(
                    f"{self.cmd}: no readiness line (exit {self.proc.poll()}, "
                    f"{buf!r}); see build/smoke/{self.log_name}")
            ready, _, _ = select.select([self.proc.stdout], [], [], min(left, 1.0))
            if ready:
                chunk = os.read(self.proc.stdout.fileno(), 256)
                if not chunk:
                    continue
                buf += chunk
        line = buf.split(b"\n", 1)[0].decode()
        if not line.startswith("ready "):
            raise AssertionError(f"{self.cmd}: bad readiness line {line!r}")
        self.port = int(line.split()[1])
        return time.perf_counter() - t0

    def kill9(self) -> None:
        self.proc.kill()
        self.proc.wait(timeout=60)
        self._close()

    def sigterm(self) -> None:
        """SIGTERM; the server must write its final checkpoint and exit 0."""
        import signal

        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(timeout=240)
        self._close()
        if rc != 0:
            with open(os.path.join(SCRATCH, self.log_name), "rb") as f:
                tail = f.read()[-3000:].decode(errors="replace")
            raise AssertionError(f"{self.cmd}: SIGTERM exit code {rc}; log tail:\n{tail}")

    def stop(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)
        self._close()

    def _close(self) -> None:
        if self.proc is not None and self.proc.stdout is not None:
            self.proc.stdout.close()
        if self._log is not None:
            self._log.close()
            self._log = None


class _Client:
    """A port clerk of its own RPC node, blocking."""

    def __init__(self, port: int, cls_name: str = "EngineClerk"):
        from multiraft_tpu_torch.distributed import engine_clerks
        from multiraft_tpu_torch.distributed.tcp import RpcNode

        self.node = RpcNode()
        self.end = self.node.client_end("127.0.0.1", port)
        self.ck = getattr(engine_clerks, cls_name)(self.node.sched, self.end)

    def run(self, gen, timeout: float = 120.0):
        from multiraft_tpu_torch.sim.scheduler import TIMEOUT

        out = self.node.sched.wait(self.node.sched.spawn(gen), timeout)
        if out is TIMEOUT:
            raise TimeoutError("clerk call timed out")
        return out

    def call(self, meth: str, args=None, timeout: float = 30.0):
        from multiraft_tpu_torch.sim.scheduler import TIMEOUT

        out = self.node.sched.wait(self.end.call(meth, args), timeout)
        if out is None or out is TIMEOUT:
            raise AssertionError(f"{meth}: no answer")
        return out

    def close(self) -> None:
        self.node.close()


def _gpu_mib(pid: int) -> tuple:
    """(MiB the card says ``pid`` holds or None, MiB used on the card)."""
    apps = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    held = None
    for row in apps.strip().splitlines():
        p, mib = (x.strip() for x in row.split(","))
        if p.isdigit() and int(p) == pid:
            held = float(mib)
    used = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return held, float(used)


def _card_memory(srv, used0: float) -> tuple:
    """(MiB, how) the card memory a server child holds: its own row of
    ``nvidia-smi``, or, where the card lists pids of another pid
    namespace, the card's used memory since ``used0``."""
    held, used1 = _gpu_mib(srv.proc.pid)
    if held is not None:
        if held <= 0:
            raise AssertionError(f"{srv.cmd} pid {srv.proc.pid} holds no card memory")
        return held, f"pid {srv.proc.pid} holds {held:.0f} MiB"
    if used1 - used0 < 100:
        raise AssertionError(f"{srv.cmd}: card memory {used0:.0f} -> {used1:.0f} MiB")
    return used1 - used0, (f"pid not listed (another pid namespace); card memory "
                           f"{used0:.0f} -> {used1:.0f} MiB")


def _readback(port: int, model: dict, tags: dict) -> int:
    """Every key of ``model`` reads back its value through one firehose
    Get frame per 4,096 keys; for each key of ``tags`` (key -> (acked
    tags, unacked tags)), each acked tag is there exactly once and each
    unacked one at most once.  Returns the keys read."""
    keys = sorted(set(model) | set(tags))
    c = _Client(port, "FirehoseClerk")
    try:
        got = {}
        for s in range(0, len(keys), FH_ROWS):
            part = keys[s: s + FH_ROWS]
            vals = c.run(c.ck.run_batch([("Get", k, "") for k in part]))
            got.update(zip(part, vals))
    finally:
        c.close()
    for k, want in model.items():
        if got[k] != want:
            raise AssertionError(f"read back {k}: {got[k]!r} != {want!r}")
    for k, (acked, unacked) in tags.items():
        for t in acked:
            if got[k].count(t) != 1:
                raise AssertionError(f"{k}: acked {t} appears {got[k].count(t)}x")
        for t in unacked:
            if got[k].count(t) > 1:
                raise AssertionError(f"{k}: unacked {t} applied twice")
    return len(keys)


def _server_metrics(port: int) -> dict:
    c = _Client(port)
    try:
        return c.call("Obs.snapshot")["metrics"]
    finally:
        c.close()


def serve_traffic(port: int, card: str, model: dict, full: bool = True,
                  tag: str = "serve 7(b)") -> dict:
    """7(b): clerk threads, one batch frame, a firehose (``full=False``:
    the clerk threads alone); every answer held against ``model`` (a
    dict of every acknowledged write)."""
    import threading

    from multiraft_tpu_torch.utils.metrics import Hist

    out = {}
    lat = {"Put": [], "Append": [], "Get": []}
    errors = []
    lock = threading.Lock()

    def worker(w: int):
        c = _Client(port)
        mine = {}
        try:
            for j in range(40):
                key = f"w{w}-k{j % 4}"
                kind = ("Put", "Append", "Append", "Get")[j % 4]
                t0 = time.perf_counter()
                if kind == "Get":
                    got = c.run(c.ck.get(key))
                    if got != mine.get(key, ""):
                        raise AssertionError(f"{key}: {got!r} != {mine.get(key, '')!r}")
                elif kind == "Put":
                    c.run(c.ck.put(key, f"<{w}.{j}>"))
                    mine[key] = f"<{w}.{j}>"
                else:
                    c.run(c.ck.append(key, f"({w}.{j})"))
                    mine[key] = mine.get(key, "") + f"({w}.{j})"
                with lock:
                    lat[kind].append(time.perf_counter() - t0)
            with lock:
                model.update(mine)
        except BaseException as e:  # re-raised on the main thread
            errors.append(e)
        finally:
            c.close()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(w,)) for w in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    every = [x for xs in lat.values() for x in xs]
    out["clerks"] = dict(
        ops=len(every), s=wall, ops_per_s=len(every) / wall,
        p50_ms=_pct(every, 50) * 1e3, p99_ms=_pct(every, 99) * 1e3,
        write_p50_ms=_pct(lat["Put"] + lat["Append"], 50) * 1e3,
        write_p99_ms=_pct(lat["Put"] + lat["Append"], 99) * 1e3,
        get_p50_ms=_pct(lat["Get"], 50) * 1e3,
    )
    log(f"{tag}: 8 clerks x 40 ops in {wall:.2f} s: {json.dumps(out['clerks'])} [{card}]")
    if not full:
        return out

    # One pipelined frame of MAX_BATCH ops; its Gets see its own writes.
    ops, want = [], {}
    for i in range(1000):
        key = f"p{i % 97}"
        if i % 7 == 0:
            ops.append(("Put", key, f"<{i}>"))
            want[key] = f"<{i}>"
        else:
            ops.append(("Append", key, f"<{i}>"))
            want[key] = want.get(key, "") + f"<{i}>"
    gets = sorted(want)[:24]
    ops += [("Get", k, "") for k in gets]
    c = _Client(port, "PipelinedClerk")
    try:
        t0 = time.perf_counter()
        vals = c.run(c.ck.run_batch(ops))
        out["batch_frame_s"] = time.perf_counter() - t0
    finally:
        c.close()
    if vals[-24:] != [want[k] for k in gets]:
        raise AssertionError("batch frame: a Get missed its own frame's writes")
    model.update(want)
    log(f"serve 7(b): one batch frame of {len(ops)} ops in "
        f"{out['batch_frame_s']:.3f} s [{card}]")

    # 16 firehose frames of 4,096 rows.
    c = _Client(port, "FirehoseClerk")
    try:
        frame_s = []
        t0 = time.perf_counter()
        for f in range(16):
            rows = []
            for i in range(FH_ROWS):
                key = f"f{(f * FH_ROWS + i) % 20011}"
                if i % 8 == 0:
                    rows.append(("Put", key, f"{f}.{i};"))
                    model[key] = f"{f}.{i};"
                else:
                    rows.append(("Append", key, f"{f}.{i};"))
                    model[key] = model.get(key, "") + f"{f}.{i};"
            t1 = time.perf_counter()
            c.run(c.ck.run_batch(rows))
            frame_s.append(time.perf_counter() - t1)
        wall = time.perf_counter() - t0
        hist = c.call("Obs.hist")
    finally:
        c.close()
    out["firehose"] = dict(
        frames=16, rows=16 * FH_ROWS, s=wall,
        rows_acked_per_s=16 * FH_ROWS / wall,
        frame_p50_ms=_pct(frame_s, 50) * 1e3, frame_max_ms=max(frame_s) * 1e3,
    )
    log(f"serve 7(b): firehose {json.dumps(out['firehose'])} [{card}]")
    pump = {}
    for name in ("pump.wall_s", "pump.cpu_s"):
        h = Hist.from_dump(hist["hists"][name])
        pump[name] = {f"p{q}_ms": h.percentile(q / 100) * 1e3 for q in (50, 90, 99)}
        pump[name]["count"] = h.count
    out["pump"] = pump
    log(f"serve 7(b): server pump (Obs.hist) {json.dumps(pump)} [{card}]")
    return out


def _kill9_in_firehose(srv, model: dict, card: str, tag: str, frames: int = 12) -> dict:
    """``kill -9`` of ``srv`` with a firehose frame in flight, a restart
    on the same directory, every acknowledged write read back (each
    acknowledged append tag once); then the crash keys are folded into
    ``model`` as they now read."""
    import threading

    out = {}
    tags = {}  # key -> (acked tags, unacked tags)
    acked_frames = []
    sent = []
    crash_err = []

    def firehose():
        c = _Client(srv.port, "FirehoseClerk")
        try:
            for f in range(frames):
                rows = [("Append", f"c{(f * 997 + i) % 9973}", f"[{f}.{i}]")
                        for i in range(FH_ROWS)]
                sent.append(rows)
                c.run(c.ck.run_batch(rows, deadline_s=8.0), timeout=12.0)
                acked_frames.append(f)
        except (TimeoutError, AssertionError, OSError):
            pass  # the server died under the frame in flight
        except BaseException as e:
            crash_err.append(e)
        finally:
            c.close()

    th = threading.Thread(target=firehose)
    th.start()
    t0 = time.perf_counter()
    while len(acked_frames) < 3 and time.perf_counter() - t0 < 120:
        time.sleep(0.005)
    if len(acked_frames) < 3:
        raise AssertionError(f"{tag}: the firehose acknowledged under 3 frames")
    time.sleep(0.05)  # the next frame is in flight
    srv.kill9()
    out["restart_after_kill_s"] = srv.start()
    th.join(timeout=60)
    if th.is_alive() or crash_err:
        raise AssertionError(f"{tag}: firehose thread {crash_err}")
    # The thread stops at the frame the kill cut: every frame before
    # it was acknowledged.
    n_acked = len(acked_frames)
    for f, rows in enumerate(sent):
        for _, key, t in rows:
            acked, unacked = tags.setdefault(key, ([], []))
            (acked if f < n_acked else unacked).append(t)
    m = _server_metrics(srv.port)
    out["replayed_records"] = m.get("wal.replayed_records", 0)
    out["restores"] = m.get("engine.restores", 0)
    keys = _readback(srv.port, model, tags)
    log(f"{tag}: kill -9 after {n_acked} acknowledged frames "
        f"({len(sent)} sent); ready again in {out['restart_after_kill_s']:.2f} s, "
        f"{out['replayed_records']} WAL records replayed; {keys} keys read "
        f"back, every acknowledged write there, each acked tag once [{card}]")
    c = _Client(srv.port, "FirehoseClerk")
    try:
        ks = sorted(tags)
        for i in range(0, len(ks), FH_ROWS):
            part = ks[i: i + FH_ROWS]
            model.update(zip(part, c.run(c.ck.run_batch(
                [("Get", k, "") for k in part]))))
    finally:
        c.close()
    return out


def phase_serve(card: str) -> dict:
    """Phase 7: ``serve-kv`` on the card at the headline widths, driven
    by the port's clerks; kill -9 and SIGTERM restarts on the same
    directory; the ``kv`` command line."""
    import shutil

    G = HEADLINE["G"]
    data = os.path.join(SCRATCH, "serve")
    shutil.rmtree(data, ignore_errors=True)
    os.makedirs(SCRATCH, exist_ok=True)
    out = {}
    model = {}  # every acknowledged write: key -> value
    srv = _Server(data, G)
    try:
        _, used0 = _gpu_mib(-1)
        out["ready_s"] = srv.start()
        out["card_mib"], how = _card_memory(srv, used0)
        log(f"serve 7(a): ready in {out['ready_s']:.2f} s at G={G}; {how} [{card}]")

        out.update(serve_traffic(srv.port, card, model))
        m = _server_metrics(srv.port)
        log(f"serve 7(b): server counters kv.writes {m.get('kv.writes')} "
            f"firehose.rows {m.get('firehose.rows')} wal.fsyncs {m.get('wal.fsyncs')} "
            f"ckpt.saves {m.get('ckpt.saves')} pump.count {m.get('pump.count')}")

        # 7(c): kill -9 in the middle of a firehose.
        out.update(_kill9_in_firehose(srv, model, card, "serve 7(c)"))
        # 7(d): SIGTERM writes the final checkpoint; the restart replays nothing.
        srv.sigterm()
        out["restart_after_sigterm_s"] = srv.start()
        m = _server_metrics(srv.port)
        if m.get("wal.replayed_records", 0) != 0 or m.get("engine.restores", 0) != 1:
            raise AssertionError(f"7(d): replayed {m.get('wal.replayed_records')}, "
                                 f"restores {m.get('engine.restores')}")
        keys = _readback(srv.port, model, {})
        log(f"serve 7(d): SIGTERM exit 0; ready again in "
            f"{out['restart_after_sigterm_s']:.2f} s from the checkpoint alone "
            f"(0 WAL records replayed); {keys} keys read back [{card}]")

        # 7(e): the command line.
        addr = f"127.0.0.1:{srv.port}"
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        cli_s = []
        for args in (("put", "smoke-cli", "hello"), ("append", "smoke-cli", " world"),
                     ("get", "smoke-cli")):
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "multiraft_tpu_torch", "kv", *args,
                 "--addr", addr],
                capture_output=True, text=True, env=env, cwd=ROOT, timeout=120,
            )
            cli_s.append(time.perf_counter() - t0)
            if r.returncode != 0:
                raise AssertionError(f"kv {args}: exit {r.returncode}: {r.stderr}")
        if r.stdout.strip() != "hello world":
            raise AssertionError(f"kv get: {r.stdout!r}")
        out["cli_s"] = cli_s
        log(f"serve 7(e): kv put/append/get round trip, "
            f"{', '.join(f'{s:.2f}' for s in cli_s)} s [{card}]")
        srv.sigterm()
    finally:
        srv.stop()
    return out


# ---------------------------------------------------------------------------
# Phase 8: the sharded engine served over TCP
# ---------------------------------------------------------------------------

NSHARDS = 10  # the reference's shard count (services/shardctrler.py)


def _wait(sched, fut, timeout: float, what: str):
    from multiraft_tpu_torch.sim.scheduler import TIMEOUT

    out = sched.wait(fut, timeout)
    if out is TIMEOUT:
        raise AssertionError(f"{what}: no answer in {timeout:.0f} s")
    return out


def _rpc(node, end, meth: str, args=None, timeout: float = 60.0):
    out = _wait(node.sched, end.call(meth, args), timeout, meth)
    if out is None:
        raise AssertionError(f"{meth}: dropped")
    return out


def _admin(node, ends, kind: str, arg, cmd: int, timeout: float = 180.0) -> float:
    """One config op on every process in order, under one command id
    (a fleet's config histories must stay aligned), re-sent under that
    id until each answers OK; returns the seconds."""
    from multiraft_tpu_torch.sim.scheduler import TIMEOUT

    t0 = time.perf_counter()
    for end in ends:
        while True:
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"admin {kind}: no OK in {timeout:.0f} s")
            r = node.sched.wait(end.call("EngineShardKV.admin", (kind, arg, cmd)), 30.0)
            if r is not None and r is not TIMEOUT and r.err == "OK":
                break
    return time.perf_counter() - t0


class _Blocking:
    """A generator clerk on an RPC node of its own, blocking;
    ``make(node)`` builds the clerk."""

    def __init__(self, make):
        from multiraft_tpu_torch.distributed.tcp import RpcNode

        self.node = RpcNode()
        self.ck = make(self.node)
        self.client_id = self.ck.client_id

    def run(self, gen, timeout: float = 120.0):
        return _wait(self.node.sched, self.node.sched.spawn(gen), timeout, "clerk op")

    def close(self) -> None:
        self.node.close()


def _shard_rows(node, ends_by_gid: dict, rows, clerks: int, deadline_s: float = 300.0):
    """``rows`` [(op, key, value)] through ``clerks`` ``ShardFirehoseClerk``s
    on one node at once, each a slice (a clerk keeps one write per shard
    in flight, so the clerks are the parallelism); returns the values
    in row order."""
    from multiraft_tpu_torch.distributed.engine_clerks import ShardFirehoseClerk

    slices = [list(range(i, len(rows), clerks)) for i in range(clerks)]
    slices = [ix for ix in slices if ix]
    futs = [node.sched.spawn(ShardFirehoseClerk(node.sched, ends_by_gid).run_batch(
        [rows[j] for j in ix], deadline_s=deadline_s)) for ix in slices]
    out = [None] * len(rows)
    for fut, ix in zip(futs, slices):
        vals = _wait(node.sched, fut, deadline_s + 5, "firehose clerk")
        for j, v in zip(ix, vals):
            out[j] = v
    return out


def _bulk_load(node, ends_by_gid: dict, kv: dict, frame_rows: int = 2048,
               window: int = 2) -> None:
    """Put every ``key: value`` of ``kv`` as a session of its own (one
    client id per row, command 1), packed into firehose frames of
    ``frame_rows`` rows, ``window`` frames in flight; rows not
    acknowledged OK are sent again under the same ids (dedup-safe)
    after a config refresh.  A clerk keeps one write per shard in
    flight, so a load of many keys through clerks is bound by round
    trips; single-op sessions are not.  The window keeps each frame
    inside the server's 5 s frame deadline: the 10 owner groups take 8
    entries a tick each."""
    import numpy as np

    from multiraft_tpu_torch.distributed.engine_wire import _OPCODE
    from multiraft_tpu_torch.engine.firehose import FH_OK, pack_request, unpack_reply
    from multiraft_tpu_torch.services.shardkv import key2shard
    from multiraft_tpu_torch.utils.ids import unique_client_id

    keys = list(kv)
    clients = np.array([unique_client_id(8_000_000 + i) for i in range(len(keys))],
                       np.uint64)
    procs = list(dict.fromkeys(ends_by_gid.values()))
    todo = list(range(len(keys)))
    t_end = time.perf_counter() + 300
    while todo:
        shards = _rpc(node, procs[0], "EngineShardKV.config")[1]
        frames = []
        by_end = {}
        for i in todo:
            gid = shards[key2shard(keys[i])]
            by_end.setdefault(ends_by_gid[gid], []).append((i, gid))
        for end, members in by_end.items():
            for s in range(0, len(members), frame_rows):
                frames.append((end, members[s: s + frame_rows]))
        retry = []
        for w in range(0, len(frames), window):
            if time.perf_counter() > t_end:
                raise AssertionError(f"bulk load: {len(todo)} rows unacknowledged")
            flights = []
            for end, part in frames[w: w + window]:
                idx = [i for i, _ in part]
                blob = pack_request(
                    np.full(len(idx), _OPCODE["Put"], np.uint8),
                    np.array([g for _, g in part], np.uint32), clients[idx],
                    np.ones(len(idx), np.uint64), [keys[i].encode() for i in idx],
                    [kv[keys[i]].encode() for i in idx])
                flights.append((idx, end.call("EngineShardKV.firehose", blob)))
            for idx, fut in flights:
                reply = node.sched.wait(fut, 120.0)
                if not isinstance(reply, (bytes, bytearray, memoryview)):
                    retry.extend(idx)  # dropped, timed out or shed: resend
                    continue
                err, _ = unpack_reply(reply)
                retry.extend(i for i, e in zip(idx, err.tolist()) if e != FH_OK)
        todo = sorted(retry)


def _read_all(node, ends_by_gid, model: dict, tags: dict, what: str) -> int:
    """Every key of ``model`` reads back its value; for each key of
    ``tags`` (key -> (acked tags, unacked tags)) each acked tag is there
    exactly once and each unacked one at most once.  Returns the keys."""
    keys = sorted(set(model) | set(tags))
    got = dict(zip(keys, _shard_rows(node, ends_by_gid, [("Get", k, "") for k in keys], 8)))
    for k, want in model.items():
        if got[k] != want:
            raise AssertionError(f"{what}: read back {k}: {got[k]!r} != {want!r}")
    for k, (acked, unacked) in tags.items():
        for t in acked:
            if got[k].count(t) != 1:
                raise AssertionError(f"{what}: {k}: acked {t} appears {got[k].count(t)}x")
        for t in unacked:
            if got[k].count(t) > 1:
                raise AssertionError(f"{what}: {k}: unacked {t} applied twice")
    return len(keys)


def _clerk_traffic(make, keys, workers: int, ops: int, during):
    """``workers`` threads, each a clerk of its own (``make(node)``), of
    appends (a unique tag each) and gets on the shared ``keys``, every
    op recorded with its wall-clock interval; ``during`` runs on this
    thread meanwhile.  Returns (history, op latencies, wall s)."""
    import threading

    from multiraft_tpu_torch.porcupine.types import (
        OP_APPEND, OP_GET, KvInput, KvOutput, Operation,
    )

    history, lat, errors = [], [], []
    lock = threading.Lock()

    def worker(w: int):
        c = _Blocking(make)
        try:
            for j in range(ops):
                key = keys[(w + j) % len(keys)]
                t0 = time.monotonic()
                if j % 3 == 2:
                    inp, out = KvInput(op=OP_GET, key=key), KvOutput(value=c.run(c.ck.get(key)))
                else:
                    tag = f"({w}.{j})"
                    c.run(c.ck.append(key, tag))
                    inp, out = KvInput(op=OP_APPEND, key=key, value=tag), KvOutput(value="")
                t1 = time.monotonic()
                with lock:
                    history.append(Operation(c.client_id, inp, t0, out, t1))
                    lat.append(t1 - t0)
        except BaseException as e:  # re-raised on the main thread
            errors.append(e)
        finally:
            c.close()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(w,)) for w in range(workers)]
    for t in threads:
        t.start()
    try:
        during()
    finally:
        for t in threads:
            t.join(timeout=300)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"clerk traffic: {errors or 'a clerk thread hung'}")
    return history, lat, time.perf_counter() - t0


def _tags_once(read, keys, workers: int, ops: int) -> dict:
    """Every append tag of :func:`_clerk_traffic` is in its key exactly
    once; returns the keys' values."""
    vals = {}
    for key in keys:
        v = vals[key] = read(key)
        for w in range(workers):
            for j in range(ops):
                tag = f"({w}.{j})"
                want = keys[(w + j) % len(keys)] == key and j % 3 != 2
                if v.count(tag) != (1 if want else 0):
                    raise AssertionError(f"{key}: {tag} appears {v.count(tag)}x")
    return vals


def _porcupine(history, what: str) -> dict:
    """The port's porcupine on a served history: the native DFS, and the
    verdict must be OK."""
    from multiraft_tpu_torch.porcupine.checker import check_operations
    from multiraft_tpu_torch.porcupine.kv import kv_model
    from multiraft_tpu_torch.porcupine.native import native_available

    if not native_available():
        raise AssertionError("the native porcupine checker did not build")
    t0 = time.perf_counter()
    verdict = check_operations(kv_model, history, timeout=120.0)
    out = dict(ops=len(history), verdict=verdict.value, path="native",
               check_s=time.perf_counter() - t0)
    if verdict.value != "ok":
        raise AssertionError(f"{what}: porcupine verdict {verdict.value}")
    return out


def _pump_hist(node, end) -> dict:
    """The server's ``pump.wall_s``/``pump.cpu_s`` percentiles (ms) from
    a raw ``Obs.hist`` call."""
    from multiraft_tpu_torch.utils.metrics import Hist

    hist = _rpc(node, end, "Obs.hist")
    out = {}
    for name in ("pump.wall_s", "pump.cpu_s"):
        h = Hist.from_dump(hist["hists"][name])
        out[name] = {f"p{q}_ms": h.percentile(q / 100) * 1e3 for q in (50, 90, 99)}
        out[name]["count"] = h.count
    return out


def _k(prefix: str, i: int) -> str:
    """Key ``i`` of a family.  A key's shard is its first byte mod 10
    (the reference's key2shard), so a leading digit spreads a family
    over all the shards."""
    return f"{i % 10}{prefix}{i}"


def _key_per_shard(prefix: str) -> list:
    """One key on each shard, in shard order."""
    from multiraft_tpu_torch.services.shardkv import key2shard

    keys = {key2shard(_k(prefix, i)): _k(prefix, i) for i in range(NSHARDS)}
    return [keys[s] for s in range(NSHARDS)]


def shard_standalone(card: str, device: str = "cuda", G: int = HEADLINE["G"],
                     n_keys: int = 9_000, workers: int = 8, ops: int = 20,
                     fh_clerks: int = 4) -> dict:
    """8(a): ``serve-shardkv`` at full width, group 0 the config RSM."""
    import shutil
    import threading

    from multiraft_tpu_torch.distributed.engine_clerks import EngineShardNetClerk
    from multiraft_tpu_torch.distributed.tcp import RpcNode
    from multiraft_tpu_torch.services.shardkv import key2shard

    data = os.path.join(SCRATCH, "shard")
    shutil.rmtree(data, ignore_errors=True)
    os.makedirs(SCRATCH, exist_ok=True)
    on_card = device == "cuda"
    srv = _Server(data, G, cmd="serve-shardkv", env={}, log="shard.log",
                  extra=[] if on_card else ["--device", device])
    node = RpcNode()
    out, model = {}, {}
    try:
        used0 = _gpu_mib(-1)[1] if on_card else None
        out["ready_s"] = srv.start()
        end = node.client_end("127.0.0.1", srv.port)
        ends = {g: end for g in range(1, G)}
        if on_card:
            used1 = _gpu_mib(srv.proc.pid)[1]
            out["card_mib"] = (used0, used1)
            if used1 - used0 < 100:
                raise AssertionError(f"serve-shardkv: card memory {used0:.0f} -> {used1:.0f} MiB")
        log(f"shard 8(a): ready in {out['ready_s']:.2f} s at G={G}; card memory "
            f"{out.get('card_mib')} MiB before/after [{card}]")

        def new_clerk(n):
            return EngineShardNetClerk(n.sched, n.client_end("127.0.0.1", srv.port))

        # Join gids 1..G-1 in one admin RPC; every shard serves when a
        # logged Get on one key of each shard answers.
        ticks0 = _rpc(node, end, "Obs.snapshot")["metrics"].get("ticks", 0)
        t0 = time.perf_counter()
        _admin(node, [end], "join", list(range(1, G)), 1)
        probe = _Blocking(new_clerk)
        try:
            for k in _key_per_shard("probe"):
                probe.run(probe.ck.get(k))
        finally:
            probe.close()
        out["join_s"] = time.perf_counter() - t0
        out["join_ticks"] = _rpc(node, end, "Obs.snapshot")["metrics"].get("ticks", 0) - ticks0
        cfg = _rpc(node, end, "EngineShardKV.config")
        if 0 in cfg[1] or len(cfg[2]) != G - 1:
            raise AssertionError(f"8(a) join: shards {cfg[1]}, {len(cfg[2])} groups")
        log(f"shard 8(a): {G - 1} gids joined by one admin RPC; every shard serving "
            f"after {out['join_ticks']} ticks, {out['join_s']:.2f} s [{card}]")

        # Load the keys: single-op sessions in firehose frames.
        load = {_k("s", i): f"<{i}>" for i in range(n_keys)}
        t0 = time.perf_counter()
        _bulk_load(node, ends, load)
        load_s = time.perf_counter() - t0
        model.update(load)
        out["load"] = dict(rows=n_keys, s=load_s, rows_acked_per_s=n_keys / load_s)
        log(f"shard 8(a): {n_keys} keys across {NSHARDS} shards in firehose frames "
            f"of 2,048 single-op sessions, 2 in flight: {json.dumps(out['load'])} [{card}]")

        # Clerk threads across a live move and leave.
        tkeys = [_k("t", i) for i in range(16)]
        owners = cfg[1]
        mshard = key2shard(tkeys[0])
        free = next(g for g in range(G - 1, 0, -1) if g not in owners)
        leaving = sorted({owners[s] for s in range(NSHARDS) if s != mshard})[:3]
        mig = {}

        def during():
            time.sleep(0.5)
            mig["move_s"] = _admin(node, [end], "move", (mshard, free), 2)
            mig["leave_s"] = _admin(node, [end], "leave", leaving, 3)

        history, lat, wall = _clerk_traffic(new_clerk, tkeys, workers, ops, during)
        cfg = _rpc(node, end, "EngineShardKV.config")
        if cfg[1][mshard] != free or set(cfg[1]) & set(leaving) or 0 in cfg[1]:
            raise AssertionError(f"8(a) move/leave: shards {cfg[1]}")
        reader = _Blocking(new_clerk)
        try:
            model.update(_tags_once(lambda k: reader.run(reader.ck.get(k)), tkeys, workers, ops))
        finally:
            reader.close()
        out["traffic"] = dict(ops=len(lat), s=wall, ops_per_s=len(lat) / wall,
                              p50_ms=_pct(lat, 50) * 1e3, p99_ms=_pct(lat, 99) * 1e3,
                              **mig)
        out["porcupine"] = _porcupine(history, "8(a) clerks")
        out["pump"] = _pump_hist(node, end)
        log(f"shard 8(a): {workers} EngineShardNetClerk threads x {ops} ops across "
            f"a move of shard {mshard} and a leave of gids {leaving}: "
            f"{json.dumps(out['traffic'])}; porcupine {json.dumps(out['porcupine'])}; "
            f"every append tag once; server pump (Obs.hist, since start) "
            f"{json.dumps(out['pump'])} [{card}]")

        # kill -9 in the middle of a ShardFirehoseClerk firehose: sets
        # of appends, one write per shard per clerk in flight.
        sets, done, stop, errs = [], [], threading.Event(), []

        def firehose():
            fnode = RpcNode()
            fend = fnode.client_end("127.0.0.1", srv.port)
            fends = {g: fend for g in range(1, G)}
            try:
                for f in range(40):
                    if stop.is_set():
                        break
                    rows = [("Append", _k("c", (f * 7 + i) % 211), f"[{f}.{i}]")
                            for i in range(NSHARDS * fh_clerks)]
                    sets.append(rows)
                    _shard_rows(fnode, fends, rows, fh_clerks, deadline_s=10.0)
                    done.append((f, time.perf_counter()))
            except AssertionError:
                pass  # the server died under the set in flight
            except BaseException as e:
                errs.append(e)
            finally:
                fnode.close()

        th = threading.Thread(target=firehose)
        t0 = time.perf_counter()
        th.start()
        while len(done) < 3 and time.perf_counter() - t0 < 120:
            time.sleep(0.005)
        if len(done) < 3:
            raise AssertionError("8(a): the firehose acknowledged under 3 sets")
        fh_s = time.perf_counter() - t0
        fh_rows = NSHARDS * fh_clerks * len(done)
        out["firehose"] = dict(clerks=fh_clerks, sets=len(done), rows=fh_rows, s=fh_s,
                               rows_acked_per_s=fh_rows / fh_s)
        time.sleep(0.05)
        stop.set()
        t_kill = time.perf_counter()
        srv.kill9()
        out["restart_after_kill_s"] = srv.start()
        th.join(timeout=120)
        if th.is_alive() or errs:
            raise AssertionError(f"8(a): firehose thread {errs}")
        acked = {f for f, t in done if t < t_kill}
        tags = {}
        for f, rows in enumerate(sets):
            for _, key, tag in rows:
                a, u = tags.setdefault(key, ([], []))
                (a if f in acked else u).append(tag)
        end = node.client_end("127.0.0.1", srv.port)
        ends = {g: end for g in range(1, G)}
        out["replayed_records"] = _rpc(node, end, "Obs.snapshot")["metrics"].get(
            "wal.replayed_records", 0)
        if out["replayed_records"] <= 0:
            raise AssertionError("8(a): the restart replayed no WAL record")
        keys = _read_all(node, ends, model, tags, "8(a) kill -9")
        log(f"shard 8(a): firehose {json.dumps(out['firehose'])}; kill -9 after "
            f"{len(acked)} acknowledged sets ({len(sets)} sent); ready again in "
            f"{out['restart_after_kill_s']:.2f} s, {out['replayed_records']} WAL records "
            f"replayed (ShardWalReplay); {keys} keys read back, every acknowledged "
            f"write there, each acked tag once [{card}]")
        ck = sorted(tags)
        model.update(zip(ck, _shard_rows(node, ends, [("Get", k, "") for k in ck], 8)))

        # SIGTERM: exit 0, final checkpoint; the restart replays nothing.
        srv.sigterm()
        out["restart_after_sigterm_s"] = srv.start()
        end = node.client_end("127.0.0.1", srv.port)
        ends = {g: end for g in range(1, G)}
        m = _rpc(node, end, "Obs.snapshot")["metrics"]
        if m.get("wal.replayed_records", 0) != 0 or m.get("engine.restores", 0) != 1:
            raise AssertionError(f"8(a) SIGTERM: replayed {m.get('wal.replayed_records')}, "
                                 f"restores {m.get('engine.restores')}")
        keys = _read_all(node, ends, model, {}, "8(a) SIGTERM")
        log(f"shard 8(a): SIGTERM exit 0; ready again in "
            f"{out['restart_after_sigterm_s']:.2f} s, 0 WAL records replayed; "
            f"{keys} keys read back [{card}]")

        # The command line.
        addr = f"127.0.0.1:{srv.port}"
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        cli_s = []
        for args in (("put", "smoke-cli", "hello"), ("append", "smoke-cli", " world"),
                     ("get", "smoke-cli")):
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "multiraft_tpu_torch", "kv", *args,
                 "--addr", addr, "--service", "EngineShardKV"],
                capture_output=True, text=True, env=env, cwd=ROOT, timeout=120,
            )
            cli_s.append(time.perf_counter() - t0)
            if r.returncode != 0:
                raise AssertionError(f"kv {args}: exit {r.returncode}: {r.stderr}")
        if r.stdout.strip() != "hello world":
            raise AssertionError(f"kv get --service EngineShardKV: {r.stdout!r}")
        out["cli_s"] = cli_s
        log(f"shard 8(a): kv --service EngineShardKV put/append/get, "
            f"{', '.join(f'{s:.2f}' for s in cli_s)} s [{card}]")
        srv.sigterm()
    finally:
        srv.stop()
        node.close()
    return out


def shard_fleet(card: str, device: str = "cuda", n_gids: int = 9_999,
                n_keys: int = 4_000, workers: int = 4, ops: int = 15) -> dict:
    """8(b): two ``serve-shardkv --gids ... --peer ...`` processes on the
    card splitting gids 1..``n_gids``; shards migrate between them."""
    import shutil

    from multiraft_tpu_torch.distributed.engine_clerks import EngineFleetClerk
    from multiraft_tpu_torch.distributed.launch import reserve_ports
    from multiraft_tpu_torch.distributed.tcp import RpcNode
    from multiraft_tpu_torch.services.shardkv import key2shard

    half = (n_gids + 1) // 2
    gids = [list(range(1, half + 1)), list(range(half + 1, n_gids + 1))]
    ports = reserve_ports(2, "127.0.0.1")
    addr = {g: ("127.0.0.1", ports[i]) for i, gl in enumerate(gids) for g in gl}
    srvs = []
    for i in range(2):
        data = os.path.join(SCRATCH, f"fleet{i}")
        shutil.rmtree(data, ignore_errors=True)
        extra = ["--port", str(ports[i]), "--gids", ",".join(map(str, gids[i]))]
        for g in gids[1 - i]:
            extra += ["--peer", f"{g}=127.0.0.1:{ports[1 - i]}"]
        if device != "cuda":
            extra += ["--device", device]
        srvs.append(_Server(data, len(gids[i]) + 1, cmd="serve-shardkv", env={},
                            log=f"fleet{i}.log", extra=extra))
    node = RpcNode()
    out = {"gids_per_process": [len(g) for g in gids]}
    try:
        for s in srvs:
            s.launch()
        out["ready_s"] = [s.wait_ready() for s in srvs]
        pends = [node.client_end("127.0.0.1", p) for p in ports]
        ends = {g: pends[0 if g <= half else 1] for g in addr}
        log(f"shard 8(b): two fleet processes of {out['gids_per_process']} gids "
            f"ready in {out['ready_s']} s [{card}]")

        def new_clerk(n):
            return EngineFleetClerk(n.sched, {g: n.client_end(*a) for g, a in addr.items()},
                                    make_end=n.client_end)

        first = list(range(1, 6))
        _admin(node, pends, "join", first, 1)
        model = {_k("b", i): f"<{i}>" for i in range(n_keys)}
        t0 = time.perf_counter()
        _bulk_load(node, ends, model)
        out["load"] = dict(rows=n_keys, s=time.perf_counter() - t0)

        # Join the second process's gids under clerk traffic: half the
        # shards move across processes (pull_shard/delete_shard).
        tkeys = [_k("ft", i) for i in range(12)]
        mig = {}

        def during():
            time.sleep(0.3)
            t1 = time.perf_counter()
            mig["join_s"] = _admin(node, pends, "join", gids[1], 2)
            probe = _Blocking(new_clerk)
            try:
                for k in _key_per_shard("fprobe"):
                    probe.run(probe.ck.get(k))
            finally:
                probe.close()
            mig["serving_s"] = time.perf_counter() - t1

        history, lat, wall = _clerk_traffic(new_clerk, tkeys, workers, ops, during)
        cfg = _rpc(node, pends[0], "EngineShardKV.config")
        moved = [s for s in range(NSHARDS) if cfg[1][s] > half]
        if not moved or len(moved) == NSHARDS:
            raise AssertionError(f"8(b) join: shards {cfg[1]}")
        reader = _Blocking(new_clerk)
        try:
            model.update(_tags_once(lambda k: reader.run(reader.ck.get(k)), tkeys, workers, ops))
        finally:
            reader.close()
        out["traffic"] = dict(ops=len(lat), s=wall, p50_ms=_pct(lat, 50) * 1e3,
                              p99_ms=_pct(lat, 99) * 1e3, shards_moved=len(moved), **mig)
        out["porcupine"] = _porcupine(history, "8(b) fleet clerks")
        log(f"shard 8(b): {workers} EngineFleetClerk threads x {ops} ops across a join "
            f"moving {len(moved)} shards to the other process: {json.dumps(out['traffic'])}; "
            f"porcupine {json.dumps(out['porcupine'])} [{card}]")

        # The first gids leave: the rest of the shards move to the second
        # process, which is killed as soon as the config commits there.
        _admin(node, pends, "leave", first, 3)
        srvs[1].kill9()
        out["restart_after_kill_s"] = srvs[1].start()
        keys = _read_all(node, ends, model, {}, "8(b) kill -9 mid-migration")
        cfg = _rpc(node, pends[0], "EngineShardKV.config")
        if any(g <= half for g in cfg[1]):
            raise AssertionError(f"8(b) leave: shards {cfg[1]}")
        log(f"shard 8(b): kill -9 of the pulling process mid-migration, ready again "
            f"in {out['restart_after_kill_s']:.2f} s; {keys} keys read back, every "
            f"acknowledged write there [{card}]")
        for s in srvs:
            s.sigterm()
    finally:
        for s in srvs:
            s.stop()
        node.close()
    return out


def shard_split(card: str, device: str = "cuda", G: int = 64) -> dict:
    """8(c): the split servers as two processes on the card, engine G
    groups each; kill -9 a minority owner under load, restart durably."""
    import shutil
    import threading

    from multiraft_tpu_torch.distributed.cluster import (
        SplitProcessCluster,
        SplitShardProcessCluster,
    )

    out = {}
    data = os.path.join(SCRATCH, "split")
    shutil.rmtree(data, ignore_errors=True)
    owners = {g: [0, 1, 1] for g in range(G)}
    keys = [_k("sk", i) for i in range(16)]

    def load(clerk, acked, tag, rounds):
        for r in range(rounds):
            for k in keys:
                clerk.append(k, f"[{tag}{r}]", timeout=120.0)
                acked[k] += f"[{tag}{r}]"

    def split_kv():
        # (c1) SplitKV: leaders parked on the 1-slot process, killed under load.
        cl = SplitProcessCluster(owners, n_procs=2, groups=G, delay_elections=[0, 300],
                                 data_dir=os.path.join(data, "kv"), snapshot_every_s=5.0,
                                 device=device)
        try:
            t0 = time.perf_counter()
            cl.start_all()
            out["kv_ready_s"] = time.perf_counter() - t0
            clerk = cl.clerk()
            try:
                acked = {k: "" for k in keys}
                load(clerk, acked, "a", 1)
                errs = []

                def under_load():
                    try:
                        load(clerk, acked, "b", 2)
                    except BaseException as e:
                        errs.append(e)

                th = threading.Thread(target=under_load)
                th.start()
                time.sleep(0.2)
                t0 = time.perf_counter()
                cl.kill(0)
                th.join(timeout=300)
                if th.is_alive() or errs:
                    raise AssertionError(f"8(c) split kv under the kill: {errs}")
                out["kv_failover_load_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                cl.start(0)
                out["kv_rejoin_s"] = time.perf_counter() - t0
                load(clerk, acked, "c", 1)
                for k, v in acked.items():
                    got = clerk.get(k, timeout=120.0)
                    if got != v:
                        raise AssertionError(f"8(c) split kv {k}: {got!r} != {v!r}")
            finally:
                clerk.close()
        finally:
            cl.shutdown()
        log(f"shard 8(c): SplitProcessCluster G={G} x 2 processes: ready in "
            f"{out['kv_ready_s']:.2f} s; kill -9 of the minority owner under load, "
            f"survivors served the load in {out['kv_failover_load_s']:.2f} s; durable "
            f"rejoin {out['kv_rejoin_s']:.2f} s; every acknowledged append read back "
            f"once [{card}]")

    def split_shard():
        # (c2) SplitShardKV: the minority owner dies mid-migration.
        cl = SplitShardProcessCluster(owners, n_procs=2, groups=G, delay_elections=[0, 400],
                                      data_dir=os.path.join(data, "shard"),
                                      snapshot_every_s=5.0, device=device)
        try:
            t0 = time.perf_counter()
            cl.start_all()
            out["shard_ready_s"] = time.perf_counter() - t0
            clerk = cl.clerk()
            try:
                clerk.admin("join", {1: ["p1"]})
                acked = {k: "" for k in keys}
                load(clerk, acked, "a", 1)
                clerk.admin("join", {2: ["p2"]})
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < 60:
                    st = clerk.status(0) or clerk.status(1)
                    if st and st[2]:
                        break
                    time.sleep(0.02)
                else:
                    raise AssertionError("8(c): the migration never showed")
                errs = []

                def under_load():
                    try:
                        load(clerk, acked, "b", 1)
                    except BaseException as e:
                        errs.append(e)

                th = threading.Thread(target=under_load)
                th.start()
                time.sleep(0.1)
                t0 = time.perf_counter()
                cl.kill(0)
                th.join(timeout=300)
                if th.is_alive() or errs:
                    raise AssertionError(f"8(c) split shard under the kill: {errs}")
                while time.perf_counter() - t0 < 120:
                    st = clerk.status(1)
                    if st and st[0] >= 2 and not st[2]:
                        break
                    time.sleep(0.05)
                else:
                    raise AssertionError(f"8(c): the survivor did not finish the migration: {st}")
                out["shard_migration_after_kill_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                cl.start(0)
                out["shard_rejoin_s"] = time.perf_counter() - t0
                load(clerk, acked, "c", 1)
                for k, v in acked.items():
                    got = clerk.get(k, timeout=120.0)
                    if got != v:
                        raise AssertionError(f"8(c) split shard {k}: {got!r} != {v!r}")
            finally:
                clerk.close()
        finally:
            cl.shutdown()
        log(f"shard 8(c): SplitShardProcessCluster G={G} x 2 processes: ready in "
            f"{out['shard_ready_s']:.2f} s; kill -9 of the minority owner mid-migration "
            f"under load; the survivor served the load and finished the migration "
            f"{out['shard_migration_after_kill_s']:.2f} s after the kill; "
            f"durable rejoin {out['shard_rejoin_s']:.2f} s; every acknowledged append "
            f"read back once [{card}]")

    # The two clusters run at once (four processes on the card): each
    # is a pass/fail check of a failure model, and run one after the
    # other they would double the sub-phase's wall time.
    errs = []

    def guarded(fn):
        try:
            fn()
        except BaseException as e:  # re-raised on this thread
            errs.append(e)

    threads = [threading.Thread(target=guarded, args=(fn,))
               for fn in (split_kv, split_shard)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errs or any(t.is_alive() for t in threads):
        raise AssertionError(f"8(c): {errs or 'a cluster hung'}")
    return out


def phase_shard_serve(card: str, kernels) -> dict:
    """Phase 8: each sub-phase with the launch counts set to 0 just
    before it and read just after; the servers are child processes
    that build their engines without the kernels, as the reference's
    do, so the counts stay 0."""
    out = {}
    for name, fn in (("8a", shard_standalone), ("8b", shard_fleet), ("8c", shard_split)):
        kernels.reset_launches()
        t0 = time.perf_counter()
        out[name] = fn(card)
        out[name]["phase_s"] = time.perf_counter() - t0
        out[name]["launches"] = dict(kernels.LAUNCHES)
        log(f"{name}: launches {out[name]['launches']}, {out[name]['phase_s']:.2f} s [{card}]")
        if max(kernels.LAUNCHES.values()) > 0:
            raise AssertionError(f"{name}: launches in this process {kernels.LAUNCHES}")
    return out


# ---------------------------------------------------------------------------
# Phase 9: the headline run traced, faulted and verified; the engine against
# the per-replica Raft simulator
# ---------------------------------------------------------------------------

# The bench's timed window (multiraft_tpu_torch/bench.py, bench.py's
# defaults): chunks of 200 ticks, 3 chunks a run, 48 leaders killed at
# each interior chunk boundary, 128 sampled groups.  RUNS is cut from 3
# to 1 to fit the smoke's time.
BENCH = dict(CHUNK=200, N_CHUNKS=3, RUNS=1, N_FAULT=48, N_SAMPLE=128)
# The same script at G=64, on the card and on the CPU.
BENCH_SMALL = dict(G=64, CHUNK=100, N_CHUNKS=3, N_FAULT=8, N_SAMPLE=16)


def headline_verified(card: str, kernels) -> dict:
    """9(a): the headline deployment traced with faults and verified."""
    import numpy as np

    from multiraft_tpu_torch.bench import _stalled_sampled, traced_run, verify_run
    from multiraft_tpu_torch.engine.core import EngineConfig
    from multiraft_tpu_torch.porcupine.native import native_available

    if not native_available():
        raise AssertionError("the native porcupine checker did not build")
    cfg = EngineConfig(use_kernels=True, **HEADLINE)
    kernels.reset_launches()
    run = traced_run(cfg, "cuda", BENCH["CHUNK"], BENCH["N_CHUNKS"] * BENCH["RUNS"],
                     BENCH["N_FAULT"], BENCH["N_SAMPLE"])
    launches = dict(kernels.LAUNCHES)
    v = verify_run(run, cfg)
    lat, porc = v["lat"], v["porc"]
    mean_ms = float(np.mean(run["tick_ms"]))
    p99_ms = float(np.percentile(np.array(run["tick_ms"]), 99))
    out = dict(
        ticks=len(run["tick_ms"]) * BENCH["CHUNK"], kills=run["n_kills"],
        warm_s=run["warm_s"], tick_ms_mean=mean_ms, tick_ms_p99=p99_ms,
        commits=sum(run["commits"]),
        commits_per_s=sum(run["commits"]) / (sum(run["tick_ms"]) * BENCH["CHUNK"] / 1e3),
        entries=lat["entries"], unaccounted=lat["unaccounted"],
        pre_window=lat["pre_window_commits"], churned_groups=lat["churned_groups"],
        rebound_entries=lat["rebound_entries"],
        p50_ticks=lat["p50_ticks"], p99_ticks=lat["p99_ticks"],
        p50_ms=lat["p50_ticks"] * mean_ms, p99_ms=lat["p99_ticks"] * mean_ms,
        failover_entries=lat["failover_entries"],
        failover_p50_ticks=lat["failover_p50_ticks"],
        failover_p99_ticks=lat["failover_p99_ticks"],
        failover_p50_ms=lat["failover_p50_ticks"] * mean_ms,
        failover_p99_ms=lat["failover_p99_ticks"] * mean_ms,
        porcupine=porc["porcupine"], sampled=porc["sampled_groups"],
        groups_ok=porc.get("groups_ok"), groups_unknown=porc.get("groups_unknown"),
        groups_churned=porc.get("groups_churned"),
        ring_crosschecked=porc.get("ring_entries_crosschecked"),
        ring_arbitrated=porc.get("ring_arbitrated_entries"),
        ambiguous=porc.get("ambiguous_entries"),
        dfs_oracle_groups=porc.get("dfs_oracle_groups"),
        checker_paths=v["paths"], verify_s=v["verify_s"],
        stalled_sampled=_stalled_sampled(run, cfg), launches=launches,
    )
    log(f"9a: G={cfg.G} P={cfg.P} L={cfg.L} E={cfg.E} INGEST={cfg.INGEST}, "
        f"{out['ticks']} traced ticks, {out['kills']} leaders killed: "
        f"{mean_ms:.3f} ms/tick mean, {p99_ms:.3f} p99 (per chunk), "
        f"{out['commits_per_s']:.0f} commits/s [{card}]")
    log(f"9a: {lat['entries']} entries measured, {lat['unaccounted']} "
        f"unaccounted, {lat['churned_groups']} churned groups; commit latency "
        f"p50/p99 {lat['p50_ticks']}/{lat['p99_ticks']} ticks = "
        f"{out['p50_ms']:.3f}/{out['p99_ms']:.3f} ms; failover p50/p99 "
        f"{lat['failover_p50_ticks']}/{lat['failover_p99_ticks']} ticks = "
        f"{out['failover_p50_ms']:.3f}/{out['failover_p99_ms']:.3f} ms [{card}]")
    log(f"9a: porcupine {porc['porcupine']} over {porc['sampled_groups']} "
        f"sampled groups: ok {porc.get('groups_ok')}, unknown "
        f"{porc.get('groups_unknown')}, {porc.get('ring_entries_crosschecked')} "
        f"ring entries cross-checked, checker paths {v['paths']}, "
        f"{v['verify_s']:.2f} s; launches {launches} [{card}]")
    if porc["porcupine"] != "ok" or porc.get("groups_unknown"):
        raise AssertionError(f"9a: porcupine {porc}")
    if lat["unaccounted"] != 0:
        raise AssertionError(f"9a: {lat['unaccounted']} entries unaccounted")
    if not porc.get("ring_entries_crosschecked"):
        raise AssertionError("9a: the ring cross-check checked nothing")
    if v["paths"]["native"] <= 0 or v["paths"]["generic"]:
        raise AssertionError(f"9a: checker paths {v['paths']}, the native DFS must run")
    if lat["entries"] <= 0 or lat["churned_groups"] <= 0:
        raise AssertionError(f"9a: nothing measured or no churn: {lat}")
    for name, n in launches.items():
        if n < out["ticks"]:
            raise AssertionError(f"9a: kernel {name} launched {n} times")

    # The same script at G=64 on the card and on the CPU.
    small = EngineConfig(use_kernels=True, **dict(HEADLINE, G=BENCH_SMALL["G"]))
    t0 = time.perf_counter()
    res = {}
    for dev in ("cuda", "cpu"):
        r = traced_run(small, dev, BENCH_SMALL["CHUNK"], BENCH_SMALL["N_CHUNKS"],
                       BENCH_SMALL["N_FAULT"], BENCH_SMALL["N_SAMPLE"])
        res[dev] = verify_run(r, small)
    for k in res["cuda"]["recs"]:
        a, b = res["cuda"]["recs"][k], res["cpu"]["recs"][k]
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"9a: G=64 record {k} differs between card and CPU")
    for k in ("lat", "porc"):
        if res["cuda"][k] != res["cpu"][k]:
            raise AssertionError(f"9a: G=64 {k} differs: {res['cuda'][k]} != {res['cpu'][k]}")
    if res["cuda"]["porc"]["porcupine"] != "ok" or res["cuda"]["lat"]["unaccounted"]:
        raise AssertionError(f"9a: G=64 verification {res['cuda']['porc']}")
    out["small"] = dict(G=small.G, churned=res["cuda"]["lat"]["churned_groups"],
                        entries=res["cuda"]["lat"]["entries"],
                        s=time.perf_counter() - t0)
    log(f"9a: G=64 card and CPU: records and bench_verify results equal "
        f"({out['small']['entries']} entries, {out['small']['churned']} churned "
        f"groups, {out['small']['s']:.2f} s)")
    return out


# 9(b) runs the battery at the reference's width (two lanes), then the
# densest fault mix at this width.
WIDE_GROUPS = 256


def conformance_on_card(card: str, kernels) -> dict:
    """9(b): every conformance scenario and three fuzz seeds on the card,
    each card stream held to the sim's (``run_both``) and to the port's
    CPU run; then ``cocktail`` at ``WIDE_GROUPS`` groups."""
    from multiraft_tpu_torch import conformance as conf

    kernels.reset_launches()
    runs = [(name, conf.SCENARIOS[name], 7) for name in sorted(conf.SCENARIOS)]
    runs += [(f"fuzz-{s}", conf.random_scenario(s), s) for s in (101, 202, 303)]
    out = {}
    for name, sc, seed in runs:
        stats = {}
        t0 = time.perf_counter()
        sim, card_streams = conf.run_both(sc, seed=seed, device="cuda", stats=stats)
        card_s = time.perf_counter() - t0
        cpu_streams = conf.run_engine(sc, seed=seed, device="cpu")
        _same_streams(name, sc, sim, card_streams, cpu_streams)
        out[name] = dict(ticks=stats["ticks"], s=card_s,
                         ms_per_tick=card_s / stats["ticks"] * 1e3)
        log(f"9b: {name}: {stats['ticks']} ticks, {card_s:.2f} s with the sim, "
            f"{out[name]['ms_per_tick']:.3f} ms per tick; card = sim = CPU [{card}]")
    sc = conf.SCENARIOS["cocktail"]
    stats = {}
    t0 = time.perf_counter()
    card_streams = conf.run_engine(sc, seed=7, groups=WIDE_GROUPS, device="cuda",
                                   stats=stats)
    card_s = time.perf_counter() - t0
    sim = conf.run_sim(sc, seed=7)
    cpu_streams = conf.run_engine(sc, seed=7, groups=WIDE_GROUPS, device="cpu")
    _same_streams("cocktail-wide", sc, sim, card_streams, cpu_streams)
    out["cocktail-wide"] = dict(groups=WIDE_GROUPS, ticks=stats["ticks"], s=card_s,
                                ms_per_tick=card_s / stats["ticks"] * 1e3)
    log(f"9b: cocktail at G={WIDE_GROUPS}: {stats['ticks']} ticks, {card_s:.2f} s, "
        f"{out['cocktail-wide']['ms_per_tick']:.3f} ms per tick; card = sim = CPU "
        f"[{card}]")
    if max(kernels.LAUNCHES.values()) > 0:
        raise AssertionError(f"9b: launches {kernels.LAUNCHES} (the plain tick runs here)")
    return out


def _same_streams(name, sc, sim, card_streams, cpu_streams) -> None:
    if card_streams != cpu_streams:
        raise AssertionError(f"9b: {name}: card streams differ from the CPU's")
    for g, s in enumerate(card_streams):
        if (s if sc.ordered else sorted(s)) != (sim if sc.ordered else sorted(sim)):
            raise AssertionError(f"9b: {name}: group {g} stream differs from the sim's")


def phase_verify(card: str, kernels, beside: Beside) -> dict:
    """Phase 9: each sub-phase with the launch counts set to 0 just
    before it and read just after; 9(b) ran in the side process."""
    t0 = time.perf_counter()
    out = {"9a": headline_verified(card, kernels)}
    out["9a"]["phase_s"] = time.perf_counter() - t0
    out["9a"]["launches"] = dict(kernels.LAUNCHES)
    log(f"9a: launches {out['9a']['launches']}, {out['9a']['phase_s']:.2f} s [{card}]")
    out["9b"] = beside.result("9b")
    return out


# ---------------------------------------------------------------------------
# Phase 10: a placed, durable, self-healing fleet on the card
# ---------------------------------------------------------------------------

# The reference's placement chaos knobs (tests/test_placement.py:789-792).
PLACE_KNOBS = dict(scrape_s=0.3, dead_s=2.0, cooldown_s=5.0, min_gain=0.25, max_moves=1)
# The self-healing runs: voluntary moves off, the replace policy on.
HEAL_KNOBS = dict(scrape_s=0.3, dead_s=2.0, cooldown_s=5.0, min_gain=10.0, max_moves=0)
# 10(a)'s deployment: 3 fleet processes of PLACED["gpp"] gids, each with
# PLACED["spare"] spare slots (the survivors' spares must hold every gid of
# the killed process).  Cut from 1,000 gids a process to the floor of 256
# to fit the smoke's time: a failover re-places the victim's gids one after
# another, three replicated intents and a recover RPC each (PERF.md section
# 4).  The map's replicas snapshot past MAP_MAXRAFTSTATE bytes of log.
PLACED = dict(gpp=256, spare=160, nemesis_s=20.0)
MAP_MAXRAFTSTATE = 16384
# This process's flight ring in 10(a): it holds the controller's PLACE
# record of every failover beside two records of every clerk RPC and the
# map's replication, and a slow failover's retries outgrow the default
# 8,192 slots before the bundle is taken, evicting the first failovers.
# The fleet's processes keep the default.
PLACED_RING_SLOTS = 1 << 17


def _keys_by_gid(shards, n_keys: int = 400) -> dict:
    """key -> owning gid under the config's shard table, for keys that
    cover every shard (a key's shard is its first byte mod 10)."""
    from multiraft_tpu_torch.services.shardkv import key2shard

    return {_k("pk", i): shards[key2shard(_k("pk", i))] for i in range(n_keys)}


def _proc_spread(loads: dict, placement: dict, procs, killed=()) -> float:
    """Per-process load spread (max - min summed commit rate) under a
    placement (scripts/placement_scenario.py's measure)."""
    load = {p: 0.0 for p in procs if p not in killed}
    for gid, rate in loads.items():
        if placement.get(gid) in load:
            load[placement[gid]] += rate
    return max(load.values()) - min(load.values()) if load else 0.0


class _Acked:
    """A single-writer closed-loop clerk that records every op for
    porcupine and keeps the model of what was acknowledged."""

    def __init__(self, fleet) -> None:
        self.ck = fleet.clerk()
        self.model, self.history = {}, []
        self.wrong = {}

    def append(self, key: str, tag: str) -> None:
        from multiraft_tpu_torch.porcupine.types import OP_APPEND, KvInput, KvOutput, Operation

        t0 = time.monotonic()
        self.ck.append(key, tag, timeout=600.0)
        self.history.append(Operation(self.ck.client_id, KvInput(op=OP_APPEND, key=key, value=tag),
                                      t0, KvOutput(value=""), time.monotonic()))
        self.model[key] = self.model.get(key, "") + tag

    def lost(self) -> int:
        """Acknowledged keys whose value does not read back exactly; each
        such key's missing and surplus tags are kept in ``wrong``."""
        self.wrong = {}
        for k, v in self.model.items():
            got = self.ck.get(k, timeout=120.0)
            if got != v:
                want_tags, got_tags = v.split(","), got.split(",")
                self.wrong[k] = dict(
                    missing=[t for t in want_tags if t and t not in got_tags],
                    surplus=sorted({t for t in got_tags if t and got_tags.count(t) > want_tags.count(t)}),
                    want_len=len(v), got_len=len(got))
        return len(self.wrong)

    def close(self) -> None:
        self.ck.close()


def placed_failover(card: str, device: str = "cuda", gpp: int = PLACED["gpp"],
                    spare: int = PLACED["spare"], nemesis_s: float = PLACED["nemesis_s"]) -> dict:
    """10(a): ``PlacedFleet`` over TCP, durable (sync shipping to a data
    dir): a join of every gid, a skew the controller rebalances, a
    nemesis of delay/drop/sever/partition windows ending in a kill of
    the process hosting the most groups, durable failover, then a
    postmortem bundle read by the doctor."""
    import shutil
    import threading

    from multiraft_tpu_torch.analysis import postmortem
    from multiraft_tpu_torch.distributed import flightrec
    from multiraft_tpu_torch.distributed.placement import PlacementController
    from multiraft_tpu_torch.harness.bundle import collect_bundle
    from multiraft_tpu_torch.harness.fleet import PlacedFleet
    from multiraft_tpu_torch.harness.nemesis import Nemesis, make_schedule, run_clerk_load
    from multiraft_tpu_torch.harness.observe import FleetObserver
    from multiraft_tpu_torch.services.shardkv import key2shard

    root = os.path.join(SCRATCH, "placed")
    shutil.rmtree(root, ignore_errors=True)
    frec_dir = os.path.join(root, "rings")
    os.makedirs(frec_dir)
    os.environ["MRT_FLIGHTREC_DIR"] = frec_dir
    slots_env = os.environ.get("MRT_FLIGHTREC_SLOTS")
    os.environ["MRT_FLIGHTREC_SLOTS"] = str(PLACED_RING_SLOTS)
    frec = flightrec.get_recorder()
    if slots_env is None:
        os.environ.pop("MRT_FLIGHTREC_SLOTS")
    else:
        os.environ["MRT_FLIGHTREC_SLOTS"] = slots_env
    if frec.slots != PLACED_RING_SLOTS:
        raise AssertionError(f"10(a): this process's flight ring has {frec.slots} slots")
    assignment = [[p * gpp + j + 1 for j in range(gpp)] for p in range(3)]
    all_gids = [g for gl in assignment for g in gl]
    fleet = PlacedFleet(assignment, spare_slots=spare, seed=31, chaos_seed=7, shipping=True,
                        ship_sync=True, data_dir=os.path.join(root, "data"), device=device,
                        controller_kwargs=PLACE_KNOBS, map_maxraftstate=MAP_MAXRAFTSTATE)
    out = {"gids": len(all_gids), "gids_per_process": gpp, "spare_slots": spare}
    obs = writer = None
    try:
        t0 = time.perf_counter()
        fleet.start()
        out["ready_s"] = time.perf_counter() - t0
        # The harness's controller idles until the skew is measured: the
        # spread before is read by a probe that scrapes and never moves.
        fleet.controller.stop()
        tr = fleet.controller.transport
        addrs = list(tr.addrs)
        obs = FleetObserver(addrs)
        t0 = time.perf_counter()
        fleet.admin("join", all_gids, timeout=300.0)
        out["join_s"] = time.perf_counter() - t0
        shards = _rpc(fleet.node, fleet.node.client_end(*addrs[0]), "EngineShardKV.config")[1]
        kmap = _keys_by_gid(shards)
        owners = sorted(set(kmap.values()))
        _, placement0 = fleet.placement()
        hot = [g for g in owners if placement0[g] == 0][:6]
        if len(hot) < 1:
            raise AssertionError(f"10(a): no shard owner on process 0 ({owners})")
        hot_keys = [k for k, g in kmap.items() if g in hot]
        cold_keys = [k for k, g in kmap.items() if g not in hot]
        writer = _Acked(fleet)
        rounds = [0]

        def skew(n: int) -> None:  # scripts/placement_scenario.py's apply_skewed_load
            for _ in range(n):
                r = rounds[0]
                for i in range(6):  # hot_factor
                    writer.append(hot_keys[(r * 6 + i) % len(hot_keys)], f"h{r}.{i},")
                writer.append(cold_keys[r % len(cold_keys)], f"c{r},")
                rounds[0] += 1

        probe = PlacementController(tr, fleet.pmap, scrape_s=0.0, dead_s=1e9, max_moves=0,
                                    min_gain=1e9)
        for _ in range(2):
            skew(3)
            probe.scrape()
        out["spread_before"] = _proc_spread(probe.loads, placement0, range(3))
        ctl = fleet.controller = PlacementController(tr, fleet.pmap, obs=fleet.node.obs,
                                                     **PLACE_KNOBS)
        ctl.start()
        t0 = time.perf_counter()
        while ctl.moves_done < 1 and time.perf_counter() - t0 < 120:
            skew(1)
        t_moved = time.perf_counter()
        while time.perf_counter() - t_moved < 1.5:  # fresh scrape windows on the new map
            skew(1)
        _, placement1 = fleet.placement()
        out["spread_after"] = _proc_spread(dict(ctl.loads), placement1, range(3))
        history = fleet.history()
        out["rebalance_moves"] = sum(h[4] == "rebalance" for h in history)
        out["rebalance_s"] = t_moved - t0
        out["skew_appends"] = len(writer.history)
        if out["rebalance_moves"] < 1 or not out["spread_after"] < out["spread_before"]:
            raise AssertionError(f"10(a) rebalance: {out}")
        log(f"10(a): {len(all_gids)} gids on 3 processes ({gpp} each, {spare} spare slots), "
            f"ready {out['ready_s']:.2f} s, join of every gid {out['join_s']:.2f} s; skew on "
            f"{len(hot)} hot gids of process 0: spread {out['spread_before']:.1f} -> "
            f"{out['spread_after']:.1f} commits/s after {out['rebalance_moves']} rebalance "
            f"move(s) ({out['rebalance_s']:.2f} s to the first) [{card}]")

        # The nemesis: fault windows under clerk load (the skew goes on,
        # with run_clerk_load on one key of every shard), then the kill of
        # the process hosting the most groups at that moment.
        obs.snapshot_all()  # caches every process's pid and clock offset
        nem = Nemesis(addrs, kill=fleet.kill_mesh_process)
        sched = make_schedule(7, 3, duration_s=nemesis_s,
                              include=("delay", "drop", "sever", "partition"))
        stop = threading.Event()
        histories, errors = [], []
        nkeys = _key_per_shard("nl")

        def load() -> None:
            try:
                while not stop.is_set():
                    histories.extend(run_clerk_load(fleet.clerk, keys=nkeys,
                                                    n_workers=3, ops_per_worker=6,
                                                    op_timeout=600.0))
            except BaseException as e:  # re-raised below
                errors.append(e)

        def skewed() -> None:
            try:
                while not stop.is_set():
                    skew(1)
            except BaseException as e:  # re-raised below
                errors.append(e)

        threads = [threading.Thread(target=load, name="clerk-load"),
                   threading.Thread(target=skewed, name="skew-load")]
        for th in threads:
            th.start()
        prober = _Acked(fleet)
        try:
            t0 = time.perf_counter()
            nem.run(sched, verify=False)
            out["nemesis_s"] = time.perf_counter() - t0
            _, pl = fleet.placement()
            counts = {p: sum(1 for q in pl.values() if q == p) for p in range(3)}
            victim = max(range(3), key=lambda p: (counts[p], p))
            victim_pid = fleet.cluster.procs[victim].pid
            seq_kill = frec._seq
            t_kill = time.perf_counter()
            nem.run([(0.0, "kill_mesh_process", {"proc": victim}), (0.05, "heal", {})],
                    verify=False)
            # The victim's gids: those the committed map places there at
            # the kill (nothing moves off a dead process but by failover).
            _, pl = fleet.placement()
            victim_gids = sorted(g for g, q in pl.items() if q == victim)
            log(f"10(a): kill of process {victim} ({len(victim_gids)} gids) after "
                f"{out['nemesis_s']:.1f} s of nemesis [{card}]")
            t_log, t_detect = t_kill, None
            while time.perf_counter() - t_kill < 900:
                if t_detect is None and victim in ctl.dead:
                    t_detect = time.perf_counter()
                _, placement, pending, _ = fleet.pmap.query()
                left = [g for g in victim_gids if placement.get(g) in (None, victim)]
                if not pending and not left:
                    break
                if time.perf_counter() - t_log > 15:
                    t_log = time.perf_counter()
                    log(f"10(a): {len(victim_gids) - len(left)} of {len(victim_gids)} "
                        f"re-placed at {t_log - t_kill:.1f} s [{card}]")
                time.sleep(0.25)
            t_placed = time.perf_counter()
            t_detect = t_placed if t_detect is None else t_detect
            log(f"10(a): victim declared dead {t_detect - t_kill:.2f} s after the kill, every "
                f"victim gid placed in {t_placed - t_kill:.2f} s [{card}]")
            # A live process declared dead (its pings lost for dead_s) is
            # fenced by its lapsed lease before its groups move: safe, but
            # recorded.
            false_dead = sorted(p for p in ctl.dead if p != victim)
            survivors = [p for p in range(3) if p != victim and p not in false_dead]
            if any(placement[g] == victim for g in victim_gids):
                raise AssertionError(f"10(a): victim gids still on process {victim}")
            # Serving: every re-placed gid is hosted, unsealed and led on
            # its new process; each shard owner among them takes a Put/Get.
            for p in survivors:
                grp = tr.groups(p)
                led = {gid: lead >= 0 for gid, lead in zip(grp["gids"], grp["leader"])}
                moved_here = [g for g in victim_gids if placement[g] == p]
                if not all(g in grp["gids"] and led.get(g) for g in moved_here):
                    raise AssertionError(f"10(a): a re-placed gid has no leader on {p}")
                if any(grp["sealed"][grp["gids"].index(g)] for g in moved_here):
                    raise AssertionError(f"10(a): a re-placed gid is sealed on {p}")
            served = [g for g in victim_gids if g in owners]
            for g in served:
                k = next(_k(f"sv{g}-", i) for i in range(NSHARDS)
                         if shards[key2shard(_k(f"sv{g}-", i))] == g)
                prober.append(k, "post,")
                got = prober.ck.get(k, timeout=600.0)
                if got != prober.model[k]:
                    raise AssertionError(f"10(a): gid {g} serves {k} = {got!r}, "
                                         f"acknowledged {prober.model[k]!r}")
            t_served = time.perf_counter()
            log(f"10(a): {len(served)} re-placed shard owners served a Put/Get "
                f"{t_served - t_kill:.2f} s after the kill [{card}]")
            # The scenario ends here: the controller stops, so the bundle
            # holds the run up to the failover and not the moves of a
            # later rebalance.
            ctl.stop()
        finally:
            stop.set()
            for th in threads:
                th.join(timeout=600)
        if errors or any(th.is_alive() for th in threads):
            raise AssertionError(f"10(a) clerk load: {errors or 'hung'}")
        nem.verify_windows()
        n_win = len([w for w in nem.windows if w["kind"] not in ("heal",)])
        hist = writer.history + prober.history + histories
        lost = writer.lost() + prober.lost()
        prober.close()
        reader = fleet.clerk()
        try:
            vals = {k: reader.get(k, timeout=120.0) for k in nkeys}
        finally:
            reader.close()
        from multiraft_tpu_torch.porcupine.kv import OP_APPEND

        # Every batch of run_clerk_load appends the same tags: each must
        # be in its key as many times as it was acknowledged there.
        acked = {}
        for op in histories:
            if op.input.op == OP_APPEND:
                kt = (op.input.key, op.input.value)
                acked[kt] = acked.get(kt, 0) + 1
        lost += sum(vals[k].count(tag) != n for (k, tag), n in acked.items())
        out.update(
            victim=victim, victim_gids=len(victim_gids), served_owner_gids=served,
            failover_replace_s=t_served - t_kill, durable_failover_s=t_placed - t_kill,
            detect_s=t_detect - t_kill, false_dead=false_dead,
            s_per_group=(t_placed - t_detect) / max(1, len(victim_gids)),
            lost_acked_writes=lost, acked_keys=len(writer.model) + len(vals),
            nemesis_windows=n_win, windows_hit=sum(1 for w in nem.windows if w.get("hits")),
            clerk_ops=len(hist),
        )
        if lost:
            wrong = {k: dict(d, gid=kmap.get(k), victim_gid=kmap.get(k) in victim_gids)
                     for k, d in list(writer.wrong.items())[:8]}
            raise AssertionError(
                f"10(a): {lost} acknowledged writes lost; writer "
                f"{len(writer.wrong)} keys {wrong}, prober {len(prober.wrong)}, controller "
                f"{dict(fleet.node.obs.metrics.counters)}; victim gids {len(victim_gids)}")
        try:
            out["porcupine"] = _porcupine(hist, "10(a) placed fleet")
        except AssertionError:
            # Keep the failing history beside the bundle for the checker's
            # visualizer.
            with open(os.path.join(root, "history.json"), "w") as f:
                json.dump([(op.client_id, op.input.op, op.input.key, op.input.value,
                            op.call, op.output.value, op.ret) for op in hist], f)
            raise
        snaps = obs.snapshot_all()
        ship = {}
        for s in snaps.values():  # the survivors' counters
            for name in ("ship.snapshots", "ship.tail_records", "ship.bytes",
                         "ship.recoveries", "ship.rejects"):
                ship[name] = ship.get(name, 0) + (s.get("metrics") or {}).get(name, 0)
        out["ship"] = ship
        out["place_counters"] = {k: v for k, v in fleet.node.obs.metrics.counters.items()
                                 if k.startswith("place.")}
        log(f"10(a): nemesis seed 7 over {out['nemesis_s']:.1f} s, {n_win} windows "
            f"({out['windows_hit']} with hits), every window verified; kill of process "
            f"{victim} ({len(victim_gids)} gids): placed in {out['durable_failover_s']:.2f} s "
            f"({out['s_per_group'] * 1e3:.1f} ms per group after the {out['detect_s']:.2f} s "
            f"detection; live processes declared dead {false_dead}), serving in {out['failover_replace_s']:.2f} s ({len(served)} shard "
            f"owners took a Put/Get); lost acked writes {lost} of {out['acked_keys']} keys; "
            f"porcupine {json.dumps(out['porcupine'])}; ship {json.dumps(ship)}; controller "
            f"{json.dumps(out['place_counters'])} [{card}]")

        # The black box: bundle, then the doctor.
        rec = flightrec.get_recorder()
        if rec is not None:
            rec.flush()
        bdir = collect_bundle(os.path.join(root, "bundle"), observer=obs,
                              reason="phase 10(a) kill", windows=nem.windows, t0_us=nem.t0_us)
        bundle = postmortem.load_bundle(bdir)
        analysis = postmortem.analyze(bundle)
        report = postmortem.build_report(bundle, analysis)
        with open(os.path.join(bdir, "report.txt"), "w") as f:
            f.write(report)
        dead = [p for p in analysis["procs"] if p["pid"] == victim_pid]
        if not dead or dead[0]["clean_close"]:
            raise AssertionError("10(a) doctor: the killed process is not an unclean death")
        if f"{dead[0]['label']}  (pid {victim_pid})  — UNCLEAN DEATH" not in report:
            raise AssertionError("10(a) doctor: the report does not name the death")
        places = {}
        for ring in bundle["rings"]:
            for r in ring["records"]:
                if r["type"] == flightrec.PLACE and r["tag"] == "failover":
                    places[r["code"]] = r
        out["ring"] = dict(slots=frec.slots, records=frec._seq,
                           records_since_kill=frec._seq - seq_kill)
        missing = [g for g in victim_gids if g not in places]
        if missing:
            raise AssertionError(f"10(a) doctor: no PLACE failover record for {missing[:5]} "
                                 f"({len(missing)} gids); this process's ring {out['ring']}")
        kinds = sorted({a["kind"] for a in analysis["anomalies"]})
        if "placement_thrash" in kinds:
            raise AssertionError("10(a) doctor: placement thrash: " + "; ".join(
                a["detail"] for a in analysis["anomalies"] if a["kind"] == "placement_thrash")
                + f"; history {fleet.history()}")
        out["doctor"] = dict(anomalies=kinds, failover_records=len(places),
                             rings=len(bundle["rings"]))
        log(f"10(a): bundle of {len(bundle['rings'])} rings; the doctor names pid "
            f"{victim_pid} an UNCLEAN DEATH, {len(places)} PLACE failover records (one per "
            f"victim gid), anomalies {kinds}, no placement thrash; this process's ring "
            f"{out['ring']['records_since_kill']} records since the kill, "
            f"{out['ring']['records']} in all, {frec.slots} slots [{card}]")
    finally:
        if writer is not None:
            writer.close()
        if obs is not None:
            obs.close()
        fleet.shutdown()
        os.environ.pop("MRT_FLIGHTREC_DIR", None)
        rec = flightrec._proc_rec
        if rec is not None:
            rec.close()
    return out


def placed_selfheal(card: str, device: str = "cuda", gpp: int = 64) -> dict:
    """10(b): a dead leader replica healed by joint consensus under
    acknowledged writes, then again with the controller crashed
    mid-reconfig and a fresh one resuming from the replicated intent."""
    import shutil

    from multiraft_tpu_torch.distributed.placement import PlacementController
    from multiraft_tpu_torch.harness.fleet import PlacedFleet

    root = os.path.join(SCRATCH, "selfheal")
    shutil.rmtree(root, ignore_errors=True)
    assignment = [[p * gpp + j + 1 for j in range(gpp)] for p in range(3)]
    fleet = PlacedFleet(assignment, spare_slots=1, seed=29, replicas=4, voters=[0, 1, 2],
                        shipping=True, data_dir=os.path.join(root, "data"), device=device,
                        controller_kwargs=HEAL_KNOBS, map_maxraftstate=MAP_MAXRAFTSTATE)
    out = {"gids": 3 * gpp}
    writer = None
    try:
        fleet.start()
        fleet.admin("join", [g for gl in assignment for g in gl], timeout=300.0)
        tr = fleet.controller.transport
        shards = _rpc(fleet.node, fleet.node.client_end(*tr.addrs[0]), "EngineShardKV.config")[1]
        kmap = _keys_by_gid(shards)
        writer = _Acked(fleet)
        owners = sorted(set(kmap.values()))
        for i, k in enumerate(list(kmap)[:20]):
            writer.append(k, f"w{i},")
        runs = []
        for crash, gid in ((False, owners[0]), (True, owners[-1])):
            _, placement = fleet.placement()
            proc = placement[gid]
            cfg0 = None
            while cfg0 is None:
                cfg0 = tr.replica_config(proc, gid)
            victim = int(cfg0["peer"])
            keys = [k for k, g in kmap.items() if g == gid][:4]
            t_kill = time.perf_counter()
            if not fleet.kill_replica(gid, victim):
                raise AssertionError(f"10(b): kill_replica({gid}, {victim}) refused")
            crashed_at, cfg, n = None, None, 0
            while time.perf_counter() - t_kill < 240:
                writer.append(keys[n % len(keys)], f"d{gid}.{n},")  # acked-write load
                n += 1
                intents = fleet.pmap.reconfig_intents()
                if crash and crashed_at is None and gid in intents:
                    crashed_at = intents[gid][2]
                    fleet.controller.stop()  # abandoned with its in-memory ledgers
                    fleet.controller = PlacementController(tr, fleet.pmap, obs=fleet.node.obs,
                                                           **HEAL_KNOBS)
                    fleet.controller.start()
                    continue
                if gid not in intents:
                    cfg = tr.replica_config(proc, gid)
                    if cfg is not None and not cfg["joint"] and victim not in cfg["voters_old"]:
                        break
                    cfg = None
            t_healed = time.perf_counter()
            if cfg is None:
                raise AssertionError(f"10(b): gid {gid} never healed")
            entries = [h for h in fleet.history() if h[4] == "replace-replica" and h[1] == gid]
            if len(entries) != 1 or cfg["voters_old"] != sorted({0, 1, 2, 3} - {victim}):
                raise AssertionError(f"10(b): gid {gid} history {entries}, config {cfg}")
            stats = fleet.controller.replace_stats.get(gid)
            run = dict(gid=gid, killed_peer=victim, crash=crash, crashed_at=crashed_at,
                       healed_voters=cfg["voters_old"], writes_during=n,
                       kill_to_healed_s=t_healed - t_kill)
            if stats is not None:
                run.update(stats)
            elif not crash:
                raise AssertionError("10(b): no replace stats")
            if crash and crashed_at not in ("learner", "catchup", "joint"):
                raise AssertionError(f"10(b): the controller crashed at {crashed_at!r}")
            runs.append(run)
        out["runs"] = runs
        out["lost_acked_writes"] = writer.lost()
        out["acked_keys"] = len(writer.model)
        if out["lost_acked_writes"]:
            raise AssertionError(f"10(b): {out['lost_acked_writes']} acknowledged writes lost")
        out["porcupine"] = _porcupine(writer.history, "10(b) self-heal")
        for r in runs:
            log(f"10(b): gid {r['gid']} leader replica {r['killed_peer']} killed"
                + (f", controller crashed at {r['crashed_at']!r} and a fresh one resumed"
                   if r["crash"] else "")
                + f": healed voters {r['healed_voters']} in {r['kill_to_healed_s']:.2f} s"
                + (f" (replace_replica_s {r['replace_replica_s']:.2f}, degraded_quorum_window_s "
                   f"{r['degraded_quorum_window_s']:.2f})" if "replace_replica_s" in r else "")
                + f", {r['writes_during']} acked writes meanwhile [{card}]")
        log(f"10(b): {3 * gpp} gids, P=4 voters [0,1,2]; lost acked writes 0 of "
            f"{out['acked_keys']} keys; porcupine {json.dumps(out['porcupine'])} [{card}]")
    finally:
        if writer is not None:
            writer.close()
        fleet.shutdown()
    return out


def _fleet_world(fleet, store) -> dict:
    """Everything the in-process fleet holds: each live instance's state
    planes, every replica's configs, shard data and dedup tables, and
    the placement map."""
    out = {"map": store.query(), "killed": sorted(fleet.killed)}
    for p, inst in enumerate(fleet.instances):
        if p in fleet.killed:
            continue
        out.update({f"{p}.s.{k}": v for k, v in inst.driver.np_state().items()})
        out[f"{p}.gids"] = dict(inst._g2l)
        out[f"{p}.reps"] = {g: (r.cur.num, {s: (sl.state, dict(sl.data), dict(sl.latest))
                                            for s, sl in r.shards.items()})
                            for g, r in inst.reps.items()}
    return out


def _inproc_legs(device: str, gpp: int, mark) -> None:
    """The fixed migration script on an ``InProcessFleet``: a live
    migration, a replica replacement, a durable recovery from a
    standby and an empty adoption after the kill; ``mark(where,
    world)`` after every leg."""
    from multiraft_tpu_torch.distributed.placement import LocalPlacementStore, PlacementController
    from multiraft_tpu_torch.distributed.stateplane import ShipSpec
    from multiraft_tpu_torch.harness.fleet import InProcessFleet, LocalFleetTransport

    assignment = [[p * gpp + j + 1 for j in range(gpp)] for p in range(3)]
    fleet = InProcessFleet(assignment, spare_slots=gpp, seed=5, replicas=4, voters=[0, 1, 2],
                           device=device)
    for gl in assignment:
        fleet.admin("join", gl)
    fleet.settle()
    pinned = assignment[2][-1]  # ships to its own owner only: never shipped
    fleet.enable_shipping([(f"gid-{pinned}$", ShipSpec(pin=(2,)))], window_s=0.0, sync=True)
    store = LocalPlacementStore({g: p for p, gl in enumerate(assignment) for g in gl})
    clock = [0.0]
    tr = LocalFleetTransport(fleet)
    ctl = PlacementController(tr, store, dead_s=1.0, min_gain=1e9, max_moves=0,
                              clock=lambda: clock[0])
    ck = fleet.clerk()
    cfg = fleet.instances[0].query_latest()
    kmap = _keys_by_gid(cfg.shards, 60)
    for i, k in enumerate(kmap):
        ck.append(k, f"[{i}]")
    fleet.pump_all(4)
    mark("writes", _fleet_world(fleet, store))
    g = assignment[0][0]
    store.begin(g, 1, "test")
    if not ctl._execute(g, 0, 1, "test", [0, 1, 2]):
        raise AssertionError("10(c): live migration did not run")
    mark("live migration", _fleet_world(fleet, store))
    gid = cfg.shards[0]
    proc = fleet.proc_of(gid)
    victim = tr.replica_config(proc, gid)["peer"]
    fleet.kill_replica(gid, victim)
    for _ in range(120):
        clock[0] += 0.5
        ctl.step()
        fleet.pump_all(6)
        c = tr.replica_config(proc, gid)
        if not store.reconfig_intents() and c and not c["joint"] and victim not in c["voters_old"]:
            break
    else:
        raise AssertionError("10(c): the replica was not replaced")
    mark("replica replacement", _fleet_world(fleet, store))
    fleet.kill(2)
    ctl.dead.add(2)
    for leg, gids in (("durable recovery", [x for x in assignment[2] if x != pinned]),
                      ("empty adoption", [pinned])):
        for x in gids:
            dst = ctl._freshest_dst(x, [0, 1], x % 2)
            store.begin(x, dst, "failover")
            if not ctl._execute(x, None, dst, "failover", [0, 1]):
                raise AssertionError(f"10(c): {leg} of gid {x} did not run")
        mark(leg, _fleet_world(fleet, store))
    for k, v in list(kmap.items())[:12]:
        ck.put(k, f"post-{v}")
    mark("serving", _fleet_world(fleet, store))


def inproc_card_vs_cpu(card: str, sizes=((3, 2), (3, 32))) -> dict:
    """10(c): the same in-process fleet script on the card and on the
    CPU; after every leg both hold equal planes, data, dedup tables and
    placement maps."""
    out = {}
    for n, gpp in sizes:
        worlds = {}
        t0 = time.perf_counter()
        for dev in ("cuda", "cpu"):
            worlds[dev] = []
            _inproc_legs(dev, gpp, lambda where, w, dev=dev: worlds[dev].append((where, w)))
        legs = [w for w, _ in worlds["cuda"]]
        if legs != [w for w, _ in worlds["cpu"]]:
            raise AssertionError(f"10(c): legs differ {legs}")
        for (where, a), (_, b) in zip(worlds["cuda"], worlds["cpu"]):
            _same_state(a, b, f"{n}x{gpp} {where}")
        out[f"{n}x{gpp}"] = dict(legs=legs, s=time.perf_counter() - t0)
        log(f"10(c): InProcessFleet {n} x {gpp} gids: card = CPU after each of {legs} "
            f"({out[f'{n}x{gpp}']['s']:.2f} s) [{card}]")
    return out


def phase_placed(card: str, kernels, beside: Beside) -> dict:
    """Phase 10: each sub-phase with the launch counts set to 0 just
    before it and read just after.  The fleet servers are child
    processes that build their engines without the kernels, as the
    reference's do, and the in-process fleets of 10(c), run in the side
    process, are built without them too, so the counts stay 0."""
    out = {}
    for name, fn in (("10a", placed_failover), ("10b", placed_selfheal)):
        kernels.reset_launches()
        t0 = time.perf_counter()
        out[name] = fn(card)
        out[name]["phase_s"] = time.perf_counter() - t0
        out[name]["launches"] = dict(kernels.LAUNCHES)
        log(f"{name}: launches {out[name]['launches']}, {out[name]['phase_s']:.2f} s [{card}]")
        if max(kernels.LAUNCHES.values()) > 0:
            raise AssertionError(f"{name}: launches in this process {kernels.LAUNCHES}")
    out["10c"] = beside.result("10c")
    return out


# ---------------------------------------------------------------------------
# The side processes: 9(b) and 10(c) beside phase 8; phase 14 beside
# phases 11 and 12
# ---------------------------------------------------------------------------

# Sub-phases that hold the card's engine against the CPU's in this
# process, with nothing timed that PERF.md compares across runs; they run
# in a spawned process while phase 8 waits on its servers.
BESIDE = ("9b", "10c")
# Phase 14 runs mostly in three spawned processes: the open-loop ladder
# (its G=10,000 server is swamped from the first rung, and its scrapes
# wait out their timeouts: PERF.md section 6) from the start of phase 11,
# the other sub-phases on the card in two processes while phase 12 waits
# on its children.  The host-only transport echo runs last, alone: beside
# another phase it measures that phase's load and slows it.
BESIDE_MESH = ("14b",)
BESIDE_TOUR = (("14a", "14c"), ("14d", "14f"))


def _beside_main(conn, card: str, names, where: str) -> None:
    """A side process: each sub-phase of ``names`` in turn, with the
    launch counts set to 0 just before it and read just after; sends
    ``(name, error or None, result, log lines)`` after each."""
    global _LOG_BUFFER
    import functools
    import signal
    import traceback

    import torch

    # A stop from the main process (``Beside.close``) unwinds the running
    # sub-phase, so each rig's ``finally`` shuts down its server children.
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(1))

    torch.set_num_threads(2)  # the servers of the phase beside keep the other cores
    from multiraft_tpu_torch.engine import kernels

    # Phase 8 reads the card memory its servers add: this process's
    # context is made before that reading starts.
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    conn.send(("ready", None, None, []))

    note = f", in the side process beside {where}"
    fns = {"9b": lambda: conformance_on_card(card, kernels),
           "10c": lambda: inproc_card_vs_cpu(card),
           **{n: functools.partial(RIGS_PHASES[n], card) for n in RIGS_PHASES}}
    for name in names:
        _LOG_BUFFER = []
        kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            res = fns[name]()
            res["phase_s"] = time.perf_counter() - t0
            res["launches"] = dict(kernels.LAUNCHES)
            log(f"{name}: launches {res['launches']}, {res['phase_s']:.2f} s{note} [{card}]")
            if max(kernels.LAUNCHES.values()) > 0:
                raise AssertionError(f"{name}: launches {kernels.LAUNCHES}")
        except BaseException:
            conn.send((name, traceback.format_exc(), None, _LOG_BUFFER))
            conn.close()
            return
        conn.send((name, None, res, _LOG_BUFFER))
    conn.close()


class Beside:
    """A side process (spawned, so it makes its own CUDA context) that
    runs the sub-phases ``names`` beside the phase ``where``: the
    constructor returns once the process holds its context, the main
    process reads each result, and :meth:`close` stops it in every case."""

    def __init__(self, card: str, names=BESIDE, where: str = "phase 8") -> None:
        import multiprocessing

        self.names = tuple(names)
        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe(duplex=False)
        self._proc = ctx.Process(target=_beside_main, args=(child, card, self.names, where),
                                 name="smoke-beside")
        self._proc.start()
        child.close()
        self._got: dict = {}
        try:
            while not self._conn.poll(1.0):
                if not self._proc.is_alive():
                    raise AssertionError(f"the side process died at start "
                                         f"(exit {self._proc.exitcode})")
            if self._recv()[0] != "ready":
                raise AssertionError("the side process did not start")
        except BaseException:
            self.close()
            raise

    def _recv(self) -> tuple:
        try:
            return self._conn.recv()
        except EOFError:  # the process closed its end without sending
            self._proc.join(timeout=30)
            raise AssertionError(f"the side process died (exit {self._proc.exitcode}) "
                                 f"after {sorted(self._got)}") from None

    def wait(self) -> float:
        """Wait until every sub-phase has sent its result (or one has
        failed); the seconds waited."""
        t0 = time.perf_counter()
        while len(self._got) < len(self.names) and not any(
                e for e, _, _ in self._got.values()):
            if self._conn.poll(1.0):
                got, err, res, lines = self._recv()
                self._got[got] = (err, res, lines)
            elif not self._proc.is_alive() and not self._conn.poll(0):
                raise AssertionError(f"the side process died (exit {self._proc.exitcode}) "
                                     f"after {sorted(self._got)}")
        return time.perf_counter() - t0

    def result(self, name: str) -> dict:
        """``name``'s result: its log lines printed, what it raised
        raised."""
        self.wait()
        if name not in self._got:
            raise AssertionError(f"{name}: not run, an earlier side sub-phase failed")
        err, res, lines = self._got[name]
        for line in lines:
            log(line)
        if err is not None:
            raise AssertionError(f"{name} in the side process:\n{err}")
        return res

    def close(self) -> None:
        sent = len(self._got) == len(self.names) or any(e for e, _, _ in self._got.values())
        self._proc.join(timeout=30 if sent else 0)
        if self._proc.is_alive():
            self._proc.terminate()  # unwinds the sub-phase: its servers stop
            self._proc.join(timeout=60)
        if self._proc.is_alive():
            self._proc.kill()
            self._proc.join()
        self._conn.close()


def placed_alone(card: str, names) -> dict:
    """``--only 10a 10b 10c``: the named sub-phases of phase 10 alone, with
    the time the controller spends in each transport and map verb (a
    development run; it prints no contract lines)."""
    import collections

    from multiraft_tpu_torch.distributed.placement import PlacementController, TcpFleetTransport
    from multiraft_tpu_torch.harness.fleet import PlacementMap

    spent, calls = collections.defaultdict(float), collections.Counter()

    def timed(cls, name):
        fn = getattr(cls, name)

        def wrapper(self, *a, **k):
            t0 = time.perf_counter()
            try:
                return fn(self, *a, **k)
            finally:
                spent[name] += time.perf_counter() - t0
                calls[name] += 1
        setattr(cls, name, wrapper)

    for name in ("recover_group", "standby_state", "adopt_group", "pull_group", "drop_group",
                 "push_placement", "lease", "groups"):
        timed(TcpFleetTransport, name)
    for name in ("begin", "dispatch", "commit", "query"):
        timed(PlacementMap, name)
    timed(PlacementController, "step")
    fns = {"10a": placed_failover, "10b": placed_selfheal, "10c": inproc_card_vs_cpu}
    out = {}
    for name in names:
        spent.clear()
        calls.clear()
        t0 = time.perf_counter()
        out[name] = fns[name](card)
        out[name]["phase_s"] = time.perf_counter() - t0
        out[name]["verb_s"] = {k: [spent[k], calls[k]] for k in spent}
        log(f"{name}: {json.dumps(out[name], default=str)} [{card}]")
    return out


# ---------------------------------------------------------------------------
# Phase 11: the groups-sharded engine (engine/mesh.py)
# ---------------------------------------------------------------------------


def _mesh_world(d) -> tuple:
    """A driver's planes, mailbox, commit total, delay queue and last
    metrics, on the host."""
    return (d.np_state(), d.np_inbox(), d.commits_total, d._delayed,
            dict(d.last_metrics))


def _assert_same_mesh(a, b, what: str) -> None:
    import numpy as np

    _assert_same(a[:3], b[:3], what)
    if not _same_delayed(a[3], b[3]):
        raise AssertionError(f"{what}: delay queues differ")
    for k in a[4]:
        if not np.array_equal(np.asarray(a[4][k]), np.asarray(b[4][k])):
            raise AssertionError(f"{what}: metric {k} differs")


def mesh_driver(card: str) -> dict:
    """11(a): ``EngineDriver(mesh=make_mesh(1))`` at the headline widths
    (kernels off: the mesh runs the plain tick): elections, a
    ``BatchedKV`` against a dict model, 5(a)'s fault script under an
    invariant monitor, a checkpoint restored onto a 1-card mesh and onto
    a 1-shard CPU mesh (30 more faulted ticks, equal on every plane),
    and a restore without a mesh refused."""
    import numpy as np

    from multiraft_tpu_torch.bench import full_ring_stalls
    from multiraft_tpu_torch.distributed.engine_wire import make_mesh
    from multiraft_tpu_torch.engine.core import LEADER, EngineConfig
    from multiraft_tpu_torch.engine.host import EngineDriver
    from multiraft_tpu_torch.engine.invariants import InvariantMonitor
    from multiraft_tpu_torch.engine.kv import BatchedKV
    from multiraft_tpu_torch.engine.mesh import Mesh

    G, P, block, n_faults = HEADLINE["G"], HEADLINE["P"], 50, 100
    cfg = EngineConfig(use_kernels=False, **HEADLINE)
    out = {}
    t0 = time.perf_counter()
    d = EngineDriver(cfg, seed=11, mesh=make_mesh(1))  # + the zero-collective check
    out["build_s"] = time.perf_counter() - t0
    if not d.run_until_quiet_leaders(500):
        raise AssertionError("11(a): not every group elected a leader")
    out["elected_at_tick"] = d.tick
    kv = BatchedKV(d, record_groups=[0, 1])
    n, groups, pumps, wall, reads = _kv_against_model(kv, G, seed=19)
    log(f"mesh 11(a): mesh of {make_mesh(1).devices} built in {out['build_s']:.2f} s; "
        f"leaders everywhere at tick {d.tick}; {n} logged requests over "
        f"{len(groups)} groups answered in {pumps} pumps ({wall:.2f} s), "
        f"{reads} reads match the dict model [{card}]")
    out["kv"] = dict(requests=n, pumps=pumps, s=wall, reads=reads)

    mon = InvariantMonitor(d)
    mon.observe()
    d.start_bulk(np.full(G, HEADLINE["INGEST"] * 300, np.int64))
    d.drop_prob = 0.01
    crashed, cut = _pick_replicas(np.random.default_rng(5), G, P, n_faults)
    ms_per_tick = []
    for b in range(4):  # ticks 0-50-100-150-200 of the run
        if b == 1:
            for g, p in crashed:
                d.set_alive(g, p, False)
            for g, p in cut:
                d.partition_replica(g, p, False)
        if b == 2:
            for g, p in crashed:
                d.restart_replica(g, p)
                mon.note_restart(g, p)
            for g, p in cut:
                d.partition_replica(g, p, True)
            at_heal = d.np_state()["commit"].max(axis=1)
        t0 = time.perf_counter()
        d.step(block)
        ms_per_tick.append((time.perf_counter() - t0) / block * 1e3)
        mon.observe()
        mon.prune_below_snapshot_floor()
    st = d.np_state()
    advanced = st["commit"].max(axis=1) > at_heal
    stalled = full_ring_stalls(st, cfg) & ~advanced
    if not (advanced | stalled).all():
        raise AssertionError(
            f"11(a): groups {np.nonzero(~(advanced | stalled))[0].tolist()[:10]} "
            f"committed nothing after the heal")
    out.update(ms_per_tick=ms_per_tick, stalled=int(stalled.sum()))
    log(f"mesh 11(a): 5(a)'s fault script on the 1-card mesh, ms/tick per 50-tick "
        f"block {[round(x, 3) for x in ms_per_tick]}; commits advanced after the "
        f"heal in {int(advanced.sum())} of {G} groups, {int(stalled.sum())} stalled "
        f"with a full ring of older-term entries [{card}]")

    os.makedirs(SCRATCH, exist_ok=True)
    path = os.path.join(SCRATCH, "mesh.ckpt")
    d.save(path)
    try:
        EngineDriver.restore(path, device="cuda")
        raise AssertionError("11(a): a mesh checkpoint restored without a mesh")
    except ValueError as e:
        if "1-device mesh" not in str(e):
            raise
    t0 = time.perf_counter()
    on_card = EngineDriver.restore(path, mesh=make_mesh(1))
    out["restore_card_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = EngineDriver.restore(path, mesh=Mesh(["cpu"]))
    out["restore_cpu_s"] = time.perf_counter() - t0
    os.remove(path)
    st = d.np_state()
    followers = [(g, int(np.nonzero(st["role"][g] != LEADER)[0][0]))
                 for g in range(0, G, max(1, G // 5))][:5]
    drivers = (d, on_card, on_cpu)
    for b in range(3):  # 30 more ticks, the same faults on all three
        for x in drivers:
            if b == 1:
                for g, p in followers:
                    x.set_alive(g, p, False)
            if b == 2:
                for g, p in followers:
                    x.restart_replica(g, p)
            x.step(10)
    ref = _mesh_world(d)
    for name, x in (("card", on_card), ("cpu", on_cpu)):
        _assert_same_mesh(ref, _mesh_world(x), f"11(a) restored on the {name} mesh")
    if not d.run_until_quiet_leaders(300):
        raise AssertionError("11(a): not every group has one leader at the end")
    log(f"mesh 11(a): checkpoint refused without a mesh; restored onto a 1-card "
        f"mesh in {out['restore_card_s']:.3f} s and a 1-shard CPU mesh in "
        f"{out['restore_cpu_s']:.3f} s, all three equal on every plane, mailbox "
        f"plane, delay queue and metric after 30 more faulted ticks "
        f"({ref[2]} commits); one leader in every group at tick {d.tick} [{card}]")
    return out


def mesh_shards(card: str) -> dict:
    """11(b): a 4-shard mesh on the one card equals the same mesh on the
    CPU over 300 ticks of drops, crashes, partitions and reorder; then
    the 4-shard mesh at the headline widths: 100 firehose ticks under
    ``assert_zero_collectives``, and the firehose ms per tick of the
    4-shard and the 1-shard mesh."""
    import numpy as np

    from multiraft_tpu_torch.engine.core import EngineConfig
    from multiraft_tpu_torch.engine.host import EngineDriver
    from multiraft_tpu_torch.engine.mesh import (
        Mesh, assert_zero_collectives, make_sharded_run_ticks,
    )

    out = {}
    cfg = EngineConfig(G=64, P=3, L=64, E=8, INGEST=8)
    pair = [EngineDriver(cfg, seed=23, mesh=Mesh([dev] * 4)) for dev in ("cuda:0", "cpu")]
    rng = np.random.default_rng(23)
    t0 = time.perf_counter()
    for t in range(300):
        acts = []
        if t % 20 == 0:
            acts.append(("start_bulk", np.full(64, 30, np.int64)))
        if t == 40:
            acts += [("drop", 0.1), ("reorder", 2 / 3)]
        if t % 30 == 15:
            g, p = int(rng.integers(64)), int(rng.integers(3))
            acts.append(("crash", (g, p)))
        if t % 30 == 25:
            acts.append(("restart_all", None))
        if t % 50 == 10:
            g, p = int(rng.integers(64)), int(rng.integers(3))
            acts.append(("cut", (g, p)))
        if t % 50 == 35:
            acts.append(("heal_all", None))
        if t == 240:
            acts += [("drop", 0.0), ("reorder", 0.0)]
        for x in pair:
            for kind, arg in acts:
                if kind == "start_bulk":
                    x.start_bulk(arg)
                elif kind == "drop":
                    x.drop_prob = arg
                elif kind == "reorder":
                    x.set_reorder(arg, 2, 8)
                elif kind == "crash":
                    x.set_alive(*arg, False)
                elif kind == "restart_all":
                    for g, p in zip(*np.nonzero(~x.np_state(["alive"])["alive"])):
                        x.restart_replica(int(g), int(p))
                elif kind == "cut":
                    x.partition_replica(*arg, False)
                elif kind == "heal_all":
                    for g, p in zip(*np.nonzero(~x.replica_conn)):
                        x.partition_replica(int(g), int(p), True)
            x.step()
        _assert_same_mesh(_mesh_world(pair[0]), _mesh_world(pair[1]), f"11(b) tick {t}")
        if pair[0]._np_rng.bit_generator.state != pair[1]._np_rng.bit_generator.state:
            raise AssertionError(f"11(b) tick {t}: reorder RNGs differ")
    out["card_vs_cpu"] = dict(ticks=300, s=time.perf_counter() - t0,
                              commits=pair[0].commits_total)
    log(f"mesh 11(b): 4 shards on {card.split(',')[0]} equal 4 CPU shards on every "
        f"plane, mailbox plane, delay queue and metric after each of 300 ticks of "
        f"drops, crashes, partitions and 2/3 reorder ({pair[0].commits_total} "
        f"commits, {out['card_vs_cpu']['s']:.2f} s) [{card}]")

    big = EngineConfig(use_kernels=False, **HEADLINE)
    four = Mesh(["cuda:0"] * 4)
    t0 = time.perf_counter()
    d4 = EngineDriver(big, seed=3, mesh=four)
    out["build4_s"] = time.perf_counter() - t0
    run = make_sharded_run_ticks(big, four, 100, HEADLINE["INGEST"])
    t0 = time.perf_counter()
    ops = assert_zero_collectives(run, d4._state_shards, d4._inbox_shards, d4.key)
    out["audited"] = dict(ticks=100, shard_ops=ops, s=time.perf_counter() - t0)
    for name, mesh in (("4 shards", four), ("1 shard", Mesh(["cuda:0"]))):
        d = d4 if mesh is four else EngineDriver(big, seed=3, mesh=mesh)
        d.step(20)
        d.start_bulk(np.full(big.G, HEADLINE["INGEST"] * 100, np.int64))
        c0 = d.commits_total
        t0 = time.perf_counter()
        d.step(100)
        c1 = d.commits_total
        wall = time.perf_counter() - t0
        out[f"firehose {name}"] = dict(ms_per_tick=wall / 100 * 1e3,
                                       commits=c1 - c0)
    log(f"mesh 11(b): headline widths on 4 shards of one card: built in "
        f"{out['build4_s']:.2f} s; 100 firehose ticks audited by "
        f"assert_zero_collectives ({ops} shard ops, none outside its shard, "
        f"{out['audited']['s']:.2f} s); firehose ms/tick 4 shards "
        f"{out['firehose 4 shards']['ms_per_tick']:.3f}, 1 shard "
        f"{out['firehose 1 shard']['ms_per_tick']:.3f} [{card}]")
    return out


def mesh_fleet(card: str) -> dict:
    """11(c), second half: the reference's fleet-of-meshes case
    (``tests/test_distributed.py:1078``) as two durable ``serve-shardkv
    --mesh-devices 1`` processes on the one card, gids [1] and [2]:
    join 1, six Puts, join 2 (shards migrate across the processes),
    every value read back, an Append, SIGTERM exit 0 for both."""
    import shutil

    from multiraft_tpu_torch.distributed.engine_clerks import EngineFleetClerk
    from multiraft_tpu_torch.distributed.launch import reserve_ports
    from multiraft_tpu_torch.distributed.tcp import RpcNode

    ports = reserve_ports(2, "127.0.0.1")
    addr = {1: ("127.0.0.1", ports[0]), 2: ("127.0.0.1", ports[1])}
    srvs = []
    for i in range(2):
        data = os.path.join(SCRATCH, f"meshfleet{i}")
        shutil.rmtree(data, ignore_errors=True)
        extra = ["--port", str(ports[i]), "--gids", str(i + 1),
                 "--peer", f"{2 - i}=127.0.0.1:{ports[1 - i]}", "--mesh-devices", "1"]
        srvs.append(_Server(data, 2, cmd="serve-shardkv", env={},
                            log=f"meshfleet{i}.log", extra=extra))
    node = RpcNode()
    out = {}
    try:
        for s in srvs:
            s.launch()
        out["ready_s"] = [s.wait_ready() for s in srvs]
        pends = [node.client_end(*addr[g]) for g in (1, 2)]
        _admin(node, pends, "join", [1], 1)
        ck = _Blocking(lambda n: EngineFleetClerk(
            n.sched, {g: n.client_end(*a) for g, a in addr.items()},
            make_end=n.client_end))
        try:
            kv = {chr(110 + i): f"v{i}" for i in range(6)}
            for k, v in kv.items():
                ck.run(ck.ck.put(k, v))
            out["join_s"] = _admin(node, pends, "join", [2], 2)
            got = {k: ck.run(ck.ck.get(k)) for k in kv}
            if got != kv:
                raise AssertionError(f"11(c) fleet: read back {got} != {kv}")
            ck.run(ck.ck.append("n", "+mesh"))
            if ck.run(ck.ck.get("n")) != kv["n"] + "+mesh":
                raise AssertionError("11(c) fleet: append lost")
        finally:
            ck.close()
        cfg = _rpc(node, pends[0], "EngineShardKV.config")
        out["shards_on_2"] = sum(1 for g in cfg[1] if g == 2)
        if not 0 < out["shards_on_2"] < NSHARDS:
            raise AssertionError(f"11(c) fleet: shards {cfg[1]}")
        for s in srvs:
            s.sigterm()
    finally:
        for s in srvs:
            s.stop()
        node.close()
    log(f"mesh 11(c): two serve-shardkv --mesh-devices 1 fleet processes ready in "
        f"{out['ready_s']} s; join 2 moved {out['shards_on_2']} shards across in "
        f"{out['join_s']:.2f} s, every value read back, SIGTERM exit 0 [{card}]")
    return out


def mesh_served(card: str) -> dict:
    """11(c): ``serve-kv --groups 10000 --mesh-devices 1``, durable, as a
    child process at the headline serve widths: s to ``ready`` and card
    memory; 8 clerks against a dict model; ``kill -9`` in a firehose and
    a restart on the same directory, restoring onto the mesh, every
    acknowledged write read back; SIGTERM exit 0; then the fleet of
    meshes (:func:`mesh_fleet`)."""
    import shutil

    G = HEADLINE["G"]
    data = os.path.join(SCRATCH, "mesh_serve")
    shutil.rmtree(data, ignore_errors=True)
    os.makedirs(SCRATCH, exist_ok=True)
    out, model = {}, {}
    srv = _Server(data, G, extra=["--mesh-devices", "1"], log="mesh_serve.log")
    try:
        _, used0 = _gpu_mib(-1)
        out["ready_s"] = srv.start()
        out["card_mib"], how = _card_memory(srv, used0)
        log(f"mesh 11(c): serve-kv --mesh-devices 1 ready in {out['ready_s']:.2f} s "
            f"at G={G}; {how} [{card}]")
        out.update(serve_traffic(srv.port, card, model, full=False, tag="mesh 11(c)"))
        out.update(_kill9_in_firehose(srv, model, card, "mesh 11(c)", frames=8))
        if out["restores"] != 1:
            raise AssertionError(f"11(c): restores {out['restores']} after the kill")
        srv.sigterm()
    finally:
        srv.stop()
    out["fleet"] = mesh_fleet(card)
    return out


MESH_PHASES = {"11a": mesh_driver, "11b": mesh_shards, "11c": mesh_served}


def phase_mesh(card: str, kernels, names=tuple(MESH_PHASES)) -> dict:
    """Phase 11: each sub-phase with the launch counts set to 0 just
    before it and read just after.  The mesh refuses the kernels (the
    reference's mesh runs without its Pallas kernels), so each count
    must stay 0."""
    out = {}
    for name in names:
        kernels.reset_launches()
        t0 = time.perf_counter()
        out[name] = MESH_PHASES[name](card)
        out[name]["phase_s"] = time.perf_counter() - t0
        out[name]["launches"] = dict(kernels.LAUNCHES)
        log(f"{name}: launches {out[name]['launches']}, {out[name]['phase_s']:.2f} s [{card}]")
        if max(kernels.LAUNCHES.values()) > 0:
            raise AssertionError(f"{name}: launches on the mesh {kernels.LAUNCHES}")
    return out


# ---------------------------------------------------------------------------
# Phase 12: the guided tour and the soak on the card
# ---------------------------------------------------------------------------

EXAMPLES = os.path.join(ROOT, "multiraft_tpu_torch", "examples")
SOAK_MINUTES = 2  # six regimes of 20 s, one each
SOAK_REGIMES = ("calm", "lossy", "reordering", "churn", "partitions", "cocktail")
TOUR_TIMEOUT_S = 300.0
SOAK_TIMEOUT_S = SOAK_MINUTES * 60 + 150.0


class _CardMemory:
    """The card's used memory (``nvidia-smi``), sampled every half second
    in a thread until :meth:`stop`; ``peak`` is the largest sample."""

    def __init__(self) -> None:
        import threading

        self.peak = self.first = _gpu_mib(-1)[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(0.5):
            self.peak = max(self.peak, _gpu_mib(-1)[1])

    def stop(self) -> float:
        self._stop.set()
        self._thread.join()
        return self.peak


class _Lines:
    """A child's stdout read line by line in a thread, each line stamped
    with ``time.perf_counter()`` as it arrives."""

    def __init__(self, proc) -> None:
        import threading

        self.proc = proc
        self.lines: list = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        for line in self.proc.stdout:
            self.lines.append((time.perf_counter(), line.rstrip("\n")))

    def join(self) -> None:
        self._thread.join()


def _start_tour(workdir: str) -> dict:
    """12(a): every port example as its own process with the default
    device (the card), all at once, each in its own directory with its
    own ``TMPDIR`` and its output in files."""
    runs = {}
    for script in sorted(f for f in os.listdir(EXAMPLES) if f.endswith(".py")):
        d = os.path.join(workdir, script[:-3])
        os.makedirs(os.path.join(d, "tmp"), exist_ok=True)
        out = open(os.path.join(d, "stdout"), "w")
        err = open(os.path.join(d, "stderr"), "w")
        runs[script] = dict(
            t0=time.perf_counter(), out=out, err=err, dir=d,
            proc=subprocess.Popen([sys.executable, os.path.join(EXAMPLES, script)],
                                  stdout=out, stderr=err, cwd=d,
                                  env=dict(os.environ, TMPDIR=os.path.join(d, "tmp"))),
        )
    return runs


def _finish_tour(runs: dict, card: str) -> dict:
    """Wait for every example; each one's exit code, wall seconds and
    last line, and 04's rate and leader tick.  Any example that fails,
    or outlives ``TOUR_TIMEOUT_S``, fails the phase."""
    import re

    out, failed = {}, []
    pending = dict(runs)
    while pending:
        for script, r in list(pending.items()):
            if r["proc"].poll() is not None:
                r["wall"] = time.perf_counter() - r["t0"]
                del pending[script]
            elif time.perf_counter() - r["t0"] > TOUR_TIMEOUT_S:
                r["proc"].kill()
                r["proc"].wait()
                r["wall"] = time.perf_counter() - r["t0"]
                failed.append(f"{script} timed out")
                del pending[script]
        time.sleep(0.05)
    for script, r in runs.items():
        rc, wall = r["proc"].returncode, r["wall"]
        with open(os.path.join(r["dir"], "stdout")) as f:
            lines = f.read().splitlines()
        last = lines[-1] if lines else ""
        out[script] = {"rc": rc, "s": round(wall, 2), "last": last}
        log(f"12a: {script}: exit {rc} in {wall:.2f} s: {last!r} [{card}]")
        if rc != 0:
            with open(os.path.join(r["dir"], "stderr")) as f:
                err = f.read()
            log(f"12a: {script} stdout:\n" + "\n".join(lines[-20:]))
            log(f"12a: {script} stderr:\n{err[-3000:]}")
            failed.append(f"{script} exit {rc}")
        if script == "04_engine_firehose.py" and rc == 0:
            text = "\n".join(lines)
            tick = int(re.search(r"elected a leader by tick (\d+)", text).group(1))
            m = re.search(r"^([\d,]+) commits in 60 ticks \(([\d,]+) commits/sec on (\S+)\)",
                          text, re.M)
            out[script].update(leader_tick=tick, commits=int(m.group(1).replace(",", "")),
                               commits_per_s=int(m.group(2).replace(",", "")), on=m.group(3))
            log(f"12a: 04: every group led by tick {tick}; {m.group(1)} commits in 60 "
                f"ticks, {m.group(2)} commits/s on {m.group(3)} [{card}]")
            if not m.group(3).startswith("cuda"):
                raise AssertionError(f"12a: 04 ran on {m.group(3)}, not the card")
    if failed:
        raise AssertionError(f"12a: {failed}")
    return out


def _finish_soak(proc, lines: _Lines, err_file, t0: float, tour_end: float,
                 card: str) -> dict:
    """12(b): wait for the soak; each regime's ticks, commits, dead and
    cut counts, and ms per tick from the stamps of its line and the line
    before (the monitor observes every tick); whether 12(a) was still
    running in it.  Fails unless it exits 0 with ``soak OK`` after the
    six regimes in order."""
    import re

    try:
        rc = proc.wait(timeout=max(1.0, SOAK_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    lines.join()
    err_file.seek(0)
    err = err_file.read()
    wall = time.perf_counter() - t0
    text = [ln for _, ln in lines.lines]
    if rc != 0 or not text or not text[-1].startswith("soak OK"):
        log("12b: soak output:\n" + "\n".join(text[-20:]) + f"\n{err[-3000:]}")
        raise AssertionError(f"12b: soak exit {rc}")
    regimes = []
    prev = lines.lines[0][0]
    for stamp, ln in lines.lines[1:]:
        m = re.match(r"soak\[\s*(\w+)\]: (\d+) ticks, \+(\d+) commits, dead=(\d+) cut=(\d+)$", ln)
        if not m:
            continue
        ticks = int(m.group(2))
        row = dict(regime=m.group(1), ticks=ticks, commits=int(m.group(3)),
                   dead=int(m.group(4)), cut=int(m.group(5)), s=round(stamp - prev, 3),
                   ms_per_tick=round(1e3 * (stamp - prev) / max(ticks, 1), 3),
                   beside_12a=prev < tour_end)
        regimes.append(row)
        log(f"12b: {row['regime']:>10}: {ticks} ticks, +{row['commits']} commits, "
            f"dead={row['dead']} cut={row['cut']}, {row['ms_per_tick']:.3f} ms a tick "
            f"(monitor every tick){', beside 12(a)' if row['beside_12a'] else ''} [{card}]")
        prev = stamp
    if tuple(r["regime"] for r in regimes) != SOAK_REGIMES:
        raise AssertionError(f"12b: regimes {[r['regime'] for r in regimes]}")
    log(f"12b: {text[-1]} ({wall:.2f} s) [{card}]")
    return {"regimes": regimes, "last": text[-1], "s": round(wall, 2)}


def phase_tour(card: str, kernels, names=("12a", "12b")) -> dict:
    """Phase 12: 12(a) the 13 port examples and 12(b) ``python -m
    multiraft_tpu_torch.soak 2``, each a child process with the default
    device, side by side, with the card's memory sampled throughout.
    The launch counts are set to 0 just before and read just after: the
    children build their engines without the kernels, as the reference's
    examples and soak build theirs without ``use_pallas``, and this
    process launches nothing."""
    import shutil

    workdir = os.path.join(SCRATCH, "tour")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    kernels.reset_launches()
    mem = _CardMemory()
    t0 = time.perf_counter()
    soak = lines = None
    runs = {}
    out = {}
    try:
        if "12b" in names:
            soak_err = open(os.path.join(workdir, "soak.stderr"), "w+")
            soak = subprocess.Popen(
                [sys.executable, "-u", "-m", "multiraft_tpu_torch.soak", str(SOAK_MINUTES)],
                stdout=subprocess.PIPE, stderr=soak_err, text=True, cwd=ROOT)
            lines = _Lines(soak)
        if "12a" in names:
            runs = _start_tour(workdir)
            out["12a"] = _finish_tour(runs, card)
            out["12a_s"] = round(time.perf_counter() - t0, 2)
            log(f"12a: 13 examples in {out['12a_s']:.2f} s [{card}]")
        tour_end = time.perf_counter()
        if soak is not None:
            out["12b"] = _finish_soak(soak, lines, soak_err, t0, tour_end, card)
    finally:
        for r in runs.values():
            if r["proc"].poll() is None:
                r["proc"].kill()
                r["proc"].wait()
            r["out"].close()
            r["err"].close()
        if soak is not None:
            if soak.poll() is None:
                soak.kill()
                soak.wait()
            soak_err.close()
        peak = mem.stop()
    out["card_mib"] = {"before": mem.first, "peak": peak}
    out["phase_s"] = round(time.perf_counter() - t0, 2)
    out["launches"] = dict(kernels.LAUNCHES)
    log(f"tour: card memory {mem.first:.0f} MiB before, {peak:.0f} MiB at the peak; "
        f"launches {out['launches']}; {out['phase_s']:.2f} s [{card}]")
    if max(kernels.LAUNCHES.values()) > 0:
        raise AssertionError(f"tour: launches in this process {kernels.LAUNCHES}")
    return out


# ---------------------------------------------------------------------------
# Phase 13: BASELINE config #5 end to end (the bench's run_config5)
# ---------------------------------------------------------------------------

# run_config5's shape and schedule, the bench's defaults: G=100,000 x P=5,
# L=112, E=INGEST=28; 200 boot ticks, a 100-tick warm chunk, 3 rounds of
# 100 traced ticks.
CONFIG5_RUN = dict(G=100_000, P=5, chunk=100, rounds=3)


def tick_kernel_inputs(cfg, st):
    """The two kernels' arguments as the tick builds them from state
    ``st``: ``(commit args, tally args)``."""
    import torch

    pi = torch.arange(cfg.P, device=st.term.device)
    own = pi[None] == pi[:, None]
    eff_match = torch.where(own, (st.base + st.log_len)[..., None], st.match_idx)
    c_args = (eff_match.contiguous(), st.term.contiguous(), st.commit.contiguous(),
              st.base.contiguous(), st.base_term.contiguous(),
              st.log_term.contiguous(), ((st.role == 2) & st.alive).contiguous())
    t_args = (st.votes.contiguous(), st.role.contiguous(), st.alive.contiguous())
    return c_args, t_args


def config5_on_card(card: str, kernels, headline_tick_ms=None) -> dict:
    """Phase 13: ``bench.run_config5`` on the card with both kernels, the
    launch counts set to 0 just before and read just after; then each
    kernel against its plain version on the run's final state, the
    jitter draw at 100,000 x 5 against the CPU's, and the tick's roofline
    bound beside the measured tick (and beside 9(a)'s headline tick)."""
    import numpy as np
    import torch

    from multiraft_tpu_torch.bench import run_config5
    from multiraft_tpu_torch.benchmarks.roofline import bytes_per_tick, tick_bound_ms
    from multiraft_tpu_torch.utils import prng

    used0 = _gpu_mib(-1)[1]
    detail = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = run_config5(True, "cuda", detail=detail, **CONFIG5_RUN)
    run_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    draw_launches = prng.KERNEL_LAUNCHES
    used1 = _gpu_mib(-1)[1]
    cfg, st = detail["cfg"], detail["state"]
    G, P = cfg.G, cfg.P
    tick_s = detail["tick_s"]
    mean_ms = float(np.mean(tick_s)) * 1e3
    revived = detail["revived_hot"]
    rebased = sum(base > was for _, _, was, base in revived)
    out = dict(result=res, run_s=run_s, boot_s=detail["boot_s"], ticks=detail["ticks"],
               timed_ticks=detail["timed_ticks"], tick_ms=[t * 1e3 for t in tick_s],
               ticks_per_s=1e3 / mean_ms, commits=detail["commits"],
               hot_commits=detail["hot_commits"], p50_ticks=detail["lat"]["p50_ticks"],
               p99_ticks=detail["lat"]["p99_ticks"], revived_hot=len(revived),
               revived_hot_rebased=rebased, launches=launches, draw_launches=draw_launches,
               peak_allocated_mib=detail["peak_bytes"] / 2**20,
               card_used_mib={"before": used0, "after": used1})
    log(f"13: config #5 G={G} P={P} L={cfg.L} E={cfg.E} INGEST={cfg.INGEST}, kernels "
        f"on: boot {detail['boot_s']:.2f} s (200 ticks), {detail['timed_ticks']} timed "
        f"ticks at {mean_ms:.3f} ms a tick ({out['ticks_per_s']:.2f} ticks/s; rounds "
        f"{', '.join(f'{t * 1e3:.3f}' for t in tick_s)} ms), {run_s:.2f} s in all [{card}]")
    log(f"13: {res['commits_per_sec']:.1f} commits/s (hot {res['hot_commits_per_sec']:.1f}, "
        f"cold {res['cold_commits_per_sec']:.1f}); commit latency p50/p99 "
        f"{out['p50_ticks']}/{out['p99_ticks']} ticks = {res['p50_latency_ms']:.3f}/"
        f"{res['p99_latency_ms']:.3f} ms; failover p99 {res['failover_p99_ms']:.3f} ms over "
        f"{res['failover_entries']} entries; {res['latency_entries_measured']} entries "
        f"measured, {res['latency_unaccounted']} unaccounted [{card}]")
    log(f"13: {res['leader_kills']} leaders killed, {res['churned_groups']} churned "
        f"groups; snapshot fast-forward: {res['snapshot_fastforward_replicas']} killed "
        f"replicas rebased, {rebased} of {len(revived)} revived hot ex-leaders rebased "
        f"past the last index they held when they died [{card}]")
    log(f"13: card memory: {out['peak_allocated_mib']:.0f} MiB allocated at the peak by "
        f"torch; the card's used memory {used0:.0f} MiB before, {used1:.0f} MiB after "
        f"[{card}]")
    if res["latency_unaccounted"] or res["latency_entries_measured"] <= 0:
        raise AssertionError(f"13: latency {res}")
    if res["leader_kills"] <= 0 or res["churned_groups"] <= 0:
        raise AssertionError(f"13: no churn: {res}")
    if not res["hot_commits_per_sec"] > res["cold_commits_per_sec"] > 0:
        raise AssertionError(f"13: the skew did not show: {res}")
    if not revived or rebased < 0.9 * len(revived):
        raise AssertionError(f"13: revived hot ex-leaders rebased {rebased}/{len(revived)}")
    for name, n in launches.items():
        if n != detail["ticks"]:
            raise AssertionError(f"13: kernel {name} launched {n} times in "
                                 f"{detail['ticks']} ticks")
    # The draw kernel: each tick's jitter, and the initial deadlines.
    if draw_launches <= detail["ticks"]:
        raise AssertionError(f"13: the draw kernel launched {draw_launches} times in "
                             f"{detail['ticks']} ticks")
    log(f"13: launches {launches}, draw kernel {draw_launches} in {detail['ticks']} "
        f"ticks [{card}]")

    # The tick's bound: its bytes (the ring read once to three times)
    # over the card's memory rate.
    shapes = [("config5", G, P, cfg.L, cfg.E, mean_ms)]
    if headline_tick_ms is not None:
        shapes.append(("headline", HEADLINE["G"], HEADLINE["P"], HEADLINE["L"],
                       HEADLINE["E"], headline_tick_ms))
    out["roofline"] = {}
    for tag, g, p, L, E, ms in shapes:
        nbytes = [bytes_per_tick(g, p, L, E, k) for k in (1.0, 2.0, 3.0)]
        bound = [tick_bound_ms(g, p, L, E, k) for k in (1.0, 2.0, 3.0)]
        out["roofline"][tag] = dict(bytes=nbytes, bound_ms=bound, tick_ms=ms,
                                    tick_over_bound=ms / bound[0])
        log(f"13: roofline {tag} G={g} P={p} L={L} E={E}: {nbytes[0]:,.0f}-{nbytes[2]:,.0f} B a "
            f"tick (ring read 1-3 times), bound {bound[0]:.4f}-{bound[2]:.4f} ms at "
            f"{H100_BYTES_PER_S / 1e12:.2f} TB/s; measured {ms:.3f} ms, "
            f"{ms / bound[0]:.1f}x the 1-pass bound [{card}]")

    # Each kernel against its plain version on the run's final state.
    c_args, t_args = tick_kernel_inputs(cfg, st)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    checks = (
        ("quorum_commit", lambda: kernels.quorum_commit(*c_args, cfg.quorum),
         lambda: kernels.quorum_commit_plain(*c_args, cfg.quorum),
         commit_bound(c_args, cfg.quorum)),
        ("vote_tally", lambda: kernels.vote_tally(*t_args, cfg.quorum),
         lambda: kernels.vote_tally_plain(*t_args, cfg.quorum), tally_bound(t_args)),
    )
    out["kernels"] = {}
    for name, kern, plain, (bound_ms, bound_by, nbytes) in checks:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"13: {name} kernel != plain version on the final state")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        k_t, p_t = cuda_ms(kern, 200), cuda_ms(plain, 50)
        plan = kernels.tile_plan(G * P, P, name, sms=sms)
        tiles = -(-G * P // plan.tile)
        out["kernels"][name] = dict(
            launches=launches[name], max_abs_err=err, ms=k_t["cold"],
            warm_ms=k_t["warm"], plain_ms=p_t["cold"], plain_warm_ms=p_t["warm"],
            bound_ms=bound_ms, bound_by=bound_by, shape=[G, P, cfg.L],
            grid=plan.grid, tiles=tiles, tail_rows=G * P - (tiles - 1) * plan.tile)
        k = out["kernels"][name]
        log(f"13: kernel {name} on the final state G={G} P={P} L={cfg.L}: equal, "
            f"{launches[name]} launches in the run; grid {plan.grid} blocks over "
            f"{tiles} tiles of {plan.tile} rows (tail {k['tail_rows']}); device cold "
            f"{k_t['cold'] * 1e3:.2f} us, warm {k_t['warm'] * 1e3:.2f} us; plain cold "
            f"{p_t['cold'] * 1e3:.2f} us, warm {p_t['warm'] * 1e3:.2f} us; bound "
            f"{bound_ms * 1e3:.3f} us by {bound_by} ({nbytes} B) [{card}]")

    # The election jitter at this width: int64 threefry with 32-bit masks.
    tk = prng.fold_in(prng.fold_in(prng.PRNGKey(11), 20 + CONFIG5_RUN["rounds"] - 1), 7)
    on_card = prng.randint(tk, (G, P), cfg.ELECT_MIN, cfg.ELECT_MAX, torch.device("cuda"))
    on_cpu = prng.randint(tk, (G, P), cfg.ELECT_MIN, cfg.ELECT_MAX, torch.device("cpu"))
    if not torch.equal(on_card.cpu(), on_cpu):
        raise AssertionError("13: the jitter draw on the card differs from the CPU's")
    log(f"13: jitter draw at {G} x {P} on the card equals the CPU's [{card}]")
    return out


# ---------------------------------------------------------------------------
# Phase 14: the served-path rigs (benchmarks/ and scripts/ of the port)
# ---------------------------------------------------------------------------

# The open-loop ladder's step, cut from the reference's 4 s (PERF.md
# section 4); the rest of the sweep is the reference's: DEFAULT_RATES,
# Poisson, seed 7, keyspace 512, a 50 ms p99 target.
OPENLOOP_STEP_S = 2.0
# ``split_bench``'s slab ticks and serving ops, cut from its 400 and 400
# (PERF.md section 4): a split tick costs 16-85 ms on the card and the
# split servers answer a serial clerk at 3-7 ops/s.
SPLIT_SLAB_TICKS = 100
SPLIT_SERVING_OPS = 100
# ``bench_firehose_sockets``'s defaults: clients, frames a client, rows a frame.
SOCKETS = dict(n_clients=3, frames_per_client=12, frame=12288)


class _Env:
    """Set environment variables for a block and restore them after."""

    def __init__(self, **env) -> None:
        self.env = env

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)
        return self

    def __exit__(self, *exc) -> None:
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def rigs_firehose(card: str) -> dict:
    """14(a): ``bench_firehose_sockets`` against ``serve-kv --groups
    10000`` at phase 7's serve widths (the rig sets the same
    ``MULTIRAFT_SERVE_*`` variables from its ``ingest``), its verifier
    clerks porcupine-checked; every row acknowledged and the wire fast
    path engaged; then ``bench_firehose_inprocess`` at the reference's
    defaults on the card (once) and the socket-over-in-process ratio."""
    from multiraft_tpu_torch.benchmarks import serving_throughput as st

    G, ingest = HEADLINE["G"], HEADLINE["INGEST"]
    t0 = time.perf_counter()
    socks = st.bench_firehose_sockets(**SOCKETS, G=G, ingest=ingest, verify=True,
                                      device="cuda")
    socks["call_s"] = time.perf_counter() - t0
    total = SOCKETS["n_clients"] * SOCKETS["frames_per_client"] * SOCKETS["frame"]
    wire = socks["wire"]
    log(f"14a: firehose over sockets at G={G}, INGEST={ingest}: "
        f"{socks['ops_ok']:,} of {total:,} rows acknowledged in {socks['wall_s']} s, "
        f"{socks['ops_per_sec']:,} rows/s; porcupine {socks['porcupine']} over "
        f"{socks['verifier_ops']} verifier ops; flushes {wire.get('rpc_flushes')}, "
        f"frames a flush {wire.get('frames_per_flush_mean')} (p99 "
        f"{wire.get('frames_per_flush_p99')}), out-of-band buffers "
        f"{wire.get('rpc_oob_buffers')}; {socks['call_s']:.2f} s with the server's "
        f"start [{card}]")
    if socks["ops_ok"] != total:
        raise AssertionError(f"14a: {socks['ops_ok']} of {total} rows acknowledged")
    if socks["porcupine"] != "ok":
        raise AssertionError(f"14a: porcupine {socks['porcupine']}")
    if not (wire.get("rpc_flushes", 0) > 0 and (wire.get("frames_per_flush_mean") or 0) >= 1.0
            and wire.get("rpc_oob_buffers", 0) > 0):
        raise AssertionError(f"14a: the wire fast path did not engage: {wire}")
    # One run, where ``serving_throughput``'s ``main`` takes the median
    # of 3 (PERF.md section 4).
    inproc = st.bench_firehose_inprocess(device="cuda")
    if inproc["ops_ok"] != inproc["ops"]:
        raise AssertionError(f"14a in process: {inproc['ops_ok']} of {inproc['ops']} rows OK")
    ratio = socks["ops_per_sec"] / inproc["ops_per_sec"]
    log(f"14a: firehose in process at G={inproc['G']}, INGEST={inproc['ingest']}, "
        f"{inproc['clerks']} clerks x {inproc['ops'] // (inproc['clerks'] * inproc['frame'])} "
        f"frames of {inproc['frame']}: "
        f"{inproc['ops_per_sec']:,} rows/s (1 run), frame latency "
        f"{inproc['frame_latency_ms']} ms; sockets_over_inprocess {ratio:.3f} [{card}]")
    return {"sockets": socks, "inprocess": inproc, "sockets_over_inprocess": ratio}


def rigs_openloop(card: str) -> dict:
    """14(b): the open-loop ladder against ``serve-kv --groups 10000`` at
    phase 7's serve widths, the porcupine sampler throughout; the report
    recorded as the port's first round in a fresh directory and gated by
    ``python -m multiraft_tpu_torch.scripts.bench_compare --family
    loadcurve`` against that round alone (no TPU round)."""
    import shutil

    from multiraft_tpu_torch.benchmarks import openloop

    G = HEADLINE["G"]
    with _Env(**SERVE_ENV):
        rep = openloop.sweep(rates=openloop.DEFAULT_RATES, step_s=OPENLOOP_STEP_S,
                             mode="poisson", seed=7, groups=G, keyspace=512,
                             p99_target_ms=50.0, verify=True, device="cuda")
    if rep["porcupine"] != "ok":
        raise AssertionError(f"14b: porcupine {rep['porcupine']} "
                             f"({rep['verifier_ops']} sampled ops)")
    os.makedirs(SCRATCH, exist_ok=True)
    path = os.path.join(SCRATCH, "loadcurve.json")
    with open(path, "w") as f:
        json.dump(rep, f, indent=1)
    knee = rep.get("knee") or {}
    for s in rep["steps"]:
        log(f"14b: offered {s['offered_rate']:g} ops/s: sent {s['sent']}, ok {s['ok']}, "
            f"shed {s['shed']}, drops {s['drops']}, achieved {s['achieved_ops_per_sec']} "
            f"ops/s, client p50/p99 {s['client_p50_ms']}/{s['client_p99_ms']} ms [{card}]")
    at_knee = rep["steps"][knee["index"]] if knee else {}
    stages = {k: (v.get("p50_ms"), v.get("p99_ms"))
              for k, v in (at_knee.get("stages") or {}).items()}
    log(f"14b: max sustainable {rep['max_sustainable_ops_per_sec']} ops/s at p99 <= "
        f"{rep['p99_target_ms']:g} ms; knee at {knee.get('offered_rate')} offered "
        f"(index {knee.get('index')} of {len(rep['steps'])}), p99 there "
        f"{knee.get('client_p99_ms')} ms; stage p50/p99 ms at the knee {stages}; "
        f"porcupine {rep['porcupine']} over {rep['verifier_ops']} sampled ops [{card}]")
    rounds = os.path.join(SCRATCH, "rounds")
    shutil.rmtree(rounds, ignore_errors=True)
    os.makedirs(rounds)
    shutil.copy(path, os.path.join(rounds, "LOADCURVE_r01.json"))
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "multiraft_tpu_torch.scripts.bench_compare", path,
         "--family", "loadcurve", "--history", os.path.join(rounds, "LOADCURVE_r*.json")],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=120)
    for line in r.stdout.splitlines():
        log(f"14b: bench_compare | {line}")
    if r.returncode != 0 or "max sustainable ops/s" not in r.stdout:
        raise AssertionError(f"14b: bench_compare exit {r.returncode}: {r.stderr}")
    return {k: rep.get(k) for k in (
        "max_sustainable_ops_per_sec", "knee_ops_per_sec", "p99_at_knee_ms",
        "p999_at_knee_ms", "tail_dominant_wait", "porcupine", "verifier_ops", "step_s",
    )} | {"knee_stages": stages,
          "steps": [{k: s.get(k) for k in ("offered_rate", "sent", "ok", "shed", "drops",
                                            "achieved_ops_per_sec", "client_p50_ms",
                                            "client_p99_ms")} for s in rep["steps"]]}


def rigs_clerks(card: str) -> dict:
    """14(c): ``serving_throughput.bench`` per-op and framed (16 clerks x
    50 ops, frame 64; ``serve-kv --groups 64`` at the default serve
    widths, a server each) and ``serving_breakdown`` at its defaults (40
    frames of 64, the service's engine on the card)."""
    from multiraft_tpu_torch.benchmarks import serving_breakdown as sb
    from multiraft_tpu_torch.benchmarks import serving_throughput as st

    out = {}
    for frame in (0, 64):
        r = st.bench(16, 50, frame=frame, device="cuda")
        if r["ops"] != 16 * 50:
            raise AssertionError(f"14c: {r}")
        out[f"frame{frame}"] = r
        log(f"14c: {r['clerks']} clerks x 50 ops, frame {frame}: {r['ops_per_sec']} ops/s, "
            f"mean latency {r['mean_latency_ms']} ms ({'a frame' if frame else 'an op'}), "
            f"wire {r['wire']} [{card}]")
    br = {"frame": 64, **sb.bench_codec(64), **sb.bench_service(64, 40, device="cuda")}
    out["breakdown"] = br
    log(f"14c: breakdown of a 64-op frame: codec request {br['codec_req_frame_ms']} ms, "
        f"reply {br['codec_rep_frame_ms']} ms ({br['codec_us_per_op']} us an op); service "
        f"{br['service_ops_per_sec']} ops/s, {br['service_ms_per_frame']} ms a frame over "
        f"{br['service_frames']} frames [{card}]")
    return out


def rigs_split(card: str) -> dict:
    """14(d): ``split_bench`` at G=8: two split sides on the one card
    against the whole-card driver over ``SPLIT_SLAB_TICKS`` ticks (the
    slab exchange's price, not two failure domains), ``serve_split_kv``
    processes per-op and framed (``SPLIT_SERVING_OPS`` ops), and the
    failover window with every acknowledged append read back."""
    from multiraft_tpu_torch.benchmarks import split_bench as sp

    out = {}
    out.update(sp.bench_slab_overhead(8, ticks=SPLIT_SLAB_TICKS, device="cuda"))
    out.update(sp.bench_serving(8, SPLIT_SERVING_OPS, device="cuda"))
    out.update(sp.bench_failover(8, device="cuda"))
    if out["lost_acked_writes"] != 0:
        raise AssertionError(f"14d: {out['lost_acked_writes']} acknowledged writes lost")
    log(f"14d: G=8: whole card {out['whole_chip_ms_per_tick']} ms a tick, split "
        f"{out['split_ms_per_tick_per_side']} ms a tick a side, slab_overhead_x "
        f"{out['slab_overhead_x']} (two sides on one card: the slab exchange, not two "
        f"failure domains); served per-op {out['per_op_ops_per_sec']} ops/s, framed "
        f"{out['framed_ops_per_sec']} ops/s; failover window {out['failover_window_ms']} "
        f"ms, then {out['post_failover_ms_per_op']} ms an op; {out['acked_writes']} "
        f"acknowledged appends read back, 0 lost [{card}]")
    return out


def rigs_transport(card: str) -> dict:
    """14(e): ``transport_echo``'s four lines and the gap (the floor
    built from the port's copy of ``loopback_floor.c``); host only."""
    from multiraft_tpu_torch.benchmarks import transport_echo as te

    out = {}
    for rec in te.lines("both"):
        out[rec["path"]] = rec
        log(f"14e: {json.dumps(rec)} [{card}]")
    if set(out) != {"sim", "native", "native_2proc", "loopback_floor_c", "gap"}:
        raise AssertionError(f"14e: lines {sorted(out)}")
    return out


def rigs_placement(card: str) -> dict:
    """14(f): ``python -m multiraft_tpu_torch.scripts.placement_scenario
    --durable --quick`` at its defaults (3 processes x 2 gids, the fleet's
    engines on the card): exit 0, no acknowledged write lost, the
    failover inside 60 s."""
    import contextlib
    import io

    from multiraft_tpu_torch.scripts import placement_scenario as ps

    os.makedirs(SCRATCH, exist_ok=True)
    path = os.path.join(SCRATCH, "placement.json")
    printed = io.StringIO()  # the scenario's own lines; the result is read from its file
    with contextlib.redirect_stdout(printed):
        rc = ps.main(["--durable", "--quick", "--out", path])
    with open(path) as f:
        res = json.load(f)
    log(f"14f: durable failover {res['durable_failover_s']} s, "
        f"{res['lost_acked_writes']} of {res['acked_writes']} acknowledged writes lost, "
        f"ship recoveries {res['ship_recoveries']}, snapshots {res['ship_snapshots']}, "
        f"tail records {res['ship_tail_records']}, exit {rc} [{card}]")
    if rc != 0 or res["lost_acked_writes"] != 0 or not res["durable_failover_s"] < 60.0:
        raise AssertionError(f"14f: exit {rc}: {res}")
    return {k: v for k, v in res.items() if k not in ("history", "placement")}


RIGS_PHASES = {"14a": rigs_firehose, "14b": rigs_openloop, "14c": rigs_clerks,
               "14d": rigs_split, "14e": rigs_transport, "14f": rigs_placement}


def phase_rigs(card: str, kernels, names=tuple(RIGS_PHASES)) -> dict:
    """Phase 14 in this process (``--only``): each sub-phase with the
    launch counts set to 0 just before it and read just after.  The
    servers, the split drivers and the fleet build their engines without
    the kernels, as the reference's serve, so each count stays 0."""
    out = {}
    for name in names:
        kernels.reset_launches()
        t0 = time.perf_counter()
        out[name] = RIGS_PHASES[name](card)
        out[name]["phase_s"] = time.perf_counter() - t0
        out[name]["launches"] = dict(kernels.LAUNCHES)
        log(f"{name}: launches {out[name]['launches']}, {out[name]['phase_s']:.2f} s [{card}]")
        if max(kernels.LAUNCHES.values()) > 0:
            raise AssertionError(f"{name}: launches in this process {kernels.LAUNCHES}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from multiraft_tpu_torch.bench import card_line
    from multiraft_tpu_torch.engine import kernels

    if sys.argv[1:2] == ["--only"]:
        tour = ("12a", "12b")
        names = sys.argv[2:] or ["2b", "10a", "10b", "10c", "11a", "11b", "11c", *tour,
                                 "13", *RIGS_PHASES]
        unknown = [n for n in names if n not in MESH_PHASES and n not in RIGS_PHASES
                   and n not in ("2b", "10a", "10b", "10c", "13") + tour]
        if unknown:
            print(f"chip_smoke: unknown sub-phases {unknown}", file=sys.stderr)
            return 2
        card = card_line()
        if "2b" in names:
            phase_build(kernels)
            draws = phase_draw(kernels)
            log(f"draws: {json.dumps({f'{s}.{t}': v for (s, t), v in draws.items()})} "
                f"[{card}]")
        if any(n.startswith("10") for n in names):
            placed_alone(card, [n for n in names if n.startswith("10")])
        mesh_names = [n for n in names if n in MESH_PHASES]
        if mesh_names:
            log(f"mesh: {json.dumps(phase_mesh(card, kernels, mesh_names))} [{card}]")
        tour_names = [n for n in names if n in tour]
        if tour_names:
            log(f"tour: {json.dumps(phase_tour(card, kernels, tour_names))} [{card}]")
        if "13" in names:
            phase_build(kernels)
            log(f"config5: {json.dumps(config5_on_card(card, kernels))} [{card}]")
        rigs_names = [n for n in names if n in RIGS_PHASES]
        if rigs_names:
            t0 = time.perf_counter()
            rigs = phase_rigs(card, kernels, rigs_names)
            log(f"rigs: {json.dumps(rigs)} [{card}]")
            log(f"rigs: phase 14 ({' '.join(rigs_names)}) in "
                f"{time.perf_counter() - t0:.2f} s [{card}]")
        return 0
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    from multiraft_tpu_torch.utils import prng

    phase_build(kernels)
    kres = phase_kernels(kernels)
    dres = phase_draw(kernels)

    kernels.reset_launches()
    fh = phase_serving(card)
    launches = dict(kernels.LAUNCHES)
    launches["threefry"] = prng.KERNEL_LAUNCHES
    log(f"main path launches: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")

    phase_whole_engine()
    ops = phase_operations(card, kernels)
    sharded = phase_sharded(card, kernels)
    kernels.reset_launches()
    t0 = time.perf_counter()
    served = phase_serve(card)
    served["phase_s"] = time.perf_counter() - t0
    # The server is a child process, and it builds its engine with the
    # kernels off, as the reference's server does (use_pallas off): this
    # process launches nothing during the phase.
    if max(kernels.LAUNCHES.values()) > 0:
        raise AssertionError(f"serve: launches in this process {kernels.LAUNCHES}")
    log(f"serve: phase 7 in {served['phase_s']:.2f} s [{card}]")
    t0 = time.perf_counter()
    beside = Beside(card)
    log(f"side process: holds its card context after {time.perf_counter() - t0:.2f} s "
        f"[{card}]")
    try:
        t0 = time.perf_counter()
        shard_served = phase_shard_serve(card, kernels)
        log(f"shard serve: phase 8 in {time.perf_counter() - t0:.2f} s [{card}]")
        # Phases 9 and 10 time the card alone: the side process ends first.
        log(f"side process: {', '.join(BESIDE)} done {beside.wait():.2f} s after phase 8 "
            f"[{card}]")
        t0 = time.perf_counter()
        verified = phase_verify(card, kernels, beside)
        log(f"verify: phase 9 in {time.perf_counter() - t0:.2f} s [{card}]")
        t0 = time.perf_counter()
        placed = phase_placed(card, kernels, beside)
        log(f"placed: phase 10 in {time.perf_counter() - t0:.2f} s [{card}]")
    finally:
        beside.close()
    t_rigs = time.perf_counter()
    sides = []
    try:
        sides.append(Beside(card, BESIDE_MESH, "phases 11 and 12"))
        t0 = time.perf_counter()
        meshed = phase_mesh(card, kernels)
        log(f"mesh: phase 11 in {time.perf_counter() - t0:.2f} s [{card}]")
        t0 = time.perf_counter()
        for names in BESIDE_TOUR:
            sides.append(Beside(card, names, "phase 12"))
        toured = phase_tour(card, kernels)
        log(f"tour: phase 12 in {time.perf_counter() - t0:.2f} s [{card}]")
        for side in sides:
            log(f"side process: {', '.join(side.names)} done {side.wait():.2f} s later [{card}]")
        got = {n: side.result(n) for side in sides for n in side.names}
    finally:
        for side in sides:
            side.close()
    log(f"rigs: phases 11, 12 and 14 in {time.perf_counter() - t_rigs:.2f} s (phase 14 "
        f"but 14e in side processes beside phases 11 and 12) [{card}]")
    # Phase 13 times the card alone: it runs after every side process.
    t0 = time.perf_counter()
    c5_run = config5_on_card(card, kernels, verified["9a"]["tick_ms_mean"])
    log(f"config5: phase 13 in {time.perf_counter() - t0:.2f} s [{card}]")
    got.update(phase_rigs(card, kernels, ["14e"]))
    rigs = {n: got[n] for n in RIGS_PHASES}

    line = []
    for name in ("quorum_commit", "vote_tally"):
        h, c5 = kres[(name, "headline")], kres[(name, "config5")]
        line.append({
            "name": name,
            "route": "cuda",
            "source": "multiraft_tpu_torch/engine/csrc/raft_kernels.cu",
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": max(h["max_abs_err"], c5["max_abs_err"]),
            "ms": h["ms"],
            "plain_ms": h["plain_ms"],
            "bound_ms": h["bound_ms"],
            "bound_by": h["bound_by"],
            "library_ms": None,
            "shape": h["shape"],
            "warm_ms": h["warm_ms"],
            "host_ms": h["host_ms"],
            "floor_ms": h["floor_ms"],
            "floor_warm_ms": h["floor_warm_ms"],
            "config5": {k: c5[k] for k in (
                "shape", "ms", "warm_ms", "host_ms", "plain_ms", "bound_ms",
                "bound_by", "floor_ms", "floor_warm_ms",
            )},
            # Phase 11: the mesh runs the plain tick, as the reference's
            # mesh runs without its Pallas kernels.
            "mesh_launches": {k: v["launches"][name] for k, v in meshed.items()},
            # Phase 12: the examples and the soak build their engines
            # without the kernels, as the reference's do; this process's
            # count.
            "tour_launches": toured["launches"][name],
            # Phase 13: config #5 end to end; the kernel against its
            # plain version on that run's final state.
            "config5_run": c5_run["kernels"][name],
            # Phase 14: the served-path rigs' servers, split drivers and
            # fleet build their engines without the kernels, as the
            # reference's serve; each sub-phase's count in its process.
            "rigs_launches": {k: v["launches"][name] for k, v in rigs.items()},
        })
    # The draw kernel replaces no TPU kernel (the JAX package draws with
    # jax.random); its headline figures are the r3 jitter's randint.
    d = dres[("randint", "r3")]
    line.append({
        "name": "threefry",
        "route": "cuda",
        "source": "multiraft_tpu_torch/engine/csrc/threefry.cu",
        "replaces": None,
        "launches": launches["threefry"],
        "max_abs_err": max(v["max_abs_err"] for v in dres.values()),
        "ms": d["ms"],
        "plain_ms": d["plain_ms"],
        "bound_ms": d["bound_ms"],
        "bound_by": d["bound_by"],
        "library_ms": None,
        "shape": d["shape"],
        "warm_ms": d["warm_ms"],
        "host_ms": d["host_ms"],
        "draws": {f"{s}.{t}": {k: v[k] for k in (
            "shape", "span", "ms", "warm_ms", "host_ms", "plain_ms", "plain_warm_ms",
            "bound_ms", "bound_by", "ops", "bytes",
        )} for (s, t), v in dres.items()},
        "config5_run": {"launches": c5_run["draw_launches"]},
    })
    log(f"firehose: {json.dumps(fh)}")
    log(f"operations: {json.dumps(ops)}")
    log(f"sharded engine: {json.dumps(sharded)} [{card}]")
    log(f"served: {json.dumps(served)} [{card}]")
    log(f"shard served: {json.dumps(shard_served)} [{card}]")
    log(f"verified: {json.dumps(verified)} [{card}]")
    log(f"placed: {json.dumps(placed)} [{card}]")
    log(f"mesh: {json.dumps(meshed)} [{card}]")
    log(f"tour: {json.dumps(toured)} [{card}]")
    log(f"config5: {json.dumps(c5_run)} [{card}]")
    log(f"rigs: {json.dumps(rigs)} [{card}]")
    log(f"total: {time.perf_counter() - t_start:.1f} s [{card}]")
    log(json.dumps({"kernels": line}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
