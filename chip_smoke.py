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
3. Serving at full width (the main path, with the launch counters reset
   just before and read just after): an ``EngineDriver`` at the headline
   deployment elects one leader in every group, a ``BatchedKV`` answers
   a few hundred Put/Append/Get requests across many groups (every value
   held against a plain dict model of the same operations), and a fused
   firehose batch runs; both kernels must have launched.
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

The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``.
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


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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


def ptxas_facts(text: str) -> dict:
    """Registers, stack frame and spill bytes of the two kernels, from
    ``nvcc -Xptxas -v`` output ("Function properties for <name>" comes
    before the lines that give them)."""
    import re

    facts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = next((k for k in ("quorum_commit_kernel", "vote_tally_kernel")
                         if k in m.group(1)), None)
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
    for name in ("quorum_commit_kernel", "vote_tally_kernel"):
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


# ---------------------------------------------------------------------------
# Phase 3: the main path at full width
# ---------------------------------------------------------------------------


def phase_serving(card: str) -> dict:
    import numpy as np

    from multiraft_tpu_torch.engine.core import EngineConfig
    from multiraft_tpu_torch.engine.host import EngineDriver
    from multiraft_tpu_torch.engine.kv import BatchedKV, KVOp

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
    rng = np.random.default_rng(7)
    model = [dict() for _ in range(G)]
    expect = []  # (ticket, expected value or None)
    cmd = {}
    groups = rng.choice(G, size=120, replace=False)
    for i in range(400):
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
    log(f"serving: {len(expect)} logged requests over {len(groups)} groups "
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


def _full_ring_stalls(st: dict, cfg):
    """Per group, whether its leader can neither ingest nor commit again:
    the ring above its commit is full (no capacity for a new entry) and
    holds no entry of the leader's own term, so the current-term commit
    rule never fires, and compaction, which waits for the commit, never
    frees a slot.  The reference engine stalls in the same state (a new
    leader appends a no-op only while a config change is pending):
    tests/test_torch_chaos.py::test_full_ring_stall_in_lockstep drives
    both engines into it in lockstep and holds this predicate equal."""
    import numpy as np

    from multiraft_tpu_torch.engine.core import LEADER

    rows = np.arange(cfg.G)
    lead = (st["role"] == LEADER) & st["alive"]
    ld = np.where(lead, st["term"], -1).argmax(axis=1)  # the max-term leader
    term, commit = st["term"][rows, ld], st["commit"][rows, ld]
    last = st["base"][rows, ld] + st["log_len"][rows, ld]
    full = cfg.L - 2 - cfg.E - st["log_len"][rows, ld] < 1
    idx = commit[:, None] + np.arange(1, cfg.L + 1)[None, :]
    ring = st["log_term"][rows, ld]
    own = (ring[rows[:, None], idx % cfg.L] == term[:, None]) & (idx <= last[:, None])
    return lead[rows, ld] & full & (commit < last) & ~own.any(axis=1)


def ops_faults(card: str) -> dict:
    """5(a), 5(b) and 5(e): the headline deployment under a firehose
    backlog and 1% drops, with an invariant monitor every 50 ticks and a
    tracer attached; crashes and cuts at tick 50, restarts and heals at
    tick 100; at tick 200 a checkpoint restored on the card and on the
    CPU, and all three drivers stepped 30 more ticks under the same
    faults and compared."""
    import numpy as np

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
    stalled = _full_ring_stalls(st, cfg) & ~advanced
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


class _SplitRig:
    """Two split 'processes' in one interpreter (the split servers'
    deployment without the sockets): every pump extracts each live
    side's slabs and injects them into the other live side.  A killed
    side stops pumping and its slabs are dropped."""

    ADMIN_CLIENT, CLIENT = 424242, 777

    def __init__(self, sides) -> None:
        self.sides = sides  # [(service, peering)]
        self.alive = [True] * len(sides)
        self.pump_s, self.slab_bytes = [], []
        self._cmd = self._admin_cmd = 0

    def shuttle(self, rounds: int = 1) -> None:
        import pickle

        for _ in range(rounds):
            t0, nbytes = time.perf_counter(), 0
            for i, (svc, peering) in enumerate(self.sides):
                if not self.alive[i]:
                    continue
                svc.pump(1)
                for proc, slab in peering.extract().items():
                    nbytes += len(pickle.dumps(slab, protocol=pickle.HIGHEST_PROTOCOL))
                    if self.alive[proc]:
                        self.sides[proc][1].inject(slab)
            self.pump_s.append(time.perf_counter() - t0)
            self.slab_bytes.append(nbytes)

    def live(self):
        return [s for i, s in enumerate(self.sides) if self.alive[i]]

    def settle(self, G: int, max_rounds: int = 800) -> None:
        for _ in range(max_rounds):
            self.shuttle()
            per = [svc.driver.leaders_per_group() for svc, _ in self.live()]
            if all(sum(int(a[g]) for a in per) == 1 for g in range(G)):
                return
        raise AssertionError("split: the groups did not elect one leader each")

    def admin(self, kind: str, arg, max_rounds: int = 2000) -> None:
        self._admin_cmd += 1
        t = None
        for _ in range(max_rounds):
            if t is not None and t.done and not t.failed:
                return
            if t is None or t.done:
                for svc, _ in self.live():
                    nt = svc.ctrl_local(kind, arg, command_id=self._admin_cmd,
                                        client_id=self.ADMIN_CLIENT)
                    if nt is not None:
                        t = nt
                        break
            self.shuttle()
        raise AssertionError(f"split: ctrler {kind} never committed")

    def client_op(self, op: str, key: str, value: str = "", max_rounds: int = 2000) -> str:
        from multiraft_tpu_torch.services.shardkv import key2shard

        self._cmd += 1
        t = None
        for _ in range(max_rounds):
            if t is not None and t.done and not t.failed and t.err == "OK":
                return t.value
            if t is None or t.done:
                t = None
                live = self.live()
                gid = live[0][0].query_latest().shards[key2shard(key)]
                for svc, _ in live:
                    if gid in svc.reps:
                        t = svc.submit_local(gid, op, key, value, client_id=self.CLIENT,
                                             command_id=self._cmd)
                        if t is not None:
                            break
            self.shuttle()
        raise AssertionError(f"split: {op}({key!r}) never committed")

    def migrating(self) -> bool:
        from multiraft_tpu_torch.services.shardkv import SERVING

        return any(sl.state != SERVING for svc, _ in self.live()
                   for r in svc.reps.values() for sl in r.shards.values())

    def wait(self, pred, max_rounds: int, what: str) -> None:
        for _ in range(max_rounds):
            if pred():
                return
            self.shuttle()
        raise AssertionError(f"split: {what} not reached in {max_rounds} rounds")

    def migrated(self, gids) -> bool:
        from multiraft_tpu_torch.services.shardkv import SERVING

        latest = max(svc.configs[-1].num for svc, _ in self.live())
        return all(svc.reps[g].cur.num == latest
                   and all(sl.state == SERVING for sl in svc.reps[g].shards.values())
                   for svc, _ in self.live() for g in gids)


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
    kv = _SplitRig(_split_sides(SplitKV, "cuda", owners, cfg))
    kv.settle(G)
    acked = {}
    for i, g in enumerate(range(0, G, 8)):
        for r in range(3):
            side = next(s for s, _ in kv.live() if s.local_leader(g) is not None)
            t = side.submit_local(g, KVOp(op=OP_APPEND, key=f"k{g}", value=f"[{r}]",
                                          client_id=5, command_id=i * 3 + r + 1))
            kv.wait(lambda: t.done, 300, "a split KV commit")
            if t.failed:
                raise AssertionError("split: a KV append lost its slot")
            acked[g] = acked.get(g, "") + f"[{r}]"
    kv.wait(lambda: all(s.data[g].get(f"k{g}") == v for s, _ in kv.sides
                        for g, v in acked.items()), 200, "both sides applied")
    kv_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    rig = _SplitRig(_split_sides(SplitShardKV, "cuda", owners, cfg, delay_on=1))
    rig.settle(G)
    lead0 = sum(rig.sides[0][0].driver.leader_of(g) is not None for g in range(G))
    rig.admin("join", {1: ["p1"]})
    keys = [chr(ord("a") + i) + "key" for i in range(10)]
    model = {}
    for k in keys:
        rig.client_op("Append", k, f"[a-{k}]")
        model[k] = f"[a-{k}]"
    rig.admin("join", {2: ["p2"]})
    rig.wait(rig.migrating, 1500, "migration in flight")
    kill_tick = rig.sides[1][0].driver.tick
    rig.alive[0] = False  # driver 0 stops pumping; its slabs are dropped
    survivor = rig.sides[1][0]
    stay = next(k for k in keys if survivor.configs[-1].shards[key2shard(k)] == 1)
    rig.client_op("Append", stay, "[during]")
    model[stay] += "[during]"
    try:
        rig.wait(lambda: rig.migrated([1, 2]), 4000, "migration on the survivor")
    except AssertionError:
        st = survivor.driver.np_state()
        stalled = np.nonzero(_full_ring_stalls(st, cfg))[0].tolist()
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
    stalls = int(_full_ring_stalls(survivor.driver.np_state(), cfg).sum())
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from multiraft_tpu_torch.engine import kernels

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    phase_build(kernels)
    kres = phase_kernels(kernels)

    kernels.reset_launches()
    fh = phase_serving(card)
    launches = dict(kernels.LAUNCHES)
    log(f"main path launches: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")

    phase_whole_engine()
    ops = phase_operations(card, kernels)
    sharded = phase_sharded(card, kernels)

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
        })
    log(f"firehose: {json.dumps(fh)}")
    log(f"operations: {json.dumps(ops)}")
    log(f"sharded engine: {json.dumps(sharded)} [{card}]")
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
