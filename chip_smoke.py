#!/usr/bin/env python3
"""End-to-end smoke run of the PyTorch/CUDA engine on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA card, ``nvcc`` (``$CUDA_HOME/bin`` or ``PATH``) and the
repository's ``multiraft_tpu_torch`` package beside this file.  Phases,
each of which raises on any failed check (so the script exits non-zero
and prints no result line):

1. Card and build: the card's name and power limit from ``nvidia-smi``;
   the hand-written kernels built from ``multiraft_tpu_torch/engine/csrc``.
2. Kernels: each kernel's output equals its plain PyTorch version on the
   card, exactly, on seeded inputs in the engine's ranges at the headline
   shape (G=10,000, P=3, L=192) and at G=100,000, P=5, L=192; the
   kernel, its plain version and its memory/operation bound are timed.
3. Serving at full width (the main path, with the launch counters reset
   just before and read just after): an ``EngineDriver`` at the headline
   deployment elects one leader in every group, a ``BatchedKV`` answers
   a few hundred Put/Append/Get requests across many groups (every value
   held against a plain dict model of the same operations), and a fused
   firehose batch runs; both kernels must have launched.
4. Whole engine, kernels against plain versions: 200 ticks from one seed
   with the kernels on and off, all planes equal; and a small engine on
   the card against the same engine on the CPU under message drops.

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
    """(bound_ms, bound_by, bytes, ops) of one quorum-commit call on these
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
    return _bound(nbytes, ops) + (nbytes, ops)


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
    return _bound(nbytes, ops) + (nbytes, ops)


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
             commit_bound(c_args, quorum)),
            ("vote_tally",
             lambda: kernels.vote_tally(*t_args, quorum),
             lambda: kernels.vote_tally_plain(*t_args, quorum),
             tally_bound(t_args)),
        )
        for name, kern, plain, bound in checks:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise AssertionError(f"{name} kernel != plain version at {tag}")
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            k_t = cuda_ms(kern, 200)
            p_t = cuda_ms(plain, 50)
            bound_ms, bound_by, nbytes, ops = bound
            results[(name, tag)] = dict(
                max_abs_err=err, ms=k_t["cold"], plain_ms=p_t["cold"],
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=ops,
                shape=[G, P, L], warm_ms=k_t["warm"], host_ms=k_t["host"],
                plain_warm_ms=p_t["warm"], plain_host_ms=p_t["host"],
            )
            # How many rows the check decides non-trivially.
            moved = got != c_args[2] if name == "quorum_commit" else got
            log(f"kernel {name} {tag} G={G} P={P} L={L}: equal "
                f"({int(moved.sum())} rows set); device cold "
                f"{k_t['cold'] * 1e3:.2f} us, warm {k_t['warm'] * 1e3:.2f} us, "
                f"host-paced {k_t['host'] * 1e3:.2f} us; plain cold "
                f"{p_t['cold'] * 1e3:.2f} us, warm {p_t['warm'] * 1e3:.2f} us, "
                f"host-paced {p_t['host'] * 1e3:.2f} us; bound "
                f"{bound_ms * 1e3:.3f} us by {bound_by} ({nbytes} B)")
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
    t0 = time.perf_counter()
    lib = kernels.build_library()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s")

    kres = phase_kernels(kernels)

    kernels.reset_launches()
    fh = phase_serving(card)
    launches = dict(kernels.LAUNCHES)
    log(f"main path launches: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")

    phase_whole_engine()

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
            "config5": {k: c5[k] for k in (
                "shape", "ms", "warm_ms", "host_ms", "plain_ms", "bound_ms",
                "bound_by",
            )},
        })
    log(f"firehose: {json.dumps(fh)}")
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
