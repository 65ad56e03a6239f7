"""Headline benchmark: log commits per second across 10,000 Raft groups
(the PyTorch port of the repository's ``bench.py``).

    python -m multiraft_tpu_torch.bench [--device cuda|cpu]

The batched engine at G=10,000 x P=3 (L=192, E=48, INGEST=48) under a
saturating Start() firehose, with both hand-written kernels on.  After
200 warm-up ticks without load, 200 with load and one traced chunk
outside the window, the timed window is RUNS x CHUNKS traced chunks of
CHUNK ticks; at every interior chunk boundary the leaders of N_FAULT
groups are killed (the previous victims revived), so the window holds
leader churn.  Committed entries are counted from the commit frontier.
From the per-tick device records, ``engine/bench_verify.py`` measures
the commit latency of every entry of the window and checks the
reconstructed histories of 128 sampled groups with porcupine.  A
``config5`` block runs BASELINE config #5: 100,000 groups x 5 peers
under churn, snapshot storms and skewed load (:func:`run_config5`).

Prints ONE JSON line on stdout, with the reference's keys; progress goes
to stderr.  The headline value is the median of the per-run medians.
The shapes and counts are the reference's environment knobs
(``MULTIRAFT_BENCH_G``, ``_P``, ``_CHUNK``, ``_CHUNKS``, ``_RUNS``,
``_SAMPLE``, ``_FAULTS``, ``_VERIFY``, ``_MESH``, ``_PALLAS`` (the
kernels), ``_CONFIG5`` and ``_CONFIG5_G/_P/_CHUNK/_CHUNKS``,
``_TRACE_DIR``).  The device is ``--device``; without it the card, or
the CPU where ``MULTIRAFT_BENCH_PLATFORM=cpu``.  The kernels default on
for the card and off on the CPU and under ``MULTIRAFT_BENCH_MESH`` (a
mesh runs the plain tick).  Unlike the reference, a failed config #5 leg
or trace artifact fails the run: nothing is caught.

The headline leg's pieces are this module's functions, which
``chip_smoke.py`` drives too: :func:`bench_victims` (the sampled groups
and the kill set), :func:`apply_leader_kills` (the fault model),
:func:`traced_run` (the staged, faulted, traced run) and
:func:`verify_run` (``bench_verify`` over it).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

__all__ = [
    "log", "write_trace_artifacts", "apply_leader_kills", "bench_victims",
    "traced_run", "verify_run", "full_ring_stalls", "main", "run_config5",
]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


_NO_KILLS = (np.zeros(0, np.int64), np.zeros(0, np.int64))


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _i64(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.int64)


def card_line() -> str:
    """``name, power limit`` of the first card, as ``nvidia-smi`` says."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def write_trace_artifacts(trace_dir, chunk_trace, metrics_snapshot):
    """Write ``trace_bench.json.gz`` (one span per timed chunk and a
    commit-rate counter track, in Chrome-trace form) and
    ``metrics_bench.json`` (the bench's metrics snapshot) into
    ``trace_dir``.  Returns the two paths."""
    from .utils.trace import Tracer

    os.makedirs(trace_dir, exist_ok=True)
    tr = Tracer(max_events=2 * len(chunk_trace) + 16)
    tr.process_name(0, "bench")
    for rec in chunk_trace:
        tr.span(
            "chunk", rec["ts_us"], rec["dur_us"], track="bench", pid=0,
            run=rec["run"], chunk=rec["chunk"], commits=rec["commits"],
            ms_per_tick=rec["ms_per_tick"],
        )
        tr.counter(
            "commit_rate", rec["ts_us"] + rec["dur_us"],
            {"commits_per_sec": rec["rate"]}, pid=0,
        )
    trace_path = tr.save(os.path.join(trace_dir, "trace_bench.json.gz"))
    metrics_path = os.path.join(trace_dir, "metrics_bench.json")
    with open(metrics_path, "w") as f:
        json.dump(metrics_snapshot, f, indent=2, sort_keys=True)
    log(f"bench: wrote {trace_path} and {metrics_path}")
    return trace_path, metrics_path


def apply_leader_kills(st, mb, kill_groups, prev_killed):
    """The one fault model of both legs: revive the previous round's
    victims (role follower, votes cleared, ``last_heard`` now; commit
    and applied are not rewound), then kill the current leader of every
    group in ``kill_groups`` (the live leader at the highest term) and
    drop the victims' in-flight messages.  ``prev_killed`` and the
    returned victims are ``(g_array, p_array)``.  Returns ``(state,
    inbox, killed)``."""
    from .engine.host import mask_active

    dev = st.alive.device
    host = lambda t: t.detach().cpu().numpy().copy()
    alive, role, votes = host(st.alive), host(st.role), host(st.votes)
    pre_votes, last_heard = host(st.pre_votes), host(st.last_heard)
    term = host(st.term).astype(np.int64)
    g_prev, p_prev = prev_killed
    if len(g_prev):
        alive[g_prev, p_prev] = True
        role[g_prev, p_prev] = 0
        votes[g_prev, p_prev, :] = False
        pre_votes[g_prev, p_prev, :] = False
        last_heard[g_prev, p_prev] = int(st.tick_no)
    lead_term = np.where((role == 2) & alive, term, np.int64(-1))
    sel = lead_term[kill_groups]
    has_leader = sel.max(axis=1) >= 0
    g_kill = np.asarray(kill_groups)[has_leader]
    p_kill = sel.argmax(axis=1)[has_leader]
    alive[g_kill, p_kill] = False
    on = lambda a: torch.from_numpy(a).to(dev)
    st = st._replace(alive=on(alive), role=on(role), votes=on(votes),
                     pre_votes=on(pre_votes), last_heard=on(last_heard))
    if len(g_kill):
        dead = np.zeros(alive.shape, bool)
        dead[g_kill, p_kill] = True
        dead = on(dead)
        edge_ok = ~(dead[:, :, None] | dead[:, None, :])
        mb = mask_active(mb, lambda _, a: a & edge_ok)
    return st, mb, (g_kill, p_kill)


def bench_victims(G: int, n_fault: int, n_sample: int):
    """The sampled groups and the kill set: half the victims are sampled
    groups (so porcupine sees churned histories), half spread over the
    rest.  Returns ``(sample list, kill array)``."""
    sample = [int(g) for g in sorted(set(np.linspace(0, G - 1, n_sample, dtype=int)))]
    kill = set()
    if n_fault:
        half = min(n_fault // 2, len(sample))
        for i in np.linspace(0, len(sample) - 1, half, dtype=int):
            kill.add(sample[int(i)])
        for g in np.linspace(0, G - 2, n_fault - half, dtype=int):
            g = int(g)
            kill.add(g + 1 if (g in kill or g in sample) else g)
    return sample, np.asarray(sorted(kill), np.int64)


def _loops(cfg, chunk: int, mesh, state, inbox, key):
    """``(state, inbox, load, traced, whole, devices)`` for one device or
    a groups-sharded mesh: ``load(st, mb, ingest, k)`` runs ``chunk``
    ticks, ``traced(st, mb, k)`` runs them with the global ``[chunk, G]``
    record, ``whole(st)`` is the global state."""
    from .engine import core

    if mesh is None:
        load = lambda st, mb, ingest, k: core.run_ticks(cfg, st, mb, chunk, ingest, k)
        traced = lambda st, mb, k: core.run_ticks_traced(
            cfg, st, mb, chunk, cfg.INGEST, k)
        return state, inbox, load, traced, (lambda st: st), [state.term.device]
    from .engine import mesh as em

    dev = state.term.device
    state, inbox = em.shard_arrays(cfg, mesh, state), em.shard_arrays(cfg, mesh, inbox)
    warm = em.make_sharded_run_ticks(cfg, mesh, chunk, 0)
    full = em.make_sharded_run_ticks(cfg, mesh, chunk, cfg.INGEST)
    rec = em.make_sharded_run_ticks_traced(cfg, mesh, chunk, cfg.INGEST)
    # One audited tick of each loop: no op of a shard touches another
    # shard's tensors, copies across devices or synchronises.
    cmds = em._full_cmds(full.sharded_tick.lcfg, mesh, cfg.INGEST)
    for run in (full, rec):
        em.assert_zero_collectives(run.sharded_tick, state, inbox, cmds, key)

    def traced(st, mb, k):
        st, mb, recs = rec(st, mb, k)
        return st, mb, {name: torch.cat([r.to(dev) for r in parts], dim=1)
                        for name, parts in recs.items()}

    load = lambda st, mb, ingest, k: (warm if ingest == 0 else full)(st, mb, k)
    return (state, inbox, load, traced, lambda st: em.gather_arrays(st, dev),
            list(mesh.devices))


def traced_run(cfg, device: str, chunk: int, n_chunks: int, n_fault: int,
               n_sample: int, seed: int = 7, verify: bool = True, mesh=None,
               on_chunk: Optional[Callable] = None) -> dict:
    """The bench's faulted run on ``device`` (or on ``mesh``, whose
    shards start from the state made on ``device``): ``chunk`` warm-up
    ticks without ingest, ``chunk`` at INGEST and (``verify``) one traced
    chunk outside the window, then ``n_chunks`` chunks, traced when
    ``verify``, with the leaders of ``n_fault`` groups killed at each
    interior boundary.  Each chunk's records are copied to the host once,
    outside its timed region; ``on_chunk(c, t0, dt, commits)`` is called
    after each (``t0`` its ``perf_counter`` start, ``dt`` its seconds).  Keys: ``fold_in(PRNGKey(seed), 1, 2, 3, 10+c)``."""
    from .engine.core import empty_mailbox, init_state
    from .utils import prng

    dev = torch.device(device)
    key = prng.PRNGKey(seed)
    state, inbox, load, traced, whole, devices = _loops(
        cfg, chunk, mesh, init_state(cfg, key, dev), empty_mailbox(cfg, dev), key)
    t0 = time.perf_counter()
    state, inbox = load(state, inbox, 0, prng.fold_in(key, 1))
    _sync(devices)
    st = whole(state)
    leaders = int(((st.role == 2) & st.alive).sum())
    elect_s = time.perf_counter() - t0
    state, inbox = load(state, inbox, cfg.INGEST, prng.fold_in(key, 2))
    if verify:
        state, inbox, _ = traced(state, inbox, prng.fold_in(key, 3))
    _sync(devices)
    warm_s = time.perf_counter() - t0
    st = whole(state)
    seed_last = _i64((st.base + st.log_len).amax(dim=1))
    seed_commit = _i64(st.commit.amax(dim=1))
    sample, kill_gs = bench_victims(cfg.G, n_fault, n_sample)
    prev_killed = _NO_KILLS
    n_kills = 0
    chunks, tick_ms, commits = [], [], []
    prev = seed_commit
    for c in range(n_chunks):
        if n_fault and c > 0:
            state, inbox, prev_killed = apply_leader_kills(
                state, inbox, kill_gs, prev_killed
            )
            n_kills += len(prev_killed[0])
        _sync(devices)
        t0 = time.perf_counter()
        k = prng.fold_in(key, 10 + c)
        if verify:
            state, inbox, rec = traced(state, inbox, k)
        else:
            state, inbox = load(state, inbox, cfg.INGEST, k)
        _sync(devices)
        dt = time.perf_counter() - t0
        if verify:
            chunks.append({name: v.cpu().numpy() for name, v in rec.items()})
        cur = _i64(whole(state).commit.amax(dim=1))
        commits.append(int((cur - prev).sum()))
        prev = cur
        tick_ms.append(dt / chunk * 1e3)
        if on_chunk is not None:
            on_chunk(c, t0, dt, commits[-1])
    return dict(chunks=chunks, seed_last=seed_last, seed_commit=seed_commit,
                state=whole(state), sample=sample, kill_groups=kill_gs,
                n_kills=n_kills, tick_ms=tick_ms, commits=commits,
                leaders_after_warmup=leaders, elect_s=elect_s,
                warm_s=warm_s)


def verify_run(run: dict, cfg) -> dict:
    """``bench_verify`` over a :func:`traced_run`: the latency histogram
    and the porcupine pass over the sampled groups; the checker path of
    each oracle group is counted."""
    from .engine import bench_verify as bv

    for k in bv.CHECKER_PATHS:
        bv.CHECKER_PATHS[k] = 0
    recs = bv.concat_records(run["chunks"])
    prep = bv.prepare_records(recs, run["seed_last"], run["seed_commit"])
    lat = bv.latency_histogram(recs, run["seed_last"], run["seed_commit"], prep=prep)
    t0 = time.perf_counter()
    porc = bv.verify_sampled_groups(
        recs, run["seed_last"], run["seed_commit"], run["sample"],
        run["state"], cfg, prep=prep,
    )
    return dict(recs=recs, lat=lat, porc=porc, verify_s=time.perf_counter() - t0,
                paths=dict(bv.CHECKER_PATHS))


def full_ring_stalls(st: dict, cfg) -> np.ndarray:
    """Per group, whether its leader can neither ingest nor commit again:
    the ring above its commit is full (no capacity for a new entry) and
    holds no entry of the leader's own term, so the current-term commit
    rule never fires, and compaction, which waits for the commit, never
    frees a slot.  The reference engine stalls in the same state (a new
    leader appends a no-op only while a config change is pending):
    tests/test_torch_chaos.py::test_full_ring_stall_in_lockstep drives
    both engines into it in lockstep and holds this predicate equal.
    ``st`` is the state's planes as numpy arrays."""
    from .engine.core import LEADER

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


def _stalled_sampled(run: dict, cfg) -> list:
    """The sampled groups of a :func:`traced_run` in the full-ring stall,
    by :func:`full_ring_stalls` on the run's final state."""
    st = {k: v.detach().cpu().numpy() for k, v in run["state"]._asdict().items()}
    stalled = full_ring_stalls(st, cfg)
    return [g for g in run["sample"] if stalled[g]]


def _device_from_env() -> str:
    forced = os.environ.get("MULTIRAFT_BENCH_PLATFORM", "")
    if forced in ("", "gpu", "cuda"):
        return "cuda"
    if forced == "cpu":
        return "cpu"
    raise SystemExit(f"bench: MULTIRAFT_BENCH_PLATFORM={forced!r}: cpu or gpu")


def main(argv=None) -> dict:
    from .engine.core import EngineConfig
    from .engine.host import resolve_device
    from .utils.metrics import Metrics

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; MULTIRAFT_BENCH_PLATFORM=cpu "
                         "also asks for the CPU")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device or _device_from_env())
    platform = "gpu" if dev.type == "cuda" else dev.type
    if dev.type == "cuda":
        log(f"bench: card {card_line()}, torch {torch.__version__}")
    log(f"bench: device={dev} platform={platform}")

    G = _env_int("MULTIRAFT_BENCH_G", 10000)
    P = _env_int("MULTIRAFT_BENCH_P", 3)
    n_mesh = _env_int("MULTIRAFT_BENCH_MESH", 0)
    # The kernels default on for the card; a mesh runs the plain tick.
    default_kernels = "1" if (dev.type == "cuda" and not n_mesh) else "0"
    use_kernels = os.environ.get("MULTIRAFT_BENCH_PALLAS", default_kernels) == "1"
    cfg = EngineConfig(G=G, P=P, L=192, E=48, INGEST=48, HB_TICKS=9,
                       use_kernels=use_kernels)
    CHUNK = _env_int("MULTIRAFT_BENCH_CHUNK", 200)
    N_CHUNKS = _env_int("MULTIRAFT_BENCH_CHUNKS", 3)
    RUNS = _env_int("MULTIRAFT_BENCH_RUNS", 3)
    VERIFY = os.environ.get("MULTIRAFT_BENCH_VERIFY", "1") == "1"
    N_SAMPLE = _env_int("MULTIRAFT_BENCH_SAMPLE", 128)
    N_FAULT = _env_int("MULTIRAFT_BENCH_FAULTS", 48)
    mesh = None
    if n_mesh:
        from .distributed.engine_wire import make_mesh

        mesh = make_mesh(n_mesh, dev.type)
        log(f"bench: mesh mode over {n_mesh} shards (zero collectives)")
        if N_FAULT:
            # Host-side fault surgery would gather the shards.
            N_FAULT = 0
            log("bench: faults disabled in mesh mode")

    m = Metrics()
    chunk_trace = []

    def on_chunk(gc: int, t0: float, dt: float, commits: int) -> None:
        run, c = divmod(gc, N_CHUNKS)
        rate = commits / dt
        m.observe("chunk_rate", rate)
        m.inc("commits", commits)
        chunk_trace.append({
            "ts_us": t0 * 1e6, "dur_us": dt * 1e6,
            "run": run, "chunk": c, "commits": commits, "rate": rate,
            "ms_per_tick": dt / CHUNK * 1e3,
        })
        log(f"bench: run {run+1}/{RUNS} chunk {c+1}/{N_CHUNKS}: {dt:.3f}s "
            f"({dt/CHUNK*1e3:.3f} ms/tick, {rate:,.0f} commits/s)")

    t_begin = time.perf_counter()
    run = traced_run(cfg, dev, CHUNK, RUNS * N_CHUNKS, N_FAULT, N_SAMPLE,
                     verify=VERIFY, mesh=mesh, on_chunk=on_chunk)
    log(f"bench: warmup done in {run['elect_s']:.1f}s, leaders="
        f"{run['leaders_after_warmup']}/{G}; staged in {run['warm_s']:.1f}s")
    elapsed = sum(run["tick_ms"]) * CHUNK / 1e3
    rates_all = [r["rate"] for r in chunk_trace]
    run_rates = [float(np.median(rates_all[i * N_CHUNKS:(i + 1) * N_CHUNKS]))
                 for i in range(RUNS)]
    rates = sorted(run_rates)
    commits_per_sec = float(np.median(run_rates))
    total_commits = m.counters["commits"]
    tick_times = np.array(run["tick_ms"]) / 1e3
    per_tick_p99 = float(np.percentile(tick_times, 99))
    per_tick_mean = float(np.mean(tick_times))
    # The 3-tick model (ingest->send, follower append, quorum commit).
    p99_model_ms = 3 * per_tick_p99 * 1e3
    st = run["state"]
    leaders = int(((st.role == 2) & st.alive).sum())

    extra = {}
    if VERIFY and run["chunks"]:
        v = verify_run(run, cfg)
        lat, porc = v["lat"], v["porc"]
        # Converted at the mean tick; the worst-chunk bound is reported
        # as p99_conservative_ms.
        p99_latency_ms = lat["p99_ticks"] * per_tick_mean * 1e3
        p99_conservative_ms = lat["p99_ticks"] * per_tick_p99 * 1e3
        failover_p99_ms = lat["failover_p99_ticks"] * per_tick_mean * 1e3
        failover_p50_ms = lat["failover_p50_ticks"] * per_tick_mean * 1e3
        hist_head = dict(sorted(lat["hist_ticks"].items())[:12])
        log(
            f"bench: measured latency p50={lat['p50_ticks']} ticks, "
            f"p99={lat['p99_ticks']} ticks over {lat['entries']:,} "
            f"entries ({lat['churned_groups']} churned groups measured "
            f"exactly, {lat['unaccounted']} unaccounted); "
            f"failover p50/p99={lat['failover_p50_ticks']}/"
            f"{lat['failover_p99_ticks']} ticks over "
            f"{lat['failover_entries']:,} churned-group entries; "
            f"hist head={hist_head}"
        )
        log(
            f"bench: porcupine over {len(run['sample'])} sampled groups: "
            f"{porc['porcupine']} ({v['verify_s']:.1f}s, "
            f"{porc.get('ring_entries_crosschecked', 0)} ring entries "
            f"cross-checked, {porc.get('groups_churned', 0)} churned "
            f"verified, {porc.get('multi_client_groups', 0)} "
            f"multi-client, checker paths {v['paths']}); stalled sampled "
            f"groups {_stalled_sampled(run, cfg)}"
        )
        extra = {
            "p99_latency_ticks": lat["p99_ticks"],
            "p50_latency_ticks": lat["p50_ticks"],
            "latency_entries_measured": lat["entries"],
            "latency_unaccounted": lat["unaccounted"],
            "churned_groups": lat["churned_groups"],
            "rebound_entries": lat["rebound_entries"],
            "p99_conservative_ms": round(p99_conservative_ms, 3),
            "p99_model_ms": round(p99_model_ms, 3),
            "failover_entries": lat["failover_entries"],
            "failover_p50_ms": round(failover_p50_ms, 3),
            "failover_p99_ms": round(failover_p99_ms, 3),
            # Target: a churned group's entries commit within 100 ms at
            # p99; None when nothing was measured.
            "failover_within_target": (
                bool(failover_p99_ms <= 100.0)
                if lat["failover_entries"] > 0 else None
            ),
            "porcupine": porc["porcupine"],
            "sampled_groups": porc["sampled_groups"],
            "groups_ok": porc.get("groups_ok", 0),
            "groups_unknown": porc.get("groups_unknown", 0),
            "groups_churned_verified": porc.get("groups_churned", 0),
            "ambiguous_entries": porc.get("ambiguous_entries", 0),
            "multi_client_groups": porc.get("multi_client_groups", 0),
            "max_concurrency": porc.get("max_concurrency", 0),
            "dfs_oracle_groups": porc.get("dfs_oracle_groups", 0),
        }
        # Gate on the measured distribution only when it measured
        # something, else on the model.
        if lat["entries"] > 0:
            p99_gate_ms = p99_latency_ms
        else:
            p99_latency_ms = p99_gate_ms = p99_model_ms
    else:
        p99_latency_ms = p99_gate_ms = p99_model_ms
    log(
        f"bench: {total_commits} commits in {elapsed:.2f}s over {G} groups "
        f"(leaders={leaders}), p99 commit latency ~{p99_latency_ms:.2f} ms; "
        f"{time.perf_counter() - t_begin:.1f}s in all"
    )

    config5 = None
    if os.environ.get("MULTIRAFT_BENCH_CONFIG5", "1") == "1" and not n_mesh:
        config5 = run_config5(use_kernels, dev)

    trace_dir = os.environ.get("MULTIRAFT_BENCH_TRACE_DIR", "")
    if trace_dir:
        write_trace_artifacts(trace_dir, chunk_trace, m.snapshot())

    baseline = 1_000_000.0  # BASELINE.md north star
    out = {
        "metric": f"log_commits_per_sec_{G}x{P}_{platform}",
        "value": round(commits_per_sec, 1),
        "unit": "commits/s",
        "vs_baseline": round(commits_per_sec / baseline, 3),
        "p99_commit_latency_ms": round(p99_latency_ms, 3),
        # Target: <= 5 ms at the north-star shape.
        "p99_within_target": bool(p99_gate_ms <= 5.0),
        "runs": len(run_rates),
        "chunks_per_run": N_CHUNKS,
        "run_commits_per_sec": [round(r, 1) for r in run_rates],
        "min": round(rates[0], 1),
        "max": round(rates[-1], 1),
        "spread_pct": round(100.0 * (rates[-1] - rates[0]) / commits_per_sec, 1),
        "faults": {
            "kill_groups": len(run["kill_groups"]),
            "leader_kills": run["n_kills"],
            "boundaries": max(RUNS * N_CHUNKS - 1, 0) if N_FAULT else 0,
        },
        **extra,
        **({"config5": config5} if config5 is not None else {}),
    }
    print(json.dumps(out), flush=True)
    return out


def run_config5(use_kernels: bool, device="cuda", G: Optional[int] = None,
                P: Optional[int] = None, chunk: Optional[int] = None,
                rounds: Optional[int] = None,
                detail: Optional[dict] = None) -> dict:
    """BASELINE config #5: 100,000 groups x 5 peers under leader churn,
    snapshot storms and skewed load, one combined leg (L=112, E=INGEST=28).

    10% hot groups ingest at the full rate, the rest one entry a tick
    (the skew); every round kills the current leaders of 1% of the
    groups and revives the previous victims (the churn); hot groups
    advance thousands of entries a round against the 112-entry ring, so
    a revived ex-leader is far behind its leader's ring base and must
    recover through the snapshot fast-forward (the storm), which its
    rebased ring base shows: the leg fails if no killed replica's base
    moved past zero.  Throughput and the measured p99 come from the
    traced loop and the headline's latency algebra.

    ``G``, ``P``, ``chunk`` and ``rounds`` default to the
    ``MULTIRAFT_BENCH_CONFIG5_*`` knobs (100,000, 5, 100, 3).  A
    ``detail`` dict receives what the JSON leaves out: the final state,
    the victims, each revived hot ex-leader's base and last index when
    it died, the per-round times, and the card's peak memory."""
    from .engine.bench_verify import concat_records, latency_histogram
    from .engine.core import (
        EngineConfig,
        empty_mailbox,
        init_state,
        run_ticks,
        run_ticks_traced_vec,
    )
    from .engine.host import resolve_device
    from .utils import prng

    G = G or _env_int("MULTIRAFT_BENCH_CONFIG5_G", 100000)
    P = P or _env_int("MULTIRAFT_BENCH_CONFIG5_P", 5)
    CHUNK = chunk or _env_int("MULTIRAFT_BENCH_CONFIG5_CHUNK", 100)
    ROUNDS = rounds or _env_int("MULTIRAFT_BENCH_CONFIG5_CHUNKS", 3)
    # The 100k-scale operating point: a leaner ring.
    cfg = EngineConfig(G=G, P=P, L=112, E=28, INGEST=28, HB_TICKS=9,
                       use_kernels=use_kernels)
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sync = lambda: _sync([dev])
    key = prng.PRNGKey(11)
    state = init_state(cfg, key, dev)
    inbox = empty_mailbox(cfg, dev)
    t0 = time.perf_counter()
    state, inbox = run_ticks(cfg, state, inbox, 200, 0, prng.fold_in(key, 1))
    sync()
    boot_s = time.perf_counter() - t0
    leaders = int(((state.role == 2) & state.alive).sum())
    log(f"bench: config5 boot {boot_s:.1f}s, leaders={leaders}/{G}")

    hot = G // 10
    new_cmds_np = np.ones(G, np.int32)
    new_cmds_np[:hot] = cfg.INGEST
    new_cmds = torch.from_numpy(new_cmds_np).to(dev)
    # Fill the skewed traced loop outside the timed region.
    state, inbox, _warm = run_ticks_traced_vec(
        cfg, state, inbox, CHUNK, new_cmds, prng.fold_in(key, 2)
    )
    sync()
    del _warm

    seed_last = _i64((state.base + state.log_len).amax(dim=1))
    seed_commit = _i64(state.commit.amax(dim=1))
    prev = seed_commit.copy()

    kill_n = max(1, G // 100)
    rng = np.random.default_rng(5)
    prev_killed = _NO_KILLS
    ever_killed = np.zeros((G, P), bool)
    # Each revived hot ex-leader: (g, p, last index when it died).
    died_last = {}
    revived_hot = []
    n_kills = 0
    recs = []
    tick_times = []
    elapsed = 0.0
    for r in range(ROUNDS):
        # The headline's fault model over a fresh 1% sample each round.
        victims = rng.choice(G, size=kill_n, replace=False)
        revived = prev_killed
        state, inbox, prev_killed = apply_leader_kills(
            state, inbox, victims, prev_killed
        )
        ever_killed[prev_killed] = True
        n_kills += len(prev_killed[0])
        revived_hot += [(int(g), int(p), died_last[(int(g), int(p))])
                        for g, p in zip(*revived) if g < hot]
        if len(prev_killed[0]):
            last = _i64(state.base + state.log_len)
            died_last.update({(int(g), int(p)): int(last[g, p])
                              for g, p in zip(*prev_killed)})
        t0 = time.perf_counter()
        state, inbox, rec = run_ticks_traced_vec(
            cfg, state, inbox, CHUNK, new_cmds, prng.fold_in(key, 20 + r),
        )
        sync()
        dt = time.perf_counter() - t0
        elapsed += dt
        tick_times.append(dt / CHUNK)
        recs.append({k: v.cpu().numpy() for k, v in rec.items()})
        cur = _i64(state.commit.amax(dim=1))
        rate = int((cur - prev).sum()) / dt
        prev = cur
        log(
            f"bench: config5 round {r+1}/{ROUNDS}: {dt:.3f}s "
            f"({dt/CHUNK*1e3:.3f} ms/tick, {rate:,.0f} commits/s, "
            f"{len(victims)} leaders killed)"
        )

    per_group = prev - seed_commit
    mean_tick = float(np.mean(tick_times))
    lat = latency_histogram(concat_records(recs), seed_last, seed_commit)
    # Snapshot-storm evidence: a revived ex-leader of a hot group is
    # > L entries behind, so its ring must have fast-forwarded (base
    # rebased past zero).
    bases = _i64(state.base)
    ff = int(((bases > 0) & ever_killed).sum())
    if ff == 0:
        raise AssertionError("config5: no killed replica's ring was rebased: "
                             "the snapshot fast-forward did not run")
    out = {
        "groups": G,
        "peers": P,
        "commits_per_sec": round(float(per_group.sum()) / elapsed, 1),
        "hot_groups": hot,
        "hot_commits_per_sec": round(float(per_group[:hot].sum()) / elapsed, 1),
        "cold_commits_per_sec": round(float(per_group[hot:].sum()) / elapsed, 1),
        "leader_kills": n_kills,
        "p99_latency_ms": round(lat["p99_ticks"] * mean_tick * 1e3, 3),
        "p50_latency_ms": round(lat["p50_ticks"] * mean_tick * 1e3, 3),
        "failover_p99_ms": round(
            lat["failover_p99_ticks"] * mean_tick * 1e3, 3
        ),
        "failover_entries": lat["failover_entries"],
        "latency_entries_measured": lat["entries"],
        "latency_unaccounted": lat["unaccounted"],
        "churned_groups": lat["churned_groups"],
        "snapshot_fastforward_replicas": ff,
        "ms_per_tick": round(mean_tick * 1e3, 3),
    }
    log(f"bench: config5 {json.dumps(out)}")
    if detail is not None:
        detail.update(
            cfg=cfg, state=state, lat=lat, boot_s=boot_s, tick_s=tick_times,
            commits=int(per_group.sum()), hot_commits=int(per_group[:hot].sum()),
            ticks=200 + CHUNK * (ROUNDS + 1), timed_ticks=CHUNK * ROUNDS,
            revived_hot=[(g, p, was, int(bases[g, p])) for g, p, was in revived_hot],
            peak_bytes=(torch.cuda.max_memory_allocated(dev)
                        if dev.type == "cuda" else None),
        )
    return out


if __name__ == "__main__":
    main()
