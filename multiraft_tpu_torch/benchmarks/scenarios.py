"""Scenario benchmarks: the hard regimes beside the headline (the PyTorch
port of ``benchmarks/scenarios.py``).

The port's ``bench`` module is the headline number (steady-state
commits/sec).  This module measures leader churn, InstallSnapshot storms
after laggard recovery, skewed shard load and group-count scaling, each
as one JSON line on stdout:

    python -m multiraft_tpu_torch.benchmarks.scenarios churn [--device cpu]
    python -m multiraft_tpu_torch.benchmarks.scenarios snapstorm
    python -m multiraft_tpu_torch.benchmarks.scenarios skew
    python -m multiraft_tpu_torch.benchmarks.scenarios sweep
    python -m multiraft_tpu_torch.benchmarks.scenarios all

Shapes default to the bench config (G=10k x P=3) and scale down via
MULTIRAFT_BENCH_G / MULTIRAFT_BENCH_CHUNK for smoke runs.  Each scenario
takes ``device`` (None means the card; ``MULTIRAFT_PLATFORM=cpu`` or
``--device cpu`` asks for the CPU); the kernels run on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict

import numpy as np
import torch

__all__ = [
    "log", "bench_churn", "bench_snapstorm", "bench_skew", "bench_sweep",
    "SCENARIOS", "main",
]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _device(device=None) -> torch.device:
    from ..engine.host import resolve_device

    if device is None and os.environ.get("MULTIRAFT_PLATFORM") == "cpu":
        device = "cpu"
    return resolve_device(device)


def _cfg(G=None, P=None, L=192, E=48, ingest=48, device=None):
    """The bench's operating point (E=INGEST=48, L=192); P comes from
    MULTIRAFT_BENCH_P so every scenario is peer-count-generic.  The
    kernels are on where ``device`` is the card."""
    from ..engine.core import EngineConfig

    G = G or int(os.environ.get("MULTIRAFT_BENCH_G", "10000"))
    P = P or int(os.environ.get("MULTIRAFT_BENCH_P", "3"))
    return EngineConfig(G=G, P=P, L=L, E=E, INGEST=ingest, HB_TICKS=9,
                        use_kernels=_device(device).type == "cuda")


def _chunk() -> int:
    return int(os.environ.get("MULTIRAFT_BENCH_CHUNK", "200"))


def _run_ticks_vec(cfg, n_ticks):
    """``run(state, inbox, new_cmds, key)``: ``n_ticks`` ticks with a
    per-group ingest vector (the skewed firehose), tick ``i`` keyed by
    ``fold_in(key, i)``."""
    from ..engine.core import tick_impl
    from ..utils import prng

    def run(state, inbox, new_cmds, key):
        for i in range(n_ticks):
            state, inbox, _ = tick_impl(cfg, state, inbox, new_cmds,
                                        prng.fold_in(key, i))
        return state, inbox

    return run


def _sync(state) -> None:
    if state.term.device.type == "cuda":
        torch.cuda.synchronize(state.term.device)


def _boot(cfg, seed=7, device=None):
    """Elect leaders everywhere; returns (state, inbox, key)."""
    from ..engine.core import empty_mailbox, init_state, run_ticks
    from ..utils import prng

    dev = _device(device)
    key = prng.PRNGKey(seed)
    state = init_state(cfg, prng.fold_in(key, 0), dev)
    inbox = empty_mailbox(cfg, dev)
    state, inbox = run_ticks(cfg, state, inbox, _chunk(), 0, key)
    _sync(state)
    leaders = int(((state.role == 2) & state.alive).sum())
    log(f"boot: leaders={leaders}/{cfg.G}")
    return state, inbox, key


def _commits(state) -> np.ndarray:
    return state.commit.amax(dim=1).cpu().numpy().astype(np.int64)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _emit(metric: str, value: float, unit: str, baseline: float,
          **extra) -> Dict:
    rec = {
        "metric": metric,
        "value": round(value, 1),
        "unit": unit,
        "vs_baseline": round(value / baseline, 3) if baseline else None,
        **extra,
    }
    print(json.dumps(rec), flush=True)
    return rec


def bench_churn(device=None) -> Dict:
    """Sustained throughput while a slice of leaders is killed every
    chunk (the batched form of leader-failure churn): kills 10% of the
    groups' leaders each round and revives the previous victims."""
    from ..engine.core import run_ticks
    from ..utils import prng

    cfg = _cfg(device=device)
    state, inbox, key = _boot(cfg, device=device)
    CHUNK = _chunk()
    ROUNDS = int(os.environ.get("MULTIRAFT_BENCH_CHUNKS", "5"))
    kill_n = max(1, cfg.G // 10)
    rng = np.random.default_rng(0)
    state, inbox = run_ticks(cfg, state, inbox, CHUNK, cfg.INGEST,
                             prng.fold_in(key, 1))
    _sync(state)

    c0 = _commits(state)
    prev_victims = None
    t0 = time.perf_counter()
    for r in range(ROUNDS):
        role = _np(state.role)
        alive = _np(state.alive).copy()
        leaders = ((role == 2) & alive).argmax(axis=1)
        victims = rng.choice(cfg.G, size=kill_n, replace=False)
        if prev_victims is not None:
            g, p = prev_victims
            alive[g, p] = True
        alive[victims, leaders[victims]] = False
        state = state._replace(alive=torch.from_numpy(alive).to(state.alive.device))
        prev_victims = (victims, leaders[victims])
        state, inbox = run_ticks(cfg, state, inbox, CHUNK, cfg.INGEST,
                                 prng.fold_in(key, 100 + r))
        _sync(state)
        log(f"churn round {r+1}/{ROUNDS}: killed {kill_n} leaders")
    elapsed = time.perf_counter() - t0
    commits = int((_commits(state) - c0).sum())
    return _emit(
        "commits_per_sec_under_leader_churn",
        commits / elapsed,
        "commits/s",
        1_000_000.0,
        groups=cfg.G,
        killed_per_round=kill_n,
    )


def bench_snapstorm(device=None) -> Dict:
    """InstallSnapshot storm: one follower per group is dead while the
    log advances past the ring capacity, then every group fast-forwards
    its laggard at once.  Metric: entries fast-forwarded per second
    during recovery."""
    from ..engine.core import run_ticks
    from ..utils import prng

    # Small ring so laggards overflow it quickly (and E+INGEST+2 < L).
    cfg = _cfg(L=32, E=8, ingest=8, device=device)
    state, inbox, key = _boot(cfg, device=device)
    CHUNK = _chunk()
    rows = np.arange(cfg.G)
    # Kill one non-leader per group (the highest replica id that is not
    # the leader).
    leaders = ((_np(state.role) == 2) & _np(state.alive)).argmax(axis=1)
    victim = np.where(leaders != cfg.P - 1, cfg.P - 1, cfg.P - 2)
    alive = _np(state.alive).copy()
    alive[rows, victim] = False
    state = state._replace(alive=torch.from_numpy(alive).to(state.alive.device))
    # Outrun the ring: advance well past L entries while the laggard sleeps.
    rounds = 0
    while True:
        state, inbox = run_ticks(cfg, state, inbox, CHUNK, cfg.INGEST,
                                 prng.fold_in(key, 200 + rounds))
        _sync(state)
        rounds += 1
        lag = _commits(state) - _np(state.commit)[rows, victim]
        if (lag > cfg.L).all() or rounds >= 50:
            break
    lag_before = _commits(state) - _np(state.commit)[rows, victim]
    log(f"snapstorm: median lag at revival {int(np.median(lag_before))} entries")
    # Revive everyone at once: the storm.  No new load during recovery.
    state = state._replace(alive=torch.ones_like(state.alive))
    t0 = time.perf_counter()
    ticks = 0
    while ticks < 50 * CHUNK:
        state, inbox = run_ticks(cfg, state, inbox, CHUNK, 0,
                                 prng.fold_in(key, 300 + ticks))
        _sync(state)
        ticks += CHUNK
        commit = _np(state.commit)
        caught = (commit[rows, victim] >= _commits(state)).mean()
        if caught == 1.0:
            break
    elapsed = time.perf_counter() - t0
    bases = _np(state.base)[rows, victim]
    assert (bases > 0).mean() > 0.9, "snapshot fast-forward path not exercised"
    total_ff = int(lag_before.sum())
    return _emit(
        "snapshot_fastforward_entries_per_sec",
        total_ff / elapsed,
        "entries/s",
        0,
        groups=cfg.G,
        recovery_ticks=ticks,
        caught_up_frac=float(
            (_np(state.commit)[rows, victim] >= _commits(state)).mean()
        ),
    )


def bench_skew(device=None) -> Dict:
    """Skewed shard load: 10% hot groups ingest at the full rate, the
    rest trickle, the regime shard rebalancing exists for."""
    from ..utils import prng

    cfg = _cfg(device=device)
    state, inbox, key = _boot(cfg, device=device)
    CHUNK = _chunk()
    ROUNDS = int(os.environ.get("MULTIRAFT_BENCH_CHUNKS", "5"))
    hot = cfg.G // 10
    new_cmds = np.ones(cfg.G, np.int32)
    new_cmds[:hot] = cfg.INGEST
    new_cmds = torch.from_numpy(new_cmds).to(state.term.device)
    run = _run_ticks_vec(cfg, CHUNK)
    state, inbox = run(state, inbox, new_cmds, prng.fold_in(key, 1))
    _sync(state)
    c0 = _commits(state)
    t0 = time.perf_counter()
    for r in range(ROUNDS):
        state, inbox = run(state, inbox, new_cmds, prng.fold_in(key, 400 + r))
        _sync(state)
    elapsed = time.perf_counter() - t0
    delta = _commits(state) - c0
    hot_rate = delta[:hot].sum() / elapsed
    cold_rate = delta[hot:].sum() / elapsed
    return _emit(
        "commits_per_sec_skewed_load",
        (hot_rate + cold_rate),
        "commits/s",
        1_000_000.0,
        groups=cfg.G,
        hot_groups=hot,
        hot_commits_per_sec=round(float(hot_rate), 1),
        cold_commits_per_sec=round(float(cold_rate), 1),
    )


def bench_sweep(device=None) -> Dict:
    """(G, P) scaling sweep: commits/sec at G = 1k/10k (and 100k with
    MULTIRAFT_BENCH_SWEEP_MAX=100000) for every peer count in
    MULTIRAFT_BENCH_SWEEP_P (default "3"; "3,5" includes config #5's
    100k x 5) on one card."""
    from ..engine.core import run_ticks
    from ..utils import prng

    CHUNK = _chunk()
    ROUNDS = int(os.environ.get("MULTIRAFT_BENCH_CHUNKS", "3"))
    gmax = int(os.environ.get("MULTIRAFT_BENCH_SWEEP_MAX", "10000"))
    peer_counts = [
        int(p)
        for p in os.environ.get("MULTIRAFT_BENCH_SWEEP_P", "3").split(",")
    ]
    points = {}
    for P in peer_counts:
        for G in [g for g in (1000, 10000, 100000) if g <= gmax]:
            # Per-scale operating point: at 100k groups a leaner ring.
            cfg = (
                _cfg(G=G, P=P, L=112, E=28, ingest=28, device=device)
                if G >= 100000
                else _cfg(G=G, P=P, device=device)
            )
            state, inbox, key = _boot(cfg, device=device)
            state, inbox = run_ticks(cfg, state, inbox, CHUNK, cfg.INGEST,
                                     prng.fold_in(key, 1))
            _sync(state)
            c0 = _commits(state)
            t0 = time.perf_counter()
            for r in range(ROUNDS):
                state, inbox = run_ticks(cfg, state, inbox, CHUNK,
                                         cfg.INGEST, prng.fold_in(key, 500 + r))
                _sync(state)
            elapsed = time.perf_counter() - t0
            rate = int((_commits(state) - c0).sum()) / elapsed
            points[f"G={G},P={P}"] = round(rate, 1)
            log(f"sweep G={G} P={P}: {rate:,.0f} commits/s")
    best = max(points.values())
    return _emit(
        "commits_per_sec_scaling_sweep",
        best,
        "commits/s",
        1_000_000.0,
        points=points,
    )


SCENARIOS = {
    "churn": bench_churn,
    "snapstorm": bench_snapstorm,
    "skew": bench_skew,
    "sweep": bench_sweep,
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="all",
                    choices=["all", *SCENARIOS])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    names = list(SCENARIOS) if args.which == "all" else [args.which]
    for n in names:
        log(f"=== scenario: {n} ===")
        SCENARIOS[n](device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
