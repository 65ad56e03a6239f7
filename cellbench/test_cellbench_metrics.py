"""The metric arithmetic on synthetic records and timestamps, and on the
engine's own records against ``bench_verify``."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cellbench import latency, manifest, roofline, run, trace
from cellbench.harness import Window


def calm_records(N=20, G=3, per_tick=4, lag=2):
    """Each group accepts ``per_tick`` entries a tick; each tick's
    entries commit ``lag`` ticks later."""
    acc = torch.full((N, G), per_tick, dtype=torch.int32)
    hi = (torch.arange(1, N + 1, dtype=torch.int32)[:, None] * per_tick).expand(N, G)
    C = torch.clamp(hi - lag * per_tick, min=0).contiguous()
    C0 = torch.zeros(G, dtype=torch.int32)
    return acc, hi.contiguous(), C, C0


def test_calm_groups_commit_in_two_ticks():
    acc, hi, C, C0 = calm_records()
    T = np.arange(1, 21, dtype=float) * 10.0  # a tick every 10 ms
    w = latency.writes(acc, hi, C, C0, T)
    assert w["hist_ticks"] == {2: 18 * 4 * 3}
    assert w["in_flight"] == 2 * 4 * 3 and w["truncated"] == 0
    assert w["ticks_p99"] == 2 and w["ms_p99"] == pytest.approx(20.0)
    assert w["committed"] == 18 * 4 * 3


def test_a_stalled_tick_moves_the_tail_and_the_rate():
    acc, hi, C, C0 = calm_records(N=200)
    T = np.arange(1, 201, dtype=float) * 10.0
    base = latency.writes(acc, hi, C, C0, T)
    stalled = T.copy()
    stalled[100:] += 1000.0  # tick 100 takes 1010 ms: 2 ticks across it, 1020
    slow = latency.writes(acc, hi, C, C0, stalled)
    assert base["ms_p99"] == pytest.approx(20.0)
    assert slow["ms_p99"] == pytest.approx(1020.0)
    cell = manifest.cell("c5.skew_steady")

    def rate(T_ms):
        out = SimpleNamespace(cell=cell, writes=base, failover=None, setup_s=1.0,
                              window=Window(ticks=200, seconds=T_ms[-1] / 1e3))
        return run.metrics_of(out, False)["writes_per_s"]["value"]

    assert rate(stalled) < rate(T) * 0.8


def test_a_truncated_binding_is_failed_and_its_rebinding_measured():
    # One group: ticks 0-1 accept (0,4] and (4,8]; the leader dies; at
    # tick 5 a new leader, whose log ends at 4, accepts (4,8] again, and
    # everything commits at tick 7.
    N = 8
    acc = torch.zeros((N, 1), dtype=torch.int32)
    hi = torch.zeros((N, 1), dtype=torch.int32)
    acc[0], hi[0] = 4, 4
    acc[1], hi[1] = 4, 8
    acc[5], hi[5] = 4, 8
    C = torch.tensor([0, 0, 4, 4, 4, 4, 4, 8], dtype=torch.int32)[:, None]
    w = latency.writes(acc, hi, C, torch.zeros(1, dtype=torch.int32), None)
    assert w["truncated"] == 4
    assert w["hist_ticks"] == {2: 8}
    assert w["accepted_committed"] == 8 and w["in_flight"] == 0


def test_failover_counts_from_the_kill_to_the_first_commit_advance():
    M, G = 30, 4
    C = torch.arange(1, M + 1, dtype=torch.int32)[:, None].repeat(1, G)
    C[5:17, 1] = C[4, 1]  # group 1 stalls from tick 5, advances at tick 17
    C[5:, 2] = C[4, 2]  # group 2 never recovers
    T = np.arange(1, M + 1, dtype=float) * 10.0
    groups = torch.tensor([1, 2, 3])
    hit = torch.tensor([True, True, False])
    fo = latency.failover(C, [(5, groups, hit, 45.0)], T, torch.zeros(G, dtype=torch.int32))
    assert fo["kills"] == 2 and fo["unserved"] == 1
    ticks = sorted([17 - 5 + 1, M - 5])
    assert fo["ticks_p99"] == ticks[-1]
    assert fo["ms_p50"] == pytest.approx(T[17] - 45.0)


def test_weighted_quantile_nearest_rank():
    v = np.array([1.0, 2.0, 3.0])
    assert latency.weighted_quantile(v, np.array([98, 1, 1]), 0.99) == 2.0
    assert latency.weighted_quantile(v, np.array([1, 1, 98]), 0.5) == 3.0


def test_algebra_equals_bench_verify_on_engine_records_with_churn():
    from multiraft_tpu_torch.engine import bench_verify
    from multiraft_tpu_torch.engine.core import EngineConfig, empty_mailbox, init_state, run_ticks_traced_vec
    from multiraft_tpu_torch.utils import prng

    from cellbench import surgery

    cfg = EngineConfig(G=24, P=5, L=40, E=8, INGEST=8, membership=False)
    key = prng.PRNGKey(3)
    st, mb = init_state(cfg, key, torch.device("cpu")), empty_mailbox(cfg, torch.device("cpu"))
    cmds = torch.tensor([8] * 6 + [1] * 18, dtype=torch.int32)
    st, mb, _ = run_ticks_traced_vec(cfg, st, mb, 120, cmds * 0, prng.fold_in(key, 1))
    st, mb, _ = run_ticks_traced_vec(cfg, st, mb, 20, cmds, prng.fold_in(key, 2))
    seed_last = (st.base + st.log_len).amax(dim=1).numpy()
    C0 = st.commit.amax(dim=1)
    chunks, prev = [], None
    rng = np.random.default_rng(0)
    for r in range(6):
        groups = torch.from_numpy(np.sort(rng.choice(24, 6, replace=False)))
        st, mb, prev = surgery.kill_leaders(st, mb, groups, prev)
        st, mb, rec = run_ticks_traced_vec(cfg, st, mb, 40, cmds, prng.fold_in(key, 10 + r))
        chunks.append({k: v.numpy() for k, v in rec.items()})
    recs = bench_verify.concat_records(chunks)
    ref = bench_verify.latency_histogram(recs, seed_last, C0.numpy())
    assert ref["churned_groups"] > 0 and ref["unaccounted"] == 0
    ours = latency.writes(*(torch.from_numpy(recs[k]) for k in ("accepted", "ing_hi", "commit")),
                          C0, None)
    assert ours["hist_ticks"] == ref["hist_ticks"]
    assert ours["unplaced"] == 0


def fake_events():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.STRETCH_SPAN, "ts": 0.0, "dur": 100.0},
          {"ph": "X", "cat": "user_annotation", "name": "cellbench.tick", "ts": 0.0, "dur": 100.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::where", "ts": 30.0, "dur": 20.0}]
    for ts, dur, name in ((0.0, 10.0, "where_kernel"), (5.0, 10.0, "quorum_commit_kernel"),
                          (60.0, 20.0, "vote_tally_kernel"), (90.0, 5.0, "quorum_commit_kernel")):
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur})
    return ev


def test_trace_busy_idle_and_breakdown():
    s = trace.from_events(fake_events(), ticks=2)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(40e-6)  # [0,15] + [60,80] + [90,95]
    gaps = dict(s.idle_gaps())
    assert gaps["cellbench.tick / aten::where"] == pytest.approx(45e-6)  # [15,60]
    assert sum(gaps.values()) == pytest.approx(60e-6)
    assert s.top_device_ops()[0] == ["vote_tally_kernel", pytest.approx(20e-6)]
    assert [d for _, d in s.kernels("quorum_commit_kernel")] == [10.0, 5.0]
    out = SimpleNamespace(stretch=s, window=Window())
    assert manifest.reader("idle_share")(out) == pytest.approx(60.0)
    assert manifest.reader("launches_per_tick")(out) == pytest.approx(2.0)


def test_trace_without_its_span_is_refused():
    with pytest.raises(RuntimeError):
        trace.from_events(fake_events()[1:], ticks=2)


def test_a_device_only_trace_takes_its_window_from_the_device():
    kernels = [e for e in fake_events() if e["cat"] == "kernel"]
    s = trace.from_events(kernels, ticks=2, window="device")
    assert s.window == (0.0, 95.0) and not s.host_ops
    assert s.busy_s == pytest.approx(40e-6)
    out = SimpleNamespace(stretch=s, window=Window())
    assert manifest.reader("idle_share")(out) == pytest.approx(100 * (1 - 40 / 95))
    with pytest.raises(RuntimeError):
        trace.from_events([], ticks=2, window="device")


def commit_args(G=64, P=5, L=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    eff = torch.randint(0, 30, (G, P, P), generator=g, dtype=torch.int32)
    term = torch.full((G, P), 3, dtype=torch.int32)
    commit = torch.randint(0, 10, (G, P), generator=g, dtype=torch.int32)
    base = torch.zeros((G, P), dtype=torch.int32)
    log_term = torch.full((G, P, L), 3, dtype=torch.int32)
    is_leader = torch.zeros((G, P), dtype=torch.bool)
    is_leader[:, 0] = True
    return (eff, term, commit, base, base.clone(), log_term, is_leader, 3)


def test_roofline_readers_divide_bound_by_device_time():
    args = commit_args()
    tally = (torch.ones((64, 5, 5), dtype=torch.bool), torch.ones((64, 5), dtype=torch.int32),
             torch.ones((64, 5), dtype=torch.bool), 3)
    bq = roofline.commit_bound(args[:7], 3)
    bt = roofline.tally_bound(tally[:3])
    s = trace.from_events(fake_events(), ticks=2)
    s.kernel_calls = {"quorum_commit": [(1, args)], "vote_tally": [(0, tally)]}
    out = SimpleNamespace(stretch=s, kind=roofline.H100)
    q = manifest.reader("quorum_commit_roofline")(out)
    t = manifest.reader("vote_tally_roofline")(out)
    assert q == pytest.approx(100 * bq / 5e-3)  # the second launch took 5 us
    assert t == pytest.approx(100 * bt / 20e-3)
    s.kernel_calls = {}
    assert manifest.reader("quorum_commit_roofline")(out) is None
    s.kernel_calls = {"quorum_commit": [(1, args)]}
    s.device_ops = [(c, n, ts, 0.0) for c, n, ts, _ in s.device_ops]
    assert manifest.reader("quorum_commit_roofline")(out) is None  # no time read, no share


def test_bytes_per_tick_matches_the_known_figures():
    assert roofline.bytes_per_tick(100_000, 5, 112, 28) == 1_524_000_000
    assert roofline.bytes_per_tick(10_000, 3, 192, 48) == 100_560_000
