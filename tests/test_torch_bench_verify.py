"""The port's ``engine/bench_verify.py`` against the JAX package's, on the
CPU.

The reference's traced fixture (G=16, P=3, L=64, E=8, INGEST=8, seed 3;
``tests/test_bench_verify.py``) runs in both packages: the records, the
final ring and every dict ``latency_histogram`` and
``verify_sampled_groups`` return must be equal, and the reference's
negative cases (commit regression, commit past ingest, ring divergence)
must raise in the port as they do in the reference.  The smoke's
faulted, traced run (``multiraft_tpu_torch.bench.traced_run`` with its
``apply_leader_kills``) is held against the same script driven through
``bench.py``'s ``apply_leader_kills`` on the reference engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import multiraft_tpu.engine.bench_verify as ref_bv
import multiraft_tpu.engine.core as ref_core
import multiraft_tpu_torch.engine.bench_verify as bv
import multiraft_tpu_torch.engine.core as core
from multiraft_tpu_torch import bench as port_bench
from multiraft_tpu.porcupine.model import CheckResult as RefCheckResult
from multiraft_tpu_torch.porcupine.model import CheckResult
from multiraft_tpu_torch.utils import prng

torch.set_num_threads(1)

CPU = torch.device("cpu")
SHAPE = dict(G=16, P=3, L=64, E=8, INGEST=8)
PLANES = ("log_term", "base", "log_len", "role", "alive", "term", "commit")


def ref_fixture():
    cfg = ref_core.EngineConfig(**SHAPE)
    key = jax.random.PRNGKey(3)
    state = ref_core.init_state(cfg, key)
    inbox = ref_core.empty_mailbox(cfg)
    state, inbox = ref_core.run_ticks(cfg, state, inbox, 80, 0, jax.random.fold_in(key, 1))
    state, inbox = ref_core.run_ticks(
        cfg, state, inbox, 40, cfg.INGEST, jax.random.fold_in(key, 2)
    )
    seed_last = np.asarray(jnp.max(state.base + state.log_len, axis=1)).astype(np.int64)
    seed_commit = np.asarray(jnp.max(state.commit, axis=1)).astype(np.int64)
    chunks = []
    for c in range(2):
        state, inbox, rec = ref_core.run_ticks_traced(
            cfg, state, inbox, 40, cfg.INGEST, jax.random.fold_in(key, 10 + c)
        )
        chunks.append({k: np.asarray(v) for k, v in rec.items()})
    return cfg, state, ref_bv.concat_records(chunks), seed_last, seed_commit


def port_fixture():
    cfg = core.EngineConfig(**SHAPE)
    key = prng.PRNGKey(3)
    state = core.init_state(cfg, key, CPU)
    inbox = core.empty_mailbox(cfg, CPU)
    state, inbox = core.run_ticks(cfg, state, inbox, 80, 0, prng.fold_in(key, 1))
    state, inbox = core.run_ticks(cfg, state, inbox, 40, cfg.INGEST, prng.fold_in(key, 2))
    seed_last = (state.base + state.log_len).amax(dim=1).numpy().astype(np.int64)
    seed_commit = state.commit.amax(dim=1).numpy().astype(np.int64)
    chunks = []
    for c in range(2):
        state, inbox, rec = core.run_ticks_traced(
            cfg, state, inbox, 40, cfg.INGEST, prng.fold_in(key, 10 + c)
        )
        chunks.append({k: v.numpy() for k, v in rec.items()})
    return cfg, state, bv.concat_records(chunks), seed_last, seed_commit


@pytest.fixture(scope="module")
def runs():
    return ref_fixture(), port_fixture()


def same_records(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_records_and_final_ring_equal(runs):
    (_, rst, rrec, rlast, rcommit), (_, pst, prec, plast, pcommit) = runs
    assert sorted(prec) == sorted(core.TRACE_KEYS)
    same_records(rrec, prec)
    np.testing.assert_array_equal(rlast, plast)
    np.testing.assert_array_equal(rcommit, pcommit)
    assert plast.dtype == pcommit.dtype == np.int64
    for k in PLANES:
        np.testing.assert_array_equal(
            np.asarray(getattr(rst, k)), getattr(pst, k).numpy(), err_msg=k
        )


def test_latency_histogram_equal(runs):
    (_, _, rrec, rlast, rcommit), (_, _, prec, plast, pcommit) = runs
    out = bv.latency_histogram(prec, plast, pcommit)
    assert out == ref_bv.latency_histogram(rrec, rlast, rcommit)
    # The reference's own pins on this fixture (fault-free, saturated).
    assert out["p50_ticks"] == out["p99_ticks"] == 2
    assert out["entries"] > 0 and out["unaccounted"] == 0
    assert set(out["hist_ticks"]) == {2}


def test_prepared_records_equal(runs):
    (_, _, rrec, rlast, rcommit), (_, _, prec, plast, pcommit) = runs
    r = ref_bv.prepare_records(rrec, rlast, rcommit)
    p = bv.prepare_records(prec, plast, pcommit)
    np.testing.assert_array_equal(r["I"], p["I"])
    np.testing.assert_array_equal(r["C"], p["C"])
    assert p["I"].dtype == p["C"].dtype == np.int64
    np.testing.assert_array_equal(
        ref_bv.detect_churn(rrec, rlast), bv.detect_churn(prec, plast)
    )


def test_verify_sampled_groups_equal(runs):
    (rcfg, rst, rrec, rlast, rcommit), (pcfg, pst, prec, plast, pcommit) = runs
    before = dict(bv.CHECKER_PATHS)
    out = bv.verify_sampled_groups(prec, plast, pcommit, [0, 3, 7, 15], pst, pcfg)
    assert out == ref_bv.verify_sampled_groups(
        rrec, rlast, rcommit, [0, 3, 7, 15], rst, rcfg
    )
    assert out["porcupine"] == "ok" and out["groups_ok"] == 4
    assert out["ring_entries_crosschecked"] > 0
    # Each oracle group went through the native DFS.
    assert bv.CHECKER_PATHS["native"] - before["native"] == out["dfs_oracle_groups"]
    assert bv.CHECKER_PATHS["generic"] == before["generic"]


def _regress(rec):
    rec["commit"][5, 3] = rec["commit"][4, 3] - 1


def _past_ingest(rec):
    rec["commit"][:, 2] = rec["commit"][:, 2] + 10_000


@pytest.mark.parametrize("mutate,match", [
    (_regress, "regressed"), (_past_ingest, "never accepted"),
], ids=["commit_regression", "commit_past_ingest"])
def test_latency_histogram_rejects_bad_records(runs, mutate, match):
    for mod, (_, _, rec, last, commit) in zip((ref_bv, bv), runs):
        bad = {k: v.copy() for k, v in rec.items()}
        mutate(bad)
        with pytest.raises(AssertionError, match=match):
            mod.latency_histogram(bad, last, commit)


def test_ring_crosscheck_catches_divergence(runs):
    for mod, (cfg, st, rec, last, commit) in zip((ref_bv, bv), runs):
        bad = {k: v.copy() for k, v in rec.items()}
        t_hot = np.nonzero(bad["accepted"][:, 0] > 0)[0][-1]
        bad["accept_term"][t_hot, 0] += 1
        with pytest.raises(AssertionError, match="ring term"):
            mod.verify_sampled_groups(bad, last, commit, [0], st, cfg)


def test_unique_order_and_dfs_match_reference():
    rng = np.random.default_rng(5)
    for trial in range(30):
        n = int(rng.integers(2, 40 if trial % 2 == 0 else 8))
        calls = np.sort(rng.uniform(0, 50, n))
        rets = np.maximum.accumulate(calls + rng.uniform(0.5, 10, n))
        if trial % 2 == 1:
            i = int(rng.integers(0, n - 1))
            calls[i], rets[i] = rets[i + 1] + 1.0, rets[i + 1] + 2.0
        fast, conc = bv._check_unique_order(calls, rets)
        rfast, rconc = ref_bv._check_unique_order(calls, rets)
        assert (fast.name, conc) == (rfast.name, rconc)
        dfs, depth = bv._check_group_history(
            list(range(100, 100 + n)), calls, rets, 0, 60, 30.0
        )
        rdfs, rdepth = ref_bv._check_group_history(
            list(range(100, 100 + n)), calls, rets, 0, 60, 30.0
        )
        assert (dfs.name, depth) == (rdfs.name, rdepth)
        assert fast is dfs
        if trial % 2 == 1:
            assert fast is CheckResult.ILLEGAL and rfast is RefCheckResult.ILLEGAL


# -- the smoke's faulted, traced run against bench.py's ------------------------

FAULTED = dict(chunk=40, n_chunks=3, n_fault=6, n_sample=8, seed=7)


def ref_faulted_run(cfg, chunk, n_chunks, n_fault, n_sample, seed):
    """``bench.py``'s staging and kills on the reference engine, at the
    shape and counts given."""
    key = jax.random.PRNGKey(seed)
    state = ref_core.init_state(cfg, key)
    inbox = ref_core.empty_mailbox(cfg)
    state, inbox = ref_core.run_ticks(cfg, state, inbox, chunk, 0, jax.random.fold_in(key, 1))
    state, inbox = ref_core.run_ticks(
        cfg, state, inbox, chunk, cfg.INGEST, jax.random.fold_in(key, 2)
    )
    state, inbox, _ = ref_core.run_ticks_traced(
        cfg, state, inbox, chunk, cfg.INGEST, jax.random.fold_in(key, 3)
    )
    seed_last = np.asarray(jnp.max(state.base + state.log_len, axis=1)).astype(np.int64)
    seed_commit = np.asarray(jnp.max(state.commit, axis=1)).astype(np.int64)
    sample, kill_gs = port_bench.bench_victims(cfg.G, n_fault, n_sample)
    prev = bench._NO_KILLS
    chunks = []
    for c in range(n_chunks):
        if c > 0:
            state, inbox, prev = bench.apply_leader_kills(state, inbox, kill_gs, prev)
        state, inbox, rec = ref_core.run_ticks_traced(
            cfg, state, inbox, chunk, cfg.INGEST, jax.random.fold_in(key, 10 + c)
        )
        chunks.append({k: np.asarray(v) for k, v in rec.items()})
    return dict(chunks=chunks, seed_last=seed_last, seed_commit=seed_commit,
                state=state, sample=sample)


def test_faulted_traced_run_matches_bench():
    cfg = core.EngineConfig(use_kernels=True, **SHAPE)
    port = port_bench.traced_run(cfg, "cpu", **FAULTED)
    ref = ref_faulted_run(ref_core.EngineConfig(**SHAPE), **FAULTED)
    assert port["sample"] == ref["sample"]
    assert port["n_kills"] > 0
    same_records(ref_bv.concat_records(ref["chunks"]), bv.concat_records(port["chunks"]))
    for k in PLANES:
        np.testing.assert_array_equal(
            np.asarray(getattr(ref["state"], k)), getattr(port["state"], k).numpy(),
            err_msg=k,
        )
    got = port_bench.verify_run(port, cfg)
    recs = ref_bv.concat_records(ref["chunks"])
    prep = ref_bv.prepare_records(recs, ref["seed_last"], ref["seed_commit"])
    assert got["lat"] == ref_bv.latency_histogram(
        recs, ref["seed_last"], ref["seed_commit"], prep=prep
    )
    assert got["porc"] == ref_bv.verify_sampled_groups(
        recs, ref["seed_last"], ref["seed_commit"], ref["sample"], ref["state"],
        ref_core.EngineConfig(**SHAPE), prep=prep,
    )
    assert got["lat"]["churned_groups"] > 0 and got["lat"]["unaccounted"] == 0
    assert got["porc"]["porcupine"] == "ok"
    assert got["paths"] == {"native": got["porc"]["dfs_oracle_groups"], "generic": 0}


def test_bench_victims_match_bench():
    """The port's sample and kill set are ``bench.py``'s formulas."""
    for G, n_fault, n_sample in ((10_000, 48, 128), (64, 8, 16), (16, 6, 8)):
        sample, kills = port_bench.bench_victims(G, n_fault, n_sample)
        assert sample == [int(g) for g in sorted(set(np.linspace(0, G - 1, n_sample, dtype=int)))]
        assert kills.dtype == np.int64 and len(set(kills.tolist())) == len(kills)
        assert len(set(kills.tolist()) & set(sample)) == min(n_fault // 2, len(sample))
