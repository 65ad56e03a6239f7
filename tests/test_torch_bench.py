"""The port's bench rig against the reference's, on the CPU.

``python -m multiraft_tpu_torch.bench --device cpu`` and the repository's
``bench.py`` (pinned to the CPU by ``MULTIRAFT_BENCH_PLATFORM=cpu``) run
at the shapes ``tests/test_bench_scenarios.py::test_bench_main_json_smoke``
gives the reference (G=16, config #5 at G=20 x P=5): the JSON key sets
are equal, every integer, string and null is equal (commit counts, the
latency and porcupine counts, the config-5 rebased-base count), the
wall-clock fields are only present, and the trace artifacts load with
the reference's ``scripts/trace_summary.py``.  In process, the records
each package hands to ``bench_verify``, the final planes and the stalled
sampled groups are equal.  The scenario legs (churn, snapstorm, skew, a
two-point sweep) at G <= 64 give equal counters and commit frontiers,
and ``bytes_per_tick`` equals the reference's.
"""

import gzip
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import bench as ref_bench
import multiraft_tpu.engine.bench_verify as ref_bv
from benchmarks import roofline as ref_roofline
from benchmarks import scenarios as ref_scenarios
import multiraft_tpu_torch.engine.bench_verify as bv
from multiraft_tpu_torch import bench
from multiraft_tpu_torch.benchmarks import roofline, scenarios
from multiraft_tpu_torch.engine.core import EngineConfig
from multiraft_tpu_torch.utils import prng

# Small shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the host's cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

# The reference's bench smoke shapes (tests/test_bench_scenarios.py:40-53).
SMOKE_ENV = dict(
    MULTIRAFT_BENCH_PLATFORM="cpu",
    MULTIRAFT_BENCH_G="16",
    MULTIRAFT_BENCH_CHUNK="40",
    MULTIRAFT_BENCH_CHUNKS="2",
    MULTIRAFT_BENCH_RUNS="2",
    MULTIRAFT_BENCH_SAMPLE="6",
    MULTIRAFT_BENCH_FAULTS="4",
    MULTIRAFT_BENCH_CONFIG5_G="20",
    MULTIRAFT_BENCH_CONFIG5_P="5",
    MULTIRAFT_BENCH_CONFIG5_CHUNK="40",
    MULTIRAFT_BENCH_CONFIG5_CHUNKS="2",
)


def _bench_env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("MULTIRAFT_BENCH_")}
    env.update(SMOKE_ENV, OMP_NUM_THREADS="1", **extra)
    return env


def _run(cmd, env):
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=420,
                         env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _run_both(tmp_path, **extra):
    """(reference JSON, port JSON, reference trace dir, port trace dir)."""
    dirs = [tmp_path / "ref", tmp_path / "port"]
    ref = _run([sys.executable, str(REPO / "bench.py")],
               _bench_env(MULTIRAFT_BENCH_TRACE_DIR=str(dirs[0]), **extra))
    port = _run([sys.executable, "-m", "multiraft_tpu_torch.bench", "--device", "cpu"],
                _bench_env(MULTIRAFT_BENCH_TRACE_DIR=str(dirs[1]), **extra))
    return ref, port, dirs[0], dirs[1]


def _same_values(ref, port, where=""):
    """Equal key sets; integers, strings and nulls equal; floats and
    bools (wall-clock figures and the targets gated on them) present."""
    assert set(ref) == set(port), (where, set(ref) ^ set(port))
    for k, a in ref.items():
        b = port[k]
        if isinstance(a, dict):
            _same_values(a, b, f"{where}.{k}")
        elif isinstance(a, bool) or isinstance(a, float):
            assert isinstance(b, (bool, float, int)), (where, k, b)
        elif isinstance(a, list):
            assert len(a) == len(b), (where, k)
        else:
            assert type(a) is type(b) and a == b, (where, k, a, b)


def _chunk_spans(trace_dir):
    with gzip.open(trace_dir / "trace_bench.json.gz", "rt") as f:
        events = json.load(f)["traceEvents"]
    return [(e["args"]["run"], e["args"]["chunk"], e["args"]["commits"])
            for e in events if e["ph"] == "X"]


def test_bench_json_matches_reference(tmp_path):
    from scripts.trace_summary import summarize

    ref, port, ref_dir, port_dir = _run_both(tmp_path)
    _same_values(ref, port)
    assert port["metric"] == "log_commits_per_sec_16x3_cpu"
    assert port["porcupine"] == "ok" and port["latency_unaccounted"] == 0
    assert port["faults"]["leader_kills"] > 0 and port["churned_groups"] > 0
    c5 = port["config5"]
    assert c5["latency_unaccounted"] == 0 and c5["snapshot_fastforward_replicas"] > 0
    assert c5["hot_commits_per_sec"] > c5["cold_commits_per_sec"]
    # The artifacts: one span and one counter per timed chunk, each
    # chunk's commits the reference's, and the metrics snapshot's total.
    s = summarize(str(port_dir / "trace_bench.json.gz"))
    assert s["spans"] == s["counters"] == 4
    assert s["process_names"].get(0) == "bench"
    assert s["top_spans"][0][0] == "chunk"
    assert _chunk_spans(port_dir) == _chunk_spans(ref_dir)
    snaps = [json.loads((d / "metrics_bench.json").read_text()) for d in (ref_dir, port_dir)]
    assert set(snaps[0]) == set(snaps[1]) and "chunk_rate_p50" in snaps[1]
    assert snaps[1]["commits"] == snaps[0]["commits"] > 0


def test_bench_mesh_mode_matches_reference(tmp_path):
    """``MULTIRAFT_BENCH_MESH=2``: both shard the groups over two devices
    (the reference over two virtual CPU devices), turn the faults off
    and skip config #5; the port's mesh follows the reference's mesh."""
    ref, port, ref_dir, port_dir = _run_both(
        tmp_path, MULTIRAFT_BENCH_MESH="2",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
    )
    _same_values(ref, port)
    assert "config5" not in port and port["faults"]["kill_groups"] == 0
    assert port["porcupine"] == "ok"
    assert _chunk_spans(port_dir) == _chunk_spans(ref_dir)


def _capture_verify(monkeypatch, module, seen):
    orig = module.verify_sampled_groups

    def wrapped(recs, seed_last, seed_commit, sample, final_state, cfg, **kw):
        seen.update(recs=recs, state=final_state, cfg=cfg, sample=sample)
        return orig(recs, seed_last, seed_commit, sample, final_state, cfg, **kw)

    monkeypatch.setattr(module, "verify_sampled_groups", wrapped)


@pytest.mark.parametrize("verify", ["1", "0"])
def test_bench_main_in_process_matches_reference(monkeypatch, capsys, verify):
    """Both ``main``s in this process (config #5 off): equal JSON values;
    with verification on, equal records handed to ``bench_verify``,
    equal final planes and the same sampled groups in the full-ring
    stall."""
    for k, v in dict(SMOKE_ENV, MULTIRAFT_BENCH_CONFIG5="0",
                     MULTIRAFT_BENCH_VERIFY=verify).items():
        monkeypatch.setenv(k, v)
    ref_seen, port_seen = {}, {}
    _capture_verify(monkeypatch, ref_bv, ref_seen)
    _capture_verify(monkeypatch, bv, port_seen)
    ref_bench.main()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    port = bench.main(["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == port
    _same_values(ref, port)
    if verify == "0":
        assert not ref_seen and not port_seen and "porcupine" not in port
        return
    assert set(ref_seen["recs"]) == set(port_seen["recs"])
    for k, a in ref_seen["recs"].items():
        b = port_seen["recs"][k]
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert ref_seen["sample"] == port_seen["sample"]
    ref_st = {k: np.asarray(v) for k, v in ref_seen["state"]._asdict().items()}
    port_st = {k: v.numpy() for k, v in port_seen["state"]._asdict().items()}
    assert set(ref_st) == set(port_st)
    for k in ref_st:
        np.testing.assert_array_equal(ref_st[k], port_st[k], err_msg=k)
    cfg = port_seen["cfg"]
    stalled = [bench.full_ring_stalls(st, cfg) for st in (ref_st, port_st)]
    np.testing.assert_array_equal(stalled[0], stalled[1])
    run = dict(state=port_seen["state"], sample=port_seen["sample"])
    assert bench._stalled_sampled(run, cfg) == [
        g for g in ref_seen["sample"] if stalled[0][g]
    ]


def test_config5_matches_reference_and_reports_rebased_ex_leaders(monkeypatch):
    """``run_config5`` at G=20 x P=5 (2 hot groups, 4 rounds of 60 ticks):
    the reference's integers, and every revived hot ex-leader's ring
    rebased past the last index it held when it died."""
    shape = dict(G="20", P="5", CHUNK="60", CHUNKS="4")
    for k, v in shape.items():
        monkeypatch.setenv(f"MULTIRAFT_BENCH_CONFIG5_{k}", v)
    ref = ref_bench.run_config5(False)
    detail = {}
    port = bench.run_config5(False, "cpu", detail=detail)
    _same_values(ref, port)
    assert detail["ticks"] == 200 + 60 * 5 and detail["timed_ticks"] == 240
    assert detail["commits"] > detail["hot_commits"] > 0
    assert detail["peak_bytes"] is None
    assert detail["revived_hot"], "no hot ex-leader was revived"
    for g, p, last_at_death, base in detail["revived_hot"]:
        assert g < 2 and base > last_at_death, (g, p, last_at_death, base)
    assert port["snapshot_fastforward_replicas"] >= len(detail["revived_hot"])


# -- the scenarios -------------------------------------------------------

# The sweep's group counts, cut to G <= 64 in both packages alike.
SWEEP_G = {1000: 16, 10000: 32}


def _instrument(monkeypatch, module, seen):
    """Record every commit frontier ``module`` reads, and cut the sweep's
    group counts by :data:`SWEEP_G`."""
    commits, cfg = module._commits, module._cfg

    def recording(state):
        out = commits(state)
        seen.append(np.array(out, np.int64))
        return out

    def cut(G=None, P=None, **kw):
        return cfg(G=SWEEP_G.get(G, G), P=P, **kw)

    monkeypatch.setattr(module, "_commits", recording)
    monkeypatch.setattr(module, "_cfg", cut)


@pytest.mark.parametrize("name", ["churn", "snapstorm", "skew", "sweep"])
def test_scenario_matches_reference(monkeypatch, capsys, name):
    for k, v in dict(MULTIRAFT_BENCH_G="16", MULTIRAFT_BENCH_CHUNK="60",
                     MULTIRAFT_BENCH_CHUNKS="2", MULTIRAFT_BENCH_SWEEP_MAX="10000",
                     MULTIRAFT_BENCH_SWEEP_P="3").items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("MULTIRAFT_BENCH_P", raising=False)
    ref_seen, port_seen = [], []
    _instrument(monkeypatch, ref_scenarios, ref_seen)
    _instrument(monkeypatch, scenarios, port_seen)
    ref = ref_scenarios.SCENARIOS[name]()
    port = scenarios.SCENARIOS[name](device="cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == port
    _same_values(ref, port)
    if name == "sweep":
        assert set(port["points"]) == {"G=1000,P=3", "G=10000,P=3"}
    if name == "snapstorm":
        assert port["caught_up_frac"] == ref["caught_up_frac"] == 1.0
    assert len(port_seen) == len(ref_seen) > 0
    for i, (a, b) in enumerate(zip(ref_seen, port_seen)):
        np.testing.assert_array_equal(a, b, err_msg=f"frontier read {i}")
    assert port_seen[-1].sum() > port_seen[0].sum()


# -- the roofline --------------------------------------------------------


@pytest.mark.parametrize("shape", [(10_000, 3, 192, 48), (100_000, 5, 112, 28),
                                   (16, 3, 32, 8)])
def test_bytes_per_tick_matches_reference(shape):
    for passes in (1.0, 2.0, 3.0):
        assert roofline.bytes_per_tick(*shape, passes) == ref_roofline.bytes_per_tick(
            *shape, passes)
    G, P, L, E = shape
    assert roofline.tick_bound_ms(G, P, L, E) == pytest.approx(
        roofline.bytes_per_tick(G, P, L, E, 1.0) / 3.35e12 * 1e3)


def test_roofline_measure_on_the_cpu():
    cfg = EngineConfig(G=8, P=3, L=32, E=8, INGEST=8)
    per_tick, rate = roofline.measure(cfg, n_ticks=40, reps=2, device="cpu")
    assert per_tick > 0 and rate > 0


# -- devices and names ---------------------------------------------------


def test_jitter_draw_at_config5_width_matches_jax():
    """The tick's election jitter at G=100,000 x P=5 (int64 threefry with
    32-bit masks) equals ``jax.random`` bit for bit."""
    jk, tk = jax.random.PRNGKey(11), prng.PRNGKey(11)
    for tick in (1, 257):
        jt = jax.random.fold_in(jax.random.fold_in(jk, tick), 7)
        tt = prng.fold_in(prng.fold_in(tk, tick), 7)
        want = np.asarray(jax.random.randint(jt, (100_000, 5), 30, 60))
        got = prng.randint(tt, (100_000, 5), 30, 60, torch.device("cpu"))
        np.testing.assert_array_equal(want, got.numpy())


def test_platform_pin_and_default_device(monkeypatch):
    """``MULTIRAFT_BENCH_PLATFORM=cpu`` is the CPU; no pin is the card,
    which raises where there is none."""
    monkeypatch.setenv("MULTIRAFT_BENCH_PLATFORM", "cpu")
    assert bench._device_from_env() == "cpu"
    monkeypatch.delenv("MULTIRAFT_BENCH_PLATFORM")
    assert bench._device_from_env() == "cuda"
    monkeypatch.setenv("MULTIRAFT_BENCH_PLATFORM", "tpu")
    with pytest.raises(SystemExit):
        bench._device_from_env()
    monkeypatch.delenv("MULTIRAFT_BENCH_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run_config5(True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scenarios.bench_churn()


@pytest.mark.parametrize("ref_name, port", [
    ("bench", bench), ("benchmarks.roofline", roofline),
    ("benchmarks.scenarios", scenarios),
])
def test_port_has_the_reference_functions(ref_name, port):
    import importlib

    ref = importlib.import_module(ref_name)
    names = [n for n, v in vars(ref).items()
             if inspect.isfunction(v) and v.__module__ == ref.__name__]
    assert names
    missing = [n for n in names if not callable(getattr(port, n, None))]
    assert not missing, f"{port.__name__} lacks {missing}"
