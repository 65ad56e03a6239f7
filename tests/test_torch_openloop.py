"""The port's open-loop load generator and load-curve script against the
reference's, on the CPU.

* ``gen_schedule`` equals ``benchmarks/openloop.py``'s exactly in every
  arrival mode for several seeds and rates; ``ZipfKeys`` draws the same
  keys and ``rate_at`` gives the same rates.
* ``sweep`` at a tiny shape (G=16, two rungs of half a second, the
  porcupine sampler on) against a ``serve-kv --device cpu`` child returns
  the reference sweep's keys, per report and per step, with every
  scheduled arrival sent and a linearizable sampled history.
* ``multiraft_tpu_torch.scripts.loadcurve`` writes its rounds under the
  port's ``build/rounds/`` (here a temporary directory) and gates
  ``--compare`` through the port's ``bench_compare``.
"""

import json
import random
import threading
import time

import pytest
import torch

from benchmarks import openloop as ref_ol
from multiraft_tpu.distributed.native import native_available
from multiraft_tpu_torch.benchmarks import openloop as ol

# Small shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the host's cores.
torch.set_num_threads(1)

needs_native = pytest.mark.skipif(
    not native_available(), reason="native transport did not build"
)

# The sweep's tiny ladder: the same arguments go to both packages.
TINY = dict(rates=[40.0, 80.0], step_s=0.5, groups=16, drain_s=0.5)


@pytest.mark.parametrize("mode", ol.ARRIVAL_MODES)
@pytest.mark.parametrize("seed,rate,duration", [
    (7, 250.0, 4.0), (1007, 1200.0, 1.5), (8007, 60.0, 2.0),
])
def test_gen_schedule_equals_the_reference(mode, seed, rate, duration):
    ours = ol.gen_schedule(seed, rate, duration, mode=mode)
    assert ours and ours == ref_ol.gen_schedule(seed, rate, duration, mode=mode)
    assert [a[0] for a in ours] == sorted(a[0] for a in ours)
    assert all(0.0 <= a[0] < duration for a in ours)


@pytest.mark.parametrize("kw", [
    dict(keyspace=7, zipf_s=0.8, get_frac=0.5, append_frac=0.1),
    dict(keyspace=4096, zipf_s=1.4, burst_factor=2.0, burst_cycle=0.25,
         burst_duty=0.5),
])
@pytest.mark.parametrize("mode", ol.ARRIVAL_MODES)
def test_gen_schedule_options_equal_the_reference(mode, kw):
    assert ol.gen_schedule(11, 700.0, 1.0, mode=mode, **kw) == (
        ref_ol.gen_schedule(11, 700.0, 1.0, mode=mode, **kw)
    )


@pytest.mark.parametrize("n,s", [(1, 1.1), (512, 1.1), (97, 0.5), (3000, 2.0)])
def test_zipf_keys_equal_the_reference(n, s):
    ours, ref = ol.ZipfKeys(n, s), ref_ol.ZipfKeys(n, s, prefix="olk")
    assert ours._cdf == ref._cdf
    a, b = random.Random(n), random.Random(n)
    assert [ours.pick(a) for _ in range(500)] == [ref.pick(b) for _ in range(500)]


@pytest.mark.parametrize("mode", ol.ARRIVAL_MODES)
def test_rate_at_equals_the_reference(mode):
    for i in range(200):
        t = i * 0.037
        for kw in ({}, dict(burst_factor=3.0, burst_cycle=0.5, burst_duty=0.25)):
            assert ol.rate_at(mode, t, 4.0, 900.0, **kw) == (
                ref_ol.rate_at(mode, t, 4.0, 900.0, **kw)
            )
    with pytest.raises(ValueError):
        ol.rate_at("sawtooth", 0.0, 1.0, 1.0)


def test_default_ladder_is_the_references():
    assert ol.DEFAULT_RATES == ref_ol.DEFAULT_RATES
    assert ol.ARRIVAL_MODES == ref_ol.ARRIVAL_MODES


def test_sweep_wants_the_card_by_default(monkeypatch):
    """No ``device`` means the card: the cluster is asked for ``cuda``."""
    import multiraft_tpu_torch.distributed.engine_cluster as ec

    seen = {}

    class Refuse(ec.EngineProcessCluster):
        def start(self):
            seen["device"] = self.spec["device"]
            raise RuntimeError("no card here")

    monkeypatch.setattr(ec, "EngineProcessCluster", Refuse)
    with pytest.raises(RuntimeError, match="no card here"):
        ol.sweep(**TINY)
    assert seen["device"] == "cuda"


class _LateClerk:
    """A blocking clerk over one shared dict whose first Append is applied
    and then reported as a timeout: the request reached the server, its
    reply did not reach the clerk in time."""

    lock = threading.Lock()
    store: dict = {}
    appends = 0

    def __init__(self, port, host="127.0.0.1", lane=""):
        pass

    def append(self, key, value, timeout=30.0):
        cls = type(self)
        with cls.lock:
            cls.store[key] = cls.store.get(key, "") + value
            cls.appends += 1
            late = cls.appends == 1
        if late:
            raise TimeoutError("cluster did not answer in time")

    def get(self, key, timeout=30.0):
        with type(self).lock:
            return type(self).store.get(key, "")

    def close(self):
        pass


def _sample_with_a_late_append(monkeypatch, cluster_module, sampler_cls):
    clerk = type("Late", (_LateClerk,), {"store": {}, "appends": 0})
    monkeypatch.setattr(cluster_module, "BlockingEngineClerk", clerk)
    sampler = sampler_cls("127.0.0.1", 1, period_s=0.01).start()
    time.sleep(0.3)
    return sampler


def test_a_timed_out_append_stays_open_in_the_sampled_history(monkeypatch):
    """The port's sampler keeps an Append whose reply came too late with an
    open return, so a later Get that sees its tag linearizes; the
    reference's drops it and reads the same run as a violation."""
    import multiraft_tpu.distributed.engine_cluster as ref_ec
    import multiraft_tpu_torch.distributed.engine_cluster as ec

    ours = _sample_with_a_late_append(monkeypatch, ec, ol.PorcupineSampler)
    res = ours.finish()
    assert res["porcupine"] == "ok" and ours.open_appends == 1
    assert sum(op.ret == float("inf") for op in ours.history) == 1
    assert res["verifier_ops"] == len(ours.history) > 3
    ref = _sample_with_a_late_append(monkeypatch, ref_ec, ref_ol.PorcupineSampler)
    with pytest.raises(AssertionError, match="not linearizable"):
        ref.finish()


@needs_native
@pytest.mark.timeout_s(240)
def test_sweep_returns_the_reference_keys():
    ours = ol.sweep(**TINY, device="cpu")
    ref = ref_ol.sweep(**TINY)
    assert set(ours) == set(ref), set(ours) ^ set(ref)
    assert len(ours["steps"]) == len(ref["steps"]) == 2
    for a, b in zip(ours["steps"], ref["steps"]):
        assert set(a) == set(b), set(a) ^ set(b)
        # The same schedule went out: same seed, rate and step.
        assert a["sent"] == b["sent"] and a["offered_rate"] == b["offered_rate"]
        assert a["drops"] == 0 and a["ok"] == a["sent"], a
    assert set(ours["curve"]) == set(ref["curve"])
    assert ours["porcupine"] == "ok" and ours["verifier_ops"] > 0
    for k in ("mode", "seed", "step_s", "keyspace", "p99_target_ms"):
        assert ours[k] == ref[k], k


@needs_native
@pytest.mark.timeout_s(240)
def test_loadcurve_script_records_and_compares_in_the_ports_rounds(
    tmp_path, monkeypatch, capsys
):
    from multiraft_tpu_torch.scripts import bench_compare, loadcurve

    rounds = tmp_path / "rounds"
    monkeypatch.setattr(bench_compare, "ROUNDS_DIR", str(rounds))
    monkeypatch.setattr(loadcurve, "ROUNDS_DIR", str(rounds))
    assert loadcurve.next_round_path() == str(rounds / "LOADCURVE_r01.json")
    argv = ["--rates", "40", "--step-s", "0.5", "--device", "cpu"]
    monkeypatch.setattr(ol, "sweep", _tiny_sweep(ol.sweep))
    # No round yet: --compare has no history and says so (exit 2), and
    # the report still lands as the first round.
    assert loadcurve.main(argv + ["--compare"]) == 2
    first = json.loads((rounds / "LOADCURVE_r01.json").read_text())
    assert first["porcupine"] == "ok" and len(first["steps"]) == 1
    assert loadcurve.next_round_path() == str(rounds / "LOADCURVE_r02.json")
    # Past a 1000% threshold the gate passes against the first round;
    # its table and exit code come from the port's gate.
    rc = loadcurve.main(argv + ["--compare", "--threshold", "1000"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "max sustainable ops/s" in out and " r01.json" in out
    assert "within 1000.0% of LOADCURVE_r01.json" in out
    assert sorted(p.name for p in rounds.iterdir()) == [
        "LOADCURVE_r01.json", "LOADCURVE_r02.json",
    ]


def _tiny_sweep(sweep):
    def tiny(**kw):
        kw["groups"] = 16
        kw["drain_s"] = 0.5
        return sweep(**kw)
    return tiny
