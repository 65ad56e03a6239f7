"""The port's sim↔engine conformance rig against the JAX package's, on the
CPU.

Every scenario and fuzz seed of ``tests/test_conformance.py`` passes the
port's ``run_both`` with the engine on the CPU, and the streams its two
halves produced equal the reference's: the sim's always (its run is
cheap), the engine's where the reference's engine runs here too (the
unordered scenario, whose stream order is not fixed by the rig, and a
sample of the ordered ones; the other ordered streams are each held to
``range(n_cmds)`` by both packages' ``run_both``).  The rig is not
vacuous: a scenario it cannot finish fails in each half.
"""

import pytest
import torch

import multiraft_tpu.conformance as ref_conf
import multiraft_tpu_torch.conformance as conf

torch.set_num_threads(1)

# Scenarios whose engine stream is also computed by the reference here.
REF_ENGINE = {"snapshot_pressure", "cocktail", "fuzz-202"}


def fields(sc) -> tuple:
    """A scenario as plain values, events included."""
    return tuple(
        [(e.time_s, e.kind, e.arg) for e in sc.events] if f == "events"
        else getattr(sc, f)
        for f in sc.__dataclass_fields__
    )


def check(name, sc, ref_sc, seed):
    assert fields(sc) == fields(ref_sc)
    sim, engine = conf.run_both(sc, seed=seed, device="cpu")
    assert sim == ref_conf.run_sim(ref_sc, seed=seed)
    if name in REF_ENGINE:
        assert engine == ref_conf.run_engine(ref_sc, seed=seed)
    else:
        assert engine == [list(range(sc.n_cmds))] * 2


def test_same_scenarios_as_reference():
    assert sorted(conf.SCENARIOS) == sorted(ref_conf.SCENARIOS)
    assert (conf.TICK_S, conf.RETRY_S, conf.DRAIN_S, conf.SENTINEL) == (
        ref_conf.TICK_S, ref_conf.RETRY_S, ref_conf.DRAIN_S, ref_conf.SENTINEL
    )


@pytest.mark.parametrize("name", sorted(conf.SCENARIOS))
def test_scenario_conformance(name):
    check(name, conf.SCENARIOS[name], ref_conf.SCENARIOS[name], 7)


@pytest.mark.parametrize("seed", [101, 202, 303])
def test_fuzz_conformance(seed):
    sc = conf.random_scenario(seed)
    check(sc.name, sc, ref_conf.random_scenario(seed), seed)


@pytest.mark.parametrize("seed", range(20))
def test_random_scenarios_match_reference(seed):
    assert fields(conf.random_scenario(seed)) == fields(
        ref_conf.random_scenario(seed)
    )


def test_streams_are_cross_checked_not_vacuous(monkeypatch):
    """A scenario demanding more commands than the pump can commit fails
    loudly in each half, as it does in the reference."""
    sc = conf.Scenario(name="impossible", n_cmds=10_000, heal_at_s=0.1)
    ref_sc = ref_conf.Scenario(name="impossible", n_cmds=10_000, heal_at_s=0.1)
    monkeypatch.setattr(conf, "DRAIN_S", 0.5)
    monkeypatch.setattr(ref_conf, "DRAIN_S", 0.5)
    for mod, s, kw in ((ref_conf, ref_sc, {}), (conf, sc, {"device": "cpu"})):
        with pytest.raises(mod.ConformanceError, match="sim"):
            mod.run_sim(s, seed=1)
        with pytest.raises(mod.ConformanceError, match="engine"):
            mod.run_engine(s, seed=1, **kw)


def test_engine_half_wants_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        conf.run_engine(conf.SCENARIOS["quiet"], seed=7)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        conf.run_both(conf.SCENARIOS["quiet"], seed=7)
