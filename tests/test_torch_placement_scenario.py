"""The port's placement scenario (``scripts/placement_scenario.py``) against
the reference's, on the CPU.

At the quick shapes with ``device="cpu"`` each variant returns the
reference's output keys from the same arguments, with the same
deterministic fields (counts of acknowledged writes, the fleet's shape)
and the scenario's own acceptance (no acknowledged write lost, the
failover inside its deadline).  The controller-crash replacement mirrors
``tests/test_selfheal.py::test_selfheal_scenario_controller_crash_resumes``
and is ``slow`` as that test is.
"""

import json

import pytest
import torch

import scripts.placement_scenario as ref_ps
from multiraft_tpu_torch.scripts import placement_scenario as ps

# Small shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the host's cores.
torch.set_num_threads(1)

SAME = ("acked_writes", "lost_acked_writes", "procs", "groups_per_proc",
        "seed", "ship_window_s", "ship_sync")


def test_keys_by_gid_is_the_references():
    from multiraft_tpu.harness.fleet import InProcessFleet as RefFleet
    from multiraft_tpu_torch.harness.fleet import InProcessFleet

    ours = InProcessFleet([[1], [2]], spare_slots=1, seed=3, device="cpu")
    ref = RefFleet([[1], [2]], spare_slots=1, seed=3)
    for fleet in (ours, ref):
        for g in (1, 2):
            fleet.admin("join", [g])
        fleet.settle()
    assert ps.keys_by_gid(ours) == ref_ps.keys_by_gid(ref)


@pytest.mark.timeout_s(180)
def test_durable_failover_returns_the_references_result():
    ours = ps.run_durable(3, 2, 0, True, device="cpu")
    ref = ref_ps.run_durable(3, 2, 0, True)
    assert set(ours) == set(ref)
    for k in SAME:
        assert ours[k] == ref[k], k
    assert ours["lost_acked_writes"] == 0 and ours["durable_failover_s"] < 60.0
    assert ours["ship_recoveries"] >= 1
    assert all(h[4] == "failover" for h in ours["history"])


@pytest.mark.timeout_s(180)
def test_main_durable_quick_exits_0_with_the_result(tmp_path, capsys):
    out = tmp_path / "placement.json"
    rc = ps.main(["--durable", "--quick", "--device", "cpu", "--out", str(out)])
    assert rc == 0
    doc = json.loads(out.read_text())
    assert doc["lost_acked_writes"] == 0 and doc["durable_failover_s"] < 60.0
    assert f"wrote {out}" in capsys.readouterr().out


@pytest.mark.timeout_s(180)
def test_rebalance_and_failover_return_the_references_keys():
    ours = ps.run(3, 2, 0, True, device="cpu")
    ref = ref_ps.run(3, 2, 0, True)
    assert set(ours) == set(ref)
    for k in ("procs", "groups_per_proc", "seed"):
        assert ours[k] == ref[k], k
    assert ours["failover_replace_s"] < 60.0
    assert sorted(ours["placement"]) == sorted(ref["placement"])


def test_the_scenario_wants_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ps.run_durable(1, 1, 0, True)


@pytest.mark.slow
@pytest.mark.timeout_s(600)
def test_selfheal_scenario_controller_crash_resumes():
    result = ps.run_replace(2, 1, seed=13, quick=True, crash_controller=True,
                            device="cpu")
    assert result["lost_acked_writes"] == 0
    assert result["reconfig_completed"] == 1
    assert result["crashed_at_phase"] in ("learner", "catchup", "joint")
    assert len([h for h in result["history"]
                if h[4] == "replace-replica"]) == 1
