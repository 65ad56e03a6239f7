"""Self-healing replica sets on the port: the placement controller's
replace-dead-replica policy (``distributed/placement.py``) driving the
engine's joint-consensus membership change, with the engines on the
CPU.

* The reference's unit cases of ``tests/test_selfheal.py`` on the port:
  the healer (learner → catch-up → joint → promote), crash-resume from
  the replicated two-phase intent, the intent's survival of the map's
  own leader dying, the wedge watchdog's reconfig/sealed exemption, and
  the doctor's degraded-quorum anomaly.
* Parity: the same fleet seed, the same kill and the same injected
  clock through both packages give the same heal — every CONFIG
  record, every recorded intent phase, every replica config after
  every controller round, the store's history and the metrics — also
  when the first controller is abandoned mid-reconfig.
* The reference's two slow socket scenarios (``-m slow``), on the card
  when there is one.
"""

from __future__ import annotations

import time
import types

import numpy as np
import pytest
import torch

from multiraft_tpu_torch.distributed import flightrec
from multiraft_tpu_torch.distributed.placement import (
    LocalPlacementStore,
    PlacementController,
)
from multiraft_tpu_torch.distributed.wedge import WedgeWatch
from multiraft_tpu_torch.harness.fleet import (
    InProcessFleet,
    LocalFleetTransport,
    PlacementMap,
)
from multiraft_tpu_torch.utils.metrics import Metrics

pytestmark = pytest.mark.timeout_s(420)


# ---------------------------------------------------------------------------
# Harness
# ---------------------------------------------------------------------------


class _Rec:
    """Record-collecting stand-in for the flight recorder."""

    def __init__(self):
        self.records = []

    def record(self, etype, code=0, a=0, b=0, c=0, tag=""):
        self.records.append(
            {"type": etype, "code": code, "a": a, "b": b, "c": c,
             "tag": tag}
        )


class _Obs:
    """Metrics-only observability stand-in for the controller."""

    def __init__(self):
        self.metrics = Metrics()


def _fleet(seed=3, device="cpu"):
    """Two-instance fleet, P=4 replica slots, voters {0,1,2} — slot 3
    is the spare seat every heal promotes into."""
    fleet = InProcessFleet([[101, 102], [103]], spare_slots=1,
                           seed=seed, replicas=4, voters=[0, 1, 2],
                           device=device)
    for g in (101, 102, 103):
        fleet.admin("join", [g])
    fleet.settle()
    return fleet


def _controller(fleet, store, clock, dead_s=1.0, obs=None, rec=None):
    tr = LocalFleetTransport(fleet)
    return PlacementController(
        tr, store, scrape_s=0.0, dead_s=dead_s, cooldown_s=0.0,
        min_gain=10.0, max_moves=0, obs=obs,
        recorder=rec if rec is not None else _Rec(),
        clock=lambda: clock[0],
    ), tr


def _heal_loop(fleet, ctl, store, clock, gid, dead_p, rounds=80,
               step_s=0.5):
    """Step controller + fleet until the intent completes and the
    config settles without ``dead_p``; returns the settled config."""
    tr = ctl.transport
    for _ in range(rounds):
        clock[0] += step_s
        ctl.step()
        fleet.pump_all(6)
        if store.reconfig_intents().get(gid) is not None:
            continue
        cfg = tr.replica_config(fleet.proc_of(gid), gid)
        if (cfg is not None and not cfg["joint"]
                and dead_p not in cfg["voters_old"]):
            return cfg
    raise AssertionError(
        f"gid {gid} never healed: intents={store.reconfig_intents()} "
        f"cfg={tr.replica_config(fleet.proc_of(gid), gid)}"
    )


def _seed_writes(fleet, n=6):
    ck = fleet.clerk()
    data = {f"k{i}": f"v{i}" for i in range(n)}
    for k, v in data.items():
        ck.put(k, v)
    return ck, data


# ---------------------------------------------------------------------------
# The healer: learner → catch-up → joint → promote
# ---------------------------------------------------------------------------


def test_heal_replaces_dead_voter():
    """Kill one (non-leader) voter replica permanently: the controller
    begins a replicated intent, seats slot 3 as a learner, promotes it
    through the joint phase, and the config settles at the swapped
    voter set — with CONFIG flight records for every phase, the
    reconfig.* metric trail, timing stats, and a replace-replica
    history entry.  No acked write is lost."""
    fleet = _fleet()
    ck, data = _seed_writes(fleet)
    store = LocalPlacementStore({101: 0, 102: 0, 103: 1})
    clock = [0.0]
    obs, rec = _Obs(), _Rec()
    ctl, tr = _controller(fleet, store, clock, obs=obs, rec=rec)

    lead = tr.replica_config(0, 101)["peer"]
    victim = next(q for q in (0, 1, 2) if q != lead)
    assert fleet.kill_replica(101, victim)
    cfg = _heal_loop(fleet, ctl, store, clock, 101, victim)

    assert cfg["voters_old"] == sorted({0, 1, 2, 3} - {victim})
    assert cfg["voters_old"] == cfg["voters_new"]
    tags = [r["tag"] for r in rec.records
            if r["type"] == flightrec.CONFIG and r["code"] == 101]
    assert tags == ["learner", "catchup", "joint", "done"]
    for key in ("reconfig.begun", "reconfig.joint_entered",
                "reconfig.completed"):
        assert obs.metrics.counters[key] == 1, key
    assert "reconfig.aborted" not in obs.metrics.counters
    stats = ctl.replace_stats[101]
    assert stats["degraded_quorum_window_s"] >= stats["replace_replica_s"]
    assert any(h[4] == "replace-replica" and h[1] == 101
               for h in store.history)
    # The swap never touched the other groups.
    assert tr.replica_config(0, 102)["voters_old"] == [0, 1, 2]
    for k, v in data.items():
        assert ck.get(k) == v
    ck.put("post", "heal")
    assert ck.get("post") == "heal"


def test_heal_replaces_dead_leader():
    """Killing the group's LEADER replica forces an election among the
    surviving voters first; the healer then runs against the new
    leader and the group ends at the swapped voter set."""
    fleet = _fleet(seed=11)
    ck, data = _seed_writes(fleet)
    store = LocalPlacementStore({101: 0, 102: 0, 103: 1})
    clock = [0.0]
    ctl, tr = _controller(fleet, store, clock)

    victim = tr.replica_config(0, 101)["peer"]
    assert fleet.kill_replica(101, victim)
    fleet.pump_all(30)  # ride out the election
    cfg = _heal_loop(fleet, ctl, store, clock, 101, victim)
    assert cfg["voters_old"] == sorted({0, 1, 2, 3} - {victim})
    for k, v in data.items():
        assert ck.get(k) == v


def test_no_spare_slot_skips_heal():
    """All P slots are voters (the legacy shape): a dead voter has no
    seat to heal into — the policy counts reconfig.no_spare and leaves
    the config alone rather than halving the quorum further."""
    fleet = InProcessFleet([[201], [202]], spare_slots=1, seed=7,
                           device="cpu")
    for g in (201, 202):
        fleet.admin("join", [g])
    fleet.settle()
    store = LocalPlacementStore({201: 0, 202: 1})
    clock = [0.0]
    obs = _Obs()
    ctl, tr = _controller(fleet, store, clock, obs=obs)

    assert fleet.kill_replica(201, 2)
    for _ in range(8):
        clock[0] += 0.5
        ctl.step()
        fleet.pump_all(4)
    assert store.reconfig_intents() == {}
    assert obs.metrics.counters["reconfig.no_spare"] >= 1
    assert "reconfig.begun" not in obs.metrics.counters
    cfg = None
    for _ in range(30):  # ride out the election if the leader died
        cfg = tr.replica_config(0, 201)
        if cfg is not None:
            break
        fleet.pump_all(6)
    assert cfg is not None and cfg["voters_old"] == [0, 1, 2]


def test_learner_death_mid_catchup_aborts_then_retries():
    """The joining learner dying mid-catch-up can never close the gap:
    the intent aborts (reconfig.aborted + CONFIG "abort" record), and
    a later round re-seats the seat with a fresh incarnation and
    completes."""
    fleet = _fleet(seed=19)
    store = LocalPlacementStore({101: 0, 102: 0, 103: 1})
    clock = [0.0]
    obs, rec = _Obs(), _Rec()
    ctl, tr = _controller(fleet, store, clock, obs=obs, rec=rec)

    lead = tr.replica_config(0, 101)["peer"]
    victim = next(q for q in (0, 1, 2) if q != lead)
    assert fleet.kill_replica(101, victim)
    # First scrape stamps the dead voter; the next step past dead_s
    # begins the intent and seats learner 3.
    clock[0] += 0.5
    ctl.step()
    clock[0] += 1.5
    ctl.step()
    intent = store.reconfig_intents().get(101)
    assert intent is not None and intent[1] == 3
    # Kill the learner before it can catch up (no pumps in between).
    assert fleet.kill_replica(101, 3)
    clock[0] += 0.5
    ctl.step()          # scrape records the learner's death...
    clock[0] += 1.5
    ctl.step()          # ...past dead_s: the intent aborts
    assert obs.metrics.counters["reconfig.aborted"] >= 1
    assert any(r["tag"] == "abort" for r in rec.records
               if r["type"] == flightrec.CONFIG)
    # A later round re-seats the (revived) spare and heals fully.
    cfg = _heal_loop(fleet, ctl, store, clock, 101, victim)
    assert victim not in cfg["voters_old"]
    assert 3 in cfg["voters_old"]


# ---------------------------------------------------------------------------
# Crash-resume: the two-phase intent is the source of truth
# ---------------------------------------------------------------------------


def test_controller_crash_mid_reconfig_successor_resumes():
    """Abandon the controller once the replicated intent reaches
    "catchup" (its in-memory ledgers die with it).  A successor built
    from nothing but the store + transport must RESUME the recorded
    intent — ending with exactly one replace-replica history entry and
    one settled config, never a forked membership."""
    fleet = _fleet(seed=23)
    ck, data = _seed_writes(fleet)
    store = LocalPlacementStore({101: 0, 102: 0, 103: 1})
    clock = [0.0]
    ctl, tr = _controller(fleet, store, clock)

    lead = tr.replica_config(0, 101)["peer"]
    victim = next(q for q in (0, 1, 2) if q != lead)
    assert fleet.kill_replica(101, victim)
    for _ in range(40):
        clock[0] += 0.5
        ctl.step()
        fleet.pump_all(4)
        intent = store.reconfig_intents().get(101)
        if intent is not None and intent[2] in ("catchup", "joint"):
            break
    else:
        raise AssertionError("intent never reached a mid-reconfig phase")

    successor, _ = _controller(fleet, store, clock)
    cfg = _heal_loop(fleet, successor, store, clock, 101, victim)
    assert cfg["voters_old"] == sorted({0, 1, 2, 3} - {victim})
    entries = [h for h in store.history if h[4] == "replace-replica"]
    assert len(entries) == 1
    # Every live replica of the group agrees on the settled config —
    # the no-fork check.
    health = fleet.instances[0].replica_health(101)
    for q in cfg["voters_old"]:
        view = fleet.instances[0].config_of_gid(101)
        assert view["voters_old"] == cfg["voters_old"]
    assert health["joint"] is False
    # The successor has no t0 for the crashed intent: stats are
    # skipped, never fabricated.
    assert 101 not in successor.replace_stats
    for k, v in data.items():
        assert ck.get(k) == v


def test_resume_reissues_joint_entry_lost_with_killed_leader():
    """The killed-leader hazard: the intent records "joint" but the
    leader died before replicating the C_old,new entry — the entry is
    LOST, not pending.  The resuming controller must detect "not
    joint, dead peer still a voter" and RE-ISSUE begin_joint rather
    than waiting forever."""
    fleet = _fleet(seed=31)
    store = LocalPlacementStore({101: 0, 102: 0, 103: 1})
    clock = [0.0]
    ctl, tr = _controller(fleet, store, clock)

    lead = tr.replica_config(0, 101)["peer"]
    victim = next(q for q in (0, 1, 2) if q != lead)
    assert fleet.kill_replica(101, victim)
    # Seat + catch up the learner by hand, then record the intent as
    # already-"joint" WITHOUT ever appending the joint entry — exactly
    # the state a begin_joint-then-SIGKILLed leader leaves behind.
    assert tr.add_learner(0, 101, 3)
    for _ in range(60):
        fleet.pump_all(4)
        m = tr.learner_match(0, 101, 3)
        if m is not None and m[0] >= m[1]:
            break
    store.rbegin(101, victim, 3)
    store.rphase(101, "catchup")
    store.rphase(101, "joint")
    assert tr.replica_config(0, 101)["joint"] is False  # entry "lost"

    cfg = _heal_loop(fleet, ctl, store, clock, 101, victim)
    assert cfg["voters_old"] == sorted({0, 1, 2, 3} - {victim})
    assert not store.reconfig_intents()


def test_reconfig_intent_survives_map_leader_kill():
    """The intent lives on the placement RSM: killing the map's Raft
    leader mid-reconfig loses nothing — the next verb pumps the
    survivors through an election and the intent reads back intact."""
    pmap = PlacementMap(n=3, seed=5, initial={301: 0})
    try:
        pmap.rbegin(301, 1, 3)
        pmap.rphase(301, "catchup")
        assert pmap.kill_leader() is not None
        assert pmap.reconfig_intents() == {301: (1, 3, "catchup")}
        pmap.rphase(301, "joint")
        assert pmap.reconfig_intents()[301][2] == "joint"
        pmap.rdone(301)
        assert pmap.reconfig_intents() == {}
        _, _, _, history = pmap.query()
        assert any(h[4] == "replace-replica" and h[1] == 301
                   for h in history)
    finally:
        pmap.cleanup()


# ---------------------------------------------------------------------------
# Wedge watchdog: reconfig/sealed exemption (satellite of the healer —
# a group intentionally paused mid-heal must not read as wedged)
# ---------------------------------------------------------------------------


class _Ctl:
    """ObsControl stand-in with scriptable membership columns."""

    def __init__(self, commit, backlog, reconfig=None, sealed=None):
        self.commit = list(commit)
        self.backlog = np.asarray(backlog, np.int64)
        self.reconfig = reconfig
        self.sealed = sealed

    def groups(self):
        out = {
            "G": len(self.commit),
            "commit": list(self.commit),
            "leader": [0] * len(self.commit),
            "term": [1] * len(self.commit),
        }
        if self.reconfig is not None:
            out["reconfig"] = list(self.reconfig)
        if self.sealed is not None:
            out["sealed"] = list(self.sealed)
        return out

    def _engine_kv(self):
        return types.SimpleNamespace(
            driver=types.SimpleNamespace(backlog=self.backlog)
        )


def _node(rec=None):
    return types.SimpleNamespace(
        sched=types.SimpleNamespace(call_after=lambda *_a, **_k: None),
        obs=types.SimpleNamespace(metrics=Metrics()),
        _frec=rec,
        _closed=False,
    )


def _watch(node, ctl, stall_ticks=3):
    w = WedgeWatch(node, interval=999.0, stall_ticks=stall_ticks)
    w._ctl = ctl
    return w


def test_wedge_exempts_reconfiguring_group():
    """A stalled group with pending backlog but an active reconfig is
    NOT a wedge (its commit may legitimately freeze while the joint
    phase waits on both quorums); once the reconfig flag clears, the
    stall counter restarts from zero."""
    node = _node(_Rec())
    ctl = _Ctl(commit=[5, 9], backlog=[4, 0], reconfig=[True, False])
    w = _watch(node, ctl, stall_ticks=2)
    for _ in range(6):
        assert w.check() == 0
    assert node.obs.metrics.counters["wedge.reconfig_exempt"] >= 6
    assert w.wedged == set()
    # Reconfig done, group still stalled: NOW it counts as a wedge —
    # but only after a fresh stall_ticks run (exemption reset the
    # counter to zero, so the trip needs stall_ticks more scrapes).
    ctl.reconfig = [False, False]
    assert w.check() == 0
    assert w.check() == 1
    assert w.wedged == {0}


def test_wedge_exempts_sealed_group_and_clears_wedged_flag():
    """Sealing a group that was ALREADY declared wedged clears it from
    the wedged set (migration freeze supersedes the wedge verdict)."""
    node = _node(_Rec())
    ctl = _Ctl(commit=[7], backlog=[3])
    w = _watch(node, ctl, stall_ticks=2)
    w.check()
    w.check()
    assert w.check() == 1
    assert w.wedged == {0}
    ctl.sealed = [True]
    assert w.check() == 0
    assert w.wedged == set()


# ---------------------------------------------------------------------------
# Postmortem doctor: the "degraded quorum" anomaly from CONFIG records
# ---------------------------------------------------------------------------


def _config_rec(seq, ts, gid=5, dead=1, new=3, epoch=2, phase="learner"):
    return {
        "seq": seq, "ts": ts, "type": flightrec.CONFIG,
        "type_name": "config", "code": gid, "a": dead, "b": new,
        "c": epoch, "tag": phase,
    }


def _doctor_bundle(records, windows=(), clean_close=True):
    ring = {
        "pid": 321, "name": "ctl", "wall_t0": 0.0, "slots": 64,
        "records": list(records), "torn": 0,
        "clean_close": clean_close, "path": "ctl.ring",
    }
    return {
        "dir": ".",
        "manifest": {
            "idents": {"h:1": {"pid": 321}},
            "offsets_us": {"h:1": 0.0},
        },
        "snapshots": {}, "windows": list(windows), "rings": [ring],
        "skipped": [],
    }


def test_postmortem_clean_reconfig_is_not_an_anomaly():
    """A reconfig that runs learner → done inside the deadline is the
    healer WORKING; the doctor must stay quiet about it (but still
    summarize it in the process section)."""
    from multiraft_tpu_torch.analysis.postmortem import analyze, build_report

    recs = [
        _config_rec(1, 1_000_000.0, phase="learner"),
        _config_rec(2, 1_500_000.0, phase="catchup"),
        _config_rec(3, 2_000_000.0, phase="joint"),
        _config_rec(4, 2_500_000.0, phase="done"),
    ]
    bundle = _doctor_bundle(recs)
    analysis = analyze(bundle)
    assert not [a for a in analysis["anomalies"]
                if a["kind"] == "degraded_quorum"]
    report = build_report(bundle, analysis)
    assert "reconfig: group 5 voter 1 → peer 3" in report


def test_postmortem_flags_open_reconfig_on_controller_death():
    """CONFIG records that stop at "joint" on an uncleanly-dead ring →
    a degraded-quorum anomaly anchored on the reconfig's onset, naming
    the group, the lost voter, and the resume obligation — plus the
    covering nemesis fault window when one exists."""
    from multiraft_tpu_torch.analysis.postmortem import analyze

    windows = [{"kind": "kill_mesh_process", "p": {"proc": 0},
                "procs": [0], "t_start_us": 900_000.0,
                "t_stop_us": 950_000.0}]
    recs = [
        _config_rec(1, 1_000_000.0, phase="learner"),
        _config_rec(2, 1_500_000.0, phase="catchup"),
        _config_rec(3, 2_000_000.0, phase="joint"),
    ]
    analysis = analyze(_doctor_bundle(recs, windows, clean_close=False))
    hits = [a for a in analysis["anomalies"]
            if a["kind"] == "degraded_quorum"]
    assert len(hits) == 1
    a = hits[0]
    assert a["ts"] == 1_000_000.0
    assert "group 5" in a["detail"] and "voter 1" in a["detail"]
    assert "still open" in a["detail"]
    assert "successor must resume" in a["detail"]
    assert "kill_mesh_process" in a["detail"]


def test_postmortem_flags_reconfig_past_deadline(monkeypatch):
    """Even a reconfig that eventually completed is flagged when the
    group sat on a reduced quorum past MRT_PLACE_REPLACE_DEADLINE_S —
    the doctor reads the same knob the healer budgets against."""
    from multiraft_tpu_torch.analysis.postmortem import analyze

    monkeypatch.setenv("MRT_PLACE_REPLACE_DEADLINE_S", "2.0")
    recs = [
        _config_rec(1, 1_000_000.0, phase="learner"),
        _config_rec(2, 4_500_000.0, phase="done"),
    ]
    hits = [a for a in analyze(_doctor_bundle(recs))["anomalies"]
            if a["kind"] == "degraded_quorum"]
    assert len(hits) == 1
    assert "> deadline 2s" in hits[0]["detail"]
    # Within the default 30s budget the same trail is clean.
    monkeypatch.delenv("MRT_PLACE_REPLACE_DEADLINE_S")
    assert not [a for a in analyze(_doctor_bundle(recs))["anomalies"]
                if a["kind"] == "degraded_quorum"]


# ---------------------------------------------------------------------------
# Acceptance (slow / nightly): socket fleet + nemesis kill_replica +
# porcupine, then the scripted r03 crash-resume scenario
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Parity: the same heal, step for step, in both packages
# ---------------------------------------------------------------------------


def _heal_trail(pkg, seed, crash):
    """One heal under an injected clock through ``pkg``'s fleet and
    controller; returns everything the control plane did, per round."""
    import importlib

    fl = importlib.import_module(f"{pkg}.harness.fleet")
    pl = importlib.import_module(f"{pkg}.distributed.placement")
    mt = importlib.import_module(f"{pkg}.utils.metrics")
    kw = {"device": "cpu"} if pkg == "multiraft_tpu_torch" else {}
    fleet = fl.InProcessFleet([[101, 102], [103]], spare_slots=1, seed=seed,
                              replicas=4, voters=[0, 1, 2], **kw)
    for g in (101, 102, 103):
        fleet.admin("join", [g])
    fleet.settle()
    ck = fleet.clerk()
    for i in range(4):
        ck.put(f"k{i}", f"v{i}")
    store = pl.LocalPlacementStore({101: 0, 102: 0, 103: 1})
    clock = [0.0]
    obs = types.SimpleNamespace(metrics=mt.Metrics())
    rec = _Rec()

    def make():
        return pl.PlacementController(
            fl.LocalFleetTransport(fleet), store, scrape_s=0.0, dead_s=1.0,
            cooldown_s=0.0, min_gain=10.0, max_moves=0, obs=obs,
            recorder=rec, clock=lambda: clock[0],
        )

    ctl = make()
    tr = ctl.transport
    victim = tr.replica_config(0, 101)["peer"]
    assert fleet.kill_replica(101, victim)
    trail, crashed = [], False
    for _ in range(80):
        clock[0] += 0.5
        n = ctl.step()
        fleet.pump_all(6)
        intents = store.reconfig_intents()
        trail.append((n, intents, tr.replica_config(0, 101)))
        if crash and not crashed and intents.get(101, (0, 0, ""))[2] in (
            "catchup", "joint"
        ):
            ctl, crashed = make(), True
        if not intents and trail[-1][2] and not trail[-1][2]["joint"] and (
            victim not in trail[-1][2]["voters_old"]
        ):
            break
    reads = [ck.get(f"k{i}") for i in range(4)]
    return (trail, rec.records, list(store.history),
            dict(obs.metrics.counters), reads, dict(ctl.replace_stats))


@pytest.mark.parametrize("seed,crash", [(3, False), (11, False), (23, True)])
def test_heal_sequence_equals_the_reference(seed, crash):
    ref = _heal_trail("multiraft_tpu", seed, crash)
    ours = _heal_trail("multiraft_tpu_torch", seed, crash)
    names = ("trail", "records", "history", "counters", "reads", "stats")
    for name, a, b in zip(names, ref, ours):
        assert a == b, name
    tags = [r["tag"] for r in ours[1] if r["type"] == flightrec.CONFIG]
    assert tags[-1] == "done" and "joint" in tags
    assert ours[4] == [f"v{i}" for i in range(4)]


# ---------------------------------------------------------------------------
# Acceptance (slow): socket fleet + nemesis kill_replica + porcupine,
# then the crash-resume scenario
# ---------------------------------------------------------------------------

# The slow scenarios run their engines on the card when there is one.
_DEVICE = "cuda" if torch.cuda.is_available() else "cpu"


@pytest.mark.slow
@pytest.mark.timeout_s(600)
def test_selfheal_chaos_kill_replica_zero_acked_loss():
    """The acceptance scenario over real sockets: a PlacedFleet with
    spare replica slots takes concurrent clerk load while the nemesis
    permanently kills one group's leader replica mid-run; the
    controller replaces it via joint consensus within the replace
    deadline, no acked write is lost, and the clerk history stays
    linearizable."""
    import time as _time

    from multiraft_tpu_torch.distributed.placement import place_knobs
    from multiraft_tpu_torch.harness.fleet import PlacedFleet
    from multiraft_tpu_torch.harness.nemesis import (
        Nemesis,
        make_schedule,
        run_clerk_load,
    )
    from multiraft_tpu_torch.porcupine.kv import kv_model
    from multiraft_tpu_torch.porcupine.visualization import (
        assert_linearizable,
    )

    fleet = PlacedFleet(
        [[1], [2]], spare_slots=1, seed=29, chaos_seed=43,
        replicas=4, voters=[0, 1, 2], device=_DEVICE,
        controller_kwargs=dict(
            scrape_s=0.3, dead_s=2.0, cooldown_s=5.0,
            min_gain=10.0, max_moves=0,
        ),
    )
    try:
        fleet.start()
        for g in (1, 2):
            fleet.admin("join", [g])
        tr = fleet.controller.transport
        victim_gid = 1
        cfg0 = tr.replica_config(0, victim_gid)
        victim_peer = int(cfg0["peer"])

        addrs = [(fleet.cluster.host, p) for p in fleet.cluster.ports]
        schedule = make_schedule(
            seed=41, n_procs=2, duration_s=6.0, include=("delay",),
            kill_replicas=[(victim_gid, victim_peer)],
        )
        nem = Nemesis(addrs, kill_replica=fleet.kill_replica)
        nem_thread = nem.run_async(schedule)
        history = run_clerk_load(
            fleet.clerk, keys=["sa", "sb", "sc"],
            n_workers=3, ops_per_worker=9, op_timeout=120.0,
        )
        nem_thread.join(timeout=120.0)
        assert nem.error is None, nem.error
        nem.verify_windows()

        deadline = _time.monotonic() + 120.0
        cfg = None
        while _time.monotonic() < deadline:
            cfg = tr.replica_config(0, victim_gid)
            if (cfg is not None and not cfg["joint"]
                    and victim_peer not in cfg["voters_old"]
                    and not fleet.pmap.reconfig_intents()):
                break
            _time.sleep(0.25)
        assert cfg is not None and victim_peer not in cfg["voters_old"], (
            cfg, fleet.pmap.reconfig_intents()
        )
        stats = fleet.controller.replace_stats.get(victim_gid)
        assert stats is not None
        assert (stats["replace_replica_s"]
                < place_knobs()["replace_deadline_s"])
        assert any(h[4] == "replace-replica"
                   for h in fleet.pmap.query()[3])
        assert_linearizable(
            kv_model, history, timeout=60.0, name="selfheal-chaos"
        )
    finally:
        fleet.shutdown()


@pytest.mark.slow
@pytest.mark.timeout_s(600)
def test_selfheal_scenario_controller_crash_resumes():
    """The crash-resume acceptance of the reference's scripted
    self-healing scenario (its ``--replace --crash-controller`` run at
    2 instances x 1 group, seed 13): the controller is killed
    mid-reconfig and a successor finishes from the replicated intent —
    one completed replacement, zero acked-write loss."""
    from multiraft_tpu_torch.distributed.observe import Observability
    from multiraft_tpu_torch.services.shardkv import key2shard

    fleet = InProcessFleet([[1], [2]], spare_slots=1, seed=13, replicas=4,
                           voters=[0, 1, 2], device=_DEVICE)
    for g in (1, 2):
        fleet.admin("join", [g])
    fleet.settle()
    obs = Observability(name="selfheal")
    clerk = fleet.clerk()
    cfg = fleet.instances[0].query_latest()
    kmap = {f"{chr(ord('a') + i % 26)}{i}": cfg.shards[key2shard(
        f"{chr(ord('a') + i % 26)}{i}")] for i in range(200)}
    transport = LocalFleetTransport(fleet)
    store = LocalPlacementStore({1: 0, 2: 1})

    def make_controller():
        return PlacementController(
            transport, store, obs=obs, scrape_s=0.0, dead_s=1.0,
            cooldown_s=0.0, min_gain=10.0, max_moves=0,
        )

    controller = make_controller()
    expected = {}
    for r in range(2):
        for k in list(kmap)[:8]:
            clerk.append(k, f"w{r},")
            expected[k] = expected.get(k, "") + f"w{r},"
    controller.scrape()
    fleet.pump_all(2)
    controller.scrape()
    victim_gid, victim_proc = 1, fleet.proc_of(1)
    victim_peer = int(transport.replica_config(victim_proc, 1)["peer"])
    assert fleet.kill_replica(victim_gid, victim_peer)
    crashed_at, healed = None, None
    deadline = time.perf_counter() + 90.0
    while time.perf_counter() < deadline:
        controller.step()
        fleet.pump_all(4)
        intents = store.reconfig_intents()
        if crashed_at is None and victim_gid in intents:
            crashed_at = intents[victim_gid][2]
            controller = make_controller()
            continue
        if victim_gid not in intents:
            c = transport.replica_config(fleet.proc_of(1), 1)
            if c is not None and not c["joint"] and (
                victim_peer not in c["voters_old"]
            ):
                healed = c
                break
    assert healed is not None, "replica never replaced"
    for g in (1, 2):
        k = next(k for k, kg in kmap.items() if kg == g)
        clerk.put(k, expected.get(k, "") + "post")
        expected[k] = expected.get(k, "") + "post"
    lost = sum(1 for k, v in expected.items() if clerk.get(k) != v)
    assert lost == 0
    assert obs.metrics.counters.get("reconfig.completed", 0) == 1
    assert crashed_at in ("learner", "catchup", "joint")
    assert len([h for h in store.history
                if h[4] == "replace-replica"]) == 1
