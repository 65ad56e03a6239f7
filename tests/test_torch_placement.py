"""The port's placement layer (``distributed/placement.py``,
``harness/fleet.py``).

* The reference's unit cases of ``tests/test_placement.py`` on the
  port: the pure planner ``plan_moves``, the replicated
  ``PlacementMap``, the controller against a scripted fake transport,
  real group migration through the in-process fleet (engines on the
  CPU), and the PLACE flight records the doctor reads.
* Parity with the reference on the same inputs (numpy-seeded, exact):
  ``plan_moves`` on random placements, loads, alive sets, cooldowns and
  excludes; both packages' ``PlacementMap`` driven through one verb
  script on one sim seed (every query answer, the replicas' Raft logs
  and the network's counters), a leader killed mid-intent included;
  and the controller over the fake transport under an injected clock
  (the same calls, moves, PLACE records and store history).
"""

from __future__ import annotations

import time
import types

import numpy as np
import pytest
import torch

from multiraft_tpu_torch.distributed.placement import (
    LocalPlacementStore,
    PlacementController,
    place_knobs,
    plan_moves,
)


class TestPlanMoves:
    def test_failover_bypasses_cooldown_cap_and_hysteresis(self):
        placement = {1: 0, 2: 0, 3: 0}  # proc 0 is dead
        moves = plan_moves(
            placement, {1: 1.0, 2: 1.0, 3: 1.0}, alive=[1, 2],
            min_gain=10.0,            # hysteresis would veto anything
            cooldown_s=1e9,           # cooldown would veto anything
            last_moved={1: 0.0, 2: 0.0, 3: 0.0}, now_s=0.0,
            max_moves=0,              # cap would veto anything
        )
        assert len(moves) == 3
        assert all(src is None and reason == "failover"
                   for _, src, _, reason in moves)
        assert {dst for _, _, dst, _ in moves} <= {1, 2}

    def test_hysteresis_blocks_marginal_gain(self):
        # 3 vs 2: rebalancing one unit gains only 1/1 of a spread of 1
        # — but with min_gain past the achievable reduction, no move.
        placement = {1: 0, 2: 0, 3: 0, 4: 1, 5: 1}
        loads = {g: 1.0 for g in placement}
        veto = plan_moves(placement, loads, [0, 1],
                          min_gain=0.99, cooldown_s=0.0, max_moves=5)
        assert veto == []

    def test_voluntary_move_when_gain_clears_hysteresis(self):
        placement = {1: 0, 2: 0, 3: 0, 4: 0}
        loads = {1: 4.0, 2: 4.0, 3: 4.0, 4: 4.0}
        moves = plan_moves(placement, loads, [0, 1],
                           min_gain=0.25, cooldown_s=0.0, max_moves=8)
        assert moves
        assert all(r == "rebalance" for *_, r in moves)

    def test_cooldown_pins_recently_moved_groups(self):
        placement = {1: 0, 2: 0, 3: 0, 4: 0}
        loads = {g: 4.0 for g in placement}
        moves = plan_moves(
            placement, loads, [0, 1], min_gain=0.1, cooldown_s=5.0,
            last_moved={g: 99.0 for g in placement}, now_s=100.0,
            max_moves=8,
        )
        assert moves == []  # all moved 1s ago, cooldown 5s

    def test_max_moves_caps_voluntary_only(self):
        placement = {g: 0 for g in range(1, 9)}
        loads = {g: 1.0 for g in placement}
        moves = plan_moves(placement, loads, [0, 1],
                           min_gain=0.1, cooldown_s=0.0, max_moves=1)
        assert len(moves) == 1

    def test_exclude_pins_inflight_groups(self):
        placement = {1: 0, 2: 0, 3: 0, 4: 0}
        loads = {g: 4.0 for g in placement}
        moves = plan_moves(placement, loads, [0, 1],
                           min_gain=0.1, cooldown_s=0.0, max_moves=8,
                           exclude={1, 2, 3, 4})
        assert moves == []

    def test_no_alive_procs_is_a_noop(self):
        assert plan_moves({1: 0}, {1: 1.0}, []) == []

    def test_knobs_resolve_from_env(self, monkeypatch):
        monkeypatch.setenv("MRT_PLACE_MIN_GAIN", "0.5")
        monkeypatch.setenv("MRT_PLACE_MAX_MOVES", "3")
        k = place_knobs()
        assert k["min_gain"] == 0.5 and int(k["max_moves"]) == 3
        monkeypatch.setenv("MRT_PLACE_MIN_GAIN", "banana")
        assert place_knobs()["min_gain"] == 0.25  # default on parse error


# ---------------------------------------------------------------------------
# PlacementMap: the replicated placement RSM
# ---------------------------------------------------------------------------



class TestPlacementMap:
    def test_map_verbs_and_two_phase_intents(self):
        from multiraft_tpu_torch.harness.fleet import PlacementMap

        pmap = PlacementMap(n=3, seed=5, initial={1: 0, 2: 1})
        try:
            version, placement, pending, history = pmap.query()
            assert placement == {1: 0, 2: 1} and not pending
            v0 = version

            pmap.begin(2, 0, "rebalance")
            _, _, pending, _ = pmap.query()
            assert pending == {2: (0, "rebalance", False)}

            pmap.dispatch(2)
            _, _, pending, _ = pmap.query()
            assert pending == {2: (0, "rebalance", True)}

            v1 = pmap.commit(2)
            version, placement, pending, history = pmap.query()
            assert v1 > v0
            assert placement == {1: 0, 2: 0} and not pending
            assert tuple(history[-1])[1:] == (2, 1, 0, "rebalance")

            pmap.begin(1, 1, "rebalance")
            pmap.abort(1)
            version, placement, pending, _ = pmap.query()
            assert not pending and placement == {1: 0, 2: 0}
            assert version == v1  # abort bumps nothing
        finally:
            pmap.cleanup()

    def test_map_survives_its_own_leader_dying_mid_intent(self):
        from multiraft_tpu_torch.harness.fleet import PlacementMap

        pmap = PlacementMap(n=3, seed=6, initial={1: 0, 2: 1, 3: 1})
        try:
            pmap.begin(3, 0, "rebalance")
            killed = pmap.kill_leader()
            assert killed is not None
            # The intent (and the map) survive the leader: the next
            # verbs elect a new one and read the same replicated state.
            _, placement, pending, _ = pmap.query()
            assert pending == {3: (0, "rebalance", False)}
            assert placement == {1: 0, 2: 1, 3: 1}
            pmap.commit(3)
            _, placement, pending, _ = pmap.query()
            assert placement[3] == 0 and not pending
        finally:
            pmap.cleanup()


# ---------------------------------------------------------------------------
# PlacementController vs a scripted fake transport
# ---------------------------------------------------------------------------


class FakeTransport:
    """Dict-backed fleet: ``hosted[proc]`` is the gid set; scripted
    per-gid loads; knobs to fail adopts and kill processes."""

    def __init__(self, n, hosted, loads=None):
        self._n = n
        self.hosted = {p: set(g) for p, g in hosted.items()}
        self.loads = dict(loads or {})
        self.down: set = set()
        self.fail_adopt: set = set()
        self.calls: list = []
        self.pushes: list = []

    @property
    def n_procs(self):
        return self._n

    def addr(self, proc):
        return ("fake", proc)

    def ping(self, proc):
        return proc not in self.down

    def groups(self, proc):
        if proc in self.down:
            return None
        gids = sorted(self.hosted.get(proc, ()))
        return {
            "G": len(gids) + 1,
            "gids": [-1] + gids,
            "commit_rate": [0.0] + [self.loads.get(g, 0.0) for g in gids],
        }

    def pull_group(self, proc, gid):
        self.calls.append(("pull", proc, gid))
        if proc in self.down or gid not in self.hosted.get(proc, ()):
            return None
        return {"gid": gid, "blob": True}

    def unseal_group(self, proc, gid, force=False):
        self.calls.append(("unseal", proc, gid))

    def adopt_group(self, proc, gid, blob):
        self.calls.append(("adopt", proc, gid))
        if proc in self.down or gid in self.fail_adopt:
            return False
        self.hosted.setdefault(proc, set()).add(gid)
        return True

    def drop_group(self, proc, gid):
        self.calls.append(("drop", proc, gid))
        if proc not in self.down:
            self.hosted.get(proc, set()).discard(gid)
        return True

    def push_placement(self, proc, version, addr_map):
        self.pushes.append((proc, version, dict(addr_map)))
        return proc not in self.down


def make_controller(transport, store, **kw):
    kw.setdefault("scrape_s", 0.0)
    kw.setdefault("dead_s", 2.0)
    kw.setdefault("cooldown_s", 0.0)
    kw.setdefault("min_gain", 0.1)
    kw.setdefault("max_moves", 1)
    return PlacementController(transport, store, **kw)


class TestControllerFakeFleet:
    def test_skew_triggers_one_bounded_move(self):
        tr = FakeTransport(2, {0: {1, 2, 3}, 1: set()},
                           loads={1: 5.0, 2: 5.0, 3: 5.0})
        store = LocalPlacementStore({1: 0, 2: 0, 3: 0})
        ctl = make_controller(tr, store)
        assert ctl.step() == 1  # max_moves bounds the round
        _, placement, pending, history = store.query()
        assert not pending
        moved = [g for g, p in placement.items() if p == 1]
        assert len(moved) == 1
        assert history[-1][4] == "rebalance"
        # seal → adopt → drop, in order, for the moved gid.
        g = moved[0]
        assert [c for c in tr.calls if c[2] == g] == [
            ("pull", 0, g), ("adopt", 1, g), ("drop", 0, g)
        ]
        assert tr.pushes and tr.pushes[-1][1] == store.version

    def test_dead_process_failover_is_empty_adoption(self):
        clock = types.SimpleNamespace(t=100.0)
        tr = FakeTransport(2, {0: {1}, 1: {2}}, loads={1: 1.0, 2: 1.0})
        store = LocalPlacementStore({1: 0, 2: 1})
        ctl = make_controller(tr, store, clock=lambda: clock.t)
        ctl.step()
        tr.down.add(0)
        clock.t += 5.0  # past dead_s
        ctl.step()
        assert 0 in ctl.dead
        _, placement, pending, history = store.query()
        assert placement == {1: 1, 2: 1} and not pending
        assert history[-1][4] == "failover"
        # Dead source: no pull, no drop — adopt-empty only.
        assert ("pull", 0, 1) not in tr.calls[3:]
        adopts = [c for c in tr.calls if c[0] == "adopt" and c[2] == 1]
        assert adopts == [("adopt", 1, 1)]

    def test_failed_adopt_leaves_intent_pending_and_never_unseals(self):
        tr = FakeTransport(2, {0: {1, 2, 3}, 1: set()},
                           loads={1: 5.0, 2: 5.0, 3: 5.0})
        store = LocalPlacementStore({1: 0, 2: 0, 3: 0})
        ctl = make_controller(tr, store)
        tr.fail_adopt = {1, 2, 3}
        assert ctl.step() == 0
        _, placement, pending, _ = store.query()
        assert len(pending) == 1  # the begun intent survived
        (gid, (dst, reason, dispatched)), = pending.items()
        # The adopt RPC flew before it failed — the intent records that.
        assert dispatched
        assert placement[gid] == 0 and dst == 1
        # The adopt reply may have been lost, not the adopt — the
        # controller must NOT unseal the source.
        assert all(c[0] != "unseal" for c in tr.calls)
        # Next round: the pending intent resumes and completes.
        tr.fail_adopt = set()
        assert ctl.step() >= 1
        _, placement, pending, _ = store.query()
        assert placement[gid] == 1 and gid not in pending

    def test_pending_intent_with_dead_dst_unseals_src_and_aborts(self):
        clock = types.SimpleNamespace(t=100.0)
        tr = FakeTransport(2, {0: {1, 2}, 1: set()},
                           loads={1: 1.0, 2: 1.0})
        store = LocalPlacementStore({1: 0, 2: 0})
        # A predecessor controller began the migration, then both it
        # and the destination died before any leg ran.
        store.begin(1, 1, "rebalance")
        tr.down.add(1)
        ctl = make_controller(tr, store, min_gain=10.0,
                              clock=lambda: clock.t)
        clock.t += 5.0  # past dead_s: the dst is declared dead
        ctl.step()
        _, placement, pending, _ = store.query()
        assert not pending and placement[1] == 0
        assert ("unseal", 0, 1) in tr.calls

    def test_dead_stays_dead_even_if_it_answers_again(self):
        clock = types.SimpleNamespace(t=0.0)
        tr = FakeTransport(2, {0: {1}, 1: {2}}, loads={1: 1.0, 2: 1.0})
        store = LocalPlacementStore({1: 0, 2: 1})
        ctl = make_controller(tr, store, clock=lambda: clock.t)
        ctl.step()
        tr.down.add(0)
        clock.t += 5.0
        ctl.step()
        assert 0 in ctl.dead
        tr.down.discard(0)  # zombie: starts answering pings again
        clock.t += 1.0
        ctl.step()
        assert 0 in ctl.dead  # declared dead is forever
        _, placement, _, _ = store.query()
        assert placement == {1: 1, 2: 1}


# ---------------------------------------------------------------------------
# In-process fleet: real group migration through BatchedShardKV
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def two_proc_fleet():
    from multiraft_tpu_torch.harness.fleet import InProcessFleet

    fleet = InProcessFleet([[1], [2]], spare_slots=1, seed=3, device="cpu")
    fleet.admin("join", [1])
    fleet.admin("join", [2])
    fleet.settle()
    return fleet


class TestInProcessFleetMigration:
    def test_live_migration_preserves_data_dedup_and_serving(self):
        from multiraft_tpu_torch.harness.fleet import (
            InProcessFleet,
            LocalFleetTransport,
        )

        fleet = InProcessFleet([[1], [2]], spare_slots=1, seed=1, device="cpu")
        fleet.admin("join", [1])
        fleet.admin("join", [2])
        fleet.settle()
        clerk = fleet.clerk()
        clerk.put("a", "1")
        clerk.append("a", "2")
        clerk.put("b", "x")

        store = LocalPlacementStore({1: 0, 2: 1})
        ctl = make_controller(LocalFleetTransport(fleet), store)
        store.begin(2, 0, "test")
        assert ctl._execute(2, 1, 0, "test", [0, 1])
        assert fleet.proc_of(2) == 0
        # Data moved with the group; dedup state too (same client id
        # re-appending with a fresh command id still applies once).
        assert clerk.get("a") == "12"
        clerk.append("a", "3")
        assert clerk.get("a") == "123"
        assert clerk.get("b") == "x"
        _, placement, pending, _ = store.query()
        assert placement == {1: 0, 2: 0} and not pending

    def test_empty_adoption_after_kill_serves_immediately(self):
        from multiraft_tpu_torch.harness.fleet import (
            InProcessFleet,
            LocalFleetTransport,
        )

        fleet = InProcessFleet([[1], [2]], spare_slots=1, seed=2, device="cpu")
        fleet.admin("join", [1])
        fleet.admin("join", [2])
        fleet.settle()
        clerk = fleet.clerk()
        clerk.put("a", "keep")     # gid of "a" per config
        clerk.put("b", "survivor")

        store = LocalPlacementStore({1: 0, 2: 1})
        ctl = make_controller(LocalFleetTransport(fleet), store)
        fleet.kill(1)
        ctl.dead.add(1)
        # Failover: adopt-empty onto proc 0; the group's data died with
        # the process (crash model) but the group serves again at the
        # LATEST config — writes work immediately, no wedged BEPULLING.
        for _ in range(5):
            ctl.step()
            _, placement, pending, _ = store.query()
            if not pending and placement[2] == 0:
                break
        assert placement == {1: 0, 2: 0}
        cfg = fleet.instances[0].query_latest()
        from multiraft_tpu_torch.services.shardkv import key2shard

        for key in ("a", "b", "q"):
            clerk.put(key, f"post-{key}")
            assert clerk.get(key) == f"post-{key}", (
                key, cfg.shards[key2shard(key)]
            )

    def test_controller_loop_rebalances_scraped_skew(self, two_proc_fleet):
        from multiraft_tpu_torch.harness.fleet import LocalFleetTransport

        fleet = two_proc_fleet
        clerk = fleet.clerk()
        cfg = fleet.instances[0].query_latest()
        from multiraft_tpu_torch.services.shardkv import key2shard

        keys = [f"{chr(ord('a') + i)}{i}" for i in range(26)]
        by_gid = {}
        for k in keys:
            by_gid.setdefault(cfg.shards[key2shard(k)], []).append(k)

        store = LocalPlacementStore({1: 0, 2: 1})
        tr = LocalFleetTransport(fleet)
        ctl = make_controller(tr, store, min_gain=0.1)
        # Both groups start on proc 0 → proc 1 idles.
        store.begin(2, 0, "setup")
        assert ctl._execute(2, 1, 0, "setup", [0, 1])
        # Two scrape windows of real load so rates are fresh deltas.
        for _ in range(2):
            for g, ks in by_gid.items():
                for k in ks:
                    clerk.append(k, ".")
            ctl.scrape()
            time.sleep(0.01)
        moved = 0
        for _ in range(4):
            for g, ks in by_gid.items():
                for k in ks:
                    clerk.append(k, ".")
            moved += ctl.step()
            if moved:
                break
        assert moved >= 1
        _, placement, _, history = store.query()
        assert sorted(placement.values()) == [0, 1]  # spread back out
        assert history[-1][4] == "rebalance"
        # The transport records the placement push for re-routing.
        assert tr.last_push[0] == store.version


# ---------------------------------------------------------------------------
# Observability: PLACE records, doctor anomaly, trace summary
# ---------------------------------------------------------------------------


class TestPlaceObservability:
    def _ring_with_places(self, tmp_path, moves):
        from multiraft_tpu_torch.distributed import flightrec

        rec = flightrec.FlightRecorder(
            str(tmp_path / "ctl.ring"), slots=256, name="controller"
        )
        for gid, src, dst, version in moves:
            rec.record(
                flightrec.PLACE, code=gid, a=src, b=dst, c=version,
                tag="rebalance",
            )
        rec.close()
        return str(tmp_path / "ctl.ring")

    def test_controller_emits_place_records(self, tmp_path, monkeypatch):
        from multiraft_tpu_torch.distributed import flightrec

        monkeypatch.setenv("MRT_FLIGHTREC_DIR", str(tmp_path))
        rec = flightrec.get_recorder(name="ctl")
        tr = FakeTransport(2, {0: {1, 2, 3}, 1: set()},
                           loads={1: 5.0, 2: 5.0, 3: 5.0})
        store = LocalPlacementStore({1: 0, 2: 0, 3: 0})
        ctl = make_controller(tr, store, recorder=rec)
        assert ctl.step() == 1
        rec.close()
        ring = flightrec.read_ring(rec.path)
        places = [r for r in ring["records"]
                  if r["type"] == flightrec.PLACE]
        assert len(places) == 1
        r = places[0]
        assert r["a"] == 0 and r["b"] == 1 and r["tag"] == "rebalance"

    def test_doctor_flags_placement_thrash(self, tmp_path):
        from multiraft_tpu_torch.analysis import postmortem

        # Group 7 ping-pongs 4 times back-to-back: thrash.  Group 8
        # moves once: healthy.
        ring = self._ring_with_places(tmp_path, [
            (7, 0, 1, 1), (7, 1, 0, 2), (7, 0, 1, 3), (7, 1, 0, 4),
            (8, 0, 1, 5),
        ])
        bundle = postmortem.load_bundle(ring)
        analysis = postmortem.analyze(bundle)
        kinds = [a["kind"] for a in analysis["anomalies"]]
        assert "placement_thrash" in kinds
        thrash = [a for a in analysis["anomalies"]
                  if a["kind"] == "placement_thrash"]
        assert len(thrash) == 1 and "group 7" in thrash[0]["detail"]
        proc = analysis["procs"][0]
        assert proc["placements"] == {7: 4, 8: 1}

    def test_doctor_trace_has_placement_instants(self, tmp_path):
        from multiraft_tpu_torch.analysis import postmortem

        ring = self._ring_with_places(tmp_path, [(7, 0, 1, 1)])
        bundle = postmortem.load_bundle(ring)
        tracer = postmortem.rings_to_trace(bundle)
        inst = [e for e in tracer.events
                if e.get("ph") == "i" and e["name"].startswith("place:")]
        assert len(inst) == 1
        assert inst[0]["args"]["group"] == 7
        assert inst[0]["args"]["src"] == 0 and inst[0]["args"]["dst"] == 1



def test_map_bootstraps_after_its_leader_and_snapshots_its_log():
    """The port's two map options (harness/fleet.py): the whole map is
    written once the map's Raft has a leader, and replicas given a
    ``maxraftstate`` compact their logs into snapshots.  The answers
    are those of a map without either, and a replica restarted from
    its persister reads the snapshot back."""
    from multiraft_tpu_torch.harness.fleet import PlacementMap

    initial = {g: g % 3 for g in range(1, 61)}
    plain = PlacementMap(n=3, seed=4, initial=initial)
    small = PlacementMap(n=3, seed=4, maxraftstate=2048)
    try:
        small.wait_leader()
        assert small.leader() is not None
        small.set_map(initial)
        for pm in (plain, small):
            for g in range(1, 21):
                pm.begin(g, (g + 1) % 3, "rebalance")
                pm.dispatch(g)
                pm.commit(g)
            pm.rbegin(7, 1, 3)
        assert plain.query() == small.query()
        assert plain.reconfig_intents() == small.reconfig_intents()
        assert small.cluster.snapshot_size() > 0
        assert small.cluster.log_size() < plain.cluster.log_size() / 4
        killed = small.kill_leader()
        small.restart_replica(killed)
        small.rphase(7, "joint")
        assert small.reconfig_intents() == {7: (1, 3, "joint")}
        assert small.query()[1] == plain.query()[1]
    finally:
        plain.cleanup()
        small.cleanup()


def test_failover_waits_for_an_unanswered_standby_probe():
    """Deviation from the reference (ROADMAP queue C): a failover whose
    standby probe went unanswered picks no destination while the silent
    process lives, for as long as it stays silent, then recovers at the
    standby once it answers; once the silent process is itself declared
    dead, the failover goes on among the rest (here an empty adoption,
    the reference's pick at once)."""
    clock = types.SimpleNamespace(t=100.0)

    class ProbedFleet(FakeTransport):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.silent = set()
            self.recovered = []

        def standby_state(self, proc, gid):
            if proc in self.silent:
                raise TimeoutError(proc)
            if proc == 2:
                return {"token": "0.x", "snap_seq": 1, "tail_seq": 3,
                        "ts": 5.0, "has_snap": True}
            return None

        def recover_group(self, proc, gid):
            if proc != 2:
                return "empty"  # no shipped state there
            self.recovered.append((proc, gid))
            self.hosted.setdefault(proc, set()).add(gid)
            return "recovered"

    for late in (False, True):
        tr = ProbedFleet(3, {0: {1}, 1: {2}, 2: set()},
                         loads={1: 1.0, 2: 1.0})
        store = LocalPlacementStore({1: 0, 2: 1})
        ctl = make_controller(tr, store, clock=lambda: clock.t)
        ctl.step()
        tr.down.add(0)
        tr.silent.add(2)  # the standby holding gid 1's state is slow
        clock.t += 5.0
        ctl.step()
        assert 0 in ctl.dead
        assert store.query()[1][1] == 0 and not tr.recovered  # waited
        clock.t += 60.0  # no timeout: a live silent standby is waited for
        ctl.step()
        assert store.query()[1][1] == 0 and not tr.recovered
        if late:
            tr.down.add(2)  # the silent standby dies in turn
            clock.t += 5.0
            ctl.step()
            assert 2 in ctl.dead
        else:
            tr.silent.clear()
        clock.t += 1.0
        ctl.step()
        _, placement, pending, _ = store.query()
        assert not pending
        if late:
            assert placement[1] == 1 and not tr.recovered
            assert ("adopt", 1, 1) in tr.calls  # adopted empty
        else:
            assert placement[1] == 2 and tr.recovered == [(2, 1)]

# ---------------------------------------------------------------------------
# Full placement chaos: sockets + SIGKILL + porcupine (slow), on the card
# when there is one
# ---------------------------------------------------------------------------

_DEVICE = "cuda" if torch.cuda.is_available() else "cpu"


@pytest.mark.slow
@pytest.mark.timeout_s(600)
def test_placement_chaos_kill_mesh_process_replaces_and_serves(tmp_path):
    """The acceptance scenario over real sockets: a PlacedFleet (fleet
    processes + replicated map + controller thread) takes clerk load
    while the nemesis SIGKILLs one mesh process mid-run; every one of
    the victim's groups is re-placed onto survivors within the
    failure-detection deadline, the fleet serves afterwards, and the
    sampled clerk history stays linearizable."""
    from multiraft_tpu_torch.harness.fleet import PlacedFleet
    from multiraft_tpu_torch.harness.nemesis import run_clerk_load
    from multiraft_tpu_torch.porcupine.kv import kv_model
    from multiraft_tpu_torch.porcupine.visualization import (
        assert_linearizable,
    )

    fleet = PlacedFleet(
        [[1], [2], [3]], spare_slots=2, seed=17, device=_DEVICE,
        controller_kwargs=dict(
            scrape_s=0.3, dead_s=2.0, cooldown_s=5.0,
            min_gain=0.25, max_moves=1,
        ),
    )
    try:
        fleet.start()
        for g in (1, 2, 3):
            fleet.admin("join", [g])
        victim = 2
        _, placement0 = fleet.placement()
        victim_gids = [g for g, p in placement0.items() if p == victim]
        assert victim_gids

        t_kill = time.monotonic()
        fleet.kill_mesh_process(victim)
        # Controller thread: ping deadline → dead → empty adoption.
        deadline = t_kill + 120.0
        while time.monotonic() < deadline:
            _, placement, pending, _ = fleet.pmap.query()
            if not pending and all(
                placement.get(g) not in (None, victim)
                for g in victim_gids
            ):
                break
            time.sleep(0.25)
        replace_s = time.monotonic() - t_kill
        _, placement, pending, history = fleet.pmap.query()
        assert all(placement[g] != victim for g in victim_gids), (
            placement, pending
        )
        assert replace_s < 120.0
        assert any(h[4] == "failover" for h in history)

        # Post-failover: the fleet serves, and the history (which
        # includes ops racing the kill) linearizes.
        history_ops = run_clerk_load(
            fleet.clerk, keys=["pa", "pb", "pc"],
            n_workers=3, ops_per_worker=6, op_timeout=120.0,
        )
        assert_linearizable(
            kv_model, history_ops, timeout=60.0, name="placement-chaos"
        )
    finally:
        fleet.shutdown()


# ---------------------------------------------------------------------------
# Parity with the reference on the same inputs
# ---------------------------------------------------------------------------


def _random_plan_inputs(seed):
    rng = np.random.default_rng(seed)
    n_procs = int(rng.integers(1, 6))
    n_gids = int(rng.integers(0, 24))
    gids = sorted(set(int(g) for g in rng.integers(1, 200, n_gids)))
    # Some groups sit on procs outside the alive set (failover).
    placement = {g: int(rng.integers(0, n_procs + 1)) for g in gids}
    loads = {g: float(np.round(rng.exponential(3.0), 3)) for g in gids
             if rng.random() < 0.9}
    alive = sorted(int(p) for p in range(n_procs) if rng.random() < 0.8)
    now = float(rng.integers(0, 100))
    last_moved = {g: float(now - rng.integers(0, 12)) for g in gids
                  if rng.random() < 0.3}
    exclude = {g for g in gids if rng.random() < 0.15}
    kw = dict(
        min_gain=float(rng.choice([0.0, 0.1, 0.25, 0.5, 0.99])),
        cooldown_s=float(rng.choice([0.0, 5.0])),
        last_moved=last_moved, now_s=now,
        max_moves=int(rng.integers(0, 4)), exclude=exclude,
    )
    return placement, loads, alive, kw


@pytest.mark.parametrize("seed", range(40))
def test_plan_moves_equals_the_reference(seed):
    from multiraft_tpu.distributed.placement import plan_moves as ref_plan

    placement, loads, alive, kw = _random_plan_inputs(seed)
    ours = plan_moves(dict(placement), dict(loads), list(alive), **kw)
    theirs = ref_plan(dict(placement), dict(loads), list(alive), **kw)
    assert ours == theirs


def _pin_client_ids(monkeypatch):
    """Clerk ids carry a random per-process nonce and a class counter:
    pin both packages' so their sims exchange the same bytes."""
    import multiraft_tpu.distributed.placement as ref_pl
    import multiraft_tpu.utils.ids as ref_ids
    import multiraft_tpu_torch.distributed.placement as pl
    import multiraft_tpu_torch.utils.ids as ids

    for mod in (ids, ref_ids):
        monkeypatch.setattr(mod, "_PROC_NONCE", 0x5EED)
    for mod in (pl, ref_pl):
        monkeypatch.setattr(mod.PlacementClerk, "_next_client_id", 1 << 21)


def _map_world(pmap):
    """What a PlacementMap has done so far: its query answer, every
    replica's Raft log and state machine, the sim network's counters
    and the virtual clock."""
    out = {"query": pmap.query()}
    for i, h in enumerate(pmap.cluster.handles):
        if h is None:
            out[f"log{i}"] = None
            continue
        out[f"log{i}"] = [
            (e.index, e.term, repr(e.command)) for e in h.rf.log.entries
        ]
        out[f"state{i}"] = (h.version, dict(h.placement),
                            dict(h.pending), dict(h.reconfigs))
    out["net"] = (pmap.net.get_total_count(), pmap.net.get_total_bytes())
    out["now"] = pmap.sched.now
    return out


@pytest.mark.parametrize("seed", [5, 6, 9])
def test_placement_map_stream_equals_the_reference(seed, monkeypatch):
    """One verb script on one sim seed through both packages' maps —
    migration intents, a reconfig intent, and the map's own leader
    killed mid-intent, restarted, and the next leader killed — answers
    the same and commits the same stream."""
    from multiraft_tpu.harness.fleet import PlacementMap as RefMap
    from multiraft_tpu_torch.harness.fleet import PlacementMap

    _pin_client_ids(monkeypatch)
    script = [
        ("begin", 3, 0, "rebalance"), ("dispatch", 3), ("commit", 3),
        ("begin", 1, 1, "rebalance"), ("kill_leader",), ("query",),
        ("dispatch", 1), ("commit", 1), ("rbegin", 2, 1, 3),
        ("rphase", 2, "catchup"), ("restart",), ("kill_leader",),
        ("rphase", 2, "joint"),
        ("rdone", 2), ("begin", 2, 0, "failover"), ("abort", 2),
        ("set_map", {1: 1, 2: 0, 3: 2}), ("rbegin", 3, 0, 3), ("rabort", 3),
    ]
    worlds = []
    for cls in (RefMap, PlacementMap):
        pmap = cls(n=3, seed=seed, initial={1: 0, 2: 1, 3: 1})
        try:
            trail = [_map_world(pmap)]
            killed = None
            for verb, *args in script:
                if verb == "query":
                    trail.append(pmap.query())
                elif verb == "kill_leader":
                    killed = pmap.kill_leader()
                    trail.append(killed)
                elif verb == "restart":
                    # Crash-restart from the persister: the map keeps a
                    # majority for the second leader kill.
                    pmap.restart_replica(killed)
                else:
                    trail.append(getattr(pmap, verb)(*args))
                trail.append(_map_world(pmap))
            worlds.append(trail)
        finally:
            pmap.cleanup()
    ref, ours = worlds
    for i, (a, b) in enumerate(zip(ref, ours)):
        assert a == b, (i, a, b)


class _Rec:
    """Record-collecting stand-in for the flight recorder."""

    def __init__(self):
        self.records = []

    def record(self, etype, code=0, a=0, b=0, c=0, tag=""):
        self.records.append((etype, code, a, b, c, tag))


def _controller_run(pkg, cooldown_s=3.0):
    """A scripted fleet history through one package's controller over
    the fake transport, under an injected clock: skew → a failed adopt
    → resume → a dead process → failover → a zombie → more skew."""
    import importlib

    placement = importlib.import_module(f"{pkg}.distributed.placement")
    clock = types.SimpleNamespace(t=100.0)
    tr = FakeTransport(3, {0: {1, 2, 3, 4, 5}, 1: {6}, 2: set()},
                       loads={1: 5.0, 2: 5.0, 3: 4.0, 4: 3.0, 5: 1.0,
                              6: 2.0})
    store = placement.LocalPlacementStore(
        {1: 0, 2: 0, 3: 0, 4: 0, 5: 0, 6: 1})
    rec = _Rec()
    ctl = placement.PlacementController(
        tr, store, scrape_s=0.0, dead_s=2.0, cooldown_s=cooldown_s,
        min_gain=0.1, max_moves=1, recorder=rec, clock=lambda: clock.t,
    )
    trail = []
    for step in range(14):
        if step == 2:
            tr.fail_adopt = {1, 2, 3, 4, 5}
        if step == 3:
            tr.fail_adopt = set()
        if step == 6:
            tr.down.add(1)
        if step == 10:
            tr.down.discard(1)
        if step == 11:
            tr.loads.update({6: 9.0, 3: 0.5})
        clock.t += 1.5
        n = ctl.step()
        trail.append((n, store.query(), sorted(ctl.dead),
                      dict(ctl.last_moved), ctl.moves_done))
    return trail, tr.calls, tr.pushes, rec.records


def test_controller_over_the_fake_transport_equals_the_reference():
    """The port's planner never cools a group down for less than the
    doctor's thrash window (a deviation, ROADMAP queue C; pinned by
    test_no_voluntary_move_makes_a_group_thrash), so the reference runs
    the script with that cooldown: every decision, RPC, push and record
    is then the same."""
    from multiraft_tpu_torch.analysis.postmortem import THRASH_WINDOW_US

    ref = _controller_run("multiraft_tpu", cooldown_s=THRASH_WINDOW_US / 1e6)
    ours = _controller_run("multiraft_tpu_torch")
    for what, a, b in zip(("trail", "calls", "pushes", "records"), ref, ours):
        assert a == b, what
    assert any(r[-1] == "failover" for r in ours[3])
    assert any(r[-1] == "rebalance" for r in ours[3])


# ---------------------------------------------------------------------------
# Fencing leases, orphaned intents and standby probes (the port's fixes;
# ROADMAP queue C)
# ---------------------------------------------------------------------------


class LeasedFleet(FakeTransport):
    """A fake fleet whose processes take the fencing lease verb."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.grants: list = []
        self.released: list = []

    def lease(self, proc, kind, deadline=None):
        self.calls.append(("lease", proc, kind))
        if proc in self.down:
            return False, None
        if kind == "grant":
            self.grants.append((proc, deadline))
            return True, deadline
        if kind == "release":
            self.released.append(proc)
        return True, None


def test_failover_waits_until_the_dead_process_lease_ran_out():
    """A running controller grants each live process a lease dead_s
    past its clock; it re-places a dead process's groups only once the
    last deadline it sent that process (answered or not) has passed."""
    clock = types.SimpleNamespace(t=100.0)
    tr = LeasedFleet(2, {0: {1}, 1: {2}}, loads={1: 1.0, 2: 1.0})
    store = LocalPlacementStore({1: 0, 2: 1})
    ctl = make_controller(tr, store, clock=lambda: clock.t)
    ctl._leasing = True  # what start() sets, without its threads
    ctl.step()
    assert (0, 102.0) in tr.grants and (1, 102.0) in tr.grants
    tr.down.add(0)
    clock.t = 102.5  # the grant sent now (to 104.5) goes unanswered
    ctl.step()
    assert 0 in ctl.dead
    assert store.query()[1][1] == 0  # its lease may still run: wait
    clock.t = 104.5
    ctl.step()
    assert store.query()[1][1] == 0
    clock.t = 104.7
    ctl.step()
    _, placement, pending, history = store.query()
    assert placement == {1: 1, 2: 1} and not pending
    assert history[-1][4] == "failover"


def test_stop_releases_the_live_processes_only():
    """The lease thread keeps renewing while the rounds run; stopping
    on purpose releases the fence of every live process, never of one
    declared dead."""
    tr = LeasedFleet(3, {0: {1}, 1: {2}, 2: {3}},
                     loads={1: 1.0, 2: 1.0, 3: 1.0})
    tr.down.add(2)
    store = LocalPlacementStore({1: 0, 2: 1, 3: 2})
    ctl = make_controller(tr, store, scrape_s=0.05, dead_s=0.3,
                          min_gain=10.0)
    ctl.start()
    try:
        deadline = time.monotonic() + 20.0
        while 2 not in ctl.dead and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        ctl.stop()
    assert ctl.dead == {2}
    assert sorted(tr.released) == [0, 1]
    assert {p for p, _ in tr.grants} == {0, 1}
    assert not ctl._leasing


class _Standbys(FakeTransport):
    """A fake fleet where process 2 holds gid 1's shipped state."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.recovered: list = []

    def standby_state(self, proc, gid):
        if proc == 2:
            return {"token": "0.x", "snap_seq": 1, "tail_seq": 3,
                    "ts": 5.0, "has_snap": True}
        return None

    def recover_group(self, proc, gid):
        if proc != 2:
            return "empty"
        self.recovered.append((proc, gid))
        self.hosted.setdefault(proc, set()).add(gid)
        return "recovered"


def test_an_orphaned_rebalance_intent_fails_over_to_the_freshest():
    """A rebalance intent whose source died before its destination
    adopted the group is dropped, and the group fails over to the
    standby with the freshest shipped state (the reference recovers at
    the intent's destination, empty where it holds nothing)."""
    clock = types.SimpleNamespace(t=100.0)
    tr = _Standbys(3, {0: {1}, 1: set(), 2: set()}, loads={1: 1.0})
    store = LocalPlacementStore({1: 0})
    store.begin(1, 1, "rebalance")
    tr.down.add(0)
    ctl = make_controller(tr, store, min_gain=10.0, clock=lambda: clock.t)
    clock.t += 5.0
    ctl.step()
    _, placement, pending, history = store.query()
    assert placement == {1: 2} and not pending
    assert tr.recovered == [(2, 1)] and history[-1][4] == "failover"
    assert ("adopt", 1, 1) not in tr.calls


def test_standby_probe_reads_a_bare_none_by_the_server_it_came_from():
    """The reference's servers answer None for "holds nothing"; the
    port's answer "none", so a None from them (or from a server that
    never answered) is a lost answer and raises."""
    from multiraft_tpu_torch.distributed.placement import TcpFleetTransport

    tr = TcpFleetTransport.__new__(TcpFleetTransport)
    tr._fences = {}
    replies = {
        (0, "Obs.ping"): "pong",  # the reference's server
        (1, "Obs.ping"): ("pong", None),  # the port's fleet server
        (2, "Obs.ping"): None,  # never answers
    }
    tr._call = lambda proc, meth, args, timeout: replies.get((proc, meth))
    for p in range(3):
        replies[(p, "EngineShardKV.standby_state")] = None
    assert tr.standby_state(0, 5) is None
    for p in (1, 2):
        with pytest.raises(TimeoutError):
            tr.standby_state(p, 5)
    replies[(1, "EngineShardKV.standby_state")] = "none"
    assert tr.standby_state(1, 5) is None
    fresh = {"token": "1.a", "snap_seq": 0, "tail_seq": 2, "ts": 1.0,
             "has_snap": True}
    replies[(2, "EngineShardKV.standby_state")] = fresh
    assert tr.standby_state(2, 5) == fresh


@pytest.mark.timeout_s(120)
def test_a_lapsed_lease_fences_every_client_op():
    """A fleet server under a controller's lease answers client ops
    until the deadline, then ErrWrongGroup to every one (and no
    placement view) until a new grant or a release."""
    from multiraft_tpu_torch.distributed.engine_clerks import EngineFleetClerk
    from multiraft_tpu_torch.distributed.engine_shard_server import (
        serve_engine_shardkv,
    )
    from multiraft_tpu_torch.distributed.engine_wire import EngineCmdArgs
    from multiraft_tpu_torch.distributed.tcp import RpcNode

    node = serve_engine_shardkv(0, gids=[1], peer_addrs={}, device="cpu")
    client = RpcNode()
    try:
        end = client.client_end(node.host, node.port)

        def call(meth, args):
            return client.sched.wait(end.call(meth, args), 30)

        assert call("EngineShardKV.admin", ("join", [1], 1)).err == "OK"
        ck = EngineFleetClerk(client.sched, {1: end})
        assert client.sched.wait(client.sched.spawn(ck.put("1k", "v")), 30) == ""
        until = time.monotonic() + 1.0
        assert call("Obs.ping", ("lease", "grant", until)) == ("pong", until)
        get = EngineCmdArgs(op="Get", key="1k")
        put = EngineCmdArgs(op="Put", key="1k", value="w", client_id=5,
                            command_id=1)
        assert call("EngineShardKV.command", get).value == "v"
        time.sleep(max(0.0, until - time.monotonic()) + 0.05)
        for args in (get, put):
            assert call("EngineShardKV.command", args).err == "ErrWrongGroup"
        (r,) = call("EngineShardKV.batch", [get])
        assert r.err == "ErrWrongGroup"
        assert call("EngineShardKV.placement", ()) is None
        assert call("Obs.ping", ("lease", "query", None)) == ("pong", until)
        assert call("Obs.ping", None) == "pong"
        assert call("Obs.ping", ("lease", "release", None)) == ("pong", None)
        r = call("EngineShardKV.command", get)
        assert (r.err, r.value) == ("OK", "v")
    finally:
        client.close()
        node.close()


def _thrash_run(pkg):
    """One package's controller over the fake fleet (injected clock): a
    hot group rebalanced onto a process that then dies, failed over, and
    a load shift that makes the planner want it back within 30 s."""
    import importlib

    placement = importlib.import_module(f"{pkg}.distributed.placement")
    clock = types.SimpleNamespace(t=100.0)
    tr = FakeTransport(3, {0: {1, 2, 3, 4}, 1: set(), 2: set()},
                       loads={1: 6.0, 2: 1.0, 3: 1.0, 4: 1.0})
    store = placement.LocalPlacementStore({1: 0, 2: 0, 3: 0, 4: 0})
    rec = _Rec()
    ctl = placement.PlacementController(
        tr, store, scrape_s=0.0, dead_s=2.0, cooldown_s=5.0,
        min_gain=0.25, max_moves=1, recorder=rec, clock=lambda: clock.t,
    )
    for step in range(20):  # 30 s of clock, one thrash window
        if step == 1:
            tr.down.add(store.query()[1][1])  # gid 1's new host dies
        if step == 6:
            tr.loads.update({1: 1.0, 2: 6.0})
        clock.t += 1.5
        ctl.step()
    return [(r[1], r[2], r[3], r[5]) for r in rec.records]


def test_no_voluntary_move_makes_a_group_thrash():
    """Deviation from the reference (ROADMAP queue C): the reference's
    controller rebalances, fails over and rebalances one group inside
    the doctor's 30 s thrash window; the port's planner, whose cooldown
    is at least that window, leaves the third move out and makes every
    other move the same."""
    from multiraft_tpu_torch.analysis.postmortem import THRASH_MIN

    ref = _thrash_run("multiraft_tpu")
    ours = _thrash_run("multiraft_tpu_torch")
    assert sum(m[0] == 1 for m in ref) == THRASH_MIN
    assert sum(m[0] == 1 for m in ours) == THRASH_MIN - 1
    assert ours == [m for m in ref if m != (1, 2, 0, "rebalance")]
