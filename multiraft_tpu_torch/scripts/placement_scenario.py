"""Hot/cold placement scenario → the ``placement`` bench family (the
PyTorch port of ``scripts/placement_scenario.py``).

    python -m multiraft_tpu_torch.scripts.placement_scenario
        [--out PATH] [--procs 3] [--groups-per-proc 2] [--seed 0]
        [--quick] [--durable] [--replace [--crash-controller]]
        [--device cpu]

Every engine of the fleet runs on ``--device``: the card unless ``cpu``
is asked for.

Runs the placement controller against an in-process fleet
(harness/fleet.py InProcessFleet — several BatchedShardKV instances
sharing one gid space; CPU-friendly and deterministic; the socket form
of every migration leg is exercised by the nightly placement chaos
test) through the acceptance scenario:

1. **Skew**: all client traffic concentrates on process 0's groups —
   a hot/cold split the static assignment cannot fix.
2. **Rebalance**: the controller scrapes per-group commit rates, plans
   weighted minimal-movement migrations, and executes them through the
   seal → export → adopt → drop path.  Reported:
   ``spread_reduction_pct`` — the drop in per-process load spread
   (max − min commit rate share) from before to after.
3. **Failover**: one process is killed mid-load; reported
   ``failover_replace_s`` — kill to every one of its groups re-placed
   AND serving again on a survivor.

Output JSON is a ``multiraft_tpu_torch.scripts.bench_compare --family
placement`` result: ``{"spread_reduction_pct", "failover_replace_s", "moves",
"spread_before", "spread_after", "history": [...]}``.

``--durable`` runs the DURABLE failover variant (PLACEMENT_r02): the
same fleet with the state plane enabled in sync-ship mode
(distributed/stateplane.py) — every group's snapshot+tail is shipped
to standbys, a kill recovers through the shipped state instead of
empty adoption, and the report adds ``durable_failover_s``,
``lost_acked_writes`` (must be 0), ``acked_writes``, ``ship_bytes``,
``ship_tail_records``, ``ship_snapshots``, and ``ship_recoveries``.
The acceptance comparison against PLACEMENT_r01: the durable failover
may cost the shipping-replay overhead on top of r01's replace time,
but never loses an acknowledged write.

``--replace`` runs the SELF-HEALING variant (PLACEMENT_r03): each
group gets a spare engine replica slot (P=4, voters {0,1,2}); one
group's LEADER replica is permanently killed under acknowledged-write
load, and the controller's replace-dead-replica policy heals it
(learner → catch-up → joint entry → promote — a replicated two-phase
intent on the placement store).  Reports ``replace_replica_s`` (grace
deadline to config settled at the new voter set),
``degraded_quorum_window_s`` (kill to healed), and
``lost_acked_writes`` (must be 0).  ``--crash-controller`` kills the
controller mid-reconfig and hands the recorded intent to a fresh one,
which must RESUME the replacement — never fork membership.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..distributed.placement import (
    LocalPlacementStore,
    PlacementController,
)
from ..harness.fleet import (
    InProcessFleet,
    LocalFleetTransport,
)
from ..services.shardkv import key2shard


def keys_by_gid(fleet, n_keys: int = 200):
    """key → owning gid for a spread of short keys, per latest config."""
    cfg = fleet.instances[0].query_latest()
    out = {}
    # key2shard hashes the FIRST character — vary it to cover every
    # shard (and therefore every gid).
    for i in range(n_keys):
        k = f"{chr(ord('a') + i % 26)}{i}"
        out[k] = cfg.shards[key2shard(k)]
    return out


def apply_skewed_load(fleet, clerk, hot_gids, kmap, rounds: int,
                      hot_factor: int = 6) -> None:
    """Appends concentrated on ``hot_gids``: each round sends
    ``hot_factor`` ops to hot groups per 1 op to every cold group."""
    hot_keys = [k for k, g in kmap.items() if g in hot_gids]
    cold_keys = [k for k, g in kmap.items() if g not in hot_gids]
    for r in range(rounds):
        for i in range(hot_factor):
            clerk.append(hot_keys[(r * hot_factor + i) % len(hot_keys)], "h")
        if cold_keys:
            clerk.append(cold_keys[r % len(cold_keys)], "c")


def proc_spread(controller, store, n_procs, killed=()) -> float:
    """Per-process load spread (max − min summed commit rate) under the
    CURRENT placement, from the controller's last scrape."""
    _, placement, _, _ = store.query()
    load = {p: 0.0 for p in range(n_procs) if p not in killed}
    for gid, rate in controller.loads.items():
        p = placement.get(gid)
        if p in load:
            load[p] += rate
    if not load:
        return 0.0
    return max(load.values()) - min(load.values())


def run(procs: int, gpp: int, seed: int, quick: bool,
        device: str = "cuda") -> dict:
    assignment = [
        [p * gpp + j + 1 for j in range(gpp)] for p in range(procs)
    ]
    all_gids = [g for gl in assignment for g in gl]
    print(f"fleet: {procs} procs x {gpp} groups {assignment}, seed {seed}")
    fleet = InProcessFleet(assignment, spare_slots=gpp, seed=seed,
                           device=device)
    for g in all_gids:
        fleet.admin("join", [g])
    fleet.settle()
    clerk = fleet.clerk()
    kmap = keys_by_gid(fleet)

    transport = LocalFleetTransport(fleet)
    store = LocalPlacementStore({g: p for p, gl in enumerate(assignment)
                                for g in gl})
    controller = PlacementController(
        transport, store,
        scrape_s=0.0, dead_s=2.0, cooldown_s=0.0,
        min_gain=0.2, max_moves=1,
    )

    hot_gids = set(assignment[0])
    load_rounds = 2 if quick else 6

    # Phase 1: skewed load with the controller planning DISABLED
    # (max_moves=0 via a huge min_gain would also work; simplest is to
    # scrape without acting) — two scrape windows so commit rates are
    # real deltas.
    apply_skewed_load(fleet, clerk, hot_gids, kmap, load_rounds)
    controller.scrape()
    apply_skewed_load(fleet, clerk, hot_gids, kmap, load_rounds)
    controller.scrape()
    spread_before = proc_spread(controller, store, procs)
    print(f"spread before: {spread_before:.1f} commits/s "
          f"(loads {dict((g, round(r, 1)) for g, r in sorted(controller.loads.items()))})")

    # Phase 2: let the controller rebalance, load still running.
    moves_budget = procs * gpp
    for _ in range(moves_budget):
        apply_skewed_load(fleet, clerk, hot_gids, kmap, load_rounds)
        if controller.step() == 0 and controller.rounds > 2:
            break
    # One more loaded scrape window so spread_after reflects the new map.
    apply_skewed_load(fleet, clerk, hot_gids, kmap, load_rounds)
    controller.scrape()
    spread_after = proc_spread(controller, store, procs)
    rebalance_moves = controller.moves_done
    version, placement, _, history = store.query()
    print(f"spread after: {spread_after:.1f} commits/s, "
          f"{rebalance_moves} move(s), placement v{version}: {placement}")
    reduction = (
        100.0 * (spread_before - spread_after) / spread_before
        if spread_before > 0 else 0.0
    )

    # Phase 3: failover — kill the process hosting the most groups.
    victim = max(
        range(procs),
        key=lambda p: sum(1 for g, q in placement.items() if q == p),
    )
    victim_gids = [g for g, q in placement.items() if q == victim]
    print(f"killing proc {victim} (groups {victim_gids})")
    t_kill = time.perf_counter()
    fleet.kill(victim)
    deadline = t_kill + 60.0
    while time.perf_counter() < deadline:
        controller.step()
        fleet.pump_all(2)
        _, pl, pend, _ = store.query()
        if not pend and all(
            pl.get(g) not in (None, victim) for g in victim_gids
        ):
            break
    # Serving check: a write to each re-placed group's keys succeeds.
    for g in victim_gids:
        k = next(k for k, kg in kmap.items() if kg == g)
        clerk.put(k, "post-failover")
        assert clerk.get(k) == "post-failover", (g, k)
    failover_s = time.perf_counter() - t_kill
    _, pl, _, history = store.query()
    print(f"failover: re-placed {victim_gids} in {failover_s:.2f}s "
          f"(final map {pl})")

    return {
        "spread_before": round(spread_before, 2),
        "spread_after": round(spread_after, 2),
        "spread_reduction_pct": round(reduction, 1),
        "rebalance_moves": rebalance_moves,
        "moves": controller.moves_done,
        "failover_replace_s": round(failover_s, 3),
        "procs": procs,
        "groups_per_proc": gpp,
        "seed": seed,
        "placement": {str(g): p for g, p in sorted(pl.items())},
        "history": [list(h) for h in history],
    }


def run_durable(procs: int, gpp: int, seed: int, quick: bool,
                device: str = "cuda") -> dict:
    """PLACEMENT_r02: durable failover through the state plane.

    A clean fleet (no rebalance phase — r01 already measures that)
    takes an acknowledged write workload with sync shipping on, loses
    its most-loaded process to a kill, and recovers every group from
    shipped snapshot+tail.  Reports the failover wall time and a
    direct count of lost acknowledged writes (the acceptance bar: 0).
    """
    from ..distributed.observe import Observability

    assignment = [
        [p * gpp + j + 1 for j in range(gpp)] for p in range(procs)
    ]
    all_gids = [g for gl in assignment for g in gl]
    print(f"durable fleet: {procs} procs x {gpp} groups {assignment}, "
          f"seed {seed}")
    fleet = InProcessFleet(assignment, spare_slots=gpp, seed=seed,
                           device=device)
    for g in all_gids:
        fleet.admin("join", [g])
    fleet.settle()
    obs = Observability(name="stateplane")
    fleet.enable_shipping(window_s=0.0, sync=True, obs=obs)
    clerk = fleet.clerk()
    kmap = keys_by_gid(fleet)

    transport = LocalFleetTransport(fleet)
    store = LocalPlacementStore({g: p for p, gl in enumerate(assignment)
                                for g in gl})
    controller = PlacementController(
        transport, store, obs=obs,
        scrape_s=0.0, dead_s=2.0, cooldown_s=0.0,
        min_gain=0.2, max_moves=1,
    )

    # Phase 1: acknowledged writes across every group.  Appends build
    # per-key values whose final form proves exactly-once replay.
    n_rounds = 2 if quick else 4
    expected = {}
    keys = list(kmap)[: procs * gpp * (4 if quick else 10)]
    for r in range(n_rounds):
        for k in keys:
            clerk.append(k, f"w{r},")
            expected[k] = expected.get(k, "") + f"w{r},"
    fleet.pump_all(4)  # shipping rounds run inside pump_all
    # Prime the controller's liveness view so the failover time below
    # INCLUDES the dead_s detection window — comparable to r01.
    controller.scrape()
    fleet.pump_all(2)
    controller.scrape()

    # Phase 2: kill the process hosting the most groups; the
    # controller recovers its groups from shipped state.
    _, placement, _, _ = store.query()
    victim = max(
        range(procs),
        key=lambda p: sum(1 for g, q in placement.items() if q == p),
    )
    victim_gids = [g for g, q in placement.items() if q == victim]
    print(f"killing proc {victim} (groups {victim_gids})")
    t_kill = time.perf_counter()
    fleet.kill(victim)
    deadline = t_kill + 60.0
    while time.perf_counter() < deadline:
        controller.step()
        fleet.pump_all(2)
        _, pl, pend, _ = store.query()
        if not pend and all(
            pl.get(g) not in (None, victim) for g in victim_gids
        ):
            break
    # Serving check mirrors run(): every re-placed group writes again.
    for g in victim_gids:
        k = next(k for k, kg in kmap.items() if kg == g)
        clerk.put(k, expected.get(k, "") + "post")
        expected[k] = expected.get(k, "") + "post"
    durable_failover_s = time.perf_counter() - t_kill

    # Phase 3: zero acknowledged-write loss, exactly-once.
    lost = sum(1 for k, v in expected.items() if clerk.get(k) != v)
    _, pl, _, history = store.query()
    counters = dict(obs.metrics.counters)
    print(f"durable failover: re-placed {victim_gids} in "
          f"{durable_failover_s:.2f}s, {lost} acked write(s) lost, "
          f"recoveries {counters.get('place.recoveries', 0)}")

    return {
        "durable_failover_s": round(durable_failover_s, 3),
        "failover_replace_s": round(durable_failover_s, 3),
        "lost_acked_writes": lost,
        "acked_writes": len(expected),
        "ship_bytes": int(counters.get("ship.bytes", 0)),
        "ship_tail_records": int(counters.get("ship.tail_records", 0)),
        "ship_snapshots": int(counters.get("ship.snapshots", 0)),
        "ship_recoveries": int(counters.get("ship.recoveries", 0)
                               or counters.get("place.recoveries", 0)),
        "ship_window_s": 0.0,
        "ship_sync": 1,
        "procs": procs,
        "groups_per_proc": gpp,
        "seed": seed,
        "placement": {str(g): p for g, p in sorted(pl.items())},
        "history": [list(h) for h in history],
    }


def run_replace(procs: int, gpp: int, seed: int, quick: bool,
                crash_controller: bool = False,
                device: str = "cuda") -> dict:
    """PLACEMENT_r03: self-healing replica sets (module docstring).

    One group's leader REPLICA is permanently killed (the process
    lives); the controller detects the dead voter past ``dead_s``,
    seats a learner in the spare engine slot, waits for catch-up,
    appends the joint config entry, and lets the engine auto-promote
    to the new voter set.  With ``crash_controller`` the first
    controller is abandoned at the first recorded mid-reconfig phase
    and a fresh controller finishes from the replicated intent.
    """
    from ..distributed.observe import Observability

    assignment = [
        [p * gpp + j + 1 for j in range(gpp)] for p in range(procs)
    ]
    all_gids = [g for gl in assignment for g in gl]
    print(f"self-heal fleet: {procs} procs x {gpp} groups {assignment}, "
          f"seed {seed}, P=4 voters [0,1,2]")
    fleet = InProcessFleet(assignment, spare_slots=1, seed=seed,
                           replicas=4, voters=[0, 1, 2], device=device)
    for g in all_gids:
        fleet.admin("join", [g])
    fleet.settle()
    obs = Observability(name="selfheal")
    clerk = fleet.clerk()
    kmap = keys_by_gid(fleet)

    transport = LocalFleetTransport(fleet)
    store = LocalPlacementStore({g: p for p, gl in enumerate(assignment)
                                 for g in gl})
    dead_s = 1.0

    def make_controller():
        # Voluntary moves off (max_moves=0): the run measures replica
        # healing, not group rebalancing.
        return PlacementController(
            transport, store, obs=obs,
            scrape_s=0.0, dead_s=dead_s, cooldown_s=0.0,
            min_gain=10.0, max_moves=0,
        )

    controller = make_controller()

    # Phase 1: acknowledged writes across every group (the ledger the
    # zero-loss check replays afterwards).
    n_rounds = 2 if quick else 4
    expected = {}
    keys = list(kmap)[: procs * gpp * (4 if quick else 10)]
    for r in range(n_rounds):
        for k in keys:
            clerk.append(k, f"w{r},")
            expected[k] = expected.get(k, "") + f"w{r},"
    controller.scrape()
    fleet.pump_all(2)
    controller.scrape()

    # Phase 2: permanently kill the victim group's LEADER replica.
    victim_gid = assignment[0][0]
    victim_proc = fleet.proc_of(victim_gid)
    cfg0 = transport.replica_config(victim_proc, victim_gid)
    victim_peer = int(cfg0["peer"])
    print(f"killing leader replica (gid {victim_gid}, peer "
          f"{victim_peer}) — config {cfg0['voters_old']}")
    t_kill = time.perf_counter()
    assert fleet.kill_replica(victim_gid, victim_peer)

    crashed_at = None
    deadline = t_kill + 90.0
    healed_cfg = None
    while time.perf_counter() < deadline:
        controller.step()
        fleet.pump_all(4)
        intents = store.reconfig_intents()
        if (crash_controller and crashed_at is None
                and victim_gid in intents):
            # SIGKILL-the-controller moment: abandon it mid-reconfig
            # (its in-memory ledgers die with it) and bring up a
            # successor that has ONLY the replicated intent to go on.
            crashed_at = intents[victim_gid][2]
            print(f"controller crashed at phase {crashed_at!r}; "
                  f"successor resumes")
            controller = make_controller()
            continue
        if victim_gid not in intents:
            cfg = transport.replica_config(
                fleet.proc_of(victim_gid), victim_gid
            )
            if (cfg is not None and not cfg["joint"]
                    and victim_peer not in cfg["voters_old"]):
                healed_cfg = cfg
                break
    t_healed = time.perf_counter()
    assert healed_cfg is not None, "replica never replaced"
    degraded_s = t_healed - t_kill
    replace_s = max(0.0, degraded_s - dead_s)
    stats = controller.replace_stats.get(victim_gid)
    if stats is not None:
        # The controller's own clock brackets the same interval more
        # tightly (scrape-observed death, not the kill call).
        replace_s = stats["replace_replica_s"]
        degraded_s = stats["degraded_quorum_window_s"]

    # Phase 3: zero acknowledged-write loss + the group still serves.
    for g in all_gids:
        k = next(k for k, kg in kmap.items() if kg == g)
        clerk.put(k, expected.get(k, "") + "post")
        expected[k] = expected.get(k, "") + "post"
    lost = sum(1 for k, v in expected.items() if clerk.get(k) != v)
    counters = dict(obs.metrics.counters)
    _, pl, _, history = store.query()
    print(f"replaced leader replica of gid {victim_gid} in "
          f"{replace_s:.2f}s (degraded-quorum window {degraded_s:.2f}s), "
          f"{lost} acked write(s) lost, healed config "
          f"{healed_cfg['voters_old']}")

    return {
        "replace_replica_s": round(replace_s, 3),
        "degraded_quorum_window_s": round(degraded_s, 3),
        "lost_acked_writes": lost,
        "acked_writes": len(expected),
        "healed_voters": healed_cfg["voters_old"],
        "killed": [victim_gid, victim_peer],
        "crash_controller": int(crash_controller),
        "crashed_at_phase": crashed_at,
        "reconfig_begun": int(counters.get("reconfig.begun", 0)),
        "reconfig_joint_entered": int(
            counters.get("reconfig.joint_entered", 0)
        ),
        "reconfig_completed": int(counters.get("reconfig.completed", 0)),
        "reconfig_aborted": int(counters.get("reconfig.aborted", 0)),
        "procs": procs,
        "groups_per_proc": gpp,
        "seed": seed,
        "placement": {str(g): p for g, p in sorted(pl.items())},
        "history": [list(h) for h in history],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="write the result JSON here")
    ap.add_argument("--procs", type=int, default=3)
    ap.add_argument("--groups-per-proc", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true",
                    help="shorter load phases (CI smoke)")
    ap.add_argument("--durable", action="store_true",
                    help="durable-failover variant (PLACEMENT_r02): "
                         "sync shipping + stateful recovery")
    ap.add_argument("--replace", action="store_true",
                    help="self-healing variant (PLACEMENT_r03): "
                         "replace a permanently killed replica via "
                         "joint consensus")
    ap.add_argument("--crash-controller", action="store_true",
                    help="with --replace: kill the controller "
                         "mid-reconfig; a successor must resume")
    ap.add_argument("--device", default="cuda",
                    help="the fleet's engine device (default cuda)")
    args = ap.parse_args(argv)
    if args.replace:
        result = run_replace(args.procs, args.groups_per_proc,
                             args.seed, args.quick,
                             crash_controller=args.crash_controller,
                             device=args.device)
    elif args.durable:
        result = run_durable(args.procs, args.groups_per_proc,
                             args.seed, args.quick, device=args.device)
    else:
        result = run(args.procs, args.groups_per_proc, args.seed,
                     args.quick, device=args.device)
    doc = json.dumps(result, indent=2, sort_keys=True)
    print(doc)
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc + "\n")
        print(f"wrote {args.out}")
    # The scenario's own acceptance: the rebalance must help (r01) /
    # no acknowledged write may be lost (r02, r03), and the
    # failover/replacement must complete inside the deadline.
    if args.replace:
        from ..distributed.placement import place_knobs

        ok = (result["lost_acked_writes"] == 0
              and result["reconfig_completed"] >= 1
              and result["replace_replica_s"]
              < place_knobs()["replace_deadline_s"])
    elif args.durable:
        ok = (result["lost_acked_writes"] == 0
              and result["durable_failover_s"] < 60.0)
    else:
        ok = (result["spread_reduction_pct"] > 0
              and result["failover_replace_s"] < 60.0)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
