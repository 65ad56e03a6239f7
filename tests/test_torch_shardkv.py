"""The port's sharded engine (``multiraft_tpu_torch/engine/shardkv.py``,
``services/shardctrler.py``, ``services/shardkv.py``) against the
reference, scenario for scenario.

Each scenario of ``tests/test_engine_shardkv.py`` runs once on a
reference ``BatchedShardKV`` (plain path, as its own tests run) and once
on the port's (``device="cpu"``), from one seed, with the same calls.
After every pump, every ``EngineState`` and ``Mailbox`` plane, the
driver's bookkeeping and the whole service state (configs, the route
table, every replica's configs, shard states, data, dedup tables and
pending tickets) are recorded; the two runs must go through the same
records, pump by pump, and every ticket must resolve the same way.
Besides: ``rebalance`` and ``key2shard`` on seeded random inputs,
``route_keys`` on negative hashes, the firehose through
``submit_frame``, migration under reordering and 1% drops, a clerk
churn run whose histories pass the reference's porcupine checker, the
``*_gid`` membership facades, the placement verbs, and a sharded
checkpoint restored across the packages.
"""

import os
import pickle
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multiraft_tpu.engine.shardkv as R
import multiraft_tpu_torch.engine.shardkv as P
from multiraft_tpu.engine.core import EngineConfig as JaxConfig
from multiraft_tpu.engine.firehose import pack_request as ref_pack
from multiraft_tpu.engine.host import EngineDriver as JaxDriver
from multiraft_tpu.porcupine.checker import CheckResult, check_operations
from multiraft_tpu.porcupine.kv import KvInput, KvOutput, kv_model
from multiraft_tpu.porcupine.model import Operation
from multiraft_tpu.services import shardctrler as ref_ctrler
from multiraft_tpu.services import shardkv as ref_services
from multiraft_tpu_torch import convert
from multiraft_tpu_torch.engine.core import EngineConfig
from multiraft_tpu_torch.engine.firehose import FH_OK, FH_WRONG_GROUP, pack_request
from multiraft_tpu_torch.engine.host import EngineDriver
from multiraft_tpu_torch.services import shardctrler
from multiraft_tpu_torch.services import shardkv as port_services
from multiraft_tpu_torch.services.shardkv import BEPULLING, SERVING, key2shard
from torch_parity import PumpRecorder, canon, first_difference, service_world

# Small shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the host's cores.
torch.set_num_threads(1)

NSHARDS = shardctrler.NSHARDS


# ---------------------------------------------------------------------------
# Two runs of one scenario, compared pump by pump
# ---------------------------------------------------------------------------


def make_side(pkg, G=4, seed=0, P_=3, seed_voters=None, **kw):
    """One package's sharded service, as the reference's tests build it
    (``make`` in tests/test_engine_shardkv.py)."""
    shape = dict(G=G, P=P_, L=64, E=8, INGEST=8, **kw)
    if pkg is R:
        driver = JaxDriver(JaxConfig(**shape), seed=seed)
    else:
        driver = EngineDriver(EngineConfig(**shape), seed=seed, device="cpu")
    if seed_voters is not None:
        driver.seed_config(seed_voters)
    assert driver.run_until_quiet_leaders(max_ticks=1000)
    return types.SimpleNamespace(mod=pkg, svc=pkg.BatchedShardKV(driver),
                                 drv=driver)


def run_both(scenario, **make_kw):
    """Run ``scenario(side)`` on the reference and on the port; every
    pump's record and the returned results must be equal."""
    sides = [make_side(pkg, **make_kw) for pkg in (R, P)]
    first = first_difference(service_world(sides[0].svc), service_world(sides[1].svc))
    assert first is None, ("after the election", first)
    rec = PumpRecorder(sides[0].svc, sides[1].svc)
    results = [scenario(x) for x in sides]
    n = rec.check(scenario.__name__)
    assert n > 0
    assert canon(results[0]) == canon(results[1])
    return sides, results


def settle(skv, max_ticks=4000):
    """Pump until every participating group is at the latest config with
    all shards quiescent (no migration in flight)."""
    target = skv.query_latest().num
    for _ in range(0, max_ticks, 5):
        skv.pump(5)
        reps = [skv.reps[g] for g in skv.query_latest().groups]
        if reps and all(
            r.cur.num == target
            and all(sh.state == SERVING for sh in r.shards.values())
            for r in reps
        ):
            return
    raise TimeoutError(f"cluster did not settle at config {target}")


def keys_for_all_shards():
    out = {}
    for c in range(32, 127):
        k = chr(c)
        s = key2shard(k)
        if s not in out:
            out[s] = k
        if len(out) == NSHARDS:
            break
    return out  # shard -> key


def tickets(ts):
    return [(t.group, t.done, t.failed, t.err, t.value, t.done_tick,
             t.command_id) for t in ts]


# ---------------------------------------------------------------------------
# The reference's fourteen scenarios
# ---------------------------------------------------------------------------


def single_group_serves_all_shards(x):
    skv = x.svc
    skv.admin_sync("join", [1])
    clerk = x.mod.BatchedShardClerk(skv, client_id=1)
    got = []
    for shard, k in keys_for_all_shards().items():
        clerk.put(k, f"v{shard}")
        got.append(clerk.get(k))
        assert got[-1] == f"v{shard}"
    return got


def join_migrates_and_preserves_data(x):
    skv = x.svc
    skv.admin_sync("join", [1])
    clerk = x.mod.BatchedShardClerk(skv, client_id=1)
    kmap = keys_for_all_shards()
    for shard, k in kmap.items():
        clerk.put(k, f"v{shard}")
    skv.admin_sync("join", [2])
    settle(skv)
    cfg = skv.query_latest()
    owned = {g: sum(1 for s in cfg.shards if s == g) for g in (1, 2)}
    assert abs(owned[1] - owned[2]) <= 1
    for shard, k in kmap.items():
        assert clerk.get(k) == f"v{shard}"
    for shard, k in kmap.items():
        clerk.append(k, "+")
        assert clerk.get(k) == f"v{shard}+"
    return cfg


def leave_returns_shards_with_data(x):
    skv = x.svc
    skv.admin_sync("join", [1])
    skv.admin_sync("join", [2])
    settle(skv)
    clerk = x.mod.BatchedShardClerk(skv, client_id=1)
    kmap = keys_for_all_shards()
    for shard, k in kmap.items():
        clerk.put(k, f"w{shard}")
    skv.admin_sync("leave", [2])
    settle(skv)
    assert all(g == 1 for g in skv.query_latest().shards)
    for shard, k in kmap.items():
        assert clerk.get(k) == f"w{shard}"
    return skv.query_latest()


def challenge1_old_owner_deletes_migrated_shards(x):
    skv = x.svc
    skv.admin_sync("join", [1])
    clerk = x.mod.BatchedShardClerk(skv, client_id=1)
    kmap = keys_for_all_shards()
    for shard, k in kmap.items():
        clerk.put(k, "x" * 64)
    skv.admin_sync("join", [2])
    settle(skv)
    cfg = skv.query_latest()
    rep1 = skv.reps[1]
    for s in range(NSHARDS):
        if cfg.shards[s] == 2:
            assert rep1.shards[s].data == {}, f"shard {s} leaked at old owner"
            assert rep1.shards[s].state == SERVING
        elif cfg.shards[s] == 1 and s in kmap:
            assert kmap[s] in rep1.shards[s].data
    return cfg


def challenge2_unaffected_shards_serve_during_stalled_migration(x):
    skv = x.svc
    skv.admin_sync("join", [1])
    clerk = x.mod.BatchedShardClerk(skv, client_id=1)
    kmap = keys_for_all_shards()
    for shard, k in kmap.items():
        clerk.put(k, f"v{shard}")
    for p in (0, 1):
        skv.driver.set_alive(2, p, False)
    skv.admin_sync("join", [2])
    for _ in range(60):
        skv.pump(5)
    cfg = skv.query_latest()
    rep1 = skv.reps[1]
    assert rep1.cur.num == cfg.num
    kept = [s for s in range(NSHARDS) if cfg.shards[s] == 1]
    moved = [s for s in range(NSHARDS) if cfg.shards[s] == 2]
    assert kept and moved
    for s in kept:
        if s in kmap:
            assert clerk.get(kmap[s]) == f"v{s}"
    assert all(rep1.shards[s].state == BEPULLING for s in moved)
    t = skv.submit(1, "Get", kmap[moved[0]], client_id=9, command_id=1)
    for _ in range(40):
        skv.pump(5)
        if t.done:
            break
    assert t.done and t.err == x.mod.ERR_WRONG_GROUP
    for p in (0, 1):
        skv.driver.restart_replica(2, p)
    settle(skv)
    for s in moved:
        if s in kmap:
            assert clerk.get(kmap[s]) == f"v{s}"
    return tickets([t])


def dedup_survives_shard_migration(x):
    skv = x.svc
    skv.admin_sync("join", [1])
    clerk = x.mod.BatchedShardClerk(skv, client_id=1)
    k = keys_for_all_shards()[0]
    clerk.put(k, "base")
    t1 = skv.submit(1, "Append", k, "+dup", client_id=7, command_id=1)
    t2 = skv.submit(1, "Append", k, "+dup", client_id=7, command_id=1)
    for _ in range(60):
        skv.pump(5)
        if t1.done and t2.done:
            break
    assert t1.done and t2.done
    skv.admin_sync("join", [2])
    settle(skv)
    owner = skv.query_latest().shards[key2shard(k)]
    t3 = skv.submit(owner, "Append", k, "+dup", client_id=7, command_id=1)
    for _ in range(60):
        skv.pump(5)
        if t3.done:
            break
    assert t3.done and t3.err == x.mod.OK
    assert clerk.get(k) == "base+dup"
    return tickets([t1, t2, t3])


def move_pins_shard(x):
    skv = x.svc
    skv.admin_sync("join", [1])
    skv.admin_sync("join", [2])
    settle(skv)
    cfg = skv.query_latest()
    shard = next(s for s in range(NSHARDS) if cfg.shards[s] == 1)
    skv.admin_sync("move", (shard, 2))
    settle(skv)
    assert skv.query_latest().shards[shard] == 2
    kmap = keys_for_all_shards()
    clerk = x.mod.BatchedShardClerk(skv, client_id=1)
    if shard in kmap:
        clerk.put(kmap[shard], "moved")
        assert clerk.get(kmap[shard]) == "moved"
        assert kmap[shard] in skv.reps[2].shards[shard].data
    return skv.query_latest()


def _churn(x, rounds, admin_plan, seed, crash=False):
    """Three clerks (Append/Get on three sampled shards) through config
    churn, optionally with rolling crash-restarts; returns the recorded
    histories."""
    skv, d = x.svc, x.svc.driver
    skv.admin_sync("join", [1])
    sample = sorted(keys_for_all_shards().items())[:3]
    shards = [s for s, _ in sample]
    clerks = [x.mod.BatchedShardClerk(skv, client_id=i + 1, record_shards=shards)
              for i in range(3)]
    sessions = {}
    rng = np.random.default_rng(seed)
    admin_steps = iter(admin_plan)
    admin_op = admin_ticket = None
    down = []
    for round_no in range(rounds):
        for i, c in enumerate(clerks):
            if i not in sessions or sessions[i].poll():
                shard, key = sample[rng.integers(len(sample))]
                if rng.random() < 0.5:
                    sessions[i] = c.begin("Append", key, f"({i}.{round_no})")
                else:
                    sessions[i] = c.begin("Get", key)
        if admin_ticket is not None and admin_ticket.done and admin_ticket.failed:
            admin_ticket = getattr(skv, admin_op[0])(
                admin_op[1], command_id=admin_ticket.command_id)
        elif admin_ticket is None or admin_ticket.done:
            admin_op = next(admin_steps, None)
            admin_ticket = getattr(skv, admin_op[0])(admin_op[1]) if admin_op else None
            if admin_op is None:
                admin_steps = iter(())
        if crash:
            if round_no % 5 == 2:
                g = int(rng.integers(d.cfg.G))
                p = d.leader_of(g)
                if p is None:
                    p = int(rng.integers(d.cfg.P))
                if (g, p) not in down:
                    d.set_alive(g, p, False)
                    down.append((g, p))
            while len(down) > d.cfg.G * ((d.cfg.P - 1) // 2) or (
                    down and rng.random() < 0.3):
                g, p = down.pop(0)
                d.restart_replica(g, p)
        skv.pump(5)
        for s in sessions.values():
            s.poll()
    while down:
        d.restart_replica(*down.pop())
    assert skv.query_latest().num >= len(admin_plan) + 1, "config churn never happened"
    for _ in range(400):
        skv.pump(5)
        if all(s.poll() for s in sessions.values()):
            break
    assert all(s.poll() for s in sessions.values())
    return {s: [o for c in clerks for o in c.histories[s]] for s in shards}


def _assert_linearizable(histories):
    """The reference's porcupine checker on histories recorded by either
    package (the port's records converted field for field)."""
    for shard, hist in histories.items():
        ops = [Operation(client_id=o.client_id,
                         input=KvInput(op=o.input.op, key=o.input.key,
                                       value=o.input.value),
                         call=o.call, output=KvOutput(value=o.output.value),
                         ret=o.ret) for o in hist]
        if ops:
            res = check_operations(kv_model, ops, timeout=10.0)
            assert res is not CheckResult.ILLEGAL, f"shard {shard}"


def concurrent_clients_through_config_churn_linearizable(x):
    return _churn(x, 120, [("join", [2, 3]), ("leave", [2])], seed=0)


def route_keys_device_table(x):
    skv = x.svc
    skv.admin_sync("join", [1])
    skv.admin_sync("join", [2])
    settle(skv)
    hashes = np.arange(100, dtype=np.int32)
    gids = np.asarray(x.mod.route_keys(skv.shard_table(), hashes)
                      if x.mod is R else
                      x.mod.route_keys(skv.shard_table(), torch.from_numpy(hashes)).numpy())
    cfg = skv.query_latest()
    assert (gids == np.array([cfg.shards[h % NSHARDS] for h in range(100)])).all()
    return gids


def fast_reads_match_logged_reads(x):
    skv = x.svc
    skv.admin_sync("join", [1, 2])
    settle(skv)
    clerk = x.mod.BatchedShardClerk(skv, client_id=1)
    kmap = keys_for_all_shards()
    for shard, k in kmap.items():
        clerk.put(k, f"w{shard}")
    out = []
    for shard, k in kmap.items():
        t = skv.get_fast(k)
        assert t.done and t.err == x.mod.OK and t.value == f"w{shard}"
        assert clerk.get(k) == t.value
        out.append(t)
    shard0, k0 = next(iter(kmap.items()))
    k_other = chr(ord(k0) + NSHARDS)
    assert key2shard(k_other) == shard0
    out.append(skv.get_fast(k_other))
    assert out[-1].err == x.mod.ERR_NO_KEY
    return tickets(out)


def fast_reads_respect_migration_gates(x):
    skv = x.svc
    skv.admin_sync("join", [1])
    clerk = x.mod.BatchedShardClerk(skv, client_id=1)
    kmap = keys_for_all_shards()
    for shard, k in kmap.items():
        clerk.put(k, f"v{shard}")
    for p in (0, 1):
        skv.driver.set_alive(2, p, False)
    skv.admin_sync("join", [2])
    for _ in range(40):
        skv.pump(5)
    cfg = skv.query_latest()
    kept = [s for s in range(NSHARDS) if cfg.shards[s] == 1 and s in kmap]
    moved = [s for s in range(NSHARDS) if cfg.shards[s] == 2 and s in kmap]
    assert kept and moved
    out = [skv.get_fast(kmap[s]) for s in kept + moved]
    assert [t.value for t in out[:len(kept)]] == [f"v{s}" for s in kept]
    assert all(t.err == x.mod.ERR_WRONG_GROUP for t in out[len(kept):])
    for p in (0, 1):
        skv.driver.restart_replica(2, p)
    settle(skv)
    for s in moved:
        out.append(skv.get_fast(kmap[s]))
        assert out[-1].value == f"v{s}"
    return tickets(out)


def fast_reads_in_churn_history_linearizable(x):
    skv = x.svc
    skv.admin_sync("join", [1])
    sample = sorted(keys_for_all_shards().items())[:2]
    shards = [s for s, _ in sample]
    writer = x.mod.BatchedShardClerk(skv, client_id=1, record_shards=shards)
    reader = x.mod.BatchedShardClerk(skv, client_id=2, record_shards=shards)
    session = None
    rng = np.random.default_rng(3)
    admin_steps = iter([("join", [2, 3]), ("leave", [3])])
    admin_ticket = admin_op = None
    for round_no in range(100):
        if session is None or session.poll():
            _, key = sample[rng.integers(len(sample))]
            session = writer.begin("Append", key, f"[{round_no}]")
        if admin_ticket is not None and admin_ticket.done and admin_ticket.failed:
            admin_ticket = getattr(skv, admin_op[0])(
                admin_op[1], command_id=admin_ticket.command_id)
        elif admin_ticket is None or admin_ticket.done:
            admin_op = next(admin_steps, None)
            admin_ticket = getattr(skv, admin_op[0])(admin_op[1]) if admin_op else None
            if admin_op is None:
                admin_steps = iter(())
        skv.pump(5)
        session.poll()
        _, key = sample[rng.integers(len(sample))]
        reader.get_fast(key)
    for _ in range(300):
        skv.pump(5)
        if session.poll():
            break
    return {s: writer.histories[s] + reader.histories[s] for s in shards}


def migration_under_reordering_and_loss(x, reorder=0.5, drop=0.1):
    skv = x.svc
    skv.driver.set_reorder(reorder, 2, 8)
    skv.driver.drop_prob = drop
    skv.admin_sync("join", [1])
    kmap = keys_for_all_shards()
    clerk = x.mod.BatchedShardClerk(skv, client_id=1)
    for shard, k in kmap.items():
        clerk.put(k, f"r{shard}")
        clerk.append(k, "a")
    skv.admin_sync("join", [2])
    skv.admin_sync("leave", [1])
    for shard, k in kmap.items():
        clerk.append(k, "b")
    skv.driver.set_reorder(0.0)
    skv.driver.drop_prob = 0.0
    settle(skv)
    assert all(g == 2 for g in skv.query_latest().shards)
    for shard, k in kmap.items():
        assert clerk.get(k) == f"r{shard}ab"
        assert skv.get_fast(k).value == f"r{shard}ab"
    return skv.query_latest()


def restart_during_config_churn_linearizable(x):
    hist = _churn(x, 160, [("join", [2, 3]), ("leave", [2]), ("join", [2]),
                           ("leave", [3])], seed=5, crash=True)
    d = x.svc.driver
    for g in range(d.cfg.G):
        d.check_log_matching(g)
    return hist


SCENARIOS = [
    (single_group_serves_all_shards, dict(G=2, seed=0)),
    (join_migrates_and_preserves_data, dict(G=3, seed=1)),
    (leave_returns_shards_with_data, dict(G=3, seed=2)),
    (challenge1_old_owner_deletes_migrated_shards, dict(G=3, seed=3)),
    (challenge2_unaffected_shards_serve_during_stalled_migration, dict(G=3, seed=4)),
    (dedup_survives_shard_migration, dict(G=3, seed=5)),
    (move_pins_shard, dict(G=3, seed=6)),
    (concurrent_clients_through_config_churn_linearizable, dict(G=4, seed=7)),
    (route_keys_device_table, dict(G=3, seed=8)),
    (fast_reads_match_logged_reads, dict(G=3, seed=21)),
    (fast_reads_respect_migration_gates, dict(G=3, seed=22)),
    (fast_reads_in_churn_history_linearizable, dict(G=4, seed=23)),
    (migration_under_reordering_and_loss, dict(G=3, seed=31)),
    (restart_during_config_churn_linearizable, dict(G=4, seed=11)),
]


@pytest.mark.parametrize("scenario,make_kw", SCENARIOS,
                         ids=[s.__name__ for s, _ in SCENARIOS])
def test_scenario_matches_reference_pump_by_pump(scenario, make_kw):
    _, results = run_both(scenario, **make_kw)
    if scenario.__name__.endswith("linearizable"):
        _assert_linearizable(results[1])


def test_migration_under_reorder_chaos_and_one_percent_drops():
    """The driver's reorder chaos (2/3 of messages held 2-8 ticks) and
    1% drops through join, leave and the appends around them."""
    def scenario(x):
        return migration_under_reordering_and_loss(x, reorder=2.0 / 3.0, drop=0.01)

    sides, _ = run_both(scenario, G=3, seed=32)
    assert sides[1].drv.tick > 0


# ---------------------------------------------------------------------------
# Pure functions against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_rebalance_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        n = int(rng.integers(0, 12))
        groups = {int(g): [f"s{g}"] for g in rng.choice(np.arange(1, 40), n, replace=False)}
        shards = [int(g) for g in rng.integers(0, 40, NSHARDS)]
        assert shardctrler.rebalance(list(shards), groups) == \
            ref_ctrler.rebalance(list(shards), groups)


@pytest.mark.parametrize("seed", range(3))
def test_key2shard_and_constants_match_reference(seed):
    rng = np.random.default_rng(seed)
    keys = ["".join(chr(int(c)) for c in rng.integers(1, 0x2FF, int(rng.integers(0, 4))))
            for _ in range(500)]
    assert [key2shard(k) for k in keys] == [ref_services.key2shard(k) for k in keys]
    assert NSHARDS == ref_ctrler.NSHARDS
    for name in ("SERVING", "PULLING", "BEPULLING", "GCING", "OK", "ERR_NO_KEY",
                 "ERR_WRONG_GROUP", "ERR_NOT_READY", "GET", "PUT", "APPEND"):
        assert getattr(ref_services, name) == getattr(port_services, name)
    for name in ("OK", "ERR_NO_KEY", "ERR_WRONG_GROUP", "ERR_NOT_READY"):
        assert getattr(R, name) == getattr(P, name) == getattr(port_services, name)
    c = shardctrler.Config(num=3, shards=list(range(NSHARDS)), groups={1: ["a"]})
    assert canon(c.clone()) == canon(ref_ctrler.Config(
        num=3, shards=list(range(NSHARDS)), groups={1: ["a"]}).clone())


def test_nshards_is_read_from_the_environment_as_the_reference_reads_it():
    import subprocess
    import sys

    code = ("from multiraft_tpu_torch.services.shardctrler import NSHARDS as a\n"
            "from multiraft_tpu.services.shardctrler import NSHARDS as b\n"
            "print(a, b)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, MULTIRAFT_NSHARDS="12.0",
                                  JAX_PLATFORMS="cpu", PYTHONPATH=root))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["12", "12"]


def test_route_keys_keeps_floor_mod_on_negative_hashes():
    table_np = np.array([5, 1, 4, 1, 5, 9, 2, 6, 5, 3], np.int32)[:NSHARDS]
    rng = np.random.default_rng(4)
    hashes = np.concatenate([
        rng.integers(-2**31, 2**31, 5000, dtype=np.int64).astype(np.int32),
        np.array([-2**31, -11, -10, -9, -1, 0, 1, 9, 10, 2**31 - 1], np.int32),
    ])
    got = P.route_keys(torch.from_numpy(table_np), torch.from_numpy(hashes))
    want = np.asarray(R.route_keys(jnp.asarray(table_np), jnp.asarray(hashes)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(P.route_keys(torch.from_numpy(table_np), hashes).numpy(), want)
    assert np.array_equal(want, table_np[np.mod(hashes.astype(np.int64), NSHARDS)])


# ---------------------------------------------------------------------------
# The firehose, the membership facades and the placement verbs
# ---------------------------------------------------------------------------


def _frame(pack, rows):
    ops, groups, clients, cmds, keys, vals = zip(*rows)
    return pack(np.array(ops, np.uint8), np.array(groups, np.uint32),
                np.array(clients, np.uint64), np.array(cmds, np.uint64),
                [k.encode() for k in keys], [v.encode() for v in vals])


def firehose(x):
    """Frames of Put/Append rows routed by the latest config, with rows
    for gids this instance does not host, through a join; failed rows
    are resent under their own session ids until every row is OK."""
    skv = x.svc
    pack = ref_pack if x.mod is R else pack_request
    skv.admin_sync("join", [1])
    keys = [f"{chr(ord('a') + i % 26)}{i}" for i in range(120)]
    rows = [(1 + i % 2, 0, 100 + i, 1, k, f"<{i}>") for i, k in enumerate(keys)]
    model, replies, pending = {}, [], list(range(len(rows)))
    for rnd in range(30):
        if not pending:
            break
        cfg = skv.query_latest()
        batch = [rows[i][:1] + (cfg.shards[key2shard(rows[i][4])],) + rows[i][2:]
                 for i in pending]
        batch += [(1, 77, 900 + rnd, 1, "zz", "lost"), (2, 5, 901, 1, "yy", "x")]
        f = skv.submit_frame(_frame(pack, batch))
        assert (f.err[-2:] == FH_WRONG_GROUP).all()
        if rnd == 0:
            skv.admin_sync("join", [2])
        for _ in range(100):
            if f.done:
                break
            skv.pump(3)
        assert f.done
        replies.append(f.err.tolist())
        still = []
        for i, e in zip(pending, f.err[:len(pending)].tolist()):
            if e == FH_OK:
                op, k, v = rows[i][0], rows[i][4], rows[i][5]
                model[k] = v if op == 1 else model.get(k, "") + v
            else:
                still.append(i)
        pending = still
    assert not pending
    settle(skv)
    for k, v in model.items():
        assert skv.get_fast(k).value == v
    return replies


def test_firehose_through_submit_frame_matches_reference():
    _, (replies, _) = run_both(firehose, G=3, seed=41)
    assert replies


def test_submit_frame_lookup_equals_the_reference_loop():
    """The port's sorted gid lookup routes the same rows, in the same
    order, as the reference's loop over hosted gids, including gids
    above every hosted one and gids below."""
    d = EngineDriver(EngineConfig(G=6, L=64, E=8, INGEST=8), seed=1, device="cpu")
    skv = P.BatchedShardKV(d, gids=[40, 7, 1000, 3])
    starts = []
    d.start_run = lambda g, f, rows: starts.append((g, rows.tolist()))
    rng = np.random.default_rng(2)
    gid_col = rng.choice([0, 3, 7, 8, 40, 41, 1000, 5000, 2**32 - 1], 300)
    rows = [(1, int(g), i + 1, 1, f"k{i}", "v") for i, g in enumerate(gid_col)]
    f = skv.submit_frame(_frame(pack_request, rows))
    g2l = skv._g2l
    wr = np.arange(len(rows))
    local = np.full(len(rows), -1, np.int64)
    for gid, loc in g2l.items():  # the reference's loop
        local[gid_col == gid] = loc
    assert np.array_equal(np.nonzero(f.err == FH_WRONG_GROUP)[0], wr[local < 0])
    order = np.argsort(local[local >= 0], kind="stable")
    good, gs = wr[local >= 0][order], local[local >= 0][order]
    want = [(int(gs[i]), good[gs == gs[i]].tolist()) for i in
            np.unique(gs, return_index=True)[1]]
    assert starts == want


def facades(x):
    """The placement controller's replace-dead-replica legs on one gid,
    each leg run twice (every verb is idempotent)."""
    skv = x.svc
    skv.admin_sync("join", [1, 2])
    out = []
    gid = 2
    lead = skv.driver.leader_of(gid)
    dead = [q for q in (0, 1, 2) if q != lead][0]
    out += [skv.kill_replica_gid(gid, dead), skv.kill_replica_gid(gid, dead)]
    out += [skv.replica_health(gid), skv.replica_health(gid)]
    spare = 3
    out += [skv.add_learner_gid(gid, spare), skv.add_learner_gid(gid, spare)]
    for _ in range(200):
        skv.pump(5)
        m = skv.learner_match_gid(gid, spare)
        if m is not None and m[0] >= m[1]:
            break
    out += [skv.learner_match_gid(gid, spare), skv.learner_match_gid(gid, spare)]
    target = sorted({0, 1, 2, spare} - {dead})
    out += [skv.begin_joint_gid(gid, target), skv.begin_joint_gid(gid, target)]
    for _ in range(200):
        skv.pump(5)
        c = skv.config_of_gid(gid)
        if c is not None and not c["joint"] and c["voters_old"] == target:
            break
    c = skv.config_of_gid(gid)
    assert not c["joint"] and c["voters_old"] == c["voters_new"] == target
    out += [skv.begin_joint_gid(gid, target), skv.replica_health(gid), c]
    out += [skv.replica_health(99), skv.add_learner_gid(99, 1),
            skv.learner_match_gid(99, 1), skv.begin_joint_gid(99, [0]),
            skv.kill_replica_gid(99, 0), skv.config_of_gid(99)]
    return out


def test_membership_facades_match_reference_and_replace_a_dead_voter():
    _, (out, _) = run_both(facades, G=3, seed=51, P_=5, seed_voters=[0, 1, 2])
    assert out[0] is True and out[2]["alive"].count(False) == 3


def test_membership_facades_refuse_on_the_kernel_path():
    d = EngineDriver(EngineConfig(G=3, P=5, L=64, E=8, INGEST=8, use_kernels=True),
                     seed=1, device="cpu")
    assert d.run_until_quiet_leaders(1000)
    skv = P.BatchedShardKV(d)
    lead = d.leader_of(1)
    spare = [q for q in range(5) if q != lead][0]
    d.set_alive(1, spare, False)
    assert skv.add_learner_gid(1, spare) is False
    assert skv.begin_joint_gid(1, [0, 1, 2]) is False
    with pytest.raises(RuntimeError, match="membership"):
        d.add_learner(1, spare)


def placement(x):
    """export/snapshot/unseal/adopt/quiesce/drop on a fleet-mode
    instance hosting gids 10 and 20 in a G=4 engine (one spare)."""
    skv = x.svc
    skv.admin_sync("join", [10, 20])
    settle(skv)
    clerk = x.mod.BatchedShardClerk(skv, client_id=3)
    for k in "abcd":
        clerk.put(k, k * 3)
    out = [skv.free_slots(), skv.snapshot_group(20), skv.export_group(20),
           skv.is_sealed(20), skv.export_group(20), skv.snapshot_group(20)]
    try:
        skv.unseal_group(20)
        out.append("unsealed")
    except RuntimeError as e:
        out.append(str(e))
    skv.unseal_group(20, force=True)
    out.append(skv.is_sealed(20))
    blob = skv.export_group(10)
    out.append(skv.adopt_gid(30, None))
    out.append(skv.free_slots())
    skv.pump(5)
    out.append(skv.group_quiesced(30))
    skv.drop_gid(30)
    out += [skv.free_slots(), blob, sorted(skv._g2l.items())]
    return out


def test_placement_verbs_match_reference():
    def make(pkg, **kw):
        side = make_side(pkg, G=4, seed=61)
        side.svc = pkg.BatchedShardKV(side.drv, gids=[10, 20])
        return side

    sides = [make(R), make(P)]
    rec = PumpRecorder(sides[0].svc, sides[1].svc)
    out = [placement(x) for x in sides]
    assert rec.check("placement") > 0
    assert canon(out[0]) == canon(out[1])


# ---------------------------------------------------------------------------
# A sharded checkpoint across the packages
# ---------------------------------------------------------------------------


class _PortConfig:
    def __setstate__(self, state):
        f = dict(state)
        f["use_pallas"] = f.pop("use_kernels")
        f["pallas_interpret"] = False
        self.cfg = JaxConfig(**f)


_INVERSE = {port: ref for ref, port in convert.CHECKPOINT_CLASSES.items()
            if ref[1] != "EngineConfig"}


class _PortToReference(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == ("multiraft_tpu_torch.engine.core", "EngineConfig"):
            return _PortConfig
        if module.split(".")[0] == "multiraft_tpu_torch":
            module, name = _INVERSE[(module, name)]
        return super().find_class(module, name)


def _traffic(skv, rnd):
    """One round of client appends (not awaited)."""
    for i in range(3):
        k = chr(ord("a") + (rnd * 3 + i) % 20)
        owner = skv.configs[-1].shards[key2shard(k)]
        if owner in skv.reps:
            skv.submit(owner, "Append", k, f"{rnd}.{i};", client_id=1 + i,
                       command_id=rnd + 1)


def _quiet(skv):
    """No replica has an internal proposal outstanding.  The reference's
    ``load_state_dict`` drops outstanding proposals (they are re-proposed,
    idempotently), so only a checkpoint taken here resumes exactly as
    the uninterrupted run goes on."""
    return all(r.pending_config is None and not r.pending_insert
               and not r.pending_delete and not r.pending_confirm
               for r in skv.reps.values())


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_sharded_checkpoint_crosses_packages_and_continues_equal(direction, tmp_path):
    """A sharded service saved with ``driver.save(path, extra={"service":
    skv.state_dict()})`` by one package, with client appends and a join
    bound and queued, is restored by the other and goes on equal to the
    uninterrupted run, pump by pump, through the migration the join
    starts."""
    src_pkg, dst_pkg = (R, P) if direction == "reference_to_port" else (P, R)
    src = make_side(src_pkg, G=4, seed=71).svc
    src.admin_sync("join", [1])
    for rnd in range(4):
        _traffic(src, rnd)
        src.pump(5)
    settle(src)
    _traffic(src, 4)
    src.join([2, 3])
    src.pump(1)
    _traffic(src, 5)
    assert _quiet(src) and src.driver.payloads and src.driver._pending_payloads
    path = str(tmp_path / "sharded.ckpt")
    src.driver.save(path, extra={"service": src.state_dict()})
    if dst_pkg is P:
        d = EngineDriver.restore(path, device="cpu")
    else:
        with open(path, "rb") as f:
            blob = _PortToReference(f).load()
        blob["cfg"] = blob["cfg"].cfg
        with open(path, "wb") as f:
            pickle.dump(blob, f, protocol=pickle.HIGHEST_PROTOCOL)
        d = JaxDriver.restore(path)
    dst = dst_pkg.BatchedShardKV(d)
    dst.load_state_dict(d.restored_extra["service"])
    assert isinstance(dst.configs[-1], (P.Config if dst_pkg is P else R.Config))
    # The orphan-sweep countdown is volatile (not checkpointed).
    dst._sweep_countdown = src._sweep_countdown
    wa, wb = service_world(src), service_world(dst)
    wa.pop("last_applied"), wb.pop("last_applied")
    assert first_difference(wa, wb) is None, ("restored", first_difference(wa, wb))
    rec = PumpRecorder(src, dst)
    for rnd in range(6, 20):
        for skv in (src, dst):
            _traffic(skv, rnd)
            skv.pump(5)
        rec.check(rnd)
    for skv in (src, dst):
        settle(skv)
    rec.check("settled")
    assert dst.configs[-1].num == 2 and {2, 3} <= set(dst.configs[-1].shards)
    assert all(sl.state == SERVING for r in dst.reps.values() for sl in r.shards.values())
    assert sum(len(sl.data) for r in dst.reps.values() for sl in r.shards.values()) == 20
