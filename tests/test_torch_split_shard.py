"""The port's sharded stack over split replica groups
(``multiraft_tpu_torch/engine/split_shard.py``) against the reference.

Each engine-level scenario of ``tests/test_engine_split_shard.py`` runs
on two reference "processes" and on two port processes
(``device="cpu"``), driven by the reference's own slab-shuttle rig
(``multiraft_tpu/harness/split_harness.py``, which takes either
package's services).  After every pump of every side the planes, driver
bookkeeping and service state (configs, replicas, the peering's payload
candidates, the no-op barrier state) are recorded, and every slab is
kept in the reference codec's bytes; the port must go through the same
records and ship the same bytes.  A mixed rig (side 0 from the port,
side 1 from the reference) must stay equal to a reference rig, which
shows that the slab, payload and group-snapshot wire forms are the
reference's.
"""

import types

import pytest
import torch

import multiraft_tpu.engine.shardkv as RK
import multiraft_tpu.engine.split as RS
import multiraft_tpu.engine.split_shard as RSS
import multiraft_tpu_torch.engine.shardkv as PK
import multiraft_tpu_torch.engine.split as PS
import multiraft_tpu_torch.engine.split_shard as PSS
from multiraft_tpu.engine.core import EngineConfig as JaxConfig
from multiraft_tpu.engine.host import EngineDriver as JaxDriver
from multiraft_tpu.harness.split_harness import SplitShardRig
from multiraft_tpu.transport import codec
from multiraft_tpu_torch.engine.core import EngineConfig
from multiraft_tpu_torch.engine.host import EngineDriver
from multiraft_tpu_torch.services.shardctrler import NSHARDS, Config
from multiraft_tpu_torch.services.shardkv import BEPULLING, GCING, SERVING, key2shard
from torch_parity import PumpRecorder, canon

# Small shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the host's cores.
torch.set_num_threads(1)

REF = types.SimpleNamespace(name="ref", split=RS, ss=RSS, skv=RK)
PORT = types.SimpleNamespace(name="port", split=PS, ss=PSS, skv=PK)

# G = 3 engine groups: 0 = config RSM, 1..2 = gids 1..2.
G = 3
OWNERS_MINORITY_0 = {g: [0, 1, 1] for g in range(G)}  # side 0 = minority


class Rig(SplitShardRig):
    """The reference rig, keeping every extracted slab as codec bytes."""

    def __init__(self, sides):
        super().__init__(sides)
        self.slabs = []

    def shuttle(self, rounds=1):
        for _ in range(rounds):
            for i, (svc, peering) in enumerate(self.sides):
                if not self.alive[i]:
                    continue
                svc.pump(1)
                slabs = peering.extract()
                self.slabs.append((i, codec.encode(slabs)))
                for proc, slab in slabs.items():
                    if self.alive[proc]:
                        self.sides[proc][1].inject(slab)


def make_rig(pkgs, owners=OWNERS_MINORITY_0, delay_on=1, delay=300):
    sides = []
    for me, (pkg, seed) in enumerate(zip(pkgs, (11, 22))):
        shape = dict(G=G, P=3, L=48, E=8, INGEST=8, host_paced_compaction=True)
        if pkg is REF:
            driver = JaxDriver(JaxConfig(**shape), seed=seed)
        else:
            driver = EngineDriver(EngineConfig(**shape), seed=seed, device="cpu")
        skv = pkg.ss.SplitShardKV(driver)
        peering = pkg.split.SplitPeering(driver, skv, pkg.split.SplitSpec(me=me, owners=owners))
        if delay_on == me:
            driver.state = driver.state._replace(elect_dl=driver.state.elect_dl + delay)
        sides.append((skv, peering))
    return Rig(sides)


def basic_migration_across_processes(rig):
    rig.settle(G)
    rig.admin("join", {1: ["p1"]})
    keys = [chr(ord("a") + i) + "key" for i in range(8)]
    for k in keys:
        rig.client_op("Put", k, f"v-{k}")
    rig.admin("join", {2: ["p2"]})
    rig.wait_migrated([1, 2])
    got = [rig.client_op("Get", k) for k in keys]
    assert got == [f"v-{k}" for k in keys]
    latest = rig.sides[0][0].configs[-1]
    for s in range(NSHARDS):
        if latest.shards[s] == 2:
            for skv, _ in rig.sides:
                assert skv.reps[1].shards[s].data == {}
    return got


def kill_minority_owner_mid_migration(rig):
    """Example 13's scenario: join gid 1, write, join gid 2, kill the
    process holding every leader mid-migration; the survivor finishes
    the pull and the GC handshake alone and serves every acked write."""
    rig.settle(G)
    assert all(rig.sides[0][0].driver.leader_of(g) is not None for g in range(G))
    rig.admin("join", {1: ["p1"]})
    acked = {}
    keys = [chr(ord("a") + i) + "key" for i in range(10)]
    for k in keys:
        rig.client_op("Append", k, f"[a-{k}]")
        acked[k] = f"[a-{k}]"
    rig.admin("join", {2: ["p2"]})
    assert rig.wait_migrating()
    rig.kill(0)
    survivor = rig.sides[1][0]
    stay = next(k for k in keys if survivor.configs[-1].shards[key2shard(k)] == 1)
    rig.client_op("Append", stay, "[during]")
    acked[stay] += "[during]"
    rig.wait_migrated([1, 2])
    for k in keys:
        assert rig.client_op("Get", k) == acked[k], f"lost {k}"
    moved = next(k for k in keys if survivor.configs[-1].shards[key2shard(k)] == 2)
    rig.client_op("Append", moved, "[post]")
    assert rig.client_op("Get", moved) == acked[moved] + "[post]"
    latest = survivor.configs[-1]
    for s in range(NSHARDS):
        if latest.shards[s] == 2:
            assert survivor.reps[1].shards[s].data == {}
    return acked


def delete_waits_for_cross_process_insert(rig):
    rig.settle(G)
    rig.admin("join", {1: ["p1"]})
    rig.client_op("Put", "watched", "payload")
    shard = key2shard("watched")
    rig.admin("move", (shard, 2))
    saw = set()
    for _ in range(3000):
        rig.shuttle()
        for i, (skv, _) in enumerate(rig.sides):
            st1 = skv.reps[1].shards[shard].state
            st2 = skv.reps[2].shards[shard].state
            saw.add((i, st1, st2))
            if st1 == SERVING and skv.reps[1].cur.num >= 2:
                if not skv.reps[1].shards[shard].data:
                    assert skv.reps[2].shards[shard].data or st2 in (GCING, SERVING)
        done = all(skv.reps[2].shards[shard].state == SERVING
                   and skv.reps[2].cur.num == rig.sides[0][0].reps[2].cur.num
                   for skv, _ in rig.sides)
        if done and rig.sides[0][0].reps[2].shards[shard].data:
            break
    assert rig.client_op("Get", "watched") == "payload"
    assert any(st[1] == BEPULLING for st in saw)
    assert any(st[2] == GCING for st in saw)
    return sorted(saw)


SCENARIOS = [basic_migration_across_processes, kill_minority_owner_mid_migration,
             delete_waits_for_cross_process_insert]


def run_rigs(scenario, pkgs_b):
    a, b = make_rig((REF, REF)), make_rig(pkgs_b)
    recs = [PumpRecorder(a.sides[i][0], b.sides[i][0]) for i in (0, 1)]
    out = [scenario(rig) for rig in (a, b)]
    for i, rec in enumerate(recs):
        assert rec.check((scenario.__name__, "side", i)) > 0
    assert canon(out[0]) == canon(out[1])
    assert len(a.slabs) == len(b.slabs)
    for n, (x, y) in enumerate(zip(a.slabs, b.slabs)):
        assert x == y, (scenario.__name__, "slab", n, "from side", x[0])
    return a, b


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s.__name__ for s in SCENARIOS])
def test_split_shard_scenario_matches_reference_pump_by_pump(scenario):
    run_rigs(scenario, (PORT, PORT))


def test_mixed_rig_matches_reference_rig():
    """Port side 0 and reference side 1 exchange slabs through example
    13's kill-mid-migration scenario, equal to two reference sides."""
    run_rigs(kill_minority_owner_mid_migration, (PORT, REF))


def persistence_adapter_roundtrip(pkg):
    """persist_group/restore_group round-trip the ctrler history and a
    replica's shard slots into a fresh instance; replay_apply dedups,
    applies and skips a no-op with the hooks quiet."""
    rig = make_rig((pkg, pkg))
    rig.settle(G)
    rig.admin("join", {1: ["p1"]})
    rig.client_op("Put", "akey", "v1")
    src = rig.sides[0][0]
    fresh = make_rig((pkg, pkg)).sides[0][0]
    blobs = []
    for g in (0, 1):
        upto, blob = src.persist_group(g)
        blobs.append((upto, blob))
        fresh.restore_group(g, upto, blob)
        assert fresh.applied_upto[g] == upto
    shard = key2shard("akey")
    assert fresh.reps[1].shards[shard].data == {"akey": "v1"}
    assert fresh.shard_table().tolist() == fresh.configs[-1].shards
    fired = []
    fresh.on_write = lambda gid, op: fired.append(op.command_id)
    seen = fresh.reps[1].shards[shard].latest[777]
    fresh.replay_apply(1, 99, pkg.skv._ClientOp(op="Append", key="akey", value="XX",
                                               client_id=777, command_id=seen))
    fresh.replay_apply(1, 100, pkg.skv._ClientOp(op="Append", key="akey", value="+2",
                                                client_id=777, command_id=seen + 1))
    fresh.replay_apply(1, 101, pkg.ss._NoOp())
    assert fresh.reps[1].shards[shard].data["akey"] == "v1+2"
    assert fired == []
    return codec.encode(blobs), fresh.reps[1].shards[shard].data


def test_persistence_adapter_roundtrip_matches_reference():
    a, b = persistence_adapter_roundtrip(REF), persistence_adapter_roundtrip(PORT)
    assert a == b


def test_wire_forms_are_the_references():
    """Every op's payload wire form, a config's and a group snapshot's,
    encoded by the reference codec, are the same bytes in both packages,
    and each package imports the other's wire form to an equal op."""
    cfg = {pkg.name: pkg.skv.Config(num=4, shards=list(range(NSHARDS)),
                                    groups={3: ["x", "y"], 1: ["z"]})
           for pkg in (REF, PORT)}

    def ops(pkg):
        m, c = pkg.skv, cfg[pkg.name]
        return [
            m._ClientOp(op="Append", key="k", value="v", client_id=7, command_id=9),
            m._CtrlOp(kind="join", arg={5: ["a"], 2: ["b", "c"]}, client_id=1, command_id=2),
            m._CtrlOp(kind="leave", arg=[2, 5], client_id=1, command_id=3),
            m._CtrlOp(kind="move", arg=(3, 5), client_id=1, command_id=4),
            m._ConfigOp(config=c),
            m._InsertOp(config_num=4, shard=2, data={"a": "1"}, latest={7: 9}),
            m._DeleteOp(config_num=4, shard=2),
            m._ConfirmOp(config_num=4, shard=2),
            pkg.ss._NoOp(),
        ]

    ref_wire = [RSS.SplitShardKV.export_payload(op) for op in ops(REF)]
    port_wire = [PSS.SplitShardKV.export_payload(op) for op in ops(PORT)]
    assert [codec.encode(w) for w in ref_wire] == [codec.encode(w) for w in port_wire]
    for w in ref_wire:
        assert canon(PSS.SplitShardKV.import_payload(w)) == canon(
            RSS.SplitShardKV.import_payload(w))
    assert codec.encode(PSS._config_to_wire(cfg["port"])) == codec.encode(
        RSS._config_to_wire(cfg["ref"]))
    assert isinstance(PSS._config_from_wire(RSS._config_to_wire(cfg["ref"])), Config)
    with pytest.raises(TypeError):
        PSS.SplitShardKV.export_payload(object())
    with pytest.raises(TypeError):
        PSS.SplitShardKV.import_payload(["?"])


def test_get_fast_is_refused_on_split_groups():
    d = EngineDriver(EngineConfig(G=3, L=48, E=8, INGEST=8, host_paced_compaction=True),
                     seed=1, device="cpu")
    skv = PSS.SplitShardKV(d)
    PS.SplitPeering(d, skv, PS.SplitSpec(me=1, owners=OWNERS_MINORITY_0))
    assert skv._ctrl_client_id == 1001
    with pytest.raises(NotImplementedError):
        skv.get_fast("a")
    assert skv.submit_local(1, "Get", "a") is None  # no leader yet
    assert skv.ctrl_local("join", {1: ["p"]}) is None
