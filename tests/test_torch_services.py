"""The port's simulated services against the JAX package's, on the CPU.

The kvraft, shardctrler and shardkv harnesses of both packages run the
same seeded scripts (crashes, unreliable links, partitions, a shard
migration); the recorded histories, the controller's configs, the final
stores and dup tables, ``sched.now`` and the network's counts must be
equal, and each package's own porcupine checker must find its history
linearizable.  The weighted rebalancer is compared on drawn inputs.
"""

import dataclasses

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import multiraft_tpu.harness.ctrler_harness as ref_ctrler_h
import multiraft_tpu.harness.kv_harness as ref_kv_h
import multiraft_tpu.harness.shardkv_harness as ref_skv_h
import multiraft_tpu.porcupine.kv as ref_pkv
import multiraft_tpu.porcupine.model as ref_pmodel
import multiraft_tpu.porcupine.visualization as ref_pvis
import multiraft_tpu.services.kvraft as ref_kvraft
import multiraft_tpu.services.shardctrler as ref_ctl
import multiraft_tpu.services.shardkv as ref_skv
import multiraft_tpu.utils.ids as ref_ids
import multiraft_tpu_torch.harness.ctrler_harness as ctrler_h
import multiraft_tpu_torch.harness.kv_harness as kv_h
import multiraft_tpu_torch.harness.shardkv_harness as skv_h
import multiraft_tpu_torch.porcupine.kv as pkv
import multiraft_tpu_torch.porcupine.model as pmodel
import multiraft_tpu_torch.porcupine.visualization as pvis
import multiraft_tpu_torch.services.kvraft as kvraft
import multiraft_tpu_torch.services.shardctrler as ctl
import multiraft_tpu_torch.services.shardkv as skv
import multiraft_tpu_torch.utils.ids as ids


@dataclasses.dataclass
class Pkg:
    kv_h: object
    ctrler_h: object
    skv_h: object
    kvraft: object
    ctl: object
    skv: object
    ids: object
    pkv: object
    pmodel: object
    pvis: object


REF = Pkg(ref_kv_h, ref_ctrler_h, ref_skv_h, ref_kvraft, ref_ctl, ref_skv,
          ref_ids, ref_pkv, ref_pmodel, ref_pvis)
PORT = Pkg(kv_h, ctrler_h, skv_h, kvraft, ctl, skv, ids, pkv, pmodel, pvis)


def pin_client_ids(p: Pkg, monkeypatch) -> None:
    """Client ids carry a random per-process nonce and class counters;
    pin both so that the two packages' clerks get the same ids."""
    monkeypatch.setattr(p.ids, "_PROC_NONCE", 0x5EED)
    monkeypatch.setattr(p.kvraft.Clerk, "_next_client_id", 0)
    monkeypatch.setattr(p.ctl.CtrlerClerk, "_next_client_id", 1 << 20)
    monkeypatch.setattr(p.skv.ShardClerk, "_next_client_id", 1 << 22)


def run_both(script, monkeypatch, *args):
    out = []
    for p in (REF, PORT):
        pin_client_ids(p, monkeypatch)
        out.append(script(p, *args))
    assert out[1] == out[0]
    return out[1]


class Recorder:
    """Runs clerk ops inside client coroutines and records each as a
    plain tuple, plus as a porcupine operation of its package."""

    def __init__(self, p: Pkg, sched):
        self.p, self.sched = p, sched
        self.rows, self.ops = [], []

    def op(self, ck, kind, key, value=""):
        t0 = self.sched.now
        if kind == "get":
            v = yield from ck.get(key)
        elif kind == "put":
            yield from ck.put(key, value)
            v = ""
        else:
            yield from ck.append(key, value)
            v = ""
        pk = self.p.pkv
        code = {"get": pk.OP_GET, "put": pk.OP_PUT, "append": pk.OP_APPEND}[kind]
        self.rows.append((ck.client_id, kind, key, value, t0, v or "", self.sched.now))
        self.ops.append(self.p.pmodel.Operation(
            client_id=ck.client_id,
            input=pk.KvInput(op=code, key=key, value=value),
            call=t0, output=pk.KvOutput(value=v or ""), ret=self.sched.now,
        ))
        return v

    def linearizable(self, name):
        self.p.pvis.assert_linearizable(
            self.p.pkv.kv_model, self.ops, timeout=5.0, name=name
        )
        return True


# -- rebalancers -----------------------------------------------------------


@settings(max_examples=150, deadline=None)
@given(
    assign=st.dictionaries(
        st.integers(0, 40), st.one_of(st.none(), st.integers(0, 6)), max_size=30
    ),
    weights=st.dictionaries(
        st.integers(0, 40),
        st.one_of(st.integers(0, 50).map(float), st.floats(0, 10, allow_nan=False)),
        max_size=30,
    ),
    bins=st.lists(st.integers(0, 6), max_size=6),
)
def test_rebalance_weighted_matches_reference(assign, weights, bins):
    assert ctl.rebalance_weighted(assign, weights, bins) == ref_ctl.rebalance_weighted(
        assign, weights, bins
    )


@settings(max_examples=150, deadline=None)
@given(
    shards=st.lists(st.integers(0, 8), min_size=10, max_size=10),
    gids=st.sets(st.integers(1, 8), max_size=8),
)
def test_rebalance_matches_reference(shards, gids):
    groups = {g: [f"s{g}"] for g in sorted(gids)}
    assert ctl.rebalance(shards, groups) == ref_ctl.rebalance(shards, groups)


# -- kvraft ----------------------------------------------------------------


def kv_script(p: Pkg, nclients, unreliable, crash, partitions, maxraftstate, seed):
    cfg = p.kv_h.KVHarness(5, unreliable=unreliable, maxraftstate=maxraftstate, seed=seed)
    sched = cfg.sched
    rec = Recorder(p, sched)
    for rnd in range(2):
        clerks = [cfg.make_client() for _ in range(nclients)]
        stop = [False]

        def client(cli, ck, rnd=rnd):
            j = 0
            while j < 12:
                key = str(cfg.rng.randrange(nclients))
                r = cfg.rng.random()
                if r < 0.5:
                    yield from rec.op(ck, "append", key, f"x {cli} {rnd}.{j} y")
                    j += 1
                elif r < 0.6:
                    yield from rec.op(ck, "put", key, f"p {cli} {rnd}.{j}")
                    j += 1
                else:
                    yield from rec.op(ck, "get", key)
                yield cfg.rng.uniform(0.001, 0.02)

        def partitioner():
            while not stop[0]:
                cfg.random_partition()
                yield cfg.rng.uniform(0.2, 0.5)
            cfg.connect_all()

        futs = [sched.spawn(client(i, ck)) for i, ck in enumerate(clerks)]
        if partitions:
            sched.spawn(partitioner())
        for f in futs:
            sched.run_until(f, max_events=5_000_000)
        stop[0] = True
        cfg.connect_all()
        sched.run_for(0.3)
        if crash:
            for i in range(5):
                cfg.shutdown_server(i)
            sched.run_for(0.2)
            for i in range(5):
                cfg.start_server(i)
            cfg.connect_all()
            sched.run_for(0.7)
    ck = cfg.make_client()
    for key in map(str, range(nclients)):
        cfg.run(rec.op(ck, "get", key))
    stores = [
        (dict(s.kv.data), dict(s.latest)) if s is not None else None
        for s in cfg.servers
    ]
    out = {
        "rows": rec.rows,
        "stores": stores,
        "now": sched.now,
        "rpcs": cfg.op_total(),
        "bytes": cfg.net.get_total_bytes(),
        "log_size": cfg.log_size(),
        "snapshot_size": cfg.snapshot_size(),
        "linearizable": rec.linearizable("kvraft"),
    }
    cfg.cleanup()
    return out


@pytest.mark.parametrize(
    "nclients,unreliable,crash,partitions,maxraftstate,seed",
    [
        (3, False, False, False, -1, 40),
        (3, True, False, False, -1, 43),
        (3, False, True, True, -1, 45),
        (3, True, True, True, 1000, 47),
    ],
    ids=["reliable", "unreliable", "crash_partitions", "snapshots_unreliable_crash"],
)
def test_kvraft_matches_reference(nclients, unreliable, crash, partitions,
                                  maxraftstate, seed, monkeypatch):
    out = run_both(kv_script, monkeypatch, nclients, unreliable, crash,
                   partitions, maxraftstate, seed)
    assert len(out["rows"]) >= 2 * nclients * 12
    if maxraftstate > 0:
        assert out["snapshot_size"] > 0


# -- shardctrler -----------------------------------------------------------


def ctrler_script(p: Pkg, unreliable, seed):
    cfg = p.ctrler_h.CtrlerHarness(3, unreliable=unreliable, seed=seed)
    ck = cfg.make_client()
    seen = []

    def snap(c):
        seen.append((c.num, list(c.shards), sorted((g, list(s)) for g, s in c.groups.items())))

    snap(cfg.run(ck.query(-1)))
    for gid in (1, 2, 3):
        cfg.run(ck.join({gid: [f"g{gid}a", f"g{gid}b"]}))
        snap(cfg.run(ck.query(-1)))
    cfg.run(ck.move(4, 1))
    # A crash of the current leader between operations.
    cfg.cluster.shutdown_server(cfg.cluster.current_leader())
    cfg.run(ck.leave([2]))
    snap(cfg.run(ck.query(-1)))
    for i in range(3):
        if cfg.cluster.handles[i] is None:
            cfg.cluster.start_server(i)
    cfg.cluster.connect_all()
    cfg.run(ck.join({4: ["g4a"], 5: ["g5a"]}))
    cfg.run(ck.leave([1, 3]))
    for num in range(-1, 9):
        snap(cfg.run(ck.query(num)))
    replicas = [
        [(c.num, list(c.shards), sorted(c.groups.items())) for c in s.configs]
        if s is not None else None
        for s in cfg.cluster.handles
    ]
    out = {"seen": seen, "replicas": replicas, "now": cfg.sched.now,
           "rpcs": cfg.net.get_total_count(), "bytes": cfg.net.get_total_bytes()}
    cfg.cleanup()
    return out


@pytest.mark.parametrize("unreliable,seed", [(False, 60), (True, 61)])
def test_shardctrler_matches_reference(unreliable, seed, monkeypatch):
    out = run_both(ctrler_script, monkeypatch, unreliable, seed)
    assert out["seen"][-1][0] == 7


# -- shardkv ---------------------------------------------------------------


def shardkv_script(p: Pkg, unreliable, seed):
    cfg = p.skv_h.ShardKVHarness(n=3, ngroups=3, unreliable=unreliable,
                                 maxraftstate=1000, seed=seed)
    sched = cfg.sched
    rec = Recorder(p, sched)
    nshards = p.ctl.NSHARDS
    cfg.join(100)
    clerks = [cfg.make_client() for _ in range(3)]

    def client(cli, ck):
        for j in range(10):
            key = str((cli * 3 + j) % nshards)
            yield from rec.op(ck, "append", key, f"({cli}.{j})")
            if j % 3 == 2:
                yield from rec.op(ck, "get", key)
            yield cfg.rng.uniform(0.005, 0.05)

    def churner():
        yield 0.2
        cfg.join(101)
        yield 0.4
        cfg.join(102)
        yield 0.4
        cfg.leave(100)
        yield 0.3
        cfg.shutdown_group(101)
        yield 0.3
        cfg.start_group(101)
        cfg.join(100)

    futs = [sched.spawn(client(i, ck)) for i, ck in enumerate(clerks)]
    churn = sched.spawn(churner())
    for f in futs:
        sched.run_until(f, max_events=10_000_000)
    sched.run_until(churn)
    sched.run_for(1.5)
    ck = cfg.make_client()
    for key in map(str, range(nshards)):
        cfg.run(rec.op(ck, "get", key))
    configs = [(c.num, list(c.shards)) for c in cfg.ctl.handles[0].configs]
    stores = {
        gid: [
            {s: (sh.state, dict(sh.data), dict(sh.latest)) for s, sh in srv.shards.items()}
            if srv is not None else None
            for srv in cfg.groups[gid].handles
        ]
        for gid in cfg.gids
    }
    out = {
        "rows": rec.rows,
        "configs": configs,
        "stores": stores,
        "now": sched.now,
        "rpcs": cfg.net.get_total_count(),
        "bytes": cfg.net.get_total_bytes(),
        "storage": cfg.total_group_storage(),
        "linearizable": rec.linearizable("shardkv"),
    }
    cfg.cleanup()
    return out


@pytest.mark.parametrize("unreliable,seed", [(False, 74), (True, 75)])
def test_shardkv_matches_reference(unreliable, seed, monkeypatch):
    out = run_both(shardkv_script, monkeypatch, unreliable, seed)
    final = {r[2]: r[5] for r in out["rows"][-ctl.NSHARDS:]}
    for cli in range(3):
        for j in range(10):
            assert f"({cli}.{j})" in final[str((cli * 3 + j) % ctl.NSHARDS)]
    # Three joins and a leave: each changed the config.
    assert len(out["configs"]) >= 6
