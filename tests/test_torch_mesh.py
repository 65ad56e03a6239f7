"""The port's groups-sharded engine (``engine/mesh.py`` and
``EngineDriver(mesh=)``) against the reference's MESH driver.

The reference's mesh is not value-identical to its one-device driver:
under ``shard_map`` each shard ticks with the local config and the same
key, so every shard draws the same election jitter, and the tick's
global predicates are evaluated per shard.  The parity target is
therefore the reference's mesh driver, plane for plane: 8 (or 4) CPU
shards of the port against the reference's mesh over the virtual CPU
devices of ``tests/conftest.py``, from one seed and one fault script,
compared after every tick on every state plane, every mailbox plane
and every scalar metric.

Also here: the six tests of ``tests/test_engine_mesh.py`` ported, the
traced bench loop's records, mesh checkpoints across the packages, the
refusals, planted faults for ``assert_zero_collectives``, the served
mesh (``serve-kv``/``serve-shardkv --mesh-devices``) in process tests
and a ``SplitKV`` pair whose drivers each run a mesh.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JaxMesh

from multiraft_tpu.engine.core import EngineConfig as JaxConfig
from multiraft_tpu.engine.core import empty_mailbox as jax_empty_mailbox
from multiraft_tpu.engine.core import init_state as jax_init_state
from multiraft_tpu.engine.host import EngineDriver as JaxDriver
from multiraft_tpu.engine.mesh import make_sharded_run_ticks_traced as jax_traced
from multiraft_tpu.engine.mesh import shard_arrays as jax_shard_arrays
from multiraft_tpu_torch import convert
from multiraft_tpu_torch.distributed.engine_wire import make_mesh
from multiraft_tpu_torch.engine import mesh as mesh_mod
from multiraft_tpu_torch.engine.core import (
    SCALAR_METRIC_KEYS,
    TRACE_KEYS,
    EngineConfig,
    empty_mailbox,
    init_state,
)
from multiraft_tpu_torch.engine.host import EngineDriver
from multiraft_tpu_torch.engine.invariants import InvariantMonitor
from multiraft_tpu_torch.engine.mesh import (
    CollectiveError,
    assert_zero_collectives,
    make_sharded_run_ticks,
    make_sharded_run_ticks_traced,
    make_sharded_tick,
    shard_arrays,
)
from multiraft_tpu_torch.utils import prng
from torch_parity import port_checkpoint_as_reference, same_delayed

torch.set_num_threads(1)

SHAPE = dict(P=3, L=32, E=4, INGEST=4)


def jax_mesh(n):
    devs = jax.devices()
    assert len(devs) >= n, f"need {n} virtual devices, have {len(devs)}"
    return JaxMesh(np.array(devs[:n]), ("groups",))


def port_mesh(n):
    return make_mesh(n, "cpu")


def mesh_pair(G, n, seed, **shape):
    shape = dict(SHAPE, **shape)
    ref = JaxDriver(JaxConfig(G=G, **shape), seed=seed, mesh=jax_mesh(n))
    port = EngineDriver(EngineConfig(G=G, **shape), seed=seed,
                        mesh=port_mesh(n))
    return ref, port


def assert_same(ref, port, where, metrics=True) -> None:
    a, b = ref.np_state(), port.np_state()
    for k in a:
        assert a[k].dtype == b[k].dtype, (where, k)
        assert np.array_equal(a[k], b[k]), (where, "state", k)
    ib = port.np_inbox()
    for k, v in ref.inbox._asdict().items():
        assert np.array_equal(np.asarray(v), ib[k]), (where, "inbox", k)
    if metrics:
        lm, pm = ref.last_metrics, port.last_metrics
        for k in SCALAR_METRIC_KEYS:
            assert int(np.asarray(lm[k])) == int(pm[k]), (where, "metric", k)
        for k in lm:
            assert np.array_equal(np.asarray(lm[k]), pm[k]), (where, "metric", k)
    assert ref.tick == port.tick, where
    assert ref.commits_total == port.commits_total, where
    assert same_delayed(ref._delayed, port._delayed), where
    assert (ref.backlog == port.backlog).all(), where


def both(drivers, fn):
    for d in drivers:
        fn(d)


# -- lockstep against the reference's mesh ---------------------------------


@pytest.mark.parametrize("G,n,seed", [(8, 4, 5), (16, 8, 29)])
def test_mesh_lockstep_with_reference_mesh_under_faults(G, n, seed):
    """Every plane, mailbox plane and scalar metric equal to the
    reference's mesh after every tick, under drops, crashes, partitions
    and reorder.  (8, 4, 5) is the run whose ``elect_dl`` leaves the
    one-device driver's at tick 31: the port's mesh follows the
    reference's mesh there, not its one-device driver."""
    ref, port = mesh_pair(G, n, seed)
    single = EngineDriver(EngineConfig(G=G, **SHAPE), seed=seed, device="cpu")
    drivers = (ref, port)
    both(drivers + (single,), lambda d: setattr(d, "drop_prob", 0.1))
    rng = np.random.default_rng(seed)
    first_divergence = None
    for t in range(160):
        if t % 3 == 0:
            both(drivers + (single,), lambda d: d.start(t % G, f"c{t}"))
        if t == 60:
            g1, g2 = int(rng.integers(G)), int(rng.integers(G))
            both(drivers, lambda d: (d.set_alive(g1, 0, False),
                                     d.partition_replica(g2, 1, False),
                                     d.set_reorder(0.5, 2, 5)))
        if t == 110:
            both(drivers, lambda d: (d.restart_replica(g1, 0),
                                     d.partition_replica(g2, 1, True),
                                     d.set_reorder(0.0)))
        both(drivers + (single,), lambda d: d.step())
        assert_same(ref, port, t)
        if first_divergence is None and t < 60:
            s, m = single.np_state(), port.np_state()
            bad = [k for k in s if not np.array_equal(s[k], m[k])]
            if bad:
                first_divergence = (single.tick, bad[0])
    assert port.commits_total > 0
    if (G, n, seed) == (8, 4, 5):
        assert first_divergence == (32, "elect_dl"), first_divergence


def test_mesh_matches_reference_mesh_not_single_device():
    """The reference's own differential (``test_engine_mesh.py:89``):
    a fault-free mesh run and a one-device run agree on ``commit`` and
    ``term``; and the port's mesh equals the reference's mesh on every
    plane, where the one-device driver's ``elect_dl`` differs."""
    ref, port = mesh_pair(8, 8, 5)
    single = EngineDriver(EngineConfig(G=8, **SHAPE), seed=5, device="cpu")
    for t in range(120):
        if t % 3 == 0:
            both((ref, port, single), lambda d: d.start(t % 8, f"c{t}"))
        both((ref, port, single), lambda d: d.step())
    assert_same(ref, port, "end")
    cm, cs = port.np_state(), single.np_state()
    assert (cm["commit"] == cs["commit"]).all()
    assert (cm["term"] == cs["term"]).all()
    assert not (cm["elect_dl"] == cs["elect_dl"]).all()


@pytest.mark.parametrize("seed", [29, 43])
def test_mesh_fuzz_faults_under_invariants(seed):
    """The reference's mesh fuzz (``test_engine_mesh.py:48``): crashes,
    restarts, live partitions, message loss and Start() load on the
    8-shard mesh, the port's invariant monitor after every tick, and the
    reference's mesh in lockstep."""
    rng = np.random.default_rng(seed)
    ref, port = mesh_pair(8, 8, seed)
    drivers = (ref, port)
    mon = InvariantMonitor(port)
    dead, cut = set(), set()
    for t in range(250):
        if rng.random() < 0.03:
            g, p = int(rng.integers(8)), int(rng.integers(3))
            if (g, p) not in dead:
                both(drivers, lambda d: d.set_alive(g, p, False))
                dead.add((g, p))
        if dead and rng.random() < 0.3:
            g, p = sorted(dead)[int(rng.integers(len(dead)))]
            both(drivers, lambda d: d.restart_replica(g, p))
            mon.note_restart(g, p)
            dead.discard((g, p))
        if rng.random() < 0.03:
            g, p = int(rng.integers(8)), int(rng.integers(3))
            if (g, p) not in cut and (g, p) not in dead:
                both(drivers, lambda d: d.partition_replica(g, p, False))
                cut.add((g, p))
        if cut and rng.random() < 0.3:
            g, p = sorted(cut)[int(rng.integers(len(cut)))]
            both(drivers, lambda d: d.partition_replica(g, p, True))
            cut.discard((g, p))
        if t % 50 == 0:
            drop = float(rng.choice([0.0, 0.1, 0.2]))
            both(drivers, lambda d: setattr(d, "drop_prob", drop))
        if rng.random() < 0.5:
            g = int(rng.integers(8))
            both(drivers, lambda d: d.start(g, f"cmd-{seed}-{t}"))
        both(drivers, lambda d: d.step())
        mon.observe()
        assert_same(ref, port, t, metrics=False)
    assert port.commits_total > 0
    for g in range(8):
        port.check_log_matching(g)


# -- the other reference mesh tests, ported ----------------------------------


def test_mesh_driver_zero_collectives_and_progress():
    """``test_engine_mesh.py:30``: construction runs the zero-collective
    check; quiet ticks elect a leader in every group and commits flow,
    with the groups staying split over the 8 shards."""
    cfg = EngineConfig(G=16, **SHAPE)
    d = EngineDriver(cfg, seed=1, mesh=port_mesh(8))
    assert d.run_until_quiet_leaders(400)
    for g in range(cfg.G):
        d.start(g, f"c{g}")
    for _ in range(30):
        d.step()
    assert d.commits_total >= cfg.G
    assert len(d._state_shards) == 8
    assert all(s.term.shape == (2, 3) for s in d._state_shards)
    assert not d.fused_eligible()


def test_mesh_fuzz_l_stress_ring_wrap_under_faults():
    """``test_engine_mesh.py:112``: a tight ring (L=16, E=INGEST=4) under
    crashes, drops and a sustained firehose on the 8-shard mesh — every
    replica wraps and compacts while the invariants hold each tick."""
    rng = np.random.default_rng(61)
    cfg = EngineConfig(G=8, P=3, L=16, E=4, INGEST=4)
    d = EngineDriver(cfg, seed=61, mesh=port_mesh(8))
    mon = InvariantMonitor(d)
    dead = set()
    for t in range(300):
        if rng.random() < 0.02:
            g, p = int(rng.integers(cfg.G)), int(rng.integers(cfg.P))
            if (g, p) not in dead:
                d.set_alive(g, p, False)
                dead.add((g, p))
        if dead and rng.random() < 0.35:
            g, p = sorted(dead)[int(rng.integers(len(dead)))]
            d.restart_replica(g, p)
            mon.note_restart(g, p)
            dead.discard((g, p))
        if t % 60 == 0:
            d.drop_prob = float(rng.choice([0.0, 0.1]))
        d.start_bulk(np.full(cfg.G, 2, np.int64))
        d.step()
        mon.observe()
    for g, p in sorted(dead):
        d.restart_replica(g, p)
        mon.note_restart(g, p)
    d.drop_prob = 0.0
    for _ in range(60):
        d.start_bulk(np.full(cfg.G, 2, np.int64))
        d.step()
        mon.observe()
    st = d.np_state()
    assert (st["base"] > 0).all(), st["base"].min()
    assert (st["commit"].max(axis=1) > 4 * cfg.L).all()
    for g in range(cfg.G):
        d.check_log_matching(g)


def test_mesh_with_service_layer():
    """``test_engine_mesh.py:161`` at G=64 (8 groups a shard): client
    ops through ``BatchedKV`` on groups at the shard boundaries, sampled
    linearizability, the groups split throughout."""
    from multiraft_tpu_torch.engine.kv import BatchedKV, KVOp
    from multiraft_tpu_torch.porcupine.types import OP_APPEND

    cfg = EngineConfig(G=64, P=3, L=32, E=8, INGEST=8)
    d = EngineDriver(cfg, seed=17, mesh=port_mesh(8))
    assert d.run_until_quiet_leaders(1200)
    sample = [0, 7, 8, 31, 32, 63]
    kv = BatchedKV(d, record_groups=sample)
    tickets = [
        kv.submit(g, KVOp(op=OP_APPEND, key=f"k{g}", value=f"[{j}]",
                          client_id=1, command_id=g * 10 + j + 1))
        for g in sample for j in range(3)
    ]
    for _ in range(400):
        kv.pump(2)
        if all(t.done for t in tickets):
            break
    assert all(t.done and not t.failed for t in tickets)
    for g in sample:
        assert kv.get(g, f"k{g}").value == "[0][1][2]"
    kv.check_sampled_linearizability()
    assert len(d._state_shards) == 8


def _initial(cfg, mesh, key):
    st = init_state(cfg, key, torch.device("cpu"))
    return shard_arrays(cfg, mesh, st), shard_arrays(
        cfg, mesh, empty_mailbox(cfg, torch.device("cpu")))


def test_sharded_run_ticks_bench_path():
    """``test_engine_mesh.py:197``: the bench's multi-tick loop over the
    mesh passes the zero-collective check and commits; each shard's
    loop equals the reference's."""
    from multiraft_tpu.engine.mesh import make_sharded_run_ticks as jax_run

    cfg = EngineConfig(G=16, **SHAPE)
    mesh = port_mesh(8)
    key = prng.PRNGKey(2)
    shards, inboxes = _initial(cfg, mesh, key)
    run = make_sharded_run_ticks(cfg, mesh, n_ticks=50, ingest_per_tick=2)
    assert assert_zero_collectives(run, shards, inboxes, key) > 0
    shards, inboxes = run(shards, inboxes, key)
    shards, inboxes = run(shards, inboxes, prng.fold_in(key, 1))
    commits = sum(int(s.commit.amax(dim=1).sum()) for s in shards)
    assert commits > 0

    jcfg = JaxConfig(G=16, **SHAPE)
    jm = jax_mesh(8)
    jkey = jax.random.PRNGKey(2)
    st = jax_shard_arrays(jcfg, jm, jax_init_state(jcfg, jkey))
    mb = jax_shard_arrays(jcfg, jm, jax_empty_mailbox(jcfg))
    jr = jax_run(jcfg, jm, n_ticks=50, ingest_per_tick=2)
    st, mb = jr(st, mb, jkey)
    st, mb = jr(st, mb, jax.random.fold_in(jkey, 1))
    got = mesh_mod.gather_arrays(shards, "cpu")
    for k, v in st._asdict().items():
        assert np.array_equal(np.asarray(v), getattr(got, k).numpy()), k


def test_sharded_traced_records_equal_reference():
    """``make_sharded_run_ticks_traced``: per-shard ``[n_ticks, G/n]``
    records that form the reference's ``[n_ticks, G]`` record, and the
    same final state."""
    cfg = EngineConfig(G=16, **SHAPE)
    mesh = port_mesh(4)
    key = prng.PRNGKey(9)
    shards, inboxes = _initial(cfg, mesh, key)
    run = make_sharded_run_ticks_traced(cfg, mesh, n_ticks=60, ingest_per_tick=3)
    shards, inboxes, recs = run(shards, inboxes, key)

    jcfg = JaxConfig(G=16, **SHAPE)
    jm = jax_mesh(4)
    jkey = jax.random.PRNGKey(9)
    st = jax_shard_arrays(jcfg, jm, jax_init_state(jcfg, jkey))
    mb = jax_shard_arrays(jcfg, jm, jax_empty_mailbox(jcfg))
    st, mb, jrec = jax_traced(jcfg, jm, 60, 3)(st, mb, jkey)
    for k in TRACE_KEYS:
        assert all(r.shape == (60, 4) for r in recs[k])
        got = torch.cat(recs[k], dim=1).numpy()
        assert np.array_equal(np.asarray(jrec[k]), got), k
    assert sum(int(r.sum()) for r in recs["accepted"]) > 0
    got = mesh_mod.gather_arrays(shards, "cpu")
    for k, v in st._asdict().items():
        assert np.array_equal(np.asarray(v), getattr(got, k).numpy()), k


# -- checkpoints across the packages ---------------------------------------


def _faulted(drivers, t0, n):
    for t in range(t0, t0 + n):
        if t % 4 == 0:
            both(drivers, lambda d: d.start(t % d.cfg.G, f"x{t}"))
        both(drivers, lambda d: d.step())


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_mesh_checkpoint_crosses_packages(direction, tmp_path):
    """A mesh checkpoint of either package restores in the other onto an
    8-device mesh and continues equal, under drops and reorder."""
    ref, port = mesh_pair(16, 8, 13)
    both((ref, port), lambda d: (setattr(d, "drop_prob", 0.1),
                                 d.set_reorder(0.3, 2, 4)))
    _faulted((ref, port), 0, 80)
    assert_same(ref, port, "before")
    path = str(tmp_path / "mesh.ckpt")
    if direction == "port_to_reference":
        port.save(path)
        out = str(tmp_path / "as_reference.ckpt")
        port_checkpoint_as_reference(path, out, convert.CHECKPOINT_CLASSES)
        restored = JaxDriver.restore(out, mesh=jax_mesh(8))
        pair = (restored, port)
    else:
        ref.save(path)
        restored = EngineDriver.restore(path, mesh=port_mesh(8))
        assert restored.mesh.size == 8
        pair = (ref, restored)
    assert_same(*pair, "restored", metrics=False)
    _faulted(pair, 80, 40)
    assert_same(*pair, "after")


def test_mesh_restore_rules(tmp_path):
    """The reference's three restore rules: a mesh checkpoint without a
    mesh is refused, onto a mesh of another size is refused, and a
    one-device checkpoint may be split onto a mesh (and continues equal
    to the reference's mesh restore of the same file)."""
    d = EngineDriver(EngineConfig(G=8, **SHAPE), seed=4, mesh=port_mesh(4))
    d.step(20)
    path = str(tmp_path / "m.ckpt")
    d.save(path)
    with pytest.raises(ValueError, match="4-device mesh"):
        EngineDriver.restore(path, device="cpu")
    with pytest.raises(ValueError, match="taken on 4 devices"):
        EngineDriver.restore(path, mesh=port_mesh(2))
    back = EngineDriver.restore(path, mesh=port_mesh(4))
    assert back.np_state().keys() == d.np_state().keys()

    one = EngineDriver(EngineConfig(G=8, **SHAPE), seed=4, device="cpu")
    one.step(20)
    single = str(tmp_path / "one.ckpt")
    one.save(single)
    port = EngineDriver.restore(single, mesh=port_mesh(8))
    ref = JaxDriver.restore(single, mesh=jax_mesh(8))
    both((ref, port), lambda d: setattr(d, "drop_prob", 0.1))
    _faulted((ref, port), 0, 30)
    assert_same(ref, port, "split onto a mesh")


def test_mesh_refusals(monkeypatch):
    with pytest.raises(ValueError, match="divide evenly"):
        EngineDriver(EngineConfig(G=6, **SHAPE), mesh=port_mesh(4))
    with pytest.raises(ValueError, match="use_kernels"):
        EngineDriver(EngineConfig(G=8, use_kernels=True, **SHAPE),
                     mesh=port_mesh(2))
    with pytest.raises(ValueError, match="device=None"):
        EngineDriver(EngineConfig(G=8, **SHAPE), device="cpu",
                     mesh=port_mesh(2))
    with pytest.raises(ValueError, match="must be positive"):
        make_mesh(0, "cpu")
    # More cards than are visible: refused, never served from the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 > 1 visible"):
        make_mesh(2)
    assert [str(x) for x in make_mesh(1).devices] == ["cuda:0"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="1 > 0 visible"):
        make_mesh(1)
    d = EngineDriver(EngineConfig(G=8, **SHAPE), mesh=port_mesh(2))
    with pytest.raises(RuntimeError, match="steps serially"):
        d.dispatch_ticks(2)


# -- the zero-collective check, with planted faults ------------------------


def _example(n=2):
    cfg = EngineConfig(G=8, **SHAPE)
    mesh = port_mesh(n)
    key = prng.PRNGKey(3)
    shards, inboxes = _initial(cfg, mesh, key)
    cmds = [torch.zeros(8 // n, dtype=torch.int32) for _ in range(n)]
    return cfg, mesh, (shards, inboxes, cmds, key)


def test_zero_collectives_clean_step():
    cfg, mesh, ex = _example(4)
    assert assert_zero_collectives(make_sharded_tick(cfg, mesh), *ex) > 100


@pytest.mark.parametrize("fault,match", [
    ("other_shard", "reads a tensor of shard 0"),
    ("cross_device", "copies cpu -> meta"),
    ("host_sync", "synchronises with the host"),
])
def test_zero_collectives_catches_planted_faults(fault, match, monkeypatch):
    """Each fault the check exists for, planted in the local tick, makes
    it fail: a read of another shard's tensor, a copy across devices, a
    synchronisation with the host."""
    cfg, mesh, ex = _example(2)
    real = mesh_mod.tick_impl
    seen = []

    def planted(lcfg, state, inbox, new_cmds, key):
        seen.append(state)
        if fault == "other_shard" and len(seen) % 2 == 0:  # shard 1
            state = state._replace(term=state.term + seen[-2].term)
        elif fault == "cross_device":
            state.term.to("meta")
        elif fault == "host_sync":
            int(state.term.sum())
        return real(lcfg, state, inbox, new_cmds, key)

    monkeypatch.setattr(mesh_mod, "tick_impl", planted)
    step = make_sharded_tick(cfg, mesh)
    step(*ex)  # the plain step runs: only the check refuses it
    with pytest.raises(CollectiveError, match=match):
        assert_zero_collectives(step, *ex)


# -- served: the mesh behind TCP, in processes ----------------------------


def _native():
    from multiraft_tpu_torch.distributed.native import native_available

    if not native_available():
        pytest.fail("native transport did not build")


def test_engine_kv_mesh_durable_restart(tmp_path, monkeypatch):
    """``test_distributed.py:1041`` on the CPU: a ``serve-kv`` process
    splits its engine over 8 shards, serves over TCP, dies, and restores
    its checkpoint back onto the mesh."""
    from multiraft_tpu_torch.distributed.cluster import EngineProcessCluster

    _native()
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cluster = EngineProcessCluster(
        kind="engine_kv", groups=16, seed=8, mesh_devices=8,
        data_dir=str(tmp_path / "mesh-engine"), checkpoint_every_s=2.0,
        device="cpu",
    )
    try:
        cluster.start()
        ck = cluster.clerk()
        try:
            for i in range(6):
                ck.put(f"m{i}", f"v{i}")
            import time

            time.sleep(2.5)  # let a checkpoint land
            ck.append("m0", "+wal")
        finally:
            ck.close()
        cluster.kill()
        cluster.start()  # the restore splits the checkpoint onto the mesh
        ck = cluster.clerk()
        try:
            assert ck.get("m0") == "v0+wal"
            for i in range(1, 6):
                assert ck.get(f"m{i}") == f"v{i}"
            ck.put("m-after", "restart")
            assert ck.get("m-after") == "restart"
        finally:
            ck.close()
    finally:
        cluster.shutdown()


def test_engine_fleet_mesh_migration(tmp_path, monkeypatch):
    """``test_distributed.py:1078`` on the CPU: two durable fleet
    processes, each splitting its engine over 2 shards, migrating shards
    between them over TCP."""
    from multiraft_tpu_torch.distributed.cluster import EngineFleetCluster

    _native()
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    fleet = EngineFleetCluster(
        [[1], [2]], seed=29, mesh_devices=2,
        data_dir=str(tmp_path / "fleet-mesh"), device="cpu",
    )
    try:
        fleet.start_all()
        fleet.admin("join", [1])
        ck = fleet.clerk()
        try:
            kv = {chr(110 + i): f"v{i}" for i in range(6)}
            for k, v in kv.items():
                ck.put(k, v)
            fleet.admin("join", [2])  # cross-process, cross-mesh migration
            assert all(ck.get(k) == v for k, v in kv.items())
            ck.append("n", "+mesh")
            assert ck.get("n") == kv["n"] + "+mesh"
        finally:
            ck.close()
    finally:
        fleet.shutdown()


def test_serve_kv_cli_refuses_more_cards_than_visible(tmp_path):
    """``serve-kv --mesh-devices 2`` on a host without cards exits
    non-zero before it listens: no CPU fallback."""
    import subprocess
    import sys

    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    out = subprocess.run(
        [sys.executable, "-m", "multiraft_tpu_torch", "serve-kv",
         "--mesh-devices", "2", "--groups", "8"],
        cwd=root, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(root),
             "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"},
    )
    assert out.returncode != 0
    assert "ready" not in out.stdout


# -- split groups across two mesh drivers ----------------------------------


def test_split_pair_of_mesh_drivers():
    """``__graft_entry__._dryrun_split_groups`` with 8 shards: two
    drivers, each split over 4 shards, share every group's 3 peer slots
    (1 on side 0, 2 on side 1) through boundary slabs; elections and
    commits cross, both sides apply the same state, and killing side 0
    fails over to side 1's quorum with every acknowledged write intact."""
    from multiraft_tpu_torch.engine.kv import KVOp
    from multiraft_tpu_torch.engine.split import SplitKV, SplitPeering, SplitSpec
    from multiraft_tpu_torch.porcupine.types import OP_APPEND

    half, G = 4, 8
    owners = {g: [0, 1, 1] for g in range(G)}
    sides = []
    for me in (0, 1):
        drv = EngineDriver(
            EngineConfig(G=G, P=3, L=32, E=4, INGEST=4,
                         host_paced_compaction=True),
            seed=31 + me, mesh=port_mesh(half),
        )
        kv = SplitKV(drv)
        sides.append((kv, SplitPeering(drv, kv, SplitSpec(me=me, owners=owners))))
    d1 = sides[1][0].driver
    d1.state = d1.state._replace(elect_dl=d1.state.elect_dl + 300)
    alive = [True, True]

    def shuttle(rounds):
        for _ in range(rounds):
            for i, (kv, peering) in enumerate(sides):
                if not alive[i]:
                    continue
                kv.pump(1)
                for proc, slab in peering.extract().items():
                    if alive[proc]:
                        sides[proc][1].inject(slab)

    def leader_side(g):
        for i, (kv, _) in enumerate(sides):
            if alive[i] and kv.local_leader(g) is not None:
                return i
        return None

    next_cmd = [0]

    def run_op(g, op, rounds=600):
        next_cmd[0] += 1
        op.client_id, op.command_id = 7, next_cmd[0]
        for _ in range(rounds):
            i = leader_side(g)
            t = sides[i][0].submit_local(g, op) if i is not None else None
            if t is None:
                shuttle(1)
                continue
            for _ in range(rounds):
                shuttle(1)
                if t.done:
                    break
            if t.done and not t.failed:
                return
        raise AssertionError(f"split-group op on g={g} never committed")

    for _ in range(400):
        shuttle(1)
        if all(leader_side(g) is not None for g in range(G)):
            break
    assert all(leader_side(g) == 0 for g in range(G))
    for g in range(G):
        run_op(g, KVOp(op=OP_APPEND, key="k", value=f"[pre{g}]"))
    shuttle(30)
    assert all(sides[0][0].data[g] == sides[1][0].data[g] for g in range(G))
    alive[0] = False
    for _ in range(800):
        shuttle(1)
        if all(leader_side(g) is not None for g in range(G)):
            break
    assert all(leader_side(g) == 1 for g in range(G))
    for g in range(G):
        run_op(g, KVOp(op=OP_APPEND, key="k", value=f"[post{g}]"))
        assert sides[1][0].data[g]["k"] == f"[pre{g}][post{g}]"
