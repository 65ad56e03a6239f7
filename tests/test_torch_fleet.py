"""The port's engine fleet: several ``serve_engine_shardkv`` processes
splitting one gid space, shards migrating between them over
``pull_shard``/``delete_shard`` RPCs, every engine on the CPU.

The engine-fleet tests of the reference's ``tests/test_distributed.py``
(its two mesh tests are ported in ``tests/test_torch_mesh.py``), run
against the port's ``EngineFleetCluster``: cross-process migration,
batch frames, durable restart, linearizability across a migration
(checked by the port's porcupine and the reference's, with one
verdict), a crash mid-migration, and the redo of a write acknowledged
before a migration.  These are the first tests of the port's ``ShardWalReplay``
and fleet clerks.  Two cross-package fleets: the port's fleet clerk
against the reference's fleet, and a mixed fleet of one process of each
package migrating shards between them.
"""

import threading
import time

import pytest
import torch

import multiraft_tpu.porcupine.checker as ref_checker
import multiraft_tpu.porcupine.kv as ref_kv
import multiraft_tpu.porcupine.model as ref_model
from multiraft_tpu_torch.distributed.cluster import EngineFleetCluster
from multiraft_tpu_torch.distributed.engine_cluster import BlockingFleetClerk
from multiraft_tpu_torch.distributed.native import native_available
from multiraft_tpu_torch.porcupine.checker import check_operations
from multiraft_tpu_torch.porcupine.kv import OP_APPEND, OP_GET, KvInput, KvOutput, kv_model
from multiraft_tpu_torch.porcupine.model import Operation
from multiraft_tpu_torch.porcupine.native import native_available as checker_native
from multiraft_tpu_torch.sim.scheduler import TIMEOUT

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native transport did not build"
)


@pytest.fixture(autouse=True)
def _one_thread_children(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _fleet(seed, **kw):
    return EngineFleetCluster([[1], [2]], seed=seed, device="cpu", **kw)


def test_engine_fleet_cross_process_migration():
    fleet = _fleet(3)
    try:
        fleet.start_all()
        fleet.admin("join", [1])
        ck = fleet.clerk()
        try:
            kv = {chr(97 + i): f"v{i}" for i in range(10)}
            for k, v in kv.items():
                ck.put(k, v)
            fleet.admin("join", [2])  # ~half the shards cross processes
            for k, v in kv.items():
                assert ck.get(k) == v, f"{k} lost in cross-process migration"
            for k in kv:
                ck.append(k, "+")
            for k, v in kv.items():
                assert ck.get(k) == v + "+"
        finally:
            ck.close()
    finally:
        fleet.shutdown()


def test_engine_fleet_batch_frames():
    from multiraft_tpu_torch.distributed.engine_server import PipelinedFleetClerk
    from multiraft_tpu_torch.distributed.tcp import RpcNode

    fleet = _fleet(47)
    cli = None
    try:
        fleet.start_all()
        fleet.admin("join", [1])
        cli = RpcNode()
        sched = cli.sched
        ck = PipelinedFleetClerk(sched, {g: cli.client_end(*a)
                                         for g, a in fleet.owner_addrs.items()})
        keys = [chr(97 + i) for i in range(12)]
        ops = [("Append", k, f"<{j}>") for j, k in enumerate(keys)]
        ops += [("Get", k, "") for k in keys]
        vals = sched.wait(sched.spawn(ck.run_batch(ops)), 120.0)
        assert vals is not TIMEOUT
        assert vals[len(keys):] == [f"<{j}>" for j in range(len(keys))]
        fleet.admin("join", [2])
        ops2 = [("Append", k, f"[{j}]") for j, k in enumerate(keys)]
        ops2 += [("Get", k, "") for k in keys]
        vals2 = sched.wait(sched.spawn(ck.run_batch(ops2)), 180.0)
        assert vals2 is not TIMEOUT
        assert vals2[len(keys):] == [f"<{j}>[{j}]" for j in range(len(keys))]
        ck.command_id -= len(keys)  # whole-batch replay: exactly-once
        vals3 = sched.wait(sched.spawn(ck.run_batch(ops2)), 120.0)
        assert vals3 is not TIMEOUT
        assert vals3[len(keys):] == [f"<{j}>[{j}]" for j in range(len(keys))], (
            "frame replay double-applied")
    finally:
        if cli is not None:
            cli.close()
        fleet.shutdown()


def test_engine_fleet_durable_process_restart(tmp_path):
    fleet = _fleet(9, data_dir=str(tmp_path / "fleet"), checkpoint_every_s=3600.0)
    try:
        fleet.start_all()
        fleet.admin("join", [1])
        ck = fleet.clerk()
        try:
            kv = {chr(97 + i): f"v{i}" for i in range(8)}
            for k, v in kv.items():
                ck.put(k, v)
            fleet.admin("join", [2])
            assert all(ck.get(k) == v for k, v in kv.items())
            # Recovery of the process hosting gid 2 is pure WAL replay.
            fleet.kill(1)
            fleet.start(1)
            for k, v in kv.items():
                assert ck.get(k) == v, f"{k} lost in fleet process restart"
            ck.append("a", "+back")
            assert ck.get("a") == kv["a"] + "+back"
        finally:
            ck.close()
    finally:
        fleet.shutdown()


def _as_reference(history):
    return [
        ref_model.Operation(
            op.client_id,
            ref_kv.KvInput(op=op.input.op, key=op.input.key, value=op.input.value),
            op.call, ref_kv.KvOutput(value=op.output.value), op.ret,
        )
        for op in history
    ]


def _clerk_traffic(make_clerk, keys, n_workers, n_ops, history, during):
    """``n_workers`` clerk threads of appends and gets; ``during`` runs
    on this thread meanwhile.  Returns each worker's errors."""
    lock, errors = threading.Lock(), []

    def worker(wid):
        ck = make_clerk()
        try:
            for j in range(n_ops):
                key = keys[(wid + j) % len(keys)]
                t0 = time.monotonic()
                if j % 3 == 2:
                    inp, out = KvInput(op=OP_GET, key=key), KvOutput(value=ck.get(key))
                else:
                    tag = f"({wid}.{j})"
                    ck.append(key, tag)
                    inp = KvInput(op=OP_APPEND, key=key, value=tag)
                    out = KvOutput(value="")
                with lock:
                    history.append(Operation(ck.client_id, inp, t0, out,
                                             time.monotonic()))
        except BaseException as e:  # surfaced by the caller
            errors.append(e)
        finally:
            ck.close()

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(n_workers)]
    for t in threads:
        t.start()
    during()
    for t in threads:
        t.join(timeout=180)
    return errors


def _tags_once(ck, keys, n_workers, n_ops):
    for key in keys:
        v = ck.get(key)
        for wid in range(n_workers):
            for j in range(n_ops):
                tag = f"({wid}.{j})"
                want = keys[(wid + j) % len(keys)] == key and j % 3 != 2
                assert v.count(tag) == (1 if want else 0), (tag, key, v)


def test_engine_fleet_linearizable_across_migration():
    """Concurrent clerks while a join migrates shards between the two
    processes: the port's checker (native DFS) and the reference's give
    the same verdict, not ILLEGAL; appends exactly-once."""
    fleet = _fleet(17)
    try:
        fleet.start_all()
        fleet.admin("join", [1])
        history = []
        keys = ["fa", "fb", "fc"]
        errors = _clerk_traffic(fleet.clerk, keys, 3, 8, history,
                                lambda: fleet.admin("join", [2]))
        assert not errors, errors
        ck = fleet.clerk()
        try:
            _tags_once(ck, keys, 3, 8)
        finally:
            ck.close()
        assert len(history) == 24
        assert checker_native()
        mine = check_operations(kv_model, history, timeout=30.0)
        theirs = ref_checker.check_operations(ref_kv.kv_model, _as_reference(history),
                                              timeout=30.0)
        assert mine.value == theirs.value != "illegal"
    finally:
        fleet.shutdown()


def test_engine_fleet_durable_crash_mid_migration(tmp_path):
    fleet = _fleet(37, data_dir=str(tmp_path / "midmig"), checkpoint_every_s=3600.0)
    try:
        fleet.start_all()
        fleet.admin("join", [1])
        ck = fleet.clerk()
        try:
            kv = {chr(97 + i): f"v{i}" for i in range(10)}
            for k, v in kv.items():
                ck.put(k, v)
            fleet.admin("join", [2])
            fleet.kill(1)  # pulls and GC race the SIGKILL
            fleet.start(1)
            for k, v in kv.items():
                assert ck.get(k) == v, f"{k} lost in mid-migration crash"
            for k in list(kv)[:4]:
                ck.append(k, "+post")
                assert ck.get(k) == kv[k] + "+post"
        finally:
            ck.close()
    finally:
        fleet.shutdown()


def test_fleet_redo_preserves_write_acked_before_migration(tmp_path):
    """A write acked at the old owner just before a config change, the
    process crashing before any pull: the restarted old owner serves
    the write from its BEPULLING slot to the puller."""
    from multiraft_tpu_torch.distributed.engine_server import EngineCmdArgs
    from multiraft_tpu_torch.distributed.tcp import RpcNode
    from multiraft_tpu_torch.services.shardctrler import rebalance
    from multiraft_tpu_torch.services.shardkv import key2shard

    fleet = _fleet(53, data_dir=str(tmp_path / "redo"), checkpoint_every_s=3600.0)
    fleet.start(0)  # process 1 stays down: no pull can happen
    probe = RpcNode()
    try:
        a = probe.client_end(fleet.host, fleet.ports[0])

        def call(svc_meth, args, timeout=30.0):
            r = probe.sched.wait(a.call(svc_meth, args), timeout)
            assert r is not None and r is not TIMEOUT, f"{svc_meth} failed"
            return r

        assert call("EngineShardKV.admin", ("join", [1], 1)).err == "OK"
        cfg2 = rebalance([1] * 10, {1: ["a"], 2: ["b"]})
        shard2 = next(s for s in range(10) if cfg2[s] == 2)
        key = next(chr(c) for c in range(97, 123) if key2shard(chr(c)) == shard2)
        rep = call("EngineShardKV.command", EngineCmdArgs(
            op="Put", key=key, value="acked-pre-migration",
            client_id=777, command_id=1))
        assert rep.err == "OK"
        assert call("EngineShardKV.admin", ("join", [2], 2)).err == "OK"
        time.sleep(0.3)
        fleet.kill(0)
        fleet.start(0)
        blob = call("EngineShardKV.pull_shard", (1, shard2, 2), 60.0)
        assert blob[0] == "OK", blob
        assert blob[1].get(key) == "acked-pre-migration", blob[1]
        fleet.start(1)
        b = probe.client_end(fleet.host, fleet.ports[1])
        for args in (("join", [1], 1), ("join", [2], 2)):
            rb = probe.sched.wait(b.call("EngineShardKV.admin", args), 30.0)
            assert rb is not None and rb is not TIMEOUT and rb.err == "OK"
        ck = fleet.clerk()
        try:
            assert ck.get(key) == "acked-pre-migration"
        finally:
            ck.close()
    finally:
        probe.close()
        fleet.shutdown()


def test_port_fleet_clerk_against_the_reference_fleet():
    """The reference's fleet processes, driven by the port's fleet
    clerk across a cross-process migration."""
    from multiraft_tpu.distributed.cluster import EngineFleetCluster as RefFleet

    fleet = RefFleet([[1], [2]], seed=61)
    try:
        fleet.start_all()
        fleet.admin("join", [1])
        ck = BlockingFleetClerk(fleet.owner_addrs)
        try:
            kv = {chr(97 + i): f"r{i}" for i in range(8)}
            for k, v in kv.items():
                ck.put(k, v)
            fleet.admin("join", [2])
            for k, v in kv.items():
                ck.append(k, "+")
                assert ck.get(k) == v + "+", k
        finally:
            ck.close()
    finally:
        fleet.shutdown()


def test_mixed_fleet_migrates_shards_between_the_packages():
    """One fleet process of each package (gid 1 on the port's, gid 2 on
    the reference's): a join moves shards from the port's process to
    the reference's, a leave moves them all back; clerks of both
    packages read every acknowledged write, appends exactly once."""
    from multiraft_tpu.distributed import launch as ref_launch
    from multiraft_tpu.distributed.engine_cluster import (
        BlockingFleetClerk as RefFleetClerk,
    )
    from multiraft_tpu_torch.distributed import launch

    fleet = _fleet(71)
    try:
        fleet.procs[0] = launch.launch_server(fleet.specs[0], "mixed-port")
        ref_spec = {k: v for k, v in fleet.specs[1].items() if k != "device"}
        ref_spec["platform"] = "cpu"
        fleet.procs[1] = ref_launch.launch_server(ref_spec, "mixed-ref")
        launch.check_ready(fleet.procs[0], "mixed-port")
        ref_launch.check_ready(fleet.procs[1], "mixed-ref")
        fleet.admin("join", [1])
        port_ck = fleet.clerk()
        ref_ck = RefFleetClerk(fleet.owner_addrs)
        try:
            kv = {chr(97 + i): f"m{i}" for i in range(10)}
            for i, (k, v) in enumerate(kv.items()):
                (port_ck if i % 2 else ref_ck).put(k, v)
            fleet.admin("join", [2])  # port process -> reference process
            for k in kv:
                port_ck.append(k, "<p>")
            fleet.admin("leave", [2])  # and back
            for k in kv:
                ref_ck.append(k, "<r>")
            for k, v in kv.items():
                assert port_ck.get(k) == ref_ck.get(k) == v + "<p><r>", k
        finally:
            port_ck.close()
            ref_ck.close()
    finally:
        fleet.shutdown()
