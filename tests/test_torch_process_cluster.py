"""The per-replica half of the port's process clusters
(``distributed/cluster.py``): ``serve_kv``, ``serve_ctrler`` and
``serve_shardkv`` as OS processes over TCP with disk persistence,
driven by ``KVProcessCluster`` and ``ShardKVProcessCluster``.  These
kinds run the host-only Raft stack and touch no device.

* The reference's process-cluster cases of ``tests/test_distributed.py``
  on the port: minority crash and restart, a full-cluster restart from
  disk, shard migration across groups over real sockets with a killed
  replica, and a controller replica crash.
* A porcupine-checked concurrent clerk load against each cluster.
* Across packages: the reference's blocking clerks against the port's
  servers and the port's clerks against the reference's servers, each
  history checked by porcupine.
"""

from __future__ import annotations

import time

import pytest

from multiraft_tpu_torch.distributed.native import native_available
from multiraft_tpu_torch.harness.nemesis import run_clerk_load
from multiraft_tpu_torch.porcupine.kv import kv_model
from multiraft_tpu_torch.porcupine.visualization import assert_linearizable

needs_native = pytest.mark.skipif(
    not native_available(), reason="native transport did not build"
)

pytestmark = pytest.mark.timeout_s(240)


@needs_native
class TestProcessCluster:
    def test_survives_minority_crash_and_restart(self, tmp_path):
        from multiraft_tpu_torch.distributed.cluster import KVProcessCluster

        cluster = KVProcessCluster(3, str(tmp_path))
        try:
            cluster.start_all()
            clerk = cluster.clerk()
            clerk.put("a", "1")
            clerk.append("a", "2")
            assert clerk.get("a") == "12"

            # Hard-kill one server; quorum of 2 keeps serving.
            cluster.kill(0)
            clerk.put("b", "x")
            assert clerk.get("b") == "x"

            # Restart it from its data dir; full cluster serves on.
            cluster.start(0)
            clerk.append("a", "3")
            assert clerk.get("a") == "123"
            clerk.close()
        finally:
            cluster.shutdown()

    def test_data_survives_full_cluster_restart(self, tmp_path):
        from multiraft_tpu_torch.distributed.cluster import KVProcessCluster

        cluster = KVProcessCluster(3, str(tmp_path))
        try:
            cluster.start_all()
            clerk = cluster.clerk()
            clerk.put("persisted", "yes")
            clerk.close()

            for i in range(3):
                cluster.kill(i)
            cluster.start_all()

            clerk2 = cluster.clerk()
            assert clerk2.get("persisted") == "yes"
            clerk2.close()
        finally:
            cluster.shutdown()


# ---------------------------------------------------------------------------
# Sharded multi-process cluster: controller + shard groups over TCP
# ---------------------------------------------------------------------------


@needs_native
class TestShardProcessCluster:
    def test_sharded_stack_migration_and_crash(self, tmp_path):
        """The full sharded deployment: 3 controller replicas + 2 groups
        x 3 replicas as 9 OS processes. Shard migration runs over real
        sockets (groups pull from each other via host:port make_end);
        a SIGKILLed replica recovers from disk."""
        from multiraft_tpu_torch.distributed.cluster import ShardKVProcessCluster

        cluster = ShardKVProcessCluster(
            str(tmp_path), gids=(100, 101), n=3
        )
        try:
            cluster.start_all()
            cluster.join(100)
            clerk = cluster.clerk()
            keys = [str(i) for i in range(10)]  # one per shard
            for k in keys:
                clerk.put(k, "v" + k)
            for k in keys:
                assert clerk.get(k) == "v" + k

            # Join the second group: some shards migrate over TCP.
            cluster.join(101)
            conf = cluster.query()
            assert sorted(conf.groups) == [100, 101]
            for k in keys:
                assert clerk.get(k) == "v" + k, f"key {k} lost in migration"

            # Hard-kill one replica of group 100; quorum keeps serving.
            cluster.kill((100, 0))
            for k in keys[:3]:
                clerk.append(k, "+")
                assert clerk.get(k) == "v" + k + "+"

            # Restart from disk; then drain group 100 entirely.
            cluster.start_server(100, 0)
            cluster.leave(100)
            deadline = time.time() + 60
            while True:
                conf = cluster.query()
                if list(conf.groups) == [101]:
                    break
                assert time.time() < deadline, "leave(100) never committed"
                time.sleep(0.5)
            for k in keys:
                expect = "v" + k + ("+" if k in keys[:3] else "")
                assert clerk.get(k) == expect, (
                    f"key {k} lost when group 100 left"
                )
            clerk.close()
        finally:
            cluster.shutdown()

    def test_controller_replica_crash_during_ops(self, tmp_path):
        """Kill one controller replica (possibly its leader): admin
        ops and client routing keep working on the remaining quorum,
        and the replica rejoins from disk."""
        from multiraft_tpu_torch.distributed.cluster import ShardKVProcessCluster

        cluster = ShardKVProcessCluster(str(tmp_path), gids=(100,), n=3)
        try:
            cluster.start_all()
            cluster.join(100)
            clerk = cluster.clerk()
            clerk.put("a", "1")
            cluster.kill(("ctrler", 0))
            # Admin + data paths survive on the 2/3 controller quorum.
            conf = cluster.query()
            assert 100 in conf.groups
            clerk.append("a", "2")
            assert clerk.get("a") == "12"
            cluster.start_ctrler(0)  # disk recovery
            assert 100 in cluster.query().groups
            clerk.put("b", "x")
            assert clerk.get("b") == "x"
            clerk.close()
        finally:
            cluster.shutdown()


def test_check_ready_times_out_on_hung_child():
    """A child that starts but never prints 'ready' (hung import) must
    not wedge the launcher: _check_ready kills it and raises."""
    import subprocess
    import sys
    import time

    from multiraft_tpu_torch.distributed.cluster import _check_ready


# ---------------------------------------------------------------------------
# Porcupine-checked clerk load, and clerks across the two packages
# ---------------------------------------------------------------------------


def _with_id(ck):
    """run_clerk_load labels each operation with the clerk's id."""
    ck.client_id = ck._clerk.client_id
    return ck


def _cluster_cls(pkg, name):
    import importlib

    return getattr(importlib.import_module(f"{pkg}.distributed.cluster"), name)


@needs_native
@pytest.mark.parametrize("servers,clerks", [
    ("multiraft_tpu_torch", "multiraft_tpu_torch"),
    ("multiraft_tpu_torch", "multiraft_tpu"),
    ("multiraft_tpu", "multiraft_tpu_torch"),
])
def test_kv_cluster_clerk_load_is_linearizable(servers, clerks, tmp_path):
    cluster = _cluster_cls(servers, "KVProcessCluster")(3, str(tmp_path))
    clerk_cls = _cluster_cls(clerks, "BlockingClerk")
    try:
        cluster.start_all()
        history = run_clerk_load(
            lambda: _with_id(clerk_cls(cluster.ports)),
            keys=["x", "y"], n_workers=3, ops_per_worker=6,
            op_timeout=60.0,
        )
        assert len(history) == 18
        assert_linearizable(kv_model, history, timeout=30.0,
                            name=f"kv-{servers}-{clerks}")
    finally:
        cluster.shutdown()


@needs_native
@pytest.mark.parametrize("servers,clerks", [
    ("multiraft_tpu_torch", "multiraft_tpu_torch"),
    ("multiraft_tpu_torch", "multiraft_tpu"),
    ("multiraft_tpu", "multiraft_tpu_torch"),
])
def test_shard_cluster_clerk_load_is_linearizable(servers, clerks, tmp_path):
    cluster = _cluster_cls(servers, "ShardKVProcessCluster")(
        str(tmp_path), gids=(100, 101), n=3, nctrlers=3,
    )
    clerk_cls = _cluster_cls(clerks, "BlockingShardClerk")
    try:
        cluster.start_all()
        cluster.join(100)
        cluster.join(101)
        history = run_clerk_load(
            lambda: _with_id(clerk_cls(cluster.ctrler_ports)),
            keys=["1a", "5b", "8c"], n_workers=3, ops_per_worker=6,
            op_timeout=90.0,
        )
        assert len(history) == 18
        assert_linearizable(kv_model, history, timeout=30.0,
                            name=f"shardkv-{servers}-{clerks}")
        assert sorted(cluster.query().groups) == [100, 101]
    finally:
        cluster.shutdown()


def test_per_replica_kinds_are_served():
    """No server kind of the reference is refused any more."""
    import inspect

    from multiraft_tpu_torch.distributed import cluster

    src = inspect.getsource(cluster._server_main)
    for kind in ("kv", "ctrler", "shardkv"):
        assert f'kind == "{kind}"' in src
    assert "NotImplementedError" not in inspect.getsource(cluster)
