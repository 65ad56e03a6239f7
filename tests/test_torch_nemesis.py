"""The port's nemesis harness (``harness/nemesis.py``) and the open-loop
burst behind its ``load_surge`` window (``benchmarks/openloop.py``).

* The reference's unit cases (``tests/test_chaos.py``,
  ``tests/test_placement.py``'s kill verb) on the port: seeded
  schedules, the gray kinds and their hit specs, the injected-surge
  ``Nemesis`` run and its silent-miss verdict, ``kill_mesh_process``.
* Parity: ``make_schedule`` equals the reference's for seeds x
  ``n_procs`` x ``include`` sets, with crashes, permanent kills,
  replica kills and load surges; the open-loop schedule equals the
  reference generator's (``benchmarks/openloop.py``) from the same seed.
* The port's own surge driver against a port ``serve-shardkv`` process
  on the CPU: the window's burst reaches the server and verifies.
"""

from __future__ import annotations

import functools

import pytest

from multiraft_tpu_torch.distributed.chaos import install_chaos
from multiraft_tpu_torch.distributed.native import native_available
from multiraft_tpu_torch.harness.nemesis import Nemesis, make_schedule

needs_native = pytest.mark.skipif(
    not native_available(), reason="native transport did not build"
)


class _Echo:
    def ping(self, args):
        return ("pong", args)


def test_make_schedule_same_seed_same_schedule():
    kw = dict(duration_s=9.0, crash_procs=[1], crash_down_s=0.5)
    s1 = make_schedule(7, 3, **kw)
    s2 = make_schedule(7, 3, **kw)
    assert s1 == s2
    assert make_schedule(8, 3, **kw) != s1  # seed actually matters
    kinds = [k for _, k, _ in s1]
    assert kinds[-1] == "heal" and kinds.count("crash") == 1
    assert all(at <= s1[-1][0] for at, _, _ in s1)


def test_make_schedule_partition_needs_two_procs():
    sched = make_schedule(3, 1, duration_s=5.0, include=("partition",))
    assert [k for _, k, _ in sched] == ["heal"]


def test_make_schedule_load_surge_window():
    kw = dict(duration_s=6.0, surge_rate=1500.0, surge_dur_s=1.2)
    s1 = make_schedule(7, 2, **kw)
    assert s1 == make_schedule(7, 2, **kw)
    surges = [(at, p) for at, k, p in s1 if k == "load_surge"]
    assert surges == [(2.4, {"proc": 0, "rate": 1500.0, "dur": 1.2})]
    # The heal still closes the schedule, after the surge window ends.
    assert s1[-1][1] == "heal" and s1[-1][0] >= 2.4 + 1.2
    # No surge_rate, no surge window (the default schedule is unchanged).
    assert not any(
        k == "load_surge" for _, k, _ in make_schedule(7, 2, duration_s=6.0)
    )


@needs_native
def test_nemesis_load_surge_runs_and_verifies():
    """The load_surge verb end to end with an injected burst driver:
    the window opens at its scheduled instant, the driver fires with
    the schedule's (rate, dur), the replied count lands as the
    window's hits, and verify_windows(require_hits) accepts it."""
    from multiraft_tpu_torch.distributed.tcp import RpcNode

    server = RpcNode(listen=True)
    server.add_service("Echo", _Echo())
    install_chaos(server, seed=2)
    fired = []

    def fake_surge(host, port, rate, dur, seed):
        fired.append((host, port, rate, dur, seed))
        return 37  # "37 requests got replies"

    sched = make_schedule(
        9, 1, duration_s=0.6, include=(),
        surge_rate=800.0, surge_dur_s=0.2,
    )
    assert [k for _, k, _ in sched] == ["load_surge", "heal"]
    nem = Nemesis([(server.host, server.port)], surge_fire=fake_surge)
    try:
        nem.run(sched)  # verify=True: must not raise
        assert fired == [(server.host, server.port, 800.0, 0.2,
                          800 + 1009 * 0)]
        (w,) = nem.windows
        assert w["kind"] == "load_surge" and w["acked"]
        assert w["hits"] == 37 and w["t_stop_us"] is not None
        nem.verify_windows(require_hits=("load_surge",))
        kinds = [(ph, k) for ph, k, _ in nem.applied]
        assert ("start", "load_surge") in kinds
        assert ("stop", "load_surge") in kinds
    finally:
        nem.close()
        server.close()


@needs_native
def test_nemesis_load_surge_failed_burst_is_a_silent_miss():
    """A burst driver that errors (or a server that never replied)
    must FAIL verification — a surge that never reached the fleet is
    exactly the false green verify_windows exists to catch."""
    from multiraft_tpu_torch.distributed.tcp import RpcNode
    from multiraft_tpu_torch.harness.nemesis import NemesisVerificationError

    server = RpcNode(listen=True)
    install_chaos(server, seed=2)

    def broken_surge(host, port, rate, dur, seed):
        raise RuntimeError("generator never started")

    sched = make_schedule(
        9, 1, duration_s=0.4, include=(),
        surge_rate=500.0, surge_dur_s=0.1,
    )
    nem = Nemesis([(server.host, server.port)], surge_fire=broken_surge)
    try:
        with pytest.raises(NemesisVerificationError, match="load_surge"):
            nem.run(sched)
        (w,) = nem.windows
        assert not w["acked"] and "surge burst failed" in w["excused"]
    finally:
        nem.close()
        server.close()


def test_make_schedule_gray_kinds_deterministic():
    gray = ("asym_partition", "partial_partition", "slow_link",
            "fsync_stall")
    s1 = make_schedule(3, 3, duration_s=9.0, include=gray)
    assert s1 == make_schedule(3, 3, duration_s=9.0, include=gray)
    kinds = {k for _, k, _ in s1}
    assert kinds - {"heal"} <= set(gray)
    assert len(kinds - {"heal"}) >= 2
    for _, k, p in s1:
        if k == "slow_link":
            assert 0.0 < p["floor"] < 1.0
        if k == "fsync_stall":
            assert 0.0 < p["stall"] < 1.0
        if k == "asym_partition":
            assert p["a"] != p["b"]

def test_gray_pairwise_kinds_need_two_procs():
    sched = make_schedule(
        3, 1, duration_s=6.0,
        include=("asym_partition", "partial_partition", "slow_link",
                 "fsync_stall"),
    )
    kinds = {k for _, k, _ in sched}
    assert "asym_partition" not in kinds
    assert "partial_partition" not in kinds
    assert kinds & {"slow_link", "fsync_stall"}

def test_hit_specs_for_gray_kinds():
    addrs = [("h", 1), ("h", 2), ("h", 3)]
    # One-way: only a's outbound edge must show block hits.
    assert Nemesis._hit_spec(
        "asym_partition", {"a": 0, "b": 2}, addrs
    ) == [(("h", 1), ["peer:h:3"], ("block",))]
    # Partial: the target blocks every other engine proc, and each
    # of them blocks the target back — client paths carry no rule.
    spec = Nemesis._hit_spec("partial_partition", {"proc": 1}, addrs)
    assert spec[0] == (("h", 2), ["peer:h:1", "peer:h:3"], ("block",))
    assert (("h", 1), ["peer:h:2"], ("block",)) in spec
    assert (("h", 3), ["peer:h:2"], ("block",)) in spec
    assert len(spec) == 3
    # Pinned survivor list (stop-time symmetry) narrows the spec.
    spec = Nemesis._hit_spec(
        "partial_partition", {"proc": 1, "others": [2]}, addrs
    )
    assert spec == [
        (("h", 2), ["peer:h:3"], ("block",)),
        (("h", 3), ["peer:h:2"], ("block",)),
    ]
    assert Nemesis._hit_spec("slow_link", {"proc": 0}, addrs) == [
        (("h", 1), ["all_in"], ("floor",))
    ]
    assert Nemesis._hit_spec("fsync_stall", {"proc": 2}, addrs) == [
        (("h", 3), ["disk"], ("fsync_stall",))
    ]


class TestNemesisKill:
    def test_make_schedule_kill_events_deterministic(self):
        from multiraft_tpu_torch.harness.nemesis import make_schedule

        kw = dict(duration_s=8.0, include=("drop",), kill_procs=[1])
        a = make_schedule(3, 2, **kw)
        assert a == make_schedule(3, 2, **kw)
        kills = [(at, p) for at, k, p in a if k == "kill_mesh_process"]
        assert kills == [(3.6, {"proc": 1})]  # 0.45 * duration
        assert a[-1][1] == "heal"

    def test_kill_dispatch_marks_dead_and_excuses_later_windows(self):
        from multiraft_tpu_torch.harness.nemesis import Nemesis

        killed = []
        nem = Nemesis([("127.0.0.1", 1), ("127.0.0.1", 2)],
                      kill=killed.append)
        nem._start("kill_mesh_process", {"proc": 0})
        assert killed == [0] and 0 in nem._dead
        w = nem.windows[-1]
        assert w["acked"] and w["t_stop_us"] is not None

        # A later fault window targeting the dead proc is excused
        # without touching the (gone) control plane.
        nem._start("drop_storm", {"proc": 0, "dur": 1.0, "prob": 0.5})
        w = nem.windows[-1]
        assert w["excused"] and w["acked"]
        nem._stop("drop_storm", {"proc": 0, "dur": 1.0, "prob": 0.5})
        nem.verify_windows(require_hits=("drop_storm",))  # excused: ok

    def test_kill_without_callback_raises(self):
        from multiraft_tpu_torch.harness.nemesis import Nemesis

        nem = Nemesis([("127.0.0.1", 1)])
        with pytest.raises(ValueError, match="no kill callback"):
            nem._start("kill_mesh_process", {"proc": 0})


# ---------------------------------------------------------------------------
# Parity with the reference on the same inputs
# ---------------------------------------------------------------------------

_INCLUDES = (
    ("delay", "drop", "partition", "sever"),
    ("delay", "drop", "sever", "partition", "isolate"),
    ("asym_partition", "partial_partition", "slow_link", "fsync_stall"),
    ("drop",),
    (),
)


@pytest.mark.parametrize("include", _INCLUDES, ids=lambda i: "+".join(i) or "none")
@pytest.mark.parametrize("n_procs", [1, 2, 3, 5])
@pytest.mark.parametrize("seed", [0, 7, 41])
def test_make_schedule_equals_the_reference(seed, n_procs, include):
    from multiraft_tpu.harness.nemesis import make_schedule as ref_make

    kws = [
        dict(duration_s=8.0),
        dict(duration_s=20.0, crash_procs=[n_procs - 1], crash_down_s=0.5,
             surge_rate=1500.0, surge_dur_s=1.2, surge_proc=n_procs - 1),
        dict(duration_s=9.0, kill_procs=list(range(min(2, n_procs))),
             kill_replicas=[(3, 1), (7, 0)], fault_s=(0.3, 0.9),
             quiet_s=(0.1, 0.4)),
    ]
    for kw in kws:
        assert make_schedule(seed, n_procs, include=include, **kw) == ref_make(
            seed, n_procs, include=include, **kw
        ), kw


@pytest.mark.parametrize("mode", ["poisson", "bursty", "diurnal"])
@pytest.mark.parametrize("seed", [800, 1809])
def test_open_loop_schedule_equals_the_reference(seed, mode):
    from benchmarks.openloop import gen_schedule as ref_gen
    from multiraft_tpu_torch.benchmarks.openloop import gen_schedule

    kw = dict(seed=seed, rate=900.0, duration=1.5, mode=mode)
    ours = gen_schedule(**kw)
    assert ours and ours == ref_gen(**kw)


@needs_native
@pytest.mark.timeout_s(180)
def test_port_surge_driver_against_a_port_shard_server(tmp_path):
    """The default surge driver, aimed at ``EngineShardKV``: a burst at
    a ``serve-shardkv --device cpu`` child process during a load_surge
    window gets replies, and the window verifies with hits."""
    from multiraft_tpu_torch.distributed.engine_cluster import (
        EngineProcessCluster,
    )
    from multiraft_tpu_torch.harness.nemesis import _openloop_surge_fire

    cluster = EngineProcessCluster(
        kind="engine_shardkv", groups=4, seed=3, join_gids=[1],
        chaos_seed=5, device="cpu", data_dir=str(tmp_path / "d"),
    )
    cluster.start()
    nem = Nemesis(
        [(cluster.host, cluster.port)],
        surge_fire=functools.partial(_openloop_surge_fire,
                                     service="EngineShardKV"),
    )
    try:
        sched = make_schedule(9, 1, duration_s=0.8, include=(),
                              surge_rate=300.0, surge_dur_s=0.5)
        assert [k for _, k, _ in sched] == ["load_surge", "heal"]
        nem.run(sched)  # verify=True: a silent miss raises
        (w,) = nem.windows
        assert w["kind"] == "load_surge" and w["acked"] and w["hits"] > 0
        nem.verify_windows(require_hits=("load_surge",))
    finally:
        nem.close()
        cluster.shutdown()
