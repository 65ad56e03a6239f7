"""The port's EngineDriver (multiraft_tpu_torch/engine/host.py and
pipeline.py) in lockstep with the reference EngineDriver, and its fused
multi-tick path against its own serial path.

The reference runs the Pallas kernels under the interpreter and steps
serially; the port runs the kernel path (the plain versions, on the
CPU) and steps fused wherever the driver's own rules allow.  From the
same seed, under drops, a one-way partition and a leader kill, every
``np_state()`` plane and every inbox plane must be equal after every
step, and so must the host bookkeeping (tick, backlog, payload
bindings, commit totals, last metrics).
"""

import numpy as np
import pytest
import torch

from multiraft_tpu.engine.core import EngineConfig as JaxConfig
from multiraft_tpu.engine.host import EngineDriver as JaxDriver
from multiraft_tpu_torch import convert
from multiraft_tpu_torch.engine.core import EngineConfig
from multiraft_tpu_torch.engine.host import EngineDriver

# Small shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the host's cores.
torch.set_num_threads(1)

SHAPE = dict(G=16, P=3, L=32, E=4, INGEST=4)


def assert_same_world(ref, port, where) -> None:
    a, b = ref.np_state(), port.np_state()
    for k in a:
        assert a[k].dtype == b[k].dtype, (where, k)
        assert np.array_equal(a[k], b[k]), (where, "state", k)
    ib = convert.mailbox_to_numpy(port.inbox)
    for k, v in ref.inbox._asdict().items():
        assert np.array_equal(np.asarray(v), ib[k]), (where, "inbox", k)
    assert ref.tick == port.tick, where
    assert ref.backlog.tolist() == port.backlog.tolist(), where
    assert ref.payloads == port.payloads, where
    assert ref._max_bound == port._max_bound, where
    assert ref.commits_total == port.commits_total, where
    for k, v in ref.last_metrics.items():
        assert np.array_equal(np.asarray(v), port.last_metrics[k]), (where, k)


def pair(seed=5):
    ref = JaxDriver(
        JaxConfig(use_pallas=True, pallas_interpret=True, **SHAPE), seed=seed
    )
    ref._pipeline_on = False  # one compiled tick; fused == serial anyway
    port = EngineDriver(EngineConfig(use_kernels=True, **SHAPE), seed=seed, device="cpu")
    return ref, port


def test_driver_lockstep_under_drops_partition_and_leader_kill():
    ref, port = pair()
    assert_same_world(ref, port, "init")
    assert ref.run_until_quiet_leaders(300) == port.run_until_quiet_leaders(300)
    assert_same_world(ref, port, "elected")
    assert (port.leaders_per_group() == 1).all()
    rng = np.random.default_rng(3)
    for rnd in range(40):
        if rnd == 5:
            ref.drop_prob = port.drop_prob = 0.1
        if rnd == 10:
            for d in (ref, port):
                d.set_edge(0, 1, 2, False)
                d.set_edge(4, 2, 0, False)
        if rnd == 15:
            for g in (1, 6):
                lead = ref.leader_of(g)
                assert lead == port.leader_of(g)
                ref.set_alive(g, lead, False)
                port.set_alive(g, lead, False)
        if rnd == 30:
            ref.drop_prob = port.drop_prob = 0.0
            for d in (ref, port):
                d.set_edge(0, 1, 2, True)
        for g in range(SHAPE["G"]):
            for i in range(int(rng.integers(0, 3))):
                ref.start(g, ("w", rnd, g, i))
                port.start(g, ("w", rnd, g, i))
        n = int(rng.integers(1, 5))
        ref.step(n)
        port.step(n)
        assert_same_world(ref, port, rnd)
    assert port.commits_total > 0
    assert port.metrics.counters["ticks"] == ref.metrics.counters["ticks"]
    for g in range(SHAPE["G"]):
        port.check_log_matching(g)
        assert port.log_terms_of(g, 0) == ref.log_terms_of(g, 0)


def drive(d: EngineDriver, fused: bool) -> EngineDriver:
    """Seeded traffic + faults; the same tick sequence either way."""
    d._pipeline_on = fused
    rng = np.random.default_rng(11)
    for rnd in range(12):
        for g in range(d.cfg.G):
            for _ in range(int(rng.integers(0, 6))):
                d.start(g, ("cmd", rnd, g))
        if rnd == 3:
            d.drop_prob = 0.15
        if rnd == 5:
            d.partition_replica(0, 1, False)
        if rnd == 7:
            d.partition_replica(0, 1, True)
        if rnd == 8:
            d.set_alive(1, 2, False)
        if rnd == 9:
            d.drop_prob = 0.0
        n = int(rng.integers(2, 7))
        if fused:
            d.step(n)
        else:
            for _ in range(n):
                d.step(1)
    return d


def assert_port_worlds_equal(a: EngineDriver, b: EngineDriver) -> None:
    for x, y in ((a.np_state(), b.np_state()),
                 (convert.mailbox_to_numpy(a.inbox), convert.mailbox_to_numpy(b.inbox))):
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k
    assert a.tick == b.tick
    assert a.backlog.tolist() == b.backlog.tolist()
    assert a.payloads == b.payloads
    assert a._max_bound == b._max_bound
    assert a.commits_total == b.commits_total
    for k in a.last_metrics:
        assert np.array_equal(a.last_metrics[k], b.last_metrics[k]), k


@pytest.mark.parametrize("kernels", [True, False])
def test_fused_step_equals_serial_under_faults(kernels):
    cfg = EngineConfig(G=4, P=3, L=32, E=4, INGEST=4, use_kernels=kernels)
    serial = drive(EngineDriver(cfg, seed=3, device="cpu"), fused=False)
    fused = drive(EngineDriver(cfg, seed=3, device="cpu"), fused=True)
    assert serial.tick > 30 and serial.commits_total > 0
    assert_port_worlds_equal(serial, fused)


def test_two_batches_in_flight_equal_serial():
    """The second dispatch must subtract the first's device-resident
    accepted counts from the backlog it ships, or commands ingest twice."""
    cfg = EngineConfig(G=4, P=3, L=32, E=4, INGEST=4, use_kernels=True)

    def seeded() -> EngineDriver:
        d = EngineDriver(cfg, seed=7, device="cpu")
        assert d.run_until_quiet_leaders(500)
        for g in range(cfg.G):
            for i in range(10):  # 10 > 2 batches * 3 ticks * INGEST/tick
                d.start(g, ("w", g, i))
        return d

    serial = seeded()
    serial._pipeline_on = False
    for _ in range(6):
        serial.step(1)
    piped = seeded()
    p1 = piped.dispatch_ticks(3)
    p2 = piped.dispatch_ticks(3)
    assert len(piped._inflight) == 2
    r1, r2 = p1.fetch(), p2.fetch()
    piped.complete_ticks(p1, r1)
    piped.complete_ticks(p2, r2)
    assert (piped.backlog >= 0).all()
    assert_port_worlds_equal(serial, piped)
    # A dispatched batch is completed first by a synchronous step.
    p3 = piped.dispatch_ticks(2)
    piped.step(1)
    assert not piped._inflight and piped.tick == p3.tick0 + 3


def test_complete_out_of_dispatch_order_asserts():
    d = EngineDriver(EngineConfig(**SHAPE), seed=1, device="cpu")
    d.start(0, ("x",))
    p1 = d.dispatch_ticks(2)
    p2 = d.dispatch_ticks(2)
    rec2 = p2.fetch()
    with pytest.raises(AssertionError, match="dispatch order"):
        d.complete_ticks(p2, rec2)
    d.complete_ticks(p1, p1.fetch())
    d.complete_ticks(p2, rec2)


def test_driver_keeps_engine_dtypes_and_reports_numpy():
    d = EngineDriver(EngineConfig(**SHAPE), seed=2, device="cpu")
    for v in d.state:
        assert v.dtype in (torch.int32, torch.bool) and v.device.type == "cpu"
    d._pipeline_on = False
    d.step(3)
    m = d.last_metrics
    assert all(isinstance(v, np.ndarray) and v.dtype == np.int32 for v in m.values())
    assert isinstance(d.np_state()["term"], np.ndarray)
