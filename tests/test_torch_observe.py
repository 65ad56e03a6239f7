"""The port's observability and schema surface against the reference:
``utils/metrics.py`` (``Hist``, the seeded reservoir), ``utils/trace.py``
(``Tracer``), the driver's tick spans on the serial and the fused path,
and ``engine/state_planes.py`` (classification and fingerprints)."""

import json

import numpy as np
import pytest
import torch

from multiraft_tpu.engine import state_planes as ref_planes
from multiraft_tpu.utils import metrics as ref_metrics
from multiraft_tpu.utils.trace import Tracer as RefTracer
from multiraft_tpu_torch.engine import state_planes
from multiraft_tpu_torch.utils import metrics
from multiraft_tpu_torch.utils.trace import Tracer
from tests.test_torch_chaos import assert_same_world, pair

# Small shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the host's cores.
torch.set_num_threads(1)


def _values(n, seed=0):
    rng = np.random.default_rng(seed)
    # Latencies across the whole bucket range, the clamps included.
    return (10.0 ** rng.uniform(-8, 4, n)).tolist() + [0.0, 1e-6, 5e3]


def test_hist_dumps_and_percentiles_equal_the_reference():
    a, b = metrics.Hist(), ref_metrics.Hist()
    for v in _values(5000):
        a.observe(v)
        b.observe(v)
    assert a.dump() == b.dump()
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert a.percentile(q) == b.percentile(q)
    # Exact merge, windowed diff and the wire form round trip.
    a2, b2 = metrics.Hist(), ref_metrics.Hist()
    for v in _values(700, seed=1):
        a2.observe(v)
        b2.observe(v)
    a.merge(a2)
    b.merge(b2)
    assert a.dump() == b.dump()
    assert metrics.Hist.from_dump(json.loads(json.dumps(a.dump()))).dump() \
        == ref_metrics.Hist.from_dump(json.loads(json.dumps(b.dump()))).dump()
    assert metrics.Hist.sub(a, a2).dump() == ref_metrics.Hist.sub(b, b2).dump()
    assert metrics.Hist().percentile(0.5) is None


def test_metrics_reservoir_keeps_the_reference_samples_past_its_cap():
    a, b = metrics.Metrics(max_samples=64), ref_metrics.Metrics(max_samples=64)
    for m in (a, b):
        for i in range(1000):
            m.observe("batch", float(i))
            m.observe("wait_s", i * 1e-4)
            m.inc("n")
        m.set("depth", 3.0)
        with m.timer("timed_s"):
            pass
    assert a.samples["batch"] == b.samples["batch"]
    assert len(a.samples["batch"]) == 64
    assert a.seen == b.seen
    assert a.hist_dumps()["wait_s"] == b.hist_dumps()["wait_s"]
    sa, sb = a.snapshot(), b.snapshot()
    assert sa.keys() == sb.keys()
    for k in sa:
        if not k.startswith("timed_s"):
            assert sa[k] == sb[k], k
    assert a.percentile("batch", 0.5) == b.percentile("batch", 0.5)
    a.reset()
    assert not a.samples and not a.hists and not a.counters and not a.seen


def _trace_calls(tr):
    tr.process_name(1, "engine")
    tr.span("tick", 10.0, 2.5, track="engine", tick=1, commits=3)
    tr.span("neg", 20.0, -1.0)
    tr.instant("mark", 30.0, track="t", why="x")
    tr.counter("consensus", 40.0, {"commits": 3, "backlog": 7})


def test_tracer_json_equals_the_reference(tmp_path):
    a, b = Tracer(max_events=4), RefTracer(max_events=4)
    for tr in (a, b):
        _trace_calls(tr)
    assert a.to_json() == b.to_json()
    assert a.dropped == 1
    for name in ("t.json", "t.json.gz"):
        path = str(tmp_path / name)
        a.save(path)
        assert Tracer.load(path) == RefTracer.load(path) == a.to_json()
    assert a.drain() == b.drain()
    assert a.to_json() == b.to_json() == {"traceEvents": [], "displayTimeUnit": "ms"}


def _span_args(tr):
    return [
        (e["name"], e["tid"], e["args"]) for e in tr.events if e["ph"] == "X"
    ] + [
        (e["name"], e["tid"], e["args"]) for e in tr.events if e["ph"] == "C"
    ]


@pytest.mark.parametrize("fused", [False, True], ids=["serial", "fused"])
def test_tick_spans_carry_the_reference_args(fused):
    ref, port = pair(4, 3, 8)
    ref._pipeline_on = port._pipeline_on = fused
    for d in (ref, port):
        d.tracer = RefTracer() if d is ref else Tracer()
        d.start_bulk(np.full(4, 30, np.int64))
    for n in (10, 10, 10, 30, 30):
        ref.step(n)
        port.step(n)
    assert_same_world(ref, port, "traced")
    assert _span_args(port.tracer) == _span_args(ref.tracer)
    spans = [e for e in port.tracer.events if e["ph"] == "X"]
    assert [e["args"]["tick"] for e in spans] == list(range(1, 91))
    assert sum(e["args"]["commits"] for e in spans) == port.commits_total > 0
    h = port.metrics.hist("tick_wall_s")
    assert h.count == 90 and h.percentile(0.99) > 0
    assert port.metrics.counters["ticks"] == 90


def test_schema_fingerprints_equal_the_reference():
    assert state_planes.check_classification() == []
    assert state_planes.state_fingerprint() == ref_planes.state_fingerprint()
    assert state_planes.mailbox_fingerprint() == ref_planes.mailbox_fingerprint()
    assert state_planes.STATE_PLANES == ref_planes.STATE_PLANES
    assert state_planes.MAILBOX_PLANES == ref_planes.MAILBOX_PLANES
    assert state_planes.CROSS_COLUMNS == ref_planes.CROSS_COLUMNS
    assert state_planes.GLOBAL_FIELDS == ref_planes.GLOBAL_FIELDS


def test_content_fingerprints_equal_after_lockstep_ticks():
    ref, port = pair(4, 3, 2)
    for d in (ref, port):
        d.start_bulk(np.full(4, 20, np.int64))
        d.drop_prob = 0.1
        d.step(50)
        d.restart_replica(1, 1)
        d.step(5)
    for a, b in ((ref.state, port.state), (ref.inbox, port.inbox)):
        assert ref_planes.content_fingerprint(a) == state_planes.content_fingerprint(b)
    port.step(1)
    assert ref_planes.content_fingerprint(ref.state) \
        != state_planes.content_fingerprint(port.state)
