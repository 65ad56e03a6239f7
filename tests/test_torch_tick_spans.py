"""The tick's phase spans and the recorder of their device time
(``multiraft_tpu_torch/utils/trace.py``: ``phases``, ``span``,
``PhaseRecorder``), the readers of the per-layer metrics built on them
(``cellbench/phases.py``), and the driver's serial tracer, which reads
the device once a step.

On the CPU the spans are real ``torch.profiler`` ranges; the recorder's
CUDA events are replaced by events on a fake clock that advances one
millisecond at each record."""

import functools
import json
import os
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cellbench import phases as layer_phases
from cellbench.harness import TRACE_TICKS
from cellbench.trace import STRETCH_SPAN, Stretch, from_events
from multiraft_tpu_torch.engine import core, host
from multiraft_tpu_torch.engine.core import EngineConfig
from multiraft_tpu_torch.engine.host import EngineDriver
from multiraft_tpu_torch.utils import prng, trace
from multiraft_tpu_torch.utils.trace import PhaseRecorder, Tracer
from tests.test_torch_core import MATRIX

# Small shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the host's cores.
torch.set_num_threads(1)

CPU = torch.device("cpu")
IDS = [f"P{m[0]}-pv{int(m[1])}-cq{int(m[2])}-mem{int(m[3])}-k{int(m[4])}-hp{int(m[5])}"
       for m in MATRIX]


def config(P, prevote, check_quorum, membership, kernels, paced):
    return EngineConfig(
        G=8, P=P, L=32, E=4, INGEST=4, HB_TICKS=2, ELECT_MIN=4, ELECT_MAX=8,
        use_kernels=kernels, host_paced_compaction=paced, prevote=prevote,
        check_quorum=check_quorum, membership=membership,
    )


@functools.lru_cache(maxsize=None)
def driven(flags):
    """A state and inbox after elections, a firehose and a crashed
    replica in every group, so that the next tick's phases do work."""
    cfg = config(*flags)
    st = core.init_state(cfg, torch.tensor([0, 9], dtype=torch.uint32), CPU)
    mb = core.empty_mailbox(cfg, CPU)
    key = torch.tensor([3, 4], dtype=torch.uint32)
    st, mb = core.run_ticks(cfg, st, mb, 30, 3, key)
    st = st._replace(alive=st.alive.clone().index_fill_(1, torch.tensor([0]), False))
    st, mb = core.run_ticks(cfg, st, mb, 6, 3, prng.fold_in(key, 99))
    return cfg, st, mb


def one_tick(cfg, st, mb):
    cmds = torch.full((cfg.G,), 3, dtype=torch.int32)
    return core.tick_impl(cfg, st, mb, cmds, torch.tensor([5, 6], dtype=torch.uint32))


def expected_phases(cfg):
    """The ranges one tick emits, in order of their start."""
    kernels = cfg.use_kernels and not cfg.membership_on
    names = ["mrt.tick", "mrt.prng", "mrt.votes", "mrt.tally"]
    names += ["mrt.kernel.vote_tally"] if kernels else []
    names += ["mrt.append", "mrt.fast_forward", "mrt.commit"]
    names += ["mrt.kernel.quorum_commit"] if kernels else []
    names += ["mrt.check_quorum"] if cfg.check_quorum else []
    names += ["mrt.membership"] if cfg.membership_on else []
    names += ["mrt.elections"]
    names += ["mrt.membership"] if cfg.membership_on else []
    return names + ["mrt.ingest", "mrt.sends", "mrt.compact"]


def profiled_events(fn):
    """``fn()`` under ``torch.profiler`` with the host's activity, inside
    the benchmark's stretch span: its result and the Chrome trace's
    complete events."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.autograd.profiler.record_function(STRETCH_SPAN):
            result = fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events["traceEvents"]
    return result, [e for e in events if e.get("ph") == "X"]


def mrt_spans(events):
    """(name, start, end) of the ``mrt.*`` events, parents before children."""
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events if e["name"].startswith("mrt.")]
    return sorted(spans, key=lambda s: (s[1], -s[2]))


def inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("flags", MATRIX, ids=IDS)
def test_tick_emits_each_phase_range_once_in_order_under_mrt_tick(flags):
    cfg, st, mb = driven(flags)
    _, events = profiled_events(lambda: one_tick(cfg, st, mb))
    spans = mrt_spans(events)
    assert [s[0] for s in spans] == expected_phases(cfg)
    tick = spans[0]
    by = {}
    for s in spans[1:]:
        assert inside(s, tick), s
        by.setdefault(s[0], s)
    assert inside(by["mrt.fast_forward"], by["mrt.append"])
    if "mrt.kernel.vote_tally" in by:
        assert inside(by["mrt.kernel.vote_tally"], by["mrt.tally"])
        assert inside(by["mrt.kernel.quorum_commit"], by["mrt.commit"])
    phases = [s for s in spans[1:] if s[0] not in
              ("mrt.fast_forward", "mrt.kernel.vote_tally", "mrt.kernel.quorum_commit")]
    for a, b in zip(phases, phases[1:]):  # one after another, none overlapping
        assert a[2] <= b[1], (a, b)


@pytest.mark.parametrize("flags", MATRIX, ids=IDS)
def test_traced_tick_equals_untraced_tick(flags):
    cfg, st, mb = driven(flags)
    want = one_tick(cfg, st, mb)
    got, _ = profiled_events(lambda: one_tick(cfg, st, mb))
    for w, g in zip(want[:2], got[:2]):
        for f in w._fields:
            a, b = getattr(w, f), getattr(g, f)
            assert a.dtype == b.dtype and torch.equal(a, b), f
    assert want[2].keys() == got[2].keys()
    for k in want[2]:
        assert torch.equal(want[2][k], got[2][k]), k


def test_the_loops_put_the_key_derivation_and_the_record_in_their_own_ranges():
    cfg, st, mb = driven(MATRIX[2])
    cmds = torch.full((cfg.G,), 3, dtype=torch.int32)
    key = torch.tensor([5, 6], dtype=torch.uint32)
    _, events = profiled_events(lambda: core.run_ticks_traced_vec(cfg, st, mb, 2, cmds, key))
    top = [s[0] for s in mrt_spans(events) if s[0] in ("mrt.prng", "mrt.tick", "mrt.record")]
    assert top == ["mrt.prng", "mrt.tick", "mrt.prng", "mrt.record"] * 2
    _, events = profiled_events(lambda: core.run_ticks(cfg, st, mb, 2, 3, key))
    top = [s[0] for s in mrt_spans(events) if s[0] in ("mrt.prng", "mrt.tick", "mrt.record")]
    assert top == ["mrt.prng", "mrt.tick", "mrt.prng"] * 2


class _Counted:
    """A stand-in for ``record_function`` that counts its constructions."""

    made = 0

    def __init__(self, name):
        type(self).made += 1
        self.inner = _REAL_RECORD_FUNCTION(name)

    def __enter__(self):
        self.inner.__enter__()
        return self

    def __exit__(self, *exc):
        return self.inner.__exit__(*exc)


_REAL_RECORD_FUNCTION = torch.autograd.profiler.record_function


class FakeClock:
    """Events on a clock that advances 1 ms at each record."""

    def __init__(self):
        self.now = 0.0
        self.made = self.recorded = 0

    def event(self):
        clock = self
        self.made += 1

        class Event:
            def record(self):
                clock.now += 1.0
                clock.recorded += 1
                self.at = clock.now

            def elapsed_time(self, other):
                return other.at - self.at

        return Event()


@pytest.fixture
def fake_recorder(monkeypatch):
    clock = FakeClock()
    rec = PhaseRecorder(max_events=256, device_types=("cpu",), event=clock.event)
    monkeypatch.setattr(trace, "PHASES", rec)
    return rec, clock


def test_with_the_profiler_off_the_tick_makes_no_range_and_records_no_event(
        monkeypatch, fake_recorder):
    rec, clock = fake_recorder
    monkeypatch.setattr(_Counted, "made", 0)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _Counted)
    cfg, st, mb = driven(MATRIX[2])
    cmds = torch.full((cfg.G,), 3, dtype=torch.int32)
    key = torch.tensor([5, 6], dtype=torch.uint32)
    one_tick(cfg, st, mb)
    core.run_ticks_traced_vec(cfg, st, mb, 3, cmds, key)
    assert _Counted.made == 0 and clock.recorded == 0 and rec.sessions == []
    # The same calls under the profiler do both: the counters see them.
    profiled_events(lambda: core.run_ticks_traced_vec(cfg, st, mb, 3, cmds, key))
    assert _Counted.made >= 3 * len(expected_phases(cfg)) and clock.recorded > 0


def test_chrome_trace_spans_come_back_as_host_ops():
    cfg, st, mb = driven(MATRIX[0])
    _, events = profiled_events(lambda: one_tick(cfg, st, mb))
    stretch = from_events(events, 1)
    names = [name for name, _, _ in stretch.host_ops if name.startswith("mrt.")]
    assert sorted(names) == sorted(expected_phases(cfg))
    assert all(e["cat"] == "user_annotation" for e in events if e["name"].startswith("mrt."))


def test_recorder_times_each_phase_between_its_events(fake_recorder):
    rec, clock = fake_recorder
    cfg, st, mb = driven(MATRIX[2])  # P=3, prevote, check-quorum, kernels
    cmds = torch.full((cfg.G,), 3, dtype=torch.int32)
    key = torch.tensor([5, 6], dtype=torch.uint32)
    profiled_events(lambda: core.run_ticks_traced_vec(cfg, st, mb, 2, cmds, key))
    (session,) = rec.read()
    assert len(session) == 2
    # One event at the tick's start, one at each phase's end, one where
    # the fast-forward begins inside the append phase: every gap 1 ms.
    want = {"mrt.prng": 2.0, "mrt.votes": 1.0, "mrt.tally": 1.0, "mrt.append": 2.0,
            "mrt.fast_forward": 1.0, "mrt.commit": 1.0, "mrt.check_quorum": 1.0,
            "mrt.elections": 1.0, "mrt.ingest": 1.0, "mrt.sends": 1.0,
            "mrt.compact": 1.0, "mrt.record": 1.0}
    assert session == [want, want]
    assert clock.recorded == 2 * (1 + sum(want.values())) and rec.dropped == 0


def test_recorder_sessions_are_runs_of_profiled_ticks(fake_recorder):
    rec, _ = fake_recorder
    cfg, st, mb = driven(MATRIX[5])
    profiled_events(lambda: [one_tick(cfg, st, mb) for _ in range(3)])
    one_tick(cfg, st, mb)  # the profiler off: the session ends
    profiled_events(lambda: None)  # no tick: no session
    profiled_events(lambda: one_tick(cfg, st, mb))
    assert [len(s) for s in rec.read()] == [3, 1]


def test_recorder_drops_past_its_pool_and_leaves_the_tick_out(monkeypatch):
    clock = FakeClock()
    rec = PhaseRecorder(max_events=20, device_types=("cpu",), event=clock.event)
    monkeypatch.setattr(trace, "PHASES", rec)
    cfg, st, mb = driven(MATRIX[1])
    profiled_events(lambda: [one_tick(cfg, st, mb) for _ in range(2)])
    per_tick = 1 + len(expected_phases(cfg)) - 1 + 1  # start, phases, fast-forward's start
    assert clock.made == 20 and rec.dropped == 2 * per_tick - 20
    (session,) = rec.read()
    assert len(session) == 1 and sum(session[0].values()) == per_tick - 1


def test_no_recorder_events_for_a_tick_off_its_devices(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(trace, "PHASES", PhaseRecorder(event=clock.event))  # CUDA only
    cfg, st, mb = driven(MATRIX[3])
    _, events = profiled_events(lambda: one_tick(cfg, st, mb))
    assert clock.made == 0 and trace.PHASES.sessions == []
    assert [s[0] for s in mrt_spans(events)] == expected_phases(cfg)


# -- the readers -------------------------------------------------------------


def synthetic_stretch(with_spans=True):
    """A 110 us window; the device is busy at [0,10], [20,30], [50,60],
    [80,85] and [95,100], so it idles 10 us under ``mrt.prng``, 20 under
    ``mrt.votes`` (whose kernel range is counted under it), 20 under the
    ``mrt.fast_forward`` inside ``mrt.append``, 10 under ``mrt.append``
    and 10 after ``mrt.tick`` has ended."""
    device = [("kernel", "k", a, b - a) for a, b in
              ((0, 10), (20, 30), (50, 60), (80, 85), (95, 100))]
    host = [(STRETCH_SPAN, 0.0, 110.0), ("cellbench.tick", 0.0, 100.0),
            ("aten::add", 12.0, 2.0)]
    if with_spans:
        host += [("mrt.tick", 0.0, 100.0), ("mrt.prng", 5.0, 20.0),
                 ("mrt.votes", 25.0, 20.0), ("mrt.kernel.vote_tally", 35.0, 10.0),
                 ("mrt.append", 60.0, 32.0), ("mrt.fast_forward", 65.0, 10.0)]
    return Stretch(ticks=1, window=(0.0, 110.0), device_ops=device, host_ops=host)


def read(metric, out):
    from cellbench import manifest

    return manifest.reader(metric)(out)


@pytest.mark.parametrize("metric,want", [
    ("prng_idle_share", 100 * 10 / 110),
    ("recovery_idle_share", 100 * 40 / 110),
    ("replication_idle_share", 100 * 10 / 110),
])
def test_idle_readers_put_each_gap_under_its_innermost_phase(metric, want):
    s = synthetic_stretch()
    assert read(metric, SimpleNamespace(host_stretch=s)) == pytest.approx(want)
    by = layer_phases.idle_by_span(s)
    assert by == {"mrt.prng": 10.0, "mrt.votes": 20.0, "mrt.fast_forward": 20.0,
                  "mrt.append": 10.0, layer_phases.NO_SPAN: 10.0}
    # No gap counted twice: the spans' idle time is the stretch's.
    assert sum(by.values()) * 1e-6 == pytest.approx(s.window_s - s.busy_s)
    assert layer_phases.ops_by_span(s) == {"mrt.prng": 1}


@pytest.mark.parametrize("metric", ["prng_idle_share", "recovery_idle_share",
                                    "replication_idle_share"])
def test_idle_readers_find_nothing_without_program_spans(metric):
    assert read(metric, SimpleNamespace(host_stretch=synthetic_stretch(False))) is None
    assert read(metric, SimpleNamespace(host_stretch=None)) is None


def fake_session(n):
    """``n`` ticks of one session; tick ``TRACE_TICKS`` on, past the
    device stretch, reads 1000 ms in every phase."""
    tick = {"mrt.prng": 4.0, "mrt.votes": 1.0, "mrt.tally": 0.5, "mrt.append": 6.0,
            "mrt.fast_forward": 0.25, "mrt.commit": 3.0, "mrt.check_quorum": 0.75,
            "mrt.elections": 2.0, "mrt.ingest": 1.5, "mrt.sends": 5.0,
            "mrt.compact": 2.5, "mrt.record": 0.1}
    return [dict(tick) if i < TRACE_TICKS else {k: 1000.0 for k in tick}
            for i in range(n)]


@pytest.mark.parametrize("metric,want", [
    ("prng_device_ms_per_tick", 4.0),
    ("recovery_device_ms_per_tick", 1.0 + 0.5 + 0.25 + 0.75 + 2.0),
    ("replication_device_ms_per_tick", 6.0 + 3.0 + 1.5 + 5.0),
])
def test_device_readers_sum_the_layers_phases_over_the_device_stretch(monkeypatch, metric, want):
    rec = SimpleNamespace(read=lambda: [fake_session(2 * TRACE_TICKS), fake_session(3)],
                          dropped=0)
    monkeypatch.setattr(trace, "PHASES", rec)
    out = SimpleNamespace(stretch=SimpleNamespace(window_s=1.0, ticks=TRACE_TICKS))
    assert read(metric, out) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["prng_device_ms_per_tick", "recovery_device_ms_per_tick",
                                    "replication_device_ms_per_tick"])
def test_device_readers_find_nothing_without_the_recorder(monkeypatch, metric):
    out = SimpleNamespace(stretch=None)
    monkeypatch.setattr(trace, "PHASES", PhaseRecorder())
    assert read(metric, out) is None  # it recorded nothing
    monkeypatch.delattr(trace, "PHASES")  # a program without one
    assert read(metric, SimpleNamespace(stretch=None)) is None


# -- the driver's serial tracer ----------------------------------------------


def test_traced_serial_step_reads_the_device_once(monkeypatch):
    d = EngineDriver(EngineConfig(G=4, P=3, L=32, E=4, INGEST=4), seed=3, device="cpu")
    d._pipeline_on = False
    assert d.run_until_quiet_leaders(300)
    d.tracer = Tracer()
    t0 = d.tick
    reads = []
    real = host._np
    monkeypatch.setattr(host, "_np", lambda t: reads.append(t) or real(t))
    d.step(12)
    assert len(reads) == 1
    spans = [e for e in d.tracer.events if e["ph"] == "X"]
    counters = [e for e in d.tracer.events if e["ph"] == "C"]
    assert [e["args"]["tick"] for e in spans] == list(range(t0 + 1, t0 + 13))
    assert len(counters) == 12 and all(e["args"]["backlog"] == 0 for e in counters)
    assert all(e["args"]["leaders"] == 4 for e in spans)
    ends = [e["ts"] + e["dur"] for e in spans]
    assert all(np.isclose(a, b["ts"]) for a, b in zip(ends, spans[1:]))
    assert d.metrics.hist("tick_wall_s").count == 12
