"""A deployment with a mechanism no cell has run comes as files only:
a configuration that names its reference and passes an engine flag, a
mix that names an event module, its failure count, and a reader that
names its spans, in a tree beside the benchmark's own (``manifest.ROOT``
patched).  And the failure count does not depend on the tick's pace."""

from __future__ import annotations

import json
import sys
from types import SimpleNamespace

import pytest
import torch

from cellbench import harness, isolation, manifest, phases, run, trace

KINDS = ("configs", "traffic", "counts", "events", "reference", "metrics")

TINY = {  # r3_600kx3's timing at a size the CPU runs in a few seconds
    "name": "tiny_down", "G": 24, "P": 3, "L": 40, "E": 8, "INGEST": 8, "HB_TICKS": 2,
    "ELECT_MIN": 10, "ELECT_MAX": 20, "use_kernels": True, "prevote": True,
    "check_quorum": True, "membership": True, "host_paced_compaction": False,
    "reference": "tick_mirror",
}

DOWN_REPLICA = '''
"""Each round downs replica ``r % P`` of every group and revives the one
the previous round downed; a round takes away the service of the groups
whose live leader it downed."""

import numpy as np
import torch

from cellbench import surgery


class DownReplica:
    def __init__(self, params, G, seed):
        self.every, self.G = int(params["every_ticks"]), G

    def rows(self, r):
        return np.arange(self.G, dtype=np.int64)

    def apply(self, state, inbox, at, groups, carry):
        r = 0 if carry is None else carry[0] + 1
        P = state.alive.shape[1]
        leads = (state.role == surgery.LEADER) & state.alive
        prev = None
        if carry is not None:
            prev = surgery.Killed(carry[1], torch.full_like(carry[1], carry[2]),
                                  torch.ones_like(carry[1], dtype=torch.bool))
        state, inbox, _ = surgery.kill_leaders(state, inbox, at[:0], prev)
        peer = torch.full_like(at, r % P)
        hit = leads[at, peer]
        dead = torch.zeros_like(state.alive).index_put((at, peer), torch.ones_like(hit))
        state = state._replace(alive=state.alive & ~dead)
        edge_ok = ~(dead[:, :, None] | dead[:, None, :])
        inbox = inbox._replace(**{f: getattr(inbox, f) & edge_ok
                                  for f in inbox._fields if f.endswith("_active")})
        return state, inbox, (r, at, r % P, hit)

    def lost(self, carry):
        return carry[1], carry[3]


def plan(params, G, seed):
    return DownReplica(params, G, seed)
'''

TICK_MIRROR = "from cellbench.reference.tick import *  # noqa: F401,F403\n"

TICK_BENT = '''
from cellbench.reference import tick as _tick
from cellbench.reference.tick import *  # noqa: F401,F403


def tick(cfg, state, inbox, new_cmds, k, rows):
    state, inbox, rec = _tick.tick(cfg, state, inbox, new_cmds, k, rows)
    return state._replace(cfg_epoch=state.cfg_epoch + 1), inbox, rec
'''

READER = '''
"""Device ms a tick in the vote phases alone, by span name."""

from cellbench import phases


def read(out):
    return phases.device_ms_per_tick(out, ("mrt.votes", "mrt.tally"))
'''


DT = 1 / 64  # fake seconds a tick at the program's pace


def paced(monkeypatch, dt=DT, step=None):
    """The program's step on a fake clock that only the step advances, by
    ``dt`` a tick: the window then holds ``seconds / dt`` ticks whatever
    the machine's load, as if each tick took ``dt``."""
    clock = {"t": 0.0}

    class FakeTime:
        @staticmethod
        def perf_counter():
            return clock["t"]

    prog = step or harness.program_step()

    def stepped(*args):
        clock["t"] += dt
        return prog(*args)

    monkeypatch.setattr(harness, "time", FakeTime)
    return stepped


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A benchmark root whose files are links to the real ones; a test
    adds its own.  Modules it loads leave ``sys.modules`` afterwards."""
    root = tmp_path / "cellbench"
    for kind in KINDS:
        (root / kind).mkdir(parents=True)
        for f in (manifest.ROOT / kind).glob("*.*"):
            (root / kind / f.name).symlink_to(f)
    monkeypatch.setattr(manifest, "ROOT", root)
    before = set(sys.modules)
    yield root
    for name in set(sys.modules) - before:
        if name.startswith(("cellbench.events.", "cellbench.reference.", "cellbench.metrics.")):
            del sys.modules[name]


def write(root, kind, name, text):
    (root / kind / name).write_text(text if isinstance(text, str) else json.dumps(text))


def tiny_bench(root, reference="tick_mirror"):
    write(root, "configs", "tiny_down.json", dict(TINY, reference=reference))
    write(root, "traffic", "down_churn.json", {
        "ingest": {"hot_share": 0.0, "hot": 8, "cold": 8},
        "events": {"module": "down_replica", "every_ticks": 30},
        "boot_ticks": 60, "fill_ticks": 30, "drain_ticks": 40})
    write(root, "counts", "down_churn.json", {"window_ticks": 40, "outcome_ticks": 30})
    write(root, "events", "down_replica.py", DOWN_REPLICA)
    write(root, "reference", "tick_mirror.py", TICK_MIRROR)
    write(root, "reference", "tick_bent.py", TICK_BENT)
    write(root, "metrics", "vote_phases_device_ms.py", READER)
    e2e = [{"name": "writes_per_s", "unit": "writes/s", "better": "higher", "bound": 0.25,
            "source": "host_clock"},
           {"name": "failover_p99_ms", "unit": "ms", "better": "lower", "bound": 0.25,
            "source": "device_trace"},
           {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
            "source": "host_clock"}]
    return {
        "configs": [{"name": "tiny_down", "source": "a test", "reduced": [], "why": "a test",
                     "file": str(root / "configs" / "tiny_down.json")}],
        "workloads": [{"name": "tiny.down_churn", "config": "tiny_down", "traffic": "down_churn",
                       "chips": 1, "why": "a replica of every group downed in turn"}],
        "end_to_end": e2e,
        "per_layer": [{"name": "vote_phases_device_ms", "unit": "ms/tick", "better": "lower",
                       "source": "program_counter", "layer": "recovery",
                       "moves": "writes_per_s"}],
    }


def test_engine_flags_pass_through():
    cfg = harness.engine_config(dict(TINY, host_paced_compaction=True, not_a_field=1))
    assert cfg.host_paced_compaction and cfg.G == 24 and cfg.membership
    with pytest.raises(KeyError):
        harness.engine_config({k: v for k, v in TINY.items() if k != "ELECT_MAX"})


def test_the_default_reference_refuses_the_joint_consensus_path():
    ref = harness.reference(dict(TINY, reference="tick"))
    with pytest.raises(NotImplementedError):
        ref.config(dict(TINY, use_kernels=False), 4)
    assert ref.config(TINY, 4, commit_quorum=1).q_commit == 1


def test_a_deployment_of_new_files_runs_and_its_bent_reference_fails(tree, monkeypatch):
    bench = tiny_bench(tree)
    cell = manifest.cell("tiny.down_churn", bench)
    out = harness.run(cell, 2**33 + 5, 100 * DT, False, "cpu", step=paced(monkeypatch))
    assert out.window.ticks == 100
    assert out.correct, out.checks
    assert out.failover is not None and out.failover["kills"] > 0
    assert out.count["span"] == 40 and out.count["judged_at"] == 70
    assert out.attempted > 0
    # The reader is found by name and, with no trace, reads nothing.
    assert run.metrics_of(out, True) == {}

    bent = manifest.cell("tiny.down_churn", tiny_bench(tree, reference="tick_bent"))
    out = harness.run(bent, 2**33 + 5, 30 * DT, False, "cpu", step=paced(monkeypatch))
    assert not out.correct
    # The bent plane feeds nothing else: the final state differs, the records do not.
    assert out.checks["state_diff"]["value"] > 0 and out.checks["record_diff"]["value"] == 0


def stretch_with_spans():
    device = [("kernel", "k", a, b - a) for a, b in ((0, 10), (20, 30), (50, 60), (95, 100))]
    host = [(trace.STRETCH_SPAN, 0.0, 110.0), ("mrt.tick", 0.0, 100.0),
            ("mrt.prng", 5.0, 20.0), ("mrt.votes", 25.0, 20.0), ("mrt.append", 60.0, 32.0),
            ("mrt.fast_forward", 65.0, 10.0)]
    return trace.Stretch(ticks=1, window=(0.0, 110.0), device_ops=device, host_ops=host)


def test_readers_may_name_their_spans(monkeypatch):
    s = stretch_with_spans()
    for layer, spans in phases.LAYERS.items():
        assert phases.idle_share(s, spans) == phases.idle_share(s, layer)
    # Gaps [10,20] under mrt.prng, [30,50] under mrt.votes, [60,95] under
    # mrt.append (its midpoint is past mrt.fast_forward), [100,110] under none.
    assert phases.idle_share(s, ("mrt.votes", "mrt.fast_forward")) == pytest.approx(100 * 20 / 110)
    assert phases.idle_share(s, ("mrt.prng", "mrt.append")) == pytest.approx(100 * 45 / 110)

    from multiraft_tpu_torch.utils import trace as program_trace

    tick = {"mrt.prng": 4.0, "mrt.votes": 1.0, "mrt.tally": 0.5, "mrt.append": 6.0,
            "mrt.membership": 0.25}
    monkeypatch.setattr(program_trace, "PHASES",
                        SimpleNamespace(read=lambda: [[tick] * 3], dropped=0))
    out = SimpleNamespace(stretch=SimpleNamespace(window_s=1.0, ticks=3))
    assert phases.device_ms_per_tick(out, ("mrt.membership",)) == pytest.approx(0.25)
    assert phases.device_ms_per_tick(out, ("mrt.votes", "mrt.tally")) == pytest.approx(1.5)
    assert phases.device_ms_per_tick(out, "prng") == pytest.approx(4.0)


def test_the_failure_count_does_not_depend_on_the_pace(tree, monkeypatch):
    """The same seed at the program's pace and slowed three times on the
    host's clock: the windows hold 240 and 80 ticks and so different work,
    and the count over the mix's span is the same."""
    churn = json.loads((manifest.ROOT / "traffic" / "skew_churn.json").read_text())
    churn["kills"] = {"share": 0.25, "every_ticks": 10}
    write(tree, "traffic", "fast_churn.json", churn)
    write(tree, "counts", "fast_churn.json", {"window_ticks": 40, "outcome_ticks": 40})
    bench = manifest.load()
    bench["workloads"].append({"name": "c5.fast_churn", "config": "c5_100kx5",
                               "traffic": "fast_churn", "chips": 1, "why": "a test"})
    cell = manifest.cell("c5.fast_churn", bench)
    outs = [harness.run(cell, 2**40 + 3, 240 * DT, False, "cpu",
                        step=paced(monkeypatch, dt), conf_override={"G": 48})
            for dt in (DT, 3 * DT)]
    fast, slow = outs
    assert all(o.correct for o in outs)
    assert (fast.window.ticks, slow.window.ticks) == (240, 80)
    assert fast.writes["accepted"] != slow.writes["accepted"]
    assert fast.count == slow.count
    assert (fast.attempted, fast.failed) == (slow.attempted, slow.failed)
    assert fast.attempted > 0 and fast.failed > 0


@pytest.mark.parametrize("path", sorted((manifest.ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_every_reference_imports_nothing_of_the_program(path):
    name = "cellbench.reference" + ("" if path.stem == "__init__" else f".{path.stem}")
    assert isolation.program_imports(path, name) == []


@pytest.mark.parametrize("text", [
    "from multiraft_tpu_torch.engine.core import tick  # noqa: F401\n",
    "import importlib\ncore = importlib.import_module('multiraft_tpu_torch.engine.core')\n",
    "from cellbench import harness  # noqa: F401\n",  # through a module that imports it
    "from ..harness import engine_config  # noqa: F401\n",
], ids=["direct", "by_name", "through_cellbench", "relative"])
def test_a_reference_that_imports_the_program_is_refused(tree, text):
    write(tree, "reference", "tick_leaky.py", TICK_MIRROR + text)
    with pytest.raises(ImportError, match="multiraft_tpu_torch"):
        harness.reference(dict(TINY, reference="tick_leaky"))
    with pytest.raises(ImportError, match="multiraft_tpu_torch"):
        harness.run(manifest.cell("tiny.down_churn", tiny_bench(tree, "tick_leaky")),
                    3, 10 * DT, False, "cpu")


def test_an_event_module_that_imports_the_program_gives_the_reference_its_own_apply(tree):
    bench = tiny_bench(tree)
    leaky = DOWN_REPLICA.replace("from cellbench import surgery\n",
                                 "from cellbench import surgery\n"
                                 "from multiraft_tpu_torch.engine import core  # noqa: F401\n")
    write(tree, "events", "down_replica.py", leaky)
    cell = manifest.cell("tiny.down_churn", bench)
    with pytest.raises(ImportError, match="apply_reference"):
        harness.run(cell, 5, 10 * DT, False, "cpu")
    write(tree, "events", "down_replica.py", leaky.replace(
        "    def lost(self, carry):",
        "    def apply_reference(self, *args):\n        return self.apply(*args)\n\n"
        "    def lost(self, carry):"))
    sys.modules.pop("cellbench.events.down_replica")  # loaded from the file's first text
    out = harness.run(cell, 5, 40 * DT, False, "cpu")
    assert out.correct, out.checks
