"""The port's graftlint (``multiraft_tpu_torch.analysis``) against the
reference's.

The port of ``tests/test_analysis.py``: the port's package lints clean,
each of the 14 host-code rules reproduces, on its fixture in
``tests/fixtures/graftlint/``, exactly the (rule, line) findings of the
reference's rule, the suppression pragmas work, and the static lock
audit sees the port's transport nesting without cycles.  The
reference's ``donated-alias`` and ``jit-purity`` rules check JAX buffer
donation and trace-time side effects; the port has neither, so their
fixture cases are not ported, and the file pragma case runs on
``blocking-in-callback`` instead of ``jit-purity``.

Also here: ``plane-lifecycle`` on the port's out-of-place column wipe
(``_set(plane, (at, v), (col, v))``) — a ``reset_replica`` that wipes the
``[g, :, p]`` column passes and one that skips it is a finding — and
``env-knob`` on the port's dict-form knob registry.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from multiraft_tpu.analysis import run as ref_run
from multiraft_tpu_torch.analysis import (
    ALL_RULES,
    LockGraph,
    LockOrderRecorder,
    Project,
    run,
)

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "multiraft_tpu_torch"
FIXTURES = Path(__file__).resolve().parent / "fixtures" / "graftlint"

HOST_RULES = {
    "wire-width", "frame-arity", "control-exempt", "lock-order",
    "unlocked-write", "unbounded-queue", "blocking-in-callback",
    "wire-schema", "plane-class", "plane-lifecycle", "record-codes",
    "chaos-kinds", "wire-caps", "env-knob",
}


def _keys(findings):
    return sorted((f.rule, Path(f.path).name, f.line) for f in findings)


# -- the gate ---------------------------------------------------------------


def test_package_lints_clean():
    """Zero unsuppressed findings over the port's package."""
    active, _suppressed = run([PACKAGE])
    assert active == [], "\n".join(str(f) for f in active)


def test_rule_registry_complete():
    names = {r.name for r in ALL_RULES}
    assert names == HOST_RULES
    assert not names & {"donated-alias", "jit-purity"}


def test_cli_lints_the_port_by_default():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", "multiraft_tpu_torch.analysis", "--per-rule"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "graftlint: clean (14 rules" in out.stderr
    bad = subprocess.run(
        [sys.executable, "-m", "multiraft_tpu_torch.analysis", "--rule", "jit-purity"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert bad.returncode == 2


# -- per-rule fixtures: each reproduces the reference rule's findings ------

_FIXTURE_CASES = [
    # (fixture, rule, minimum number of findings)
    ("wire_pack.py", "wire-width", 3),
    ("frame_drift.py", "frame-arity", 4),
    ("control_drift.py", "control-exempt", 1),
    ("lock_cycle.py", "lock-order", 1),
    ("unlocked_counter.py", "unlocked-write", 1),
    ("unbounded_queue.py", "unbounded-queue", 1),
    ("blocking_callback.py", "blocking-in-callback", 2),
    ("wire_schema", "wire-schema", 2),
    ("busy_drift.py", "frame-arity", 2),
    ("wire_schema_busy", "wire-schema", 2),
    ("plane_unclassified.py", "plane-class", 2),
    ("plane_lifecycle.py", "plane-lifecycle", 3),
    ("record_drift", "record-codes", 4),
    ("chaos_kinds.py", "chaos-kinds", 2),
    ("wire_caps.py", "wire-caps", 2),
    ("knob_drift", "env-knob", 2),
]


@pytest.mark.parametrize("fixture,rule,at_least", _FIXTURE_CASES)
def test_rule_fires_on_fixture(fixture, rule, at_least):
    active, _ = run([FIXTURES / fixture])
    hits = [f for f in active if f.rule == rule]
    assert len(hits) >= at_least, (
        f"{rule} found {len(hits)} finding(s) on {fixture}, "
        f"expected >= {at_least}: {[str(f) for f in active]}"
    )
    # and no *other* rule misfires on the fixture
    others = [f for f in active if f.rule != rule]
    assert others == [], [str(f) for f in others]
    # and the findings are the reference's, rule and line
    ref_active, ref_suppressed = ref_run([FIXTURES / fixture])
    suppressed = run([FIXTURES / fixture])[1]
    assert _keys(active) == _keys(ref_active)
    assert _keys(suppressed) == _keys(ref_suppressed)


def test_clean_fixture_has_no_findings():
    active, _ = run([FIXTURES / "clean.py"])
    assert active == [], [str(f) for f in active]


def test_every_fixture_matches_the_reference_rule_for_rule():
    """Over the whole fixture tree at once (cross-module rules see every
    fixture), the port's findings are the reference's minus the two JAX
    rules."""
    active, suppressed = run([FIXTURES])
    ref_active, ref_suppressed = ref_run([FIXTURES])
    jax_only = {"donated-alias", "jit-purity"}
    assert _keys(active) == _keys(
        f for f in ref_active if f.rule not in jax_only)
    assert _keys(suppressed) == _keys(
        f for f in ref_suppressed if f.rule not in jax_only)


# -- suppression pragma -----------------------------------------------------


def test_line_pragma_suppresses(tmp_path):
    src = (FIXTURES / "unlocked_counter.py").read_text()
    patched = src.replace(
        "self.dropped += 1  # no lock: races the locked increment",
        "self.dropped += 1  # graftlint: disable=unlocked-write",
    )
    p = tmp_path / "suppressed.py"
    p.write_text(patched)
    active, suppressed = run([p])
    assert active == [], [str(f) for f in active]
    assert [f.rule for f in suppressed] == ["unlocked-write"]


def test_file_pragma_suppresses(tmp_path):
    src = (FIXTURES / "blocking_callback.py").read_text()
    p = tmp_path / "suppressed.py"
    p.write_text("# graftlint: disable-file=blocking-in-callback\n" + src)
    active, suppressed = run([p])
    assert active == [], [str(f) for f in active]
    assert len(suppressed) == 2


def test_unsuppressed_rules_still_fire(tmp_path):
    """A pragma for rule A must not hide rule B on the same line."""
    src = (FIXTURES / "unlocked_counter.py").read_text()
    patched = src.replace(
        "self.dropped += 1  # no lock: races the locked increment",
        "self.dropped += 1  # graftlint: disable=wire-width",
    )
    p = tmp_path / "other_rule.py"
    p.write_text(patched)
    active, _ = run([p])
    assert [f.rule for f in active] == ["unlocked-write"]


def test_line_pragma_suppresses_plane_lifecycle(tmp_path):
    src = (FIXTURES / "plane_lifecycle.py").read_text()
    patched = src.replace(
        "voted_for=st.voted_for.at[g, p].set(-1),  # persistent!",
        "voted_for=st.voted_for.at[g, p].set(-1),"
        "  # graftlint: disable=plane-lifecycle",
    )
    p = tmp_path / "suppressed.py"
    p.write_text(patched)
    active, suppressed = run([p])
    assert [f.rule for f in suppressed] == ["plane-lifecycle"]
    assert len([f for f in active if f.rule == "plane-lifecycle"]) == 2


def test_file_pragma_suppresses_chaos_kinds(tmp_path):
    src = (FIXTURES / "chaos_kinds.py").read_text()
    p = tmp_path / "suppressed.py"
    p.write_text("# graftlint: disable-file=chaos-kinds\n" + src)
    active, suppressed = run([p])
    assert active == [], [str(f) for f in active]
    assert len(suppressed) == 2


def test_file_pragma_suppresses_record_codes(tmp_path):
    d = tmp_path / "record_drift"
    d.mkdir()
    for name in ("flightrec.py", "postmortem.py"):
        src = (FIXTURES / "record_drift" / name).read_text()
        if name == "flightrec.py":
            src = "# graftlint: disable-file=record-codes\n" + src
        (d / name).write_text(src)
    active, suppressed = run([d])
    assert active == [], [str(f) for f in active]
    assert len(suppressed) == 4


def test_line_pragma_suppresses_wire_caps_but_not_decl(tmp_path):
    src = (FIXTURES / "wire_caps.py").read_text()
    patched = src.replace(
        '    if "zstd" in caps:  # never declared in _WIRE_CAPS',
        '    if "zstd" in caps:  # graftlint: disable=wire-caps',
    )
    p = tmp_path / "suppressed.py"
    p.write_text(patched)
    active, suppressed = run([p])
    assert [f.rule for f in suppressed] == ["wire-caps"]
    assert len(active) == 1 and "busy" in active[0].message


def test_file_pragma_suppresses_env_knob(tmp_path):
    d = tmp_path / "knob_drift"
    d.mkdir()
    for name in ("knobs.py", "mod.py"):
        src = (FIXTURES / "knob_drift" / name).read_text()
        if name == "mod.py":
            src = "# graftlint: disable-file=env-knob\n" + src
        (d / name).write_text(src)
    active, suppressed = run([d])
    assert active == [], [str(f) for f in active]
    assert [f.rule for f in suppressed] == ["env-knob", "env-knob"]


def test_line_pragma_suppresses_plane_class(tmp_path):
    src = (FIXTURES / "plane_unclassified.py").read_text()
    patched = src.replace(
        "    lease_dl: int  # new field, never classified",
        "    lease_dl: int  # graftlint: disable=plane-class",
    )
    p = tmp_path / "suppressed.py"
    p.write_text(patched)
    active, suppressed = run([p])
    assert [f.rule for f in suppressed] == ["plane-class"]
    assert len(active) == 1 and "gone" in active[0].message


# -- the port's idioms -----------------------------------------------------

_PLANES = '''
STATE_PLANES = {
    "tick_no": "persistent", "term": "persistent", "votes": "leadership",
    "match_idx": "leadership", "alive": "volatile",
}
GLOBAL_FIELDS = ("tick_no",)
CROSS_COLUMNS = ("votes", "match_idx")
'''

_RESET = '''
from typing import NamedTuple


class EngineState(NamedTuple):
    tick_no: int
    term: int
    votes: int
    match_idx: int
    alive: int


def _set(t, *writes):
    t = t.clone()
    for index, value in writes:
        t[index] = value
    return t


class Driver:
    def reset_replica(self, g, p):
        st = self.state
        at, col = (g, p), (g, slice(None), p)
        self.state = st._replace(
            term=_set(st.term, (at, 0)),
            votes=_set(st.votes, (at, False), (col, False)),
            match_idx=_set(st.match_idx, (at, 0){match_col}),
            alive=_set(st.alive, (at, False)),
        )
'''


@pytest.mark.parametrize("wipes_column", [True, False])
def test_plane_lifecycle_reads_the_port_column_wipe(wipes_column, tmp_path):
    """A port-style ``reset_replica``: the ``(col, v)`` write pair of
    ``_set`` is the ``[g, :, p]`` column wipe.  Skipping it for a
    declared cross column is a finding; doing it is none."""
    (tmp_path / "state_planes.py").write_text(_PLANES)
    (tmp_path / "host.py").write_text(_RESET.format(
        match_col=", (col, 0)" if wipes_column else ""))
    active, _ = run([tmp_path])
    lifecycle = [f for f in active if f.rule == "plane-lifecycle"]
    if wipes_column:
        assert active == [], [str(f) for f in active]
    else:
        assert len(lifecycle) == 1 and "'match_idx'" in lifecycle[0].message
        assert "[g, :, p]" in lifecycle[0].message
    # The written-out index form reads the same as the bound name.
    inline = _RESET.replace("(col, False)", "((g, slice(None), p), False)")
    (tmp_path / "host.py").write_text(inline.format(
        match_col=", ((g, slice(None), p), 0)" if wipes_column else ""))
    assert [f for f in run([tmp_path])[0] if f.rule == "plane-lifecycle"] == lifecycle


def test_port_reset_replica_is_recognised_without_a_pragma():
    """The port's own ``reset_replica`` wipes its columns through
    ``_set``: no lifecycle finding and no suppression in the engine."""
    active, suppressed = run([PACKAGE / "engine"])
    assert not [f for f in active + suppressed if f.rule == "plane-lifecycle"]


def test_env_knob_reads_the_port_dict_registry(tmp_path):
    """The port's ``KNOBS`` is a dict keyed by knob name: its names count
    as declared, and an accessor reading an undeclared name, or a raw
    ``os.environ`` read of an ``MRT_`` name, is a finding."""
    (tmp_path / "knobs.py").write_text(
        'KNOBS: dict = {"MRT_A": ("int", 1)}\n'
        "def knob_int(name):\n    return 0\n")
    (tmp_path / "mod.py").write_text(
        "import os\nfrom knobs import knob_int\n"
        'ok = knob_int("MRT_A")\n'
        'bad = knob_int("MRT_B")\n'
        'raw = os.environ.get("MRT_A")\n')
    active, _ = run([tmp_path])
    assert sorted((f.rule, f.line) for f in active) == [
        ("env-knob", 4), ("env-knob", 5)]


# -- env-knob registry round-trip ------------------------------------------


def test_knobs_registry_round_trip(monkeypatch):
    """The port's declared table ⇄ accessors agree, with the reference's
    names and defaults."""
    from multiraft_tpu_torch.utils import knobs

    for name, (typ, _default) in knobs.KNOBS.items():
        assert name.startswith("MRT_") and typ in ("str", "int", "float", "bool")
    monkeypatch.delenv("MRT_ADMIT_INFLIGHT", raising=False)
    assert knobs.knob_int("MRT_ADMIT_INFLIGHT") == 512
    monkeypatch.setenv("MRT_ADMIT_INFLIGHT", "64")
    assert knobs.knob_int("MRT_ADMIT_INFLIGHT") == 64
    monkeypatch.setenv("MRT_ADMIT_INFLIGHT", "junk")
    assert knobs.knob_int("MRT_ADMIT_INFLIGHT") == 512
    for falsey in ("", "0", "false", "no", "off", "OFF"):
        monkeypatch.setenv("MRT_PREVOTE", falsey)
        assert knobs.knob_bool("MRT_PREVOTE") is False
    monkeypatch.setenv("MRT_PREVOTE", "1")
    assert knobs.knob_bool("MRT_PREVOTE") is True


def test_knobs_reject_undeclared_and_untyped():
    from multiraft_tpu_torch.utils import knobs

    with pytest.raises(KeyError):
        knobs.knob_int("MRT_NOT_A_KNOB")
    with pytest.raises(TypeError):
        knobs.knob_bool("MRT_ADMIT_INFLIGHT")
    with pytest.raises(TypeError):
        knobs.knob_int("MRT_SPIN_US")


def test_knobs_doc_in_repo_covers_the_port():
    """The port declares no knob of its own: every knob it reads is one
    the reference's generated ``docs/KNOBS.md`` documents."""
    from multiraft_tpu_torch.utils import knobs

    doc = (REPO / "docs" / "KNOBS.md").read_text()
    missing = [n for n in knobs.KNOBS if f"`{n}`" not in doc]
    assert missing == []


# -- static lock audit over the port's tree ---------------------------------


def test_lock_graph_extracts_transport_nesting():
    g = LockGraph(Project.load([PACKAGE]))
    edge_names = {
        (f"{a[0]}.{a[1]}", f"{b[0]}.{b[1]}") for (a, b) in g.edges
    }
    assert ("RpcNode._lock", "NativeTransport._lock") in edge_names
    assert g.cycles() == [], g.cycles()


def test_lock_graph_sees_threaded_classes():
    g = LockGraph(Project.load([PACKAGE]))
    locked = {c.name for c in g.classes.values() if c.lock_attrs}
    assert {"RpcNode", "NativeTransport", "ChaosState",
            "RealtimeScheduler"} <= locked


def test_lock_graph_covers_flight_recorder():
    g = LockGraph(Project.load([PACKAGE]))
    assert "_lock" in g.classes["FlightRecorder"].lock_attrs
    assert "_proc_lock" in g.module_locks["flightrec"]
    assert g.cycles() == [], g.cycles()


def test_lock_rules_share_one_graph():
    from multiraft_tpu_torch.analysis.lockgraph import get_lock_graph

    p = Project.load([PACKAGE])
    assert get_lock_graph(p) is get_lock_graph(p)


# -- dynamic lock-order recorder -------------------------------------------


class _Box:
    def __init__(self):
        self.a = threading.Lock()
        self.b = threading.Lock()


def test_recorder_clean_on_consistent_order():
    box = _Box()
    rec = LockOrderRecorder()
    rec.wrap(box, "a", "A")
    rec.wrap(box, "b", "B")
    for _ in range(3):
        with box.a:
            with box.b:
                pass
    assert ("A", "B") in rec.edges
    rec.assert_acyclic()


def test_recorder_detects_abba():
    box = _Box()
    rec = LockOrderRecorder()
    rec.wrap(box, "a", "A")
    rec.wrap(box, "b", "B")
    with box.a:
        with box.b:
            pass
    with box.b:
        with box.a:
            pass
    with pytest.raises(AssertionError, match="cycle"):
        rec.assert_acyclic()


def test_recorder_handles_non_lifo_release():
    box = _Box()
    rec = LockOrderRecorder()
    rec.wrap(box, "a", "A")
    rec.wrap(box, "b", "B")
    box.a.acquire()
    box.b.acquire()
    box.a.release()  # out of LIFO order
    box.b.release()
    assert rec.edges == {("A", "B"): threading.current_thread().name}
    rec.assert_acyclic()


def test_recorder_wrap_is_idempotent():
    box = _Box()
    rec = LockOrderRecorder()
    rec.wrap(box, "a", "A")
    rec.wrap(box, "a", "A")
    with box.a:
        pass
    assert box.a.locked() is False
