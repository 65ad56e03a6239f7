"""The port's ``bench_compare`` against the reference's
``scripts/bench_compare.py``, on the CPU.

For every family, on the same fresh files and the same ``--history``
globs, the port prints the same table (stdout), the same regressions
(stderr) and returns the same exit code.  The repository's round files
are read-only inputs; the regressions are synthetic copies of the latest
round pushed past the threshold.  The port's default history is its own
``build/rounds/``, never the repository root's rounds.
"""

import json
import os
from pathlib import Path

import pytest

from scripts import bench_compare as ref_bc
from multiraft_tpu_torch.scripts import bench_compare as bc

REPO = Path(__file__).resolve().parents[1]


def _rounds(family):
    return sorted(REPO.glob(bc.FAMILIES[family]["history"]))


def _history(family):
    return str(REPO / bc.FAMILIES[family]["history"])


def _both(capsys, argv):
    """(rc, stdout, stderr) of the port's ``main`` and the reference's."""
    out = []
    for main in (bc.main, ref_bc.main):
        rc = main(list(argv))
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    return out


def _same(capsys, argv):
    ours, ref = _both(capsys, argv)
    assert ours == ref
    return ours[0]


def _write(path: Path, doc) -> str:
    path.write_text(json.dumps(doc))
    return str(path)


def _latest(family) -> dict:
    return bc.load_result(str(_rounds(family)[-1]))


def test_the_tables_are_the_references():
    assert bc.FAMILIES == ref_bc.FAMILIES
    assert bc._STR_KEYS == ref_bc._STR_KEYS


def test_every_family_has_rounds_in_the_repository():
    for family in bc.FAMILIES:
        assert _rounds(family), family


@pytest.mark.parametrize("family,fresh", [
    (family, p.name) for family in sorted(bc.FAMILIES) for p in _rounds(family)
])
def test_each_round_as_fresh_gives_the_references_table(capsys, family, fresh):
    rc = _same(capsys, [str(REPO / fresh), "--family", family,
                        "--history", _history(family)])
    assert rc in (0, 1)


@pytest.mark.parametrize("family", sorted(bc.FAMILIES))
def test_a_regression_past_the_threshold_exits_1_as_the_reference(
    tmp_path, capsys, family
):
    doc = dict(_latest(family))
    moved = 0
    for key, _, higher in bc.FAMILIES[family]["metrics"]:
        v = doc.get(key)
        if isinstance(v, (int, float)) and not isinstance(v, bool) and v:
            doc[key] = v * (0.5 if higher else 2.0)
            moved += 1
    assert moved, family
    if family == "loadcurve":
        # p99 at the knee is read off the fresh curve at the latest
        # round's knee rate: push that point up too.
        curve = dict(doc["curve"])
        curve["client_p99_ms"] = [
            2.0 * p if isinstance(p, (int, float)) else p
            for p in curve["client_p99_ms"]
        ]
        doc["curve"] = curve
    fresh = _write(tmp_path / "fresh.json", doc)
    ours, ref = _both(capsys, [fresh, "--family", family,
                               "--history", _history(family)])
    assert ours == ref and ours[0] == 1
    assert "regression(s) past 5.0%" in ours[2]


@pytest.mark.parametrize("family", sorted(bc.FAMILIES))
def test_an_improvement_never_fails_as_the_reference(tmp_path, capsys, family):
    doc = dict(_latest(family))
    for key, _, higher in bc.FAMILIES[family]["metrics"]:
        v = doc.get(key)
        if isinstance(v, (int, float)) and not isinstance(v, bool) and v:
            doc[key] = v * (3.0 if higher else 0.25)
    fresh = _write(tmp_path / "fresh.json", {"parsed": doc})
    for extra in ([], ["--quiet"], ["--threshold", "0.5"]):
        rc = _same(capsys, [fresh, "--family", family,
                            "--history", _history(family), *extra])
        if family != "loadcurve":
            assert rc == 0, (family, extra)


def test_a_synthetic_history_gives_the_references_verdicts(tmp_path, capsys):
    """The reference's own cases (``tests/test_flightrec.py::TestBenchCompare``)
    on both packages."""
    _write(tmp_path / "BENCH_r01.json", {"parsed": {"value": 100e6}})
    _write(tmp_path / "BENCH_r02.json", {"parsed": {
        "value": 200e6, "p99_commit_latency_ms": 3.0, "failover_p99_ms": 12.0,
    }})
    hist = str(tmp_path / "BENCH_r0*.json")
    cases = [
        (dict(value=196e6, p99_commit_latency_ms=3.1, failover_p99_ms=12.2), 0),
        (dict(value=150e6, p99_commit_latency_ms=3.0), 1),
        (dict(value=200e6, p99_commit_latency_ms=3.5), 1),
        (dict(value=400e6, p99_commit_latency_ms=1.0, failover_p99_ms=5.0), 0),
        (dict(value=199e6), 0),
    ]
    for i, (doc, want) in enumerate(cases):
        fresh = _write(tmp_path / f"fresh{i}.json", doc)
        assert _same(capsys, [fresh, "--history", hist]) == want, doc


def test_unreadable_inputs_exit_2_as_the_reference(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text("{truncated")
    lst = _write(tmp_path / "list.json", [1, 2])
    ok = _write(tmp_path / "ok.json", {"value": 1.0})
    assert _same(capsys, [str(bad), "--history", _history("bench")]) == 2
    assert _same(capsys, [lst, "--history", _history("bench")]) == 2
    assert _same(capsys, [ok, "--history", str(tmp_path / "NONE_r*.json")]) == 2
    # One corrupt round is skipped, not fatal.
    (tmp_path / "BENCH_r09.json").write_text("{")
    _write(tmp_path / "BENCH_r10.json", {"value": 1.0})
    assert _same(capsys, [ok, "--history", str(tmp_path / "BENCH_r*.json")]) == 0


def test_the_default_history_is_the_ports_rounds(tmp_path, monkeypatch, capsys):
    assert bc.ROUNDS_DIR == str(REPO / "build" / "rounds")
    rounds = tmp_path / "rounds"
    rounds.mkdir()
    monkeypatch.setattr(bc, "ROUNDS_DIR", str(rounds))
    fresh = str(REPO / "LOADCURVE_r05.json")
    assert bc.main([fresh, "--family", "loadcurve"]) == 2
    err = capsys.readouterr().err
    assert os.path.join(str(rounds), "LOADCURVE_r*.json") in err
    # A round of the port's own is the history; the TPU's rounds are not.
    _write(rounds / "LOADCURVE_r01.json", _latest("loadcurve"))
    assert bc.main([fresh, "--family", "loadcurve"]) == 0
    out = capsys.readouterr().out
    assert "r01.json" in out and "r05.json" not in out.split("\n")[0]
