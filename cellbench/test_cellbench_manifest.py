"""``BENCHMARK.json`` against its required shape, and discovery by name."""

from __future__ import annotations

import json
import math

import pytest

from cellbench import harness, manifest, traffic
from cellbench.manifest import REPO, ROOT

TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def test_top_level_keys_and_limits(bench):
    assert set(bench) == TOP
    assert bench["paths"] == ["cellbench"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(bench["command"]) <= 32
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    manifest.validate_names(bench)


def test_entries_have_only_the_allowed_keys(bench):
    for c in bench["configs"]:
        assert set(c) == CONFIG_KEYS
    for w in bench["workloads"]:
        assert set(w) == WORKLOAD_KEYS
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert m["source"] in SOURCES
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert m["better"] in ("lower", "higher")


def test_end_to_end_metrics_are_the_four(bench):
    names = [m["name"] for m in bench["end_to_end"]]
    assert names == ["writes_per_s", "write_p99_ms", "failover_p99_ms", "setup_s"]
    assert next(m for m in bench["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25


def test_configs_files_and_reductions(bench):
    widths = ("L", "E", "INGEST", "P")
    for c in bench["configs"]:
        path = REPO / c["file"]
        assert path.resolve().is_relative_to(ROOT)
        conf = json.loads(path.read_text())
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert k in conf and k not in widths
        for k in ("G", "P", "L", "E", "INGEST", "HB_TICKS", "ELECT_MIN", "ELECT_MAX"):
            assert isinstance(conf[k], int)
    assert len({c["file"] for c in bench["configs"]}) == len(bench["configs"])


@pytest.mark.parametrize("name", ["c5.skew_churn", "r3.uniform_steady", "c5.skew_steady",
                                  "r3.uniform_churn"])
def test_cells_resolve_by_name(bench, name):
    cell = manifest.cell(name, bench)
    assert cell.traffic_path.is_file()
    mix = traffic.load(cell.traffic_path)
    assert mix.boot_ticks > 0 and mix.fill_ticks > 0
    count = traffic.Count.load(cell.count_path)
    assert count.window_ticks > 0 and count.outcome_ticks > 0
    assert callable(harness.reference(cell.conf).tick)
    e2e = {m["name"] for m in cell.end_to_end}
    assert {"setup_s", "writes_per_s"} <= e2e
    assert ("failover_p99_ms" in e2e) == (mix.events == "leader_kills")
    # The write tail is compared where it is steady: not in c5.skew_steady,
    # where it reads the shared host's random stalls.
    assert ("write_p99_ms" in e2e) == (name != "c5.skew_steady")
    for m in cell.per_layer:
        assert m["moves"] in e2e, (m["name"], name)
        assert callable(manifest.reader(m["name"]))
    assert cell.per_layer


def test_every_metric_workload_is_a_cell(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e


def test_run_seconds_fit_the_check_with_24_cells(bench):
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_validate_names_refuses(bench):
    bad = json.loads(json.dumps(bench))
    bad["workloads"][0]["name"] = "has space"
    with pytest.raises(ValueError):
        manifest.validate_names(bad)
    bad = json.loads(json.dumps(bench))
    bad["per_layer"][0]["unit"] = "launches per tick"
    with pytest.raises(ValueError):
        manifest.validate_names(bad)
    bad = json.loads(json.dumps(bench))
    bad["configs"].append(dict(bad["configs"][0]))
    with pytest.raises(ValueError):
        manifest.validate_names(bad)


def test_unknown_workload_is_refused(bench):
    with pytest.raises(KeyError):
        manifest.cell("no.such_cell", bench)


def test_traffic_plan_is_a_function_of_the_seed():
    cell = manifest.cell("c5.skew_churn")
    mix = traffic.load(cell.traffic_path)
    assert (mix.events, mix.event_params) == ("leader_kills", {"share": 0.01, "every_ticks": 100})
    seed = 2**31 + 977
    kills = manifest.module("events", mix.events)
    v1, v2 = (kills.plan(mix.event_params, 1000, seed) for _ in range(2))
    v2.rows(5)  # drawing ahead does not change earlier rounds
    assert all((v1.rows(r) == v2.rows(r)).all() for r in range(6))
    assert (traffic.sample(mix, 1000, seed, v1) == traffic.sample(mix, 1000, seed, v2)).all()
    assert traffic.key_seed(seed) == traffic.key_seed(seed) < 2**31
    ing = traffic.ingest(mix, 1000)
    assert (ing[:100] == 28).all() and (ing[100:] == 1).all()
    assert math.isclose(v1.victims.n, 10) and v1.every == 100
