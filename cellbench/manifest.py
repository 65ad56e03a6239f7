"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; the configuration is
``cellbench/configs/<config>.json``, the mix ``cellbench/traffic/<traffic>.json``
and each per-layer metric a reader ``cellbench/metrics/<name>.py``.  A
later cell, mix or metric is a new file and a new entry, never an edit.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int
    conf: dict  # the configuration file's contents
    end_to_end: List[dict]  # the cell's end-to-end metrics
    per_layer: List[dict]  # the cell's per-layer metrics

    @property
    def traffic_path(self) -> Path:
        return ROOT / "traffic" / f"{self.traffic}.json"


def load(path: Optional[Path] = None) -> dict:
    return json.loads((path or REPO / "BENCHMARK.json").read_text())


def validate_names(bench: dict) -> None:
    """Raise ``ValueError`` on a name or unit outside the allowed
    alphabet, or on a name used twice within its kind."""
    kinds = {
        "configs": [c["name"] for c in bench["configs"]],
        "workloads": [w["name"] for w in bench["workloads"]],
        "metrics": [m["name"] for m in bench["end_to_end"] + bench["per_layer"]],
    }
    for kind, names in kinds.items():
        if len(set(names)) != len(names):
            raise ValueError(f"{kind}: a name is used twice: {names}")
        for n in names:
            if not NAME.match(n):
                raise ValueError(f"{kind}: bad name {n!r}")
    for w in bench["workloads"]:
        for n in (w["config"], w["traffic"]):
            if not NAME.match(n):
                raise ValueError(f"workload {w['name']}: bad name {n!r}")
    for c in bench["configs"]:
        for n in c["reduced"]:
            if not NAME.match(n):
                raise ValueError(f"config {c['name']}: bad reduced key {n!r}")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not UNIT.match(m["unit"]):
            raise ValueError(f"metric {m['name']}: bad unit {m['unit']!r}")


def _applies(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench if bench is not None else load()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    confs = [c for c in bench["configs"] if c["name"] == w["config"]]
    if not confs:
        raise KeyError(f"workload {name!r}: no config {w['config']!r}")
    conf = json.loads((REPO / confs[0]["file"]).read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name)]
    return Cell(name, w["config"], w["traffic"], int(w["chips"]), conf,
                e2e, per_layer)


def reader(metric: str) -> Callable:
    """The ``read`` function of ``cellbench/metrics/<metric>.py``."""
    path = ROOT / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"cellbench_metric_{metric}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
