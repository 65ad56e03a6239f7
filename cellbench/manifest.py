"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; each per-layer metric
names its reader.  A new deployment, with a mechanism no cell has run
yet, comes as new files and new entries in ``BENCHMARK.json``, never as
an edit:

* a configuration, ``cellbench/configs/<config>.json``: every key that
  names a field of the program's ``EngineConfig`` is passed to it (the
  twelve of :data:`cellbench.harness.REQUIRED` must be there), and
  ``"reference": <module>`` picks the plain reference that replays it,
  ``cellbench/reference/<module>.py`` (default ``tick``);
* a traffic mix, ``cellbench/traffic/<traffic>.json``
  (:mod:`cellbench.traffic`), which may name an event module,
  ``cellbench/events/<name>.py`` (:mod:`cellbench.events`): faults or
  admin operations between ticks;
* the mix's failure count, ``cellbench/counts/<traffic>.json``
  (:class:`cellbench.traffic.Count`): the fixed span of window ticks over
  which ``attempted`` and ``failed`` are counted, so that they do not
  depend on the tick's pace;
* a reader per per-layer metric, ``cellbench/metrics/<name>.py``, with a
  ``read(outcome)`` function; a reader of the program's phase spans
  names a layer of :data:`cellbench.phases.LAYERS` or a tuple of
  ``mrt.*`` span names.

``r3.uniform_churn`` came so: ``r3_600kx3`` under a new mix that takes
the leader churn of BASELINE config #5 (``BASELINE.json`` configs[4]) at
the rate of ``bench.py: run_config5``, to see recovery under a tick the
card paces.

A reference module has ``config(conf, G, commit_quorum)`` (which refuses
a configuration it cannot replay), ``State``, ``init_state``,
``empty_mailbox``, ``tick`` and ``RECORD_KEYS``, with the signatures of
:mod:`cellbench.reference.tick`.  It imports nothing of the program, of
JAX or of the JAX package, itself or through the ``cellbench`` modules
it imports: :func:`module` refuses one that does.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional

from .isolation import program_imports

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

    @property
    def count_path(self) -> Path:
        return ROOT / "counts" / f"{self.traffic}.json"


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
    return module("metrics", metric).read


def module(kind: str, name: str):
    """``cellbench/<kind>/<name>.py`` (``kind`` is ``reference``,
    ``events`` or ``metrics``), imported as ``cellbench.<kind>.<name>``:
    the one already imported if it came from that file.  A reference
    that imports the program, JAX or the JAX package, itself or through
    a module of ``cellbench`` (:func:`cellbench.isolation.program_imports`),
    is refused with ``ImportError``."""
    path = ROOT / kind / f"{name}.py"
    if not NAME.match(name) or not path.is_file():
        raise FileNotFoundError(path)
    full = f"cellbench.{kind}.{name}"
    mod = sys.modules.get(full)
    if mod is not None and Path(mod.__file__).resolve() == path.resolve():
        return mod
    if kind == "reference":
        bad = program_imports(path, full)
        if bad:
            raise ImportError(f"{path}: a reference imports nothing of the program, "
                              f"and this one does: {bad}")
    spec = importlib.util.spec_from_file_location(full, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[full]
        raise
    return mod
