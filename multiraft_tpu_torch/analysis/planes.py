"""graftlint v3: engine state-plane lifecycle rules (PyTorch port of
``multiraft_tpu/analysis/planes.py``).

The engine's persistence discipline lives in four hand-synced sites
(checkpoint save/restore, ``restart_replica``, ``reset_replica``, the
cross-replica column clears) plus one declared source of truth:
``engine/state_planes.py``.  These rules verify the sites against the
declaration statically — a voted_for reset across a restart, and
stale votes/match columns on a re-add, are the bug classes caught
here.

* ``plane-class`` — every ``EngineState`` / ``Mailbox`` field carries
  a classification in ``STATE_PLANES`` / ``MAILBOX_PLANES``; stale
  registry entries (field removed, classification kept) are findings
  too, as are classifications outside the four planes.
* ``plane-lifecycle`` — ``restart_replica`` must reset every VOLATILE
  plane and touch nothing PERSISTENT or CONFIG; ``reset_replica`` must
  wipe every plane except the engine-global clock and CONFIG, and for
  each declared ``CROSS_COLUMNS`` field additionally clear the
  ``[g, :, p]`` column (stale votes/match/acks about the reborn peer).

Approximations: both rules activate
only when a module declaring ``STATE_PLANES`` is in the linted
project, so fixture stubs of ``EngineState`` elsewhere stay silent;
the lifecycle rule reads the ``st._replace(field=...)`` keyword set,
so a lifecycle function with no ``_replace`` call (harness wrappers
that delegate over RPC) is out of scope; a cross-column clear is
recognized as an ``.at[...]`` subscript whose index tuple has a slice
in position 1 (``[g, :, p]``), or, in this package's out-of-place
idiom, as an ``(index, value)`` write pair of a call such as
``_set(plane, (at, v), (col, v))`` whose index is such a tuple, written
out or through a name the function binds to one
(``col = (g, slice(None), p)``); Mailbox lifecycle masking goes through
``membership.drop_edges`` and is checked at runtime, not here.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, ModuleInfo, Project, Rule, dotted_name, register

_PLANE_VALUES = {"persistent", "volatile", "leadership", "config"}
_STATE_CLASSES = ("EngineState", "Mailbox")


class _Registry:
    """One parsed ``state_planes``-style declaration module."""

    def __init__(self, mod: ModuleInfo) -> None:
        self.mod = mod
        self.state_planes: Dict[str, str] = {}
        self.mailbox_planes: Dict[str, str] = {}
        self.cross_columns: Tuple[str, ...] = ()
        self.global_fields: Tuple[str, ...] = ()
        self.lines: Dict[str, int] = {}  # table name -> def line
        self.entry_lines: Dict[Tuple[str, str], int] = {}

    @property
    def planes_of(self) -> Dict[str, Dict[str, str]]:
        return {"EngineState": self.state_planes,
                "Mailbox": self.mailbox_planes}


def _str_consts(mod: ModuleInfo) -> Dict[str, str]:
    """Top-level ``NAME = "literal"`` bindings (the plane constants)."""
    out: Dict[str, str] = {}
    for stmt in mod.tree.body:
        if (
            isinstance(stmt, ast.Assign)
            and len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)
            and isinstance(stmt.value, ast.Constant)
            and isinstance(stmt.value.value, str)
        ):
            out[stmt.targets[0].id] = stmt.value.value
    return out


def _str_tuple(node: ast.AST) -> Optional[Tuple[str, ...]]:
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        vals = []
        for el in node.elts:
            if not (isinstance(el, ast.Constant)
                    and isinstance(el.value, str)):
                return None
            vals.append(el.value)
        return tuple(vals)
    return None


def find_registry(project: Project) -> Optional[_Registry]:
    """The project's plane declaration: the module assigning a dict
    literal to ``STATE_PLANES`` at top level (None when absent — the
    plane rules then stay silent, so fixture stubs don't misfire)."""
    for mod in project.modules:
        tables: Dict[str, ast.Dict] = {}
        tuples: Dict[str, Tuple[str, ...]] = {}
        lines: Dict[str, int] = {}
        for stmt in mod.tree.body:
            tgt = None
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                tgt = stmt.targets[0]
                value = stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                tgt = stmt.target
                value = stmt.value
            else:
                continue
            if not isinstance(tgt, ast.Name):
                continue
            if tgt.id in ("STATE_PLANES", "MAILBOX_PLANES") and isinstance(
                value, ast.Dict
            ):
                tables[tgt.id] = value
                lines[tgt.id] = stmt.lineno
            elif tgt.id in ("CROSS_COLUMNS", "GLOBAL_FIELDS"):
                st = _str_tuple(value)
                if st is not None:
                    tuples[tgt.id] = st
                    lines[tgt.id] = stmt.lineno
        if "STATE_PLANES" not in tables:
            continue
        reg = _Registry(mod)
        reg.lines = lines
        consts = _str_consts(mod)
        for tname, node in tables.items():
            table: Dict[str, str] = {}
            for k, v in zip(node.keys, node.values):
                if not (isinstance(k, ast.Constant)
                        and isinstance(k.value, str)):
                    continue
                if isinstance(v, ast.Constant) and isinstance(v.value, str):
                    plane = v.value
                elif isinstance(v, ast.Name):
                    plane = consts.get(v.id, v.id)
                else:
                    plane = "?"
                table[k.value] = plane
                reg.entry_lines[(tname, k.value)] = k.lineno
            if tname == "STATE_PLANES":
                reg.state_planes = table
            else:
                reg.mailbox_planes = table
        reg.cross_columns = tuples.get("CROSS_COLUMNS", ())
        reg.global_fields = tuples.get("GLOBAL_FIELDS", ())
        return reg
    return None


def _namedtuple_fields(
    project: Project,
) -> List[Tuple[ModuleInfo, str, List[Tuple[str, int]]]]:
    """Every EngineState/Mailbox NamedTuple class in the project as
    ``(module, class_name, [(field, line), ...])``."""
    out = []
    for mod in project.modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            if node.name not in _STATE_CLASSES:
                continue
            fields = [
                (st.target.id, st.lineno)
                for st in node.body
                if isinstance(st, ast.AnnAssign)
                and isinstance(st.target, ast.Name)
            ]
            if fields:
                out.append((mod, node.name, fields))
    return out


@register
class PlaneClassRule(Rule):
    name = "plane-class"
    doc = (
        "every EngineState/Mailbox field must carry a plane "
        "classification in engine/state_planes.py (and no stale "
        "entry may outlive its field)"
    )

    def check(self, project: Project) -> List[Finding]:
        reg = find_registry(project)
        if reg is None:
            return []
        out: List[Finding] = []
        seen_classes: Set[str] = set()
        for mod, cls_name, fields in _namedtuple_fields(project):
            seen_classes.add(cls_name)
            table = reg.planes_of[cls_name]
            tname = ("STATE_PLANES" if cls_name == "EngineState"
                     else "MAILBOX_PLANES")
            if not table:
                out.append(Finding(
                    rule=self.name, path=str(mod.path), line=1,
                    message=f"{cls_name} has no {tname} table in the "
                            f"plane registry ({reg.mod.path.name})",
                ))
                continue
            declared = set(table)
            names = {f for f, _ in fields}
            for f, line in fields:
                if f not in declared:
                    out.append(Finding(
                        rule=self.name, path=str(mod.path), line=line,
                        message=(
                            f"{cls_name} field '{f}' is unclassified: add "
                            f"it to {tname} in {reg.mod.path.name} "
                            f"(persistent/volatile/leadership/config) and "
                            f"bump CKPT_VERSION if the checkpoint schema "
                            f"changed"
                        ),
                    ))
            for f in sorted(declared - names):
                out.append(Finding(
                    rule=self.name, path=str(reg.mod.path),
                    line=reg.entry_lines.get((tname, f), reg.lines[tname]),
                    message=f"{tname} entry '{f}' names no {cls_name} "
                            f"field (stale classification)",
                ))
            for f in sorted(declared & names):
                if table[f] not in _PLANE_VALUES:
                    out.append(Finding(
                        rule=self.name, path=str(reg.mod.path),
                        line=reg.entry_lines.get(
                            (tname, f), reg.lines[tname]),
                        message=f"{tname}['{f}'] = {table[f]!r} is not "
                                f"one of {sorted(_PLANE_VALUES)}",
                    ))
        if "EngineState" in seen_classes:
            for f in reg.cross_columns:
                if reg.state_planes.get(f, "leadership") != "leadership":
                    out.append(Finding(
                        rule=self.name, path=str(reg.mod.path),
                        line=reg.lines.get("CROSS_COLUMNS", 1),
                        message=f"CROSS_COLUMNS field '{f}' must be a "
                                f"leadership plane (it holds per-peer "
                                f"state about a replica)",
                    ))
        return out


def _replace_keywords(fn: ast.AST) -> Dict[str, ast.keyword]:
    """Keyword set across every ``._replace(...)`` call in ``fn``."""
    out: Dict[str, ast.keyword] = {}
    for call in ast.walk(fn):
        if (
            isinstance(call, ast.Call)
            and isinstance(call.func, ast.Attribute)
            and call.func.attr == "_replace"
        ):
            for kw in call.keywords:
                if kw.arg is not None:
                    out[kw.arg] = kw
    return out


def _is_column_index(idx: Optional[ast.AST]) -> bool:
    """An index tuple with a slice in position 1 — ``[g, :, p]`` or
    ``(g, slice(None), p)``: the cross-replica column axis."""
    if not (isinstance(idx, ast.Tuple) and len(idx.elts) >= 3):
        return False
    e = idx.elts[1]
    return isinstance(e, ast.Slice) or (
        isinstance(e, ast.Call) and dotted_name(e.func) == "slice"
    )


def _index_bindings(fn: ast.AST) -> Dict[str, ast.AST]:
    """Names ``fn`` binds by plain assignment, tuple unpacking included
    (``at, col = (g, p), (g, slice(None), p)``)."""
    out: Dict[str, ast.AST] = {}
    for stmt in ast.walk(fn):
        if not isinstance(stmt, ast.Assign):
            continue
        for tgt in stmt.targets:
            if isinstance(tgt, ast.Name):
                out[tgt.id] = stmt.value
            elif (
                isinstance(tgt, ast.Tuple)
                and isinstance(stmt.value, ast.Tuple)
                and len(tgt.elts) == len(stmt.value.elts)
            ):
                for t, v in zip(tgt.elts, stmt.value.elts):
                    if isinstance(t, ast.Name):
                        out[t.id] = v
    return out


def _has_column_write(
    node: ast.AST, bindings: Optional[Dict[str, ast.AST]] = None
) -> bool:
    """A write to the cross-replica column: an ``x.at[g, :, p]``
    subscript, or an ``(index, value)`` argument pair of a call
    (``_set(plane, (col, v))``) whose index is a column index, written
    out or bound to a name in ``bindings``."""
    bindings = bindings or {}
    for sub in ast.walk(node):
        if (
            isinstance(sub, ast.Subscript)
            and isinstance(sub.value, ast.Attribute)
            and sub.value.attr == "at"
            and _is_column_index(sub.slice)
        ):
            return True
        if isinstance(sub, ast.Call):
            for arg in sub.args:
                if not (isinstance(arg, ast.Tuple) and len(arg.elts) == 2):
                    continue
                idx = arg.elts[0]
                if isinstance(idx, ast.Name):
                    idx = bindings.get(idx.id)
                if _is_column_index(idx):
                    return True
    return False


@register
class PlaneLifecycleRule(Rule):
    name = "plane-lifecycle"
    doc = (
        "restart_replica resets exactly the volatile(+leadership) "
        "planes and never a persistent/config one; reset_replica "
        "wipes everything but the global clock and config, including "
        "the declared [g, :, p] cross-replica columns"
    )

    def check(self, project: Project) -> List[Finding]:
        reg = find_registry(project)
        if reg is None or not reg.state_planes:
            return []
        out: List[Finding] = []
        planes = reg.state_planes
        for mod in project.modules:
            for fn in ast.walk(mod.tree):
                if not isinstance(
                    fn, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    continue
                if fn.name not in ("restart_replica", "reset_replica"):
                    continue
                kws = _replace_keywords(fn)
                if not kws:
                    # Harness wrappers delegate over RPC; the
                    # tensorized lifecycle site is the _replace one.
                    continue
                if fn.name == "restart_replica":
                    out.extend(self._check_restart(mod, fn, kws, planes))
                else:
                    out.extend(self._check_reset(mod, fn, kws, reg))
        return out

    def _check_restart(
        self,
        mod: ModuleInfo,
        fn: ast.AST,
        kws: Dict[str, ast.keyword],
        planes: Dict[str, str],
    ) -> List[Finding]:
        out: List[Finding] = []
        for f, kw in kws.items():
            plane = planes.get(f)
            if plane in ("persistent", "config"):
                out.append(Finding(
                    rule=self.name, path=str(mod.path),
                    line=kw.value.lineno,
                    message=(
                        f"restart_replica resets {plane} plane '{f}' — "
                        f"a crash-restart must preserve it (raft "
                        f"readPersist discipline; reset_replica is the "
                        f"fresh-incarnation path)"
                    ),
                ))
        missing = [
            f for f, plane in planes.items()
            if plane == "volatile" and f not in kws
        ]
        for f in sorted(missing):
            out.append(Finding(
                rule=self.name, path=str(mod.path), line=fn.lineno,
                message=(
                    f"restart_replica leaves volatile plane '{f}' "
                    f"unreset — stale {f} of the dead run would survive "
                    f"the crash-restart"
                ),
            ))
        return out

    def _check_reset(
        self,
        mod: ModuleInfo,
        fn: ast.AST,
        kws: Dict[str, ast.keyword],
        reg: _Registry,
    ) -> List[Finding]:
        out: List[Finding] = []
        planes = reg.state_planes
        bindings = _index_bindings(fn)
        exempt = set(reg.global_fields) | {
            f for f, p in planes.items() if p == "config"
        }
        for f, kw in kws.items():
            if f in exempt and f in planes:
                what = ("config plane" if planes.get(f) == "config"
                        else "engine-global field")
                out.append(Finding(
                    rule=self.name, path=str(mod.path),
                    line=kw.value.lineno,
                    message=(
                        f"reset_replica touches {what} '{f}' — config "
                        f"is managed by the membership ops "
                        f"(add_learner seeds the reborn peer's view)"
                    ),
                ))
        for f in sorted(set(planes) - set(kws) - exempt):
            out.append(Finding(
                rule=self.name, path=str(mod.path), line=fn.lineno,
                message=(
                    f"reset_replica leaves plane '{f}' of the dead "
                    f"incarnation in place — a fresh incarnation must "
                    f"wipe it"
                ),
            ))
        for f in reg.cross_columns:
            kw = kws.get(f)
            if kw is None:
                continue  # the missing-wipe finding above covers it
            if not _has_column_write(kw.value, bindings):
                out.append(Finding(
                    rule=self.name, path=str(mod.path),
                    line=kw.value.lineno,
                    message=(
                        f"reset_replica clears only the own row of "
                        f"'{f}' — the [g, :, p] cross-replica column "
                        f"must be wiped too, or stale {f} about the "
                        f"reborn peer leaks into the new incarnation"
                    ),
                ))
        for f, kw in kws.items():
            if f in reg.cross_columns or f not in planes:
                continue
            if _has_column_write(kw.value, bindings):
                out.append(Finding(
                    rule=self.name, path=str(mod.path),
                    line=kw.value.lineno,
                    message=(
                        f"reset_replica wipes a [g, :, p] column of "
                        f"'{f}' that CROSS_COLUMNS does not declare — "
                        f"declare it in {reg.mod.path.name}"
                    ),
                ))
        return out
