"""graftlint v3: registry-drift rules (PyTorch port of
``multiraft_tpu/analysis/registry.py``).

The deployment plane keeps several hand-maintained registries whose
consumers live in other files: the flight recorder's numbered event
types (decoded by the postmortem doctor), the chaos kind vocabulary
(flightrec codes ⇄ nemesis verbs ⇄ ``make_schedule`` include sets),
the hello wire-capability strings (negotiated at scattered membership
tests), and the ``MRT_*`` env-knob table (``utils/knobs.py``).  Each
rule here makes the registry and its consumers drift-proof:

* ``record-codes`` — every ``_TYPE_NAMES`` key resolves to a unique
  integer constant, every recorded type constant is in the table, and
  every type is referenced by the postmortem doctor's decoders.
* ``chaos-kinds`` — literal kinds at ``_hit``/``note_fault`` sites
  must be ``CHAOS_KIND_CODES`` keys; every window kind emitted by
  ``make_schedule`` must be handled by a nemesis verb comparison; the
  ``include`` default set must be kinds ``make_schedule`` dispatches.
* ``wire-caps`` — capability strings tested against a ``caps``
  variable must be declared in ``_WIRE_CAPS``, and every declared cap
  must be negotiated (tested) somewhere.
* ``env-knob`` — a raw ``os.environ`` read of an ``MRT_*`` literal
  outside the knobs module is a finding (use the typed accessors), and
  a ``knob_*()`` accessor call with an undeclared name is a finding.

Approximations: registries are recognized by their
literal shapes (``_TYPE_NAMES`` dicts keyed by Names, ``KNOBS`` tuples
of ``Knob(...)`` calls, ``_WIRE_CAPS`` string tuples); dynamic kinds
(``note_fault(path, kind)`` forwarding a variable) and env names built
at runtime are out of scope; the doctor-coverage and untested-cap
arms need both sides present in the linted project, so single-file
fixtures exercise them via fixture directories.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from .core import (
    Finding,
    ModuleInfo,
    Project,
    Rule,
    const_int,
    dotted_name,
    register,
)

_UPPER = re.compile(r"^[A-Z][A-Z0-9_]*$")


def _top_assign(mod: ModuleInfo, name: str) -> Optional[ast.stmt]:
    """The module's top-level ``name = ...`` (annotated or not)."""
    for stmt in mod.tree.body:
        if (
            isinstance(stmt, ast.Assign)
            and len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)
            and stmt.targets[0].id == name
        ) or (
            isinstance(stmt, ast.AnnAssign)
            and stmt.value is not None
            and isinstance(stmt.target, ast.Name)
            and stmt.target.id == name
        ):
            return stmt
    return None


def _int_consts(mod: ModuleInfo) -> Dict[str, Tuple[int, int]]:
    """Top-level ``NAME = <int>`` bindings → (value, line)."""
    out: Dict[str, Tuple[int, int]] = {}
    for stmt in mod.tree.body:
        if (
            isinstance(stmt, ast.Assign)
            and len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)
        ):
            v = const_int(stmt.value)
            if v is not None:
                out[stmt.targets[0].id] = (v, stmt.lineno)
    return out


def _leaf(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


# ---------------------------------------------------------------------------
# record-codes
# ---------------------------------------------------------------------------


@register
class RecordCodesRule(Rule):
    name = "record-codes"
    doc = (
        "flight-record type codes must be unique, registered in "
        "_TYPE_NAMES, and known to the postmortem doctor's decoders"
    )

    def check(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        for mod in project.modules:
            stmt = _top_assign(mod, "_TYPE_NAMES")
            if stmt is None or not isinstance(stmt.value, ast.Dict):
                continue
            out.extend(self._check_table(project, mod, stmt))
        return out

    def _check_table(
        self, project: Project, mod: ModuleInfo, stmt: ast.stmt
    ) -> List[Finding]:
        out: List[Finding] = []
        consts = _int_consts(mod)
        keys: List[str] = []
        for k in stmt.value.keys:  # type: ignore[union-attr]
            kn = _leaf(k)
            if kn is None:
                continue
            keys.append(kn)
            if kn not in consts:
                out.append(Finding(
                    rule=self.name, path=str(mod.path), line=k.lineno,
                    message=f"_TYPE_NAMES key {kn} resolves to no "
                            f"module-level integer constant",
                ))
        # Uniqueness among the registered type codes.
        by_value: Dict[int, List[str]] = {}
        for kn in keys:
            if kn in consts:
                by_value.setdefault(consts[kn][0], []).append(kn)
        for value, names in sorted(by_value.items()):
            if len(names) > 1:
                for kn in names[1:]:
                    out.append(Finding(
                        rule=self.name, path=str(mod.path),
                        line=consts[kn][1],
                        message=(
                            f"flight-record type code {value} collides: "
                            f"{names[0]} and {kn} share it — readers "
                            f"cannot tell the events apart"
                        ),
                    ))
        # Every recorded constant of this module must be registered.
        known = set(keys)
        for m2 in project.modules:
            for call in ast.walk(m2.tree):
                if not (
                    isinstance(call, ast.Call)
                    and isinstance(call.func, ast.Attribute)
                    and call.func.attr == "record"
                    and call.args
                ):
                    continue
                leaf = _leaf(call.args[0])
                if (
                    leaf is not None
                    and _UPPER.match(leaf)
                    and leaf in consts
                    and leaf not in known
                ):
                    out.append(Finding(
                        rule=self.name, path=str(m2.path),
                        line=call.lineno,
                        message=(
                            f"recorded event type {leaf} is not in "
                            f"_TYPE_NAMES — readers will print a bare "
                            f"number for it"
                        ),
                    ))
        # Doctor coverage: every registered type must be referenced by
        # a postmortem module's decoders.
        doctors = project.find("postmortem")
        if doctors:
            referenced: Set[str] = set()
            for d in doctors:
                for n in ast.walk(d.tree):
                    leaf = _leaf(n)
                    if leaf is not None:
                        referenced.add(leaf)
            for kn in keys:
                if kn in consts and kn not in referenced:
                    out.append(Finding(
                        rule=self.name, path=str(mod.path),
                        line=consts[kn][1],
                        message=(
                            f"flight-record type {kn} is unknown to the "
                            f"postmortem doctor — no decoder references "
                            f"it, so its events vanish from reports"
                        ),
                    ))
        return out


# ---------------------------------------------------------------------------
# chaos-kinds
# ---------------------------------------------------------------------------


def _str_const(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


@register
class ChaosKindsRule(Rule):
    name = "chaos-kinds"
    doc = (
        "chaos kind literals at _hit/note_fault sites must be "
        "CHAOS_KIND_CODES keys; make_schedule's emitted window kinds "
        "and include defaults must match the nemesis verbs"
    )

    def check(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        codes: Optional[Set[str]] = None
        for mod in project.modules:
            stmt = _top_assign(mod, "CHAOS_KIND_CODES")
            if stmt is not None and isinstance(stmt.value, ast.Dict):
                codes = {
                    s for s in (_str_const(k) for k in stmt.value.keys)
                    if s is not None
                }
                break
        if codes:
            out.extend(self._check_hit_sites(project, codes))
        out.extend(self._check_schedule(project))
        return out

    def _check_hit_sites(
        self, project: Project, codes: Set[str]
    ) -> List[Finding]:
        out: List[Finding] = []
        for mod in project.modules:
            for call in ast.walk(mod.tree):
                if not (
                    isinstance(call, ast.Call)
                    and _leaf(call.func) in ("_hit", "note_fault")
                    and len(call.args) >= 2
                ):
                    continue
                kind = _str_const(call.args[1])
                if kind is not None and kind not in codes:
                    out.append(Finding(
                        rule=self.name, path=str(mod.path),
                        line=call.lineno,
                        message=(
                            f"chaos kind '{kind}' has no "
                            f"CHAOS_KIND_CODES entry — its flight-"
                            f"record events carry code 0 and the "
                            f"doctor cannot attribute them"
                        ),
                    ))
        return out

    def _handled_kinds(self, project: Project) -> Set[str]:
        """String kinds some nemesis class compares ``kind`` against
        (``kind == "x"`` / ``kind in (...)``) — collected from classes
        defining a ``_start`` dispatcher."""
        handled: Set[str] = set()
        for mod in project.modules:
            for cls in ast.walk(mod.tree):
                if not isinstance(cls, ast.ClassDef):
                    continue
                if not any(
                    isinstance(n, ast.FunctionDef) and n.name == "_start"
                    for n in cls.body
                ):
                    continue
                for cmp_ in ast.walk(cls):
                    if not isinstance(cmp_, ast.Compare):
                        continue
                    if not (
                        isinstance(cmp_.left, ast.Name)
                        and cmp_.left.id == "kind"
                    ):
                        continue
                    for op, comp in zip(cmp_.ops, cmp_.comparators):
                        if isinstance(op, (ast.Eq, ast.NotEq)):
                            s = _str_const(comp)
                            if s is not None:
                                handled.add(s)
                        elif isinstance(op, (ast.In, ast.NotIn)):
                            if isinstance(comp, (ast.Tuple, ast.List,
                                                 ast.Set)):
                                for el in comp.elts:
                                    s = _str_const(el)
                                    if s is not None:
                                        handled.add(s)
        return handled

    def _check_schedule(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        handled = self._handled_kinds(project)
        for mod in project.modules:
            for fn in ast.walk(mod.tree):
                if not (
                    isinstance(fn, ast.FunctionDef)
                    and fn.name == "make_schedule"
                ):
                    continue
                # Kinds the if-chain dispatches (`kind == "x"`).
                dispatched: Set[str] = set()
                for cmp_ in ast.walk(fn):
                    if (
                        isinstance(cmp_, ast.Compare)
                        and isinstance(cmp_.left, ast.Name)
                        and cmp_.left.id == "kind"
                        and len(cmp_.ops) == 1
                        and isinstance(cmp_.ops[0], ast.Eq)
                    ):
                        s = _str_const(cmp_.comparators[0])
                        if s is not None:
                            dispatched.add(s)
                # include default set ⊆ dispatched kinds.
                args = fn.args
                defaults = dict(
                    zip([a.arg for a in args.args][-len(args.defaults):],
                        args.defaults)
                ) if args.defaults else {}
                inc = defaults.get("include")
                if dispatched and isinstance(inc, (ast.Tuple, ast.List)):
                    for el in inc.elts:
                        s = _str_const(el)
                        if s is not None and s not in dispatched:
                            out.append(Finding(
                                rule=self.name, path=str(mod.path),
                                line=el.lineno,
                                message=(
                                    f"include default '{s}' is not a "
                                    f"kind make_schedule dispatches — "
                                    f"schedules would raise on it"
                                ),
                            ))
                # Emitted window kinds ⊆ nemesis-handled verbs.
                if not handled:
                    continue
                for call in ast.walk(fn):
                    if not (
                        isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Attribute)
                        and call.func.attr == "append"
                        and len(call.args) == 1
                        and isinstance(call.args[0], ast.Tuple)
                        and len(call.args[0].elts) >= 2
                    ):
                        continue
                    s = _str_const(call.args[0].elts[1])
                    if s is not None and s not in handled:
                        out.append(Finding(
                            rule=self.name, path=str(mod.path),
                            line=call.lineno,
                            message=(
                                f"make_schedule emits window kind "
                                f"'{s}' that no nemesis verb handles "
                                f"(_start would raise mid-run)"
                            ),
                        ))
        return out


# ---------------------------------------------------------------------------
# wire-caps
# ---------------------------------------------------------------------------


@register
class WireCapsRule(Rule):
    name = "wire-caps"
    doc = (
        "hello capability strings tested against a caps set must be "
        "declared in _WIRE_CAPS, and every declared cap must be "
        "negotiated somewhere"
    )

    def check(self, project: Project) -> List[Finding]:
        decl: Optional[Tuple[ModuleInfo, ast.stmt, Set[str]]] = None
        for mod in project.modules:
            stmt = _top_assign(mod, "_WIRE_CAPS")
            if stmt is not None and isinstance(
                stmt.value, (ast.Tuple, ast.List)
            ):
                caps = {
                    s for s in (_str_const(el) for el in stmt.value.elts)
                    if s is not None
                }
                decl = (mod, stmt, caps)
                break
        if decl is None:
            return []
        dmod, dstmt, caps = decl
        out: List[Finding] = []
        tested: Set[str] = set()
        for mod in project.modules:
            for cmp_ in ast.walk(mod.tree):
                if not (
                    isinstance(cmp_, ast.Compare)
                    and len(cmp_.ops) == 1
                    and isinstance(cmp_.ops[0], (ast.In, ast.NotIn))
                ):
                    continue
                s = _str_const(cmp_.left)
                if s is None:
                    continue
                leaf = _leaf(cmp_.comparators[0])
                if leaf is None or "cap" not in leaf.lower():
                    continue
                tested.add(s)
                if s not in caps:
                    out.append(Finding(
                        rule=self.name, path=str(mod.path),
                        line=cmp_.lineno,
                        message=(
                            f"capability '{s}' is tested against the "
                            f"negotiated caps but not declared in "
                            f"_WIRE_CAPS — this build never offers it, "
                            f"so the branch is dead (or the hello "
                            f"payload drifted)"
                        ),
                    ))
        for s in sorted(caps - tested):
            out.append(Finding(
                rule=self.name, path=str(dmod.path), line=dstmt.lineno,
                message=(
                    f"_WIRE_CAPS declares '{s}' but no site tests for "
                    f"it — the capability is advertised and never "
                    f"negotiated"
                ),
            ))
        return out


# ---------------------------------------------------------------------------
# env-knob
# ---------------------------------------------------------------------------

_ACCESSORS = ("knob_str", "knob_int", "knob_float", "knob_bool")


def _knob_decls(project: Project) -> Tuple[Set[str], Set[str]]:
    """(declared knob names, paths of modules defining KNOBS): a tuple
    of ``Knob(name, ...)`` calls, or this package's dict literal keyed
    by knob name (``{"MRT_X": (type, default)}``)."""
    names: Set[str] = set()
    paths: Set[str] = set()
    for mod in project.modules:
        stmt = _top_assign(mod, "KNOBS")
        if stmt is not None and isinstance(stmt.value, ast.Dict):
            keys = {_str_const(k) for k in stmt.value.keys if k is not None}
            keys.discard(None)
            if keys:
                names |= keys
                paths.add(str(mod.path))
            continue
        if stmt is None or not isinstance(stmt.value, (ast.Tuple, ast.List)):
            continue
        found = False
        for el in stmt.value.elts:
            if not (isinstance(el, ast.Call) and _leaf(el.func) == "Knob"):
                continue
            name = None
            if el.args:
                name = _str_const(el.args[0])
            for kw in el.keywords:
                if kw.arg == "name":
                    name = _str_const(kw.value)
            if name is not None:
                names.add(name)
                found = True
        if found:
            paths.add(str(mod.path))
    return names, paths


@register
class EnvKnobRule(Rule):
    name = "env-knob"
    doc = (
        "MRT_* environment knobs must be declared in utils/knobs.py "
        "and read through the typed accessors — raw os.environ reads "
        "and undeclared accessor names are findings"
    )

    def check(self, project: Project) -> List[Finding]:
        declared, knob_paths = _knob_decls(project)
        out: List[Finding] = []
        for mod in project.modules:
            in_registry = str(mod.path) in knob_paths
            for node in ast.walk(mod.tree):
                if not in_registry:
                    raw = self._raw_read(node)
                    if raw is not None:
                        name, line = raw
                        out.append(Finding(
                            rule=self.name, path=str(mod.path), line=line,
                            message=(
                                f"raw os.environ read of '{name}' — "
                                f"declare it in utils/knobs.py KNOBS "
                                f"and use the typed knob_*() accessor"
                            ),
                        ))
                        continue
                if declared and isinstance(node, ast.Call):
                    leaf = _leaf(node.func)
                    if leaf in _ACCESSORS and node.args:
                        name = _str_const(node.args[0])
                        if name is not None and name not in declared:
                            out.append(Finding(
                                rule=self.name, path=str(mod.path),
                                line=node.lineno,
                                message=(
                                    f"knob accessor reads '{name}' "
                                    f"which KNOBS does not declare — "
                                    f"add the registry entry (type, "
                                    f"default, doc)"
                                ),
                            ))
        return out

    @staticmethod
    def _raw_read(node: ast.AST) -> Optional[Tuple[str, int]]:
        """(MRT name, line) when ``node`` reads os.environ raw."""
        if isinstance(node, ast.Call):
            d = dotted_name(node.func)
            if d is not None and (
                d.endswith("environ.get") or d.endswith("getenv")
            ):
                if node.args:
                    s = _str_const(node.args[0])
                    if s is not None and s.startswith("MRT_"):
                        return s, node.lineno
        elif isinstance(node, ast.Subscript) and isinstance(
            node.ctx, ast.Load
        ):
            d = dotted_name(node.value)
            if d is not None and d.endswith("environ"):
                s = _str_const(node.slice)
                if s is not None and s.startswith("MRT_"):
                    return s, node.lineno
        elif isinstance(node, ast.Compare) and len(node.ops) == 1:
            if isinstance(node.ops[0], (ast.In, ast.NotIn)):
                d = dotted_name(node.comparators[0])
                if d is not None and d.endswith("environ"):
                    s = _str_const(node.left)
                    if s is not None and s.startswith("MRT_"):
                        return s, node.lineno
        return None
