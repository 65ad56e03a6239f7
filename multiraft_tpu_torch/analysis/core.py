"""graftlint core: project-native AST lint framework (PyTorch port of
``multiraft_tpu/analysis/core.py``).

The reference Go stack keeps a heavily concurrent consensus codebase
honest with ``go vet`` and the race detector; graftlint is the Python
equivalent, except the rules are *project-specific*: each one encodes
a bug class the codebase actually shipped.

Design:

* A :class:`Project` parses every ``.py`` file under the requested
  paths once (``ast.parse`` — files are never imported, so linting
  cannot execute project code or require heavyweight deps).
* A :class:`Rule` sees the whole project and yields
  :class:`Finding` objects.  Rules are whole-project rather than
  per-file because half of them are cross-file by nature (frame
  arities between encoder and decoder, service registrations vs. the
  chaos exemption set, the lock acquisition graph).
* Suppression is inline and auditable: ``# graftlint: disable=<rule>``
  on the offending line suppresses that rule there;
  ``# graftlint: disable-file=<rule>`` anywhere in a file suppresses
  the rule for the file.  ``run()`` returns suppressed findings
  separately so the test suite can assert suppressions stay few and
  documented.
"""

from __future__ import annotations

import ast
import re
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Finding",
    "ModuleInfo",
    "Project",
    "Rule",
    "run",
    "ALL_RULES",
    "register",
]

_PRAGMA_LINE = re.compile(r"#\s*graftlint:\s*disable=([\w,-]+)")
_PRAGMA_FILE = re.compile(r"#\s*graftlint:\s*disable-file=([\w,-]+)")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class ModuleInfo:
    """One parsed source file plus its suppression pragmas."""

    path: Path
    source: str
    tree: ast.Module
    # line number -> set of rule names disabled on that line
    line_disables: Dict[int, Set[str]] = field(default_factory=dict)
    # rule names disabled for the whole file
    file_disables: Set[str] = field(default_factory=set)

    @property
    def name(self) -> str:
        return self.path.stem

    def is_suppressed(self, rule: str, line: int) -> bool:
        if rule in self.file_disables:
            return True
        return rule in self.line_disables.get(line, ())


class Project:
    """All parsed modules under the linted roots."""

    def __init__(self, modules: Sequence[ModuleInfo]) -> None:
        self.modules: List[ModuleInfo] = list(modules)
        self._by_stem: Dict[str, List[ModuleInfo]] = {}
        for m in self.modules:
            self._by_stem.setdefault(m.name, []).append(m)

    def find(self, stem: str) -> List[ModuleInfo]:
        """Modules whose filename (sans .py) is ``stem``."""
        return self._by_stem.get(stem, [])

    @classmethod
    def load(cls, paths: Iterable[Path]) -> "Project":
        files: List[Path] = []
        for p in paths:
            p = Path(p)
            if p.is_dir():
                files.extend(sorted(p.rglob("*.py")))
            elif p.suffix == ".py":
                files.append(p)
        mods = []
        for f in files:
            if "__pycache__" in f.parts:
                continue
            mod = _parse_module(f)
            if mod is not None:
                mods.append(mod)
        return cls(mods)


def _parse_module(path: Path) -> Optional[ModuleInfo]:
    try:
        source = path.read_text(encoding="utf-8")
    except OSError:
        return None
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as e:
        # A file that does not parse is itself a finding-worthy state,
        # but tier-1 pytest already fails on import errors; skip here.
        raise SyntaxError(f"{path}: {e}") from e
    line_disables: Dict[int, Set[str]] = {}
    file_disables: Set[str] = set()
    for i, line in enumerate(source.splitlines(), start=1):
        m = _PRAGMA_FILE.search(line)
        if m:
            file_disables.update(m.group(1).split(","))
            continue
        m = _PRAGMA_LINE.search(line)
        if m:
            line_disables.setdefault(i, set()).update(m.group(1).split(","))
    return ModuleInfo(
        path=path,
        source=source,
        tree=tree,
        line_disables=line_disables,
        file_disables=file_disables,
    )


class Rule:
    """Base class: subclass, set ``name``/``doc``, implement ``check``."""

    name: str = "abstract"
    doc: str = ""

    def check(self, project: Project) -> List[Finding]:
        raise NotImplementedError


ALL_RULES: List[Rule] = []


def register(rule_cls):
    """Class decorator adding an instance to the default rule set."""
    ALL_RULES.append(rule_cls())
    return rule_cls


def run(
    paths: Iterable[Path],
    rules: Optional[Sequence[Rule]] = None,
    timings: Optional[Dict[str, float]] = None,
) -> Tuple[List[Finding], List[Finding]]:
    """Lint ``paths``; returns ``(active, suppressed)`` findings.

    ``active`` are unsuppressed violations (the gate fails on any);
    ``suppressed`` were matched by a ``# graftlint: disable`` pragma
    and are reported so suppressions stay visible.  Pass a dict as
    ``timings`` to collect per-rule wall-clock seconds (the first rule
    that touches the dataflow cache pays its build cost).
    """
    project = Project.load(paths)
    if rules is None:
        # Import for the registration side effect only.
        from . import rules as _rules  # noqa: F401
        from . import lockgraph as _lockgraph  # noqa: F401
        from . import dataflow as _dataflow  # noqa: F401
        from . import planes as _planes  # noqa: F401
        from . import registry as _registry  # noqa: F401

        rules = ALL_RULES
    by_path = {str(m.path): m for m in project.modules}
    active: List[Finding] = []
    suppressed: List[Finding] = []
    for rule in rules:
        t0 = time.perf_counter() if timings is not None else 0.0
        findings = rule.check(project)
        if timings is not None:
            timings[rule.name] = (
                timings.get(rule.name, 0.0) + time.perf_counter() - t0
            )
        for f in findings:
            mod = by_path.get(f.path)
            if mod is not None and mod.is_suppressed(f.rule, f.line):
                suppressed.append(f)
            else:
                active.append(f)
    key = lambda f: (f.path, f.line, f.rule)  # noqa: E731
    # rules may visit nested functions from both enclosing scopes;
    # Finding is frozen/hashable so dedup is exact
    return (
        sorted(set(active), key=key),
        sorted(set(suppressed), key=key),
    )


# ---------------------------------------------------------------------------
# Shared AST helpers used by the rule modules.
# ---------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def const_int(node: ast.AST) -> Optional[int]:
    """Evaluate small constant integer expressions (``2 ** 16``)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    if isinstance(node, ast.BinOp):
        left, right = const_int(node.left), const_int(node.right)
        if left is None or right is None:
            return None
        try:
            if isinstance(node.op, ast.Pow):
                return left**right if right < 128 else None
            if isinstance(node.op, ast.Mult):
                return left * right
            if isinstance(node.op, ast.Add):
                return left + right
            if isinstance(node.op, ast.Sub):
                return left - right
        except Exception:  # pragma: no cover - defensive
            return None
    return None


def iter_functions(tree: ast.Module):
    """Yield every (possibly nested) function/lambda-free def node."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def names_in(node: ast.AST) -> Set[str]:
    """All Name identifiers loaded anywhere inside ``node``."""
    return {
        n.id for n in ast.walk(node) if isinstance(n, ast.Name)
    }
