"""Static lock-graph audit: acquisition-order cycles + unlocked writes
(PyTorch port of ``multiraft_tpu/analysis/lockgraph.py``).

The threaded transport stack (tcp.py's loop thread + caller threads,
chaos.py's RNG lock, realtime.py's scheduler condition, nemesis.py's
clerk history lock) is exactly the code Go's race detector would watch
in the reference stack.  This module extracts an approximation of the
runtime lock graph from the AST:

* **lock identities** are ``(ClassName, attr)`` for ``self.X =
  threading.Lock()/RLock()/Condition()`` attributes and
  ``(module, name)`` for module-level locks.  This collapses all
  instances of a class onto one node — conservative for cycle
  detection across classes (the interesting case), at the cost of
  false positives for self-edges on per-instance locks, which are
  reported distinctly ("self-cycle") and only when a ``with`` on the
  lock appears lexically inside another ``with`` on the same lock.
* **edges** H → L mean "L acquired while H held": directly nested
  ``with`` blocks, plus calls made under H into methods (same class,
  attribute-typed member objects, module functions) that acquire
  their own locks — followed transitively to depth 4.
* ``lock-order`` findings are cycles in that graph; ``unlocked-write``
  findings are attribute stores outside any lock for attributes that
  are stored under a lock elsewhere in the same class (the classic
  "forgot the lock on one branch" race — chaos.py's block-branch
  counter increment was exactly this).

The static audit is backed by a *dynamic* recorder
(:mod:`.lockorder`) asserted in the chaos tests, so the approximation
has a runtime cross-check.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, Project, Rule, register
from .dataflow import ClassInfo, get_dataflow

__all__ = [
    "Acquisition",
    "ClassInfo",
    "LockGraph",
    "LockId",
    "get_lock_graph",
]

LockId = Tuple[str, str]  # (scope = class or module stem, attr/name)


@dataclass
class Acquisition:
    lock: LockId
    path: str
    line: int
    method: str


class LockGraph:
    """Per-method acquisitions and the lock-order edge set.

    Class/lock/type collection lives in :mod:`.dataflow` (one shared
    pass per lint run — the serving-path rules read the same tables);
    this class keeps the lock-specific analysis: with-block resolution,
    transitive acquisition closure, and edge construction."""

    def __init__(self, project: Project) -> None:
        self.project = project
        df = get_dataflow(project)
        self.classes: Dict[str, ClassInfo] = df.classes
        self.module_locks: Dict[str, Set[str]] = df.module_locks
        self.module_funcs: Dict[str, Dict[str, ast.FunctionDef]] = (
            df.module_funcs
        )
        # (scope, method) → locks transitively acquired inside
        self._acq_memo: Dict[Tuple[str, str], Set[LockId]] = {}
        # edge → one witness site
        self.edges: Dict[Tuple[LockId, LockId], Acquisition] = {}
        self._build_edges()

    # -- lock resolution ---------------------------------------------------

    def _lock_of_withitem(
        self, ci: Optional[ClassInfo], stem: str, ctx: ast.AST
    ) -> Optional[LockId]:
        if (
            ci is not None
            and isinstance(ctx, ast.Attribute)
            and isinstance(ctx.value, ast.Name)
            and ctx.value.id == "self"
            and ctx.attr in ci.lock_attrs
        ):
            return (ci.name, ctx.attr)
        if isinstance(ctx, ast.Name) and ctx.id in self.module_locks.get(
            stem, ()
        ):
            return (stem, ctx.id)
        return None

    # -- transitive acquisitions per callee --------------------------------

    def _callee_acquires(
        self,
        ci: Optional[ClassInfo],
        stem: str,
        call: ast.Call,
        depth: int,
    ) -> Set[LockId]:
        if depth <= 0:
            return set()
        f = call.func
        # self.meth(...)
        if (
            ci is not None
            and isinstance(f, ast.Attribute)
            and isinstance(f.value, ast.Name)
            and f.value.id == "self"
            and f.attr in ci.methods
        ):
            return self._method_acquires(ci, f.attr, depth)
        # self.attr.meth(...)
        if (
            ci is not None
            and isinstance(f, ast.Attribute)
            and isinstance(f.value, ast.Attribute)
            and isinstance(f.value.value, ast.Name)
            and f.value.value.id == "self"
        ):
            target_cls = ci.attr_types.get(f.value.attr)
            tci = self.classes.get(target_cls or "")
            if tci is not None and f.attr in tci.methods:
                return self._method_acquires(tci, f.attr, depth)
        # module_fn(...)
        if isinstance(f, ast.Name) and f.id in self.module_funcs.get(
            stem, ()
        ):
            fn = self.module_funcs[stem][f.id]
            return self._fn_acquires(None, stem, fn, f"{stem}.{f.id}", depth)
        return set()

    def _method_acquires(
        self, ci: ClassInfo, meth: str, depth: int
    ) -> Set[LockId]:
        key = (ci.name, meth)
        if key in self._acq_memo:
            return self._acq_memo[key]
        self._acq_memo[key] = set()  # cycle guard
        acc = self._fn_acquires(
            ci, ci.module, ci.methods[meth], f"{ci.name}.{meth}", depth
        )
        self._acq_memo[key] = acc
        return acc

    def _fn_acquires(
        self,
        ci: Optional[ClassInfo],
        stem: str,
        fn: ast.FunctionDef,
        label: str,
        depth: int,
    ) -> Set[LockId]:
        acc: Set[LockId] = set()
        for n in ast.walk(fn):
            if isinstance(n, ast.With):
                for item in n.items:
                    lock = self._lock_of_withitem(
                        ci, stem, item.context_expr
                    )
                    if lock is not None:
                        acc.add(lock)
            elif isinstance(n, ast.Call):
                acc |= self._callee_acquires(ci, stem, n, depth - 1)
        return acc

    # -- edge construction -------------------------------------------------

    def _build_edges(self) -> None:
        for ci in self.classes.values():
            for mname, meth in ci.methods.items():
                self._walk_held(ci, ci.module, meth, mname, [])
        for stem, funcs in self.module_funcs.items():
            mod = next(
                (m for m in self.project.modules if m.name == stem), None
            )
            if mod is None:
                continue
            for fname, fn in funcs.items():
                self._walk_held(None, stem, fn, fname, [])

    def _walk_held(
        self,
        ci: Optional[ClassInfo],
        stem: str,
        node: ast.AST,
        method: str,
        held: List[LockId],
    ) -> None:
        path = ci.path if ci is not None else next(
            (str(m.path) for m in self.project.modules if m.name == stem),
            stem,
        )

        def add_edges(locks: Set[LockId], line: int) -> None:
            for lock in locks:
                for h in held:
                    if h == lock:
                        continue  # re-entry on one lock: self-cycle below
                    key = (h, lock)
                    if key not in self.edges:
                        self.edges[key] = Acquisition(
                            lock=lock, path=path, line=line, method=method
                        )

        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.With):
                acquired: List[LockId] = []
                for item in child.items:
                    lock = self._lock_of_withitem(
                        ci, stem, item.context_expr
                    )
                    if lock is not None:
                        add_edges({lock}, child.lineno)
                        acquired.append(lock)
                for sub in child.body:
                    self._walk_held(
                        ci, stem, sub, method, held + acquired
                    )
                continue
            if isinstance(child, ast.Call) and held:
                add_edges(
                    self._callee_acquires(ci, stem, child, 4),
                    child.lineno,
                )
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                # nested defs execute later, not under the held locks
                self._walk_held(ci, stem, child, child.name, [])
                continue
            self._walk_held(ci, stem, child, method, held)

    # -- queries -----------------------------------------------------------

    def cycles(self) -> List[List[LockId]]:
        """Elementary cycles in the edge set (DFS over components)."""
        graph: Dict[LockId, Set[LockId]] = {}
        for (a, b) in self.edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        out: List[List[LockId]] = []
        seen_cycles: Set[Tuple[LockId, ...]] = set()

        def dfs(start: LockId, node: LockId, stack: List[LockId]) -> None:
            for nxt in graph.get(node, ()):  # noqa: B007
                if nxt == start and len(stack) > 0:
                    canon = min(
                        tuple(stack[i:] + stack[:i])
                        for i in range(len(stack))
                    )
                    if canon not in seen_cycles:
                        seen_cycles.add(canon)
                        out.append(list(canon))
                elif nxt not in stack and len(stack) < 6:
                    dfs(start, nxt, stack + [nxt])

        for node in graph:
            dfs(node, node, [node])
        return out


def get_lock_graph(project: Project) -> LockGraph:
    """Build (or reuse) the lock graph for this project.

    Both lock rules need the same edge set; memoizing on the project
    halves the cost of the most expensive analysis pass."""
    cached = getattr(project, "_graftlint_lockgraph", None)
    if cached is None:
        cached = LockGraph(project)
        project._graftlint_lockgraph = cached  # type: ignore[attr-defined]
    return cached


@register
class LockOrderRule(Rule):
    name = "lock-order"
    doc = (
        "the static lock acquisition graph must be acyclic; a cycle "
        "is a potential ABBA deadlock between threads."
    )

    def check(self, project: Project) -> List[Finding]:
        graph = get_lock_graph(project)
        out: List[Finding] = []
        for cycle in graph.cycles():
            # find a witness edge on the cycle for location info
            witness = None
            for i in range(len(cycle)):
                key = (cycle[i], cycle[(i + 1) % len(cycle)])
                if key in graph.edges:
                    witness = graph.edges[key]
                    break
            desc = " -> ".join(f"{c[0]}.{c[1]}" for c in cycle)
            out.append(
                Finding(
                    rule=self.name,
                    path=witness.path if witness else "<project>",
                    line=witness.line if witness else 1,
                    message=(
                        f"lock-order cycle {desc} -> "
                        f"{cycle[0][0]}.{cycle[0][1]}: potential ABBA "
                        "deadlock (or document + refactor the nesting)"
                    ),
                )
            )
        return out


@register
class UnlockedWriteRule(Rule):
    name = "unlocked-write"
    doc = (
        "an attribute stored under a lock in one method must not be "
        "stored without it in another branch/method (minus __init__): "
        "the unlocked store races the locked readers."
    )

    def check(self, project: Project) -> List[Finding]:
        graph = get_lock_graph(project)
        out: List[Finding] = []
        for ci in graph.classes.values():
            if not ci.lock_attrs:
                continue
            locked_writes = self._writes(ci, under_lock=True, graph=graph)
            if not locked_writes:
                continue
            for attr, site in self._writes(
                ci, under_lock=False, graph=graph
            ).items():
                if attr in locked_writes:
                    out.append(
                        Finding(
                            rule=self.name,
                            path=ci.path,
                            line=site,
                            message=(
                                f"self.{attr} is written under "
                                f"{ci.name}'s lock elsewhere but "
                                "written here without it; the "
                                "unlocked store races the locked "
                                "readers/writers"
                            ),
                        )
                    )
        return out

    def _writes(
        self, ci: ClassInfo, under_lock: bool, graph: LockGraph
    ) -> Dict[str, int]:
        """attr → first write line, filtered by lock context."""
        found: Dict[str, int] = {}

        def visit(node: ast.AST, held: bool) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.With):
                    acquires = any(
                        graph._lock_of_withitem(
                            ci, ci.module, item.context_expr
                        )
                        is not None
                        for item in child.items
                    )
                    for sub in child.body:
                        visit(sub, held or acquires)
                    continue
                if isinstance(child, (ast.Assign, ast.AugAssign)):
                    targets = (
                        child.targets
                        if isinstance(child, ast.Assign)
                        else [child.target]
                    )
                    for t in targets:
                        base = t
                        while isinstance(base, ast.Subscript):
                            base = base.value
                        if (
                            isinstance(base, ast.Attribute)
                            and isinstance(base.value, ast.Name)
                            and base.value.id == "self"
                            and held == under_lock
                            and base.attr not in found
                        ):
                            found[base.attr] = child.lineno
                visit(child, held)

        for mname, meth in ci.methods.items():
            if mname == "__init__":
                continue
            visit(meth, False)
        return found
