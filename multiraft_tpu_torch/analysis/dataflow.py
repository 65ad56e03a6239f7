"""graftlint dataflow: whole-project call graph + serving-path rules
(PyTorch port of ``multiraft_tpu/analysis/dataflow.py``).

The rules of :mod:`.rules` are intraprocedural — each looks at one
function (or one module) at a time.  The bug classes of a serving path
are not: a queue grows in ``_reply`` because a *callback
registration* three calls away put it on the scheduler loop, and a
checkpoint fsync blocks the loop because a pump tick reached it through
two layers of durability plumbing.  This module builds the shared
interprocedural substrate once per lint run:

* **Function table** — every def (methods, nested defs included) as a
  :class:`FuncInfo` keyed by ``(path, qualname)``.
* **Class table** — :class:`ClassInfo` with lock attributes and
  one-step ctor-param attribute typing (grown out of lockgraph.py's
  collector, which now consumes this table instead of building its
  own).
* **Call resolution** — ``self.meth`` / ``self.a.b.meth`` chains via
  attribute types, module functions, imported project functions,
  nested defs, local aliases (``reply = self._reply if … else …``),
  ctor-typed locals (``fut = Future(); fut.resolve``).
* **Serving roots** — the functions that run on a scheduler loop
  thread or as RPC handlers: callables registered through
  ``call_at/call_after/call_soon/post/spawn/run_call/
  add_done_callback``, ``*Scheduler(...)`` ctor hooks (io_poll /
  io_handle / io_flush), and the public methods of every class passed
  to ``add_service``.
* **Reachability** — BFS over the call graph from those roots; the
  serving-path rules below only fire inside the reachable set.

Approximations (deliberate, documented): one type per attribute /
local (last ctor wins), no flow through containers or ``**kwargs``,
dynamic dispatch through reassigned bound-method attributes is
invisible, and a callback registered in dead code still roots its
target.  All three rules err toward silence outside the resolved
serving set and toward noise inside it — the pragma machinery from
core.py is the escape hatch, and every suppression is inventoried by
``-v`` / the test suite.

Rules that live here:

* ``unbounded-queue`` — a ``self.<attr>`` container that grows
  (``append``/``appendleft``/``add``, incl. ``setdefault(...).append``
  chains and local aliases of the attribute) inside a serving-reachable
  function, with no dominating bound check (a ``len()`` comparison
  mentioning the container) or shed path (``pop``/``popleft``/
  ``clear``/``discard``/``del``/truncating re-slice) in the same
  function.  The seed true positive was tcp.py's per-connection reply
  queue (fixed in this PR with a cap + shed-oldest policy).
* ``blocking-in-callback`` — ``time.sleep``, ``os.fsync``/
  ``os.fdatasync``, blocking socket ``sendall``, ``run_call``
  rendezvous, ``sched.wait`` and blocking ``lock.acquire()`` reached
  from a scheduler/timer callback: each one stalls the single loop
  thread that every reply on this node rides on.  The WAL/disk
  durability layer is allowlisted (its contract IS sync-on-pump);
  everything else needs an explicit pragma.
* ``wire-schema`` — frame-arity extended across modules: tuple frames
  that actually flow into ``codec.encode`` / ``codec.encode_oob``
  (both the 0x80 legacy pickle path and the 0x01 out-of-band path,
  including the coalesced ``repb`` reply frames) are collected
  project-wide and checked against every decoder branch, wherever it
  lives.  Same-module drift stays frame-arity's report (no double
  findings).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from .core import Finding, Project, Rule, dotted_name, register

__all__ = [
    "ClassInfo",
    "Dataflow",
    "FuncInfo",
    "get_dataflow",
    "is_lock_ctor",
    "own_nodes",
]

FuncId = Tuple[str, str]  # (path, qualname)

_LOCK_CTORS = ("Lock", "RLock", "Condition")


def is_lock_ctor(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    d = dotted_name(node.func)
    if d is None:
        return False
    return d.rsplit(".", 1)[-1] in _LOCK_CTORS


@dataclass
class ClassInfo:
    """One class: its methods, lock attributes, and attribute types
    (``self.x = T(...)`` plus one-step ctor-param binding)."""

    name: str
    module: str
    path: str
    node: ast.ClassDef
    bases: List[str] = field(default_factory=list)
    lock_attrs: Set[str] = field(default_factory=set)
    attr_types: Dict[str, str] = field(default_factory=dict)
    methods: Dict[str, ast.FunctionDef] = field(default_factory=dict)


@dataclass
class FuncInfo:
    """One def — top-level, method, or nested — with enough context to
    resolve ``self`` and enclosing-scope names."""

    path: str
    module: str  # file stem
    qualname: str
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    cls: Optional[str] = None  # nearest enclosing class (self's type)
    parent: Optional["FuncInfo"] = None  # nearest enclosing function

    @property
    def name(self) -> str:
        return self.qualname.rsplit(".", 1)[-1]

    @property
    def fid(self) -> FuncId:
        return (self.path, self.qualname)


def own_nodes(root: ast.AST) -> Iterator[ast.AST]:
    """Nodes in a function's own body, NOT descending into nested defs
    or lambdas — their bodies execute later, in their own frame, and
    are analyzed as their own functions (lambdas at their registration
    site)."""
    stack: List[ast.AST] = list(getattr(root, "body", []))
    while stack:
        n = stack.pop()
        yield n
        for c in ast.iter_child_nodes(n):
            if isinstance(
                c, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            stack.append(c)


def _attr_chain(expr: ast.AST) -> Optional[Tuple[str, List[str]]]:
    """``a.b.c`` → ``("a", ["b", "c"])``; None unless rooted at a Name."""
    parts: List[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        return expr.id, list(reversed(parts))
    return None


# Callback-registering method name → index of the callable argument.
_CB_ATTRS = {
    "call_at": 1,
    "call_after": 1,
    "call_soon": 0,
    "post": 0,
    "spawn": 0,
    "run_call": 0,
    "add_done_callback": 0,
}


class Dataflow:
    """The shared interprocedural substrate for one :class:`Project`.

    Build once via :func:`get_dataflow` (memoized on the project);
    lockgraph.py and the serving-path rules all read from the same
    instance, so collection cost is paid once per lint run.
    """

    def __init__(self, project: Project) -> None:
        self.project = project
        self.classes: Dict[str, ClassInfo] = {}
        # stem-keyed views kept for the lock-graph rules (which collapse
        # same-stem modules exactly as before this refactor).
        self.module_locks: Dict[str, Set[str]] = {}
        self.module_funcs: Dict[str, Dict[str, ast.FunctionDef]] = {}
        self.funcs: Dict[FuncId, FuncInfo] = {}
        self._stems: Set[str] = {m.name for m in project.modules}
        self._stem_path: Dict[str, str] = {}
        self._toplevel: Dict[str, Dict[str, FuncInfo]] = {}
        self._methods: Dict[Tuple[str, str], FuncInfo] = {}
        self._nested: Dict[Tuple[FuncId, str], FuncInfo] = {}
        self._by_node: Dict[int, FuncInfo] = {}
        # alias → ("mod", stem) | ("from", "stem:name"), per file
        self._imports: Dict[str, Dict[str, Tuple[str, str]]] = {}
        self._assign_memo: Dict[FuncId, Dict[str, List[ast.AST]]] = {}
        self._edges: Optional[Dict[FuncId, Set[FuncId]]] = None
        self._reach: Optional[Dict[FuncId, Tuple[str, str]]] = None
        self._collect()
        self._bind_ctor_params()

    # -- collection --------------------------------------------------------

    def _collect(self) -> None:
        for mod in self.project.modules:
            stem, path = mod.name, str(mod.path)
            self._stem_path.setdefault(stem, path)
            self.module_funcs.setdefault(stem, {})
            self.module_locks.setdefault(stem, set())
            self._toplevel[path] = {}
            for stmt in mod.tree.body:
                if isinstance(stmt, ast.Assign) and is_lock_ctor(stmt.value):
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            self.module_locks[stem].add(t.id)
            self._imports[path] = self._scan_imports(mod.tree)
            self._visit(stem, path, mod.tree, cls=None, parent=None, prefix="")

    def _visit(
        self,
        stem: str,
        path: str,
        node: ast.AST,
        cls: Optional[ClassInfo],
        parent: Optional[FuncInfo],
        prefix: str,
    ) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                ci = self._make_class(stem, path, child)
                self._visit(
                    stem, path, child, cls=ci, parent=None,
                    prefix=prefix + child.name + ".",
                )
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = prefix + child.name
                fi = FuncInfo(
                    path=path, module=stem, qualname=qual, node=child,
                    cls=cls.name if cls is not None else None,
                    parent=parent,
                )
                self.funcs[fi.fid] = fi
                self._by_node[id(child)] = fi
                if parent is not None:
                    self._nested[(parent.fid, child.name)] = fi
                elif cls is not None:
                    self._methods.setdefault((cls.name, child.name), fi)
                else:
                    self._toplevel[path].setdefault(child.name, fi)
                    self.module_funcs[stem].setdefault(child.name, child)
                self._visit(
                    stem, path, child, cls=cls, parent=fi,
                    prefix=qual + ".",
                )
            else:
                self._visit(stem, path, child, cls, parent, prefix)

    def _make_class(
        self, stem: str, path: str, node: ast.ClassDef
    ) -> ClassInfo:
        ci = ClassInfo(
            name=node.name,
            module=stem,
            path=path,
            node=node,
            bases=[
                b.rsplit(".", 1)[-1]
                for b in (dotted_name(base) for base in node.bases)
                if b is not None
            ],
        )
        for item in node.body:
            if isinstance(item, ast.FunctionDef):
                ci.methods[item.name] = item
        for meth in ci.methods.values():
            for n in ast.walk(meth):
                if (
                    isinstance(n, ast.Assign)
                    and len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Attribute)
                    and isinstance(n.targets[0].value, ast.Name)
                    and n.targets[0].value.id == "self"
                ):
                    attr = n.targets[0].attr
                    if is_lock_ctor(n.value):
                        ci.lock_attrs.add(attr)
                    else:
                        t = self._ctor_class(n.value)
                        if t is not None:
                            ci.attr_types[attr] = t
        self.classes.setdefault(node.name, ci)
        return self.classes[node.name]

    @staticmethod
    def _ctor_class(value: ast.AST) -> Optional[str]:
        """Class name constructed anywhere in an assignment RHS."""
        for n in ast.walk(value):
            if isinstance(n, ast.Call):
                d = dotted_name(n.func)
                if d is not None:
                    leaf = d.rsplit(".", 1)[-1]
                    if leaf[:1].isupper():
                        return leaf
        return None

    def _scan_imports(self, tree: ast.Module) -> Dict[str, Tuple[str, str]]:
        imp: Dict[str, Tuple[str, str]] = {}
        for n in ast.walk(tree):
            if isinstance(n, ast.Import):
                for a in n.names:
                    leaf = a.name.split(".")[-1]
                    if leaf in self._stems:
                        imp[a.asname or leaf] = ("mod", leaf)
            elif isinstance(n, ast.ImportFrom):
                modleaf = (n.module or "").split(".")[-1]
                for a in n.names:
                    if a.name in self._stems:
                        imp[a.asname or a.name] = ("mod", a.name)
                    elif modleaf in self._stems:
                        imp[a.asname or a.name] = (
                            "from", f"{modleaf}:{a.name}"
                        )
        return imp

    def _bind_ctor_params(self) -> None:
        """One-step inter-procedural attr typing: wherever ``T(x, …)``
        is called with a typable argument, bind T.__init__'s parameter
        to that type, so ``self._dur = dur`` inside T.__init__ types
        ``_dur``.  This closes back-references (transport → node) and
        dependency injection through serve()-style builders."""
        for _ in range(2):  # fixpoint over 1-hop chains
            for fi in self.funcs.values():
                for call in own_nodes(fi.node):
                    if not isinstance(call, ast.Call):
                        continue
                    d = dotted_name(call.func)
                    if d is None:
                        continue
                    target = self.classes.get(d.rsplit(".", 1)[-1])
                    if target is None or "__init__" not in target.methods:
                        continue
                    params = [
                        a.arg
                        for a in target.methods["__init__"].args.args
                    ][1:]  # drop self
                    bound: Dict[str, str] = {}
                    for p, arg in zip(params, call.args):
                        t = self._class_of_expr(fi, arg, 3)
                        if t is not None:
                            bound[p] = t
                    for kw in call.keywords:
                        if kw.arg is not None:
                            t = self._class_of_expr(fi, kw.value, 3)
                            if t is not None:
                                bound[kw.arg] = t
                    if not bound:
                        continue
                    for n in ast.walk(target.methods["__init__"]):
                        if (
                            isinstance(n, ast.Assign)
                            and len(n.targets) == 1
                            and isinstance(n.targets[0], ast.Attribute)
                            and isinstance(n.targets[0].value, ast.Name)
                            and n.targets[0].value.id == "self"
                            and isinstance(n.value, ast.Name)
                            and n.value.id in bound
                        ):
                            target.attr_types.setdefault(
                                n.targets[0].attr, bound[n.value.id]
                            )

    # -- name/type resolution ----------------------------------------------

    def toplevel_func(self, stem: str, name: str) -> Optional[FuncInfo]:
        path = self._stem_path.get(stem)
        if path is None:
            return None
        return self._toplevel.get(path, {}).get(name)

    def lookup_method(
        self, cls_name: str, meth: str, _seen: Optional[Set[str]] = None
    ) -> Optional[FuncInfo]:
        hit = self._methods.get((cls_name, meth))
        if hit is not None:
            return hit
        ci = self.classes.get(cls_name)
        if ci is None:
            return None
        seen = _seen or set()
        if cls_name in seen:
            return None
        seen.add(cls_name)
        for b in ci.bases:
            hit = self.lookup_method(b, meth, seen)
            if hit is not None:
                return hit
        return None

    def resolve_attr_class(
        self, cls_name: str, chain: Sequence[str]
    ) -> Optional[str]:
        """Type of ``self.a.b`` given self's class and ["a", "b"]."""
        cur: Optional[str] = cls_name
        for a in chain:
            ci = self.classes.get(cur or "")
            cur = ci.attr_types.get(a) if ci is not None else None
            if cur is None:
                return None
        return cur

    def _local_assigns(self, fi: FuncInfo) -> Dict[str, List[ast.AST]]:
        memo = self._assign_memo.get(fi.fid)
        if memo is None:
            memo = {}
            for n in own_nodes(fi.node):
                if (
                    isinstance(n, ast.Assign)
                    and len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Name)
                ):
                    memo.setdefault(n.targets[0].id, []).append(n.value)
            self._assign_memo[fi.fid] = memo
        return memo

    def _local_type(
        self, fi: FuncInfo, name: str, depth: int
    ) -> Optional[str]:
        """Class of a local: ``x = Cls(...)``, ``x = sched.run_call(
        build)`` (build's return class), ``x = make()`` (make's return
        class)."""
        if depth <= 0:
            return None
        if name == "self":
            return fi.cls
        p: Optional[FuncInfo] = fi
        while p is not None:
            for rhs in self._local_assigns(p).get(name, ()):
                t = self._class_of_expr(p, rhs, depth - 1)
                if t is not None:
                    return t
            p = p.parent
        return None

    def _class_of_expr(
        self, fi: Optional[FuncInfo], expr: ast.AST, depth: int
    ) -> Optional[str]:
        if depth <= 0:
            return None
        if isinstance(expr, ast.IfExp):
            return self._class_of_expr(
                fi, expr.body, depth - 1
            ) or self._class_of_expr(fi, expr.orelse, depth - 1)
        if isinstance(expr, ast.Name):
            if expr.id == "self" and fi is not None:
                return fi.cls
            if expr.id in self.classes:
                return None  # a class object, not an instance
            if fi is not None:
                return self._local_type(fi, expr.id, depth)
            return None
        if isinstance(expr, ast.Attribute):
            bc = _attr_chain(expr)
            if bc is None or fi is None:
                return None
            base, chain = bc
            if base == "self" and fi.cls:
                return self.resolve_attr_class(fi.cls, chain)
            t = self._local_type(fi, base, depth - 1)
            if t is not None:
                return self.resolve_attr_class(t, chain)
            return None
        if isinstance(expr, ast.Call):
            d = dotted_name(expr.func)
            leaf = d.rsplit(".", 1)[-1] if d is not None else None
            if leaf is not None and leaf in self.classes:
                return leaf
            # sched.run_call(build, ...) — the loop-thread constructor
            # rendezvous: the result is whatever ``build`` returns.
            if leaf == "run_call" and expr.args:
                for t in self.callable_targets(fi, expr.args[0], depth - 1):
                    rc = self._return_class(t, depth - 1)
                    if rc is not None:
                        return rc
                return None
            for t in self.callable_targets(fi, expr.func, depth - 1):
                rc = self._return_class(t, depth - 1)
                if rc is not None:
                    return rc
        return None

    def _return_class(self, fi: FuncInfo, depth: int) -> Optional[str]:
        if fi.name == "__init__" and fi.cls:
            return fi.cls
        for n in own_nodes(fi.node):
            if isinstance(n, ast.Return) and n.value is not None:
                t = self._class_of_expr(fi, n.value, depth)
                if t is not None:
                    return t
        return None

    def callable_targets(
        self, fi: Optional[FuncInfo], expr: ast.AST, depth: int = 4
    ) -> List[FuncInfo]:
        """Project functions a callable expression may denote.  Handles
        bound methods (through typed attribute chains), module and
        imported functions, nested defs, local aliases (including
        conditional ``a if c else b``), lambdas (their call targets),
        and ctor references (→ ``__init__``)."""
        if depth <= 0:
            return []
        out: List[FuncInfo] = []
        if isinstance(expr, ast.IfExp):
            return self.callable_targets(
                fi, expr.body, depth - 1
            ) + self.callable_targets(fi, expr.orelse, depth - 1)
        if isinstance(expr, ast.Lambda):
            for n in ast.walk(expr.body):
                if isinstance(n, ast.Call):
                    out.extend(
                        self.callable_targets(fi, n.func, depth - 1)
                    )
            return out
        if isinstance(expr, ast.Call):
            # A callback built by a call: spawn(_guarded(gen)),
            # partial(fn, ...).  Collect from callee and arguments.
            out.extend(self.callable_targets(fi, expr.func, depth - 1))
            for a in expr.args:
                out.extend(self.callable_targets(fi, a, depth - 1))
            return out
        if isinstance(expr, ast.Name):
            name = expr.id
            p = fi
            while p is not None:
                hit = self._nested.get((p.fid, name))
                if hit is not None:
                    return [hit]
                p = p.parent
            p = fi
            while p is not None:
                for rhs in self._local_assigns(p).get(name, ()):
                    out.extend(self.callable_targets(p, rhs, depth - 1))
                p = p.parent
            if out:
                return out
            if fi is not None:
                hit = self._toplevel.get(fi.path, {}).get(name)
                if hit is not None:
                    return [hit]
                imp = self._imports.get(fi.path, {}).get(name)
                if imp is not None and imp[0] == "from":
                    stem, fname = imp[1].split(":", 1)
                    tl = self.toplevel_func(stem, fname)
                    if tl is not None:
                        return [tl]
            if name in self.classes:
                init = self.lookup_method(name, "__init__")
                return [init] if init is not None else []
            return []
        if isinstance(expr, ast.Attribute):
            bc = _attr_chain(expr)
            if bc is None:
                return []
            base, chain = bc
            meth, mid = chain[-1], chain[:-1]
            if base == "self" and fi is not None and fi.cls:
                owner: Optional[str] = fi.cls
                if mid:
                    owner = self.resolve_attr_class(fi.cls, mid)
                if owner:
                    hit = self.lookup_method(owner, meth)
                    return [hit] if hit is not None else []
                return []
            if fi is not None and not mid:
                imp = self._imports.get(fi.path, {}).get(base)
                if imp is not None and imp[0] == "mod":
                    hit = self.toplevel_func(imp[1], meth)
                    return [hit] if hit is not None else []
            if base in self.classes and not mid:
                hit = self.lookup_method(base, meth)
                return [hit] if hit is not None else []
            if fi is not None:
                t = self._local_type(fi, base, depth - 1)
                if t is not None:
                    owner = self.resolve_attr_class(t, mid) if mid else t
                    if owner:
                        hit = self.lookup_method(owner, meth)
                        return [hit] if hit is not None else []
            return []
        return []

    def resolve_call(self, fi: FuncInfo, call: ast.Call) -> List[FuncInfo]:
        return self.callable_targets(fi, call.func)

    def func_of_node(self, node: ast.AST) -> Optional[FuncInfo]:
        return self._by_node.get(id(node))

    # -- call graph / roots / reachability ---------------------------------

    def call_edges(self) -> Dict[FuncId, Set[FuncId]]:
        if self._edges is None:
            edges: Dict[FuncId, Set[FuncId]] = {}
            for fi in self.funcs.values():
                tgts: Set[FuncId] = set()
                for n in own_nodes(fi.node):
                    if isinstance(n, ast.Call):
                        for t in self.callable_targets(fi, n.func):
                            tgts.add(t.fid)
                edges[fi.fid] = tgts
            self._edges = edges
        return self._edges

    def serving_roots(self) -> Dict[FuncId, Tuple[str, str]]:
        """fid → (kind, label) for every function that enters the
        serving path: scheduler/timer callbacks and RPC handlers."""
        roots: Dict[FuncId, Tuple[str, str]] = {}

        def add(t: FuncInfo, kind: str, label: str) -> None:
            roots.setdefault(t.fid, (kind, label))

        contexts: List[Tuple[Optional[FuncInfo], ast.AST]] = [
            (fi, fi.node) for fi in self.funcs.values()
        ]
        # module top-level statements (serve() blocks, script mains)
        for mod in self.project.modules:
            contexts.append((None, mod.tree))
        for fi, body in contexts:
            for n in own_nodes(body):
                if not isinstance(n, ast.Call):
                    continue
                d = dotted_name(n.func)
                leaf = d.rsplit(".", 1)[-1] if d is not None else None
                # SomeScheduler(...) ctor: every callable argument is an
                # io/timer hook that runs on the loop thread.
                if (
                    leaf is not None
                    and leaf.endswith("Scheduler")
                    and leaf in self.classes
                ):
                    hook_args = list(n.args) + [
                        kw.value for kw in n.keywords
                    ]
                    for a in hook_args:
                        for t in self.callable_targets(fi, a):
                            add(t, "callback", f"{leaf}() hook")
                    continue
                if not isinstance(n.func, ast.Attribute):
                    continue
                attr = n.func.attr
                if attr in _CB_ATTRS:
                    idx = _CB_ATTRS[attr]
                    if len(n.args) > idx:
                        where = fi.qualname if fi is not None else "<module>"
                        for t in self.callable_targets(fi, n.args[idx]):
                            add(t, "callback", f"{attr} in {where}")
                elif attr == "add_service":
                    self._service_roots(fi, n, add)
        return roots

    def _service_roots(self, fi, call: ast.Call, add) -> None:
        svc, obj = None, None
        if (
            len(call.args) >= 2
            and isinstance(call.args[0], ast.Constant)
            and isinstance(call.args[0].value, str)
        ):
            svc, obj = call.args[0].value, call.args[1]
        elif len(call.args) == 1:
            # sim shape: add_service(Service(obj, name="Raft"))
            a = call.args[0]
            if isinstance(a, ast.Call) and a.args:
                d = dotted_name(a.func)
                if d is not None and d.rsplit(".", 1)[-1] == "Service":
                    obj = a.args[0]
                    for kw in a.keywords:
                        if (
                            kw.arg == "name"
                            and isinstance(kw.value, ast.Constant)
                        ):
                            svc = str(kw.value.value)
        if obj is None:
            return
        cls = self._class_of_expr(fi, obj, 4)
        ci = self.classes.get(cls or "")
        if ci is None:
            return
        label = f'rpc "{svc or ci.name}"'
        for mname in ci.methods:
            if mname.startswith("_"):
                continue
            m = self.lookup_method(ci.name, mname)
            if m is not None:
                add(m, "rpc", label)

    def reachable(self) -> Dict[FuncId, Tuple[str, str]]:
        """fid → (kind, root label) for every function reachable from a
        serving root over the resolved call graph."""
        if self._reach is None:
            edges = self.call_edges()
            reach: Dict[FuncId, Tuple[str, str]] = {}
            queue: List[FuncId] = []
            for fid, info in self.serving_roots().items():
                if fid not in reach:
                    reach[fid] = info
                    queue.append(fid)
            while queue:
                cur = queue.pop()
                info = reach[cur]
                for nxt in edges.get(cur, ()):
                    if nxt not in reach:
                        reach[nxt] = info
                        queue.append(nxt)
            self._reach = reach
        return self._reach


def get_dataflow(project: Project) -> Dataflow:
    """The memoized per-project :class:`Dataflow` (built on first use;
    all rules in one ``run()`` share it)."""
    df = getattr(project, "_graftlint_dataflow", None)
    if df is None:
        df = Dataflow(project)
        project._graftlint_dataflow = df  # type: ignore[attr-defined]
    return df


# ---------------------------------------------------------------------------
# unbounded-queue
# ---------------------------------------------------------------------------

_GROW_ATTRS = {"append", "appendleft", "add"}
_SHED_ATTRS = {"pop", "popleft", "popitem", "clear", "discard", "remove"}


def _container_attr(expr: ast.AST) -> Optional[str]:
    """The self-attribute behind a growing receiver: ``self.X``,
    ``self.X[k]``, ``self.X.setdefault(...)``, ``self.X.get(...)``."""
    if isinstance(expr, ast.Attribute):
        cur: ast.AST = expr
        while isinstance(cur, ast.Attribute):
            cur = cur.value
        if isinstance(cur, ast.Name) and cur.id == "self":
            return expr.attr
        return None
    if isinstance(expr, ast.Subscript):
        return _container_attr(expr.value)
    if (
        isinstance(expr, ast.Call)
        and isinstance(expr.func, ast.Attribute)
        and expr.func.attr in ("setdefault", "get")
    ):
        return _container_attr(expr.func.value)
    return None


def _mentions_container(node: ast.AST, attr: str, aliases: Set[str]) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr == attr:
            return True
        if isinstance(n, ast.Name) and n.id in aliases:
            return True
    return False


def _has_bound_or_shed(
    nodes: List[ast.AST], attr: str, aliases: Set[str]
) -> bool:
    """A dominating bound check (len() comparison mentioning the
    container) or shed path (pop/clear/del/truncating re-slice) in the
    same function."""
    for n in nodes:
        if isinstance(n, ast.Compare):
            for side in [n.left, *n.comparators]:
                for c in ast.walk(side):
                    if (
                        isinstance(c, ast.Call)
                        and dotted_name(c.func) == "len"
                        and c.args
                        and _mentions_container(c.args[0], attr, aliases)
                    ):
                        return True
        elif (
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr in _SHED_ATTRS
            and _mentions_container(n.func.value, attr, aliases)
        ):
            return True
        elif isinstance(n, ast.Delete):
            if any(
                _mentions_container(t, attr, aliases) for t in n.targets
            ):
                return True
        elif isinstance(n, ast.Assign):
            # truncation: self.X = self.X[-k:] (or alias re-slice)
            if any(
                _mentions_container(t, attr, aliases) for t in n.targets
            ) and any(
                isinstance(c, ast.Subscript)
                and _mentions_container(c.value, attr, aliases)
                for c in ast.walk(n.value)
            ):
                return True
    return False


@register
class UnboundedQueueRule(Rule):
    name = "unbounded-queue"
    doc = (
        "a self-attribute container growing inside a serving-reachable "
        "function needs a dominating bound check or shed path in that "
        "function: an overloaded server must shed, not grow until the "
        "flight recorder is the only witness."
    )

    def check(self, project: Project) -> List[Finding]:
        df = get_dataflow(project)
        out: List[Finding] = []
        for fid, (kind, root) in df.reachable().items():
            fi = df.funcs[fid]
            nodes = list(own_nodes(fi.node))
            # include enclosing-function context for guards: a nested
            # callback may rely on a bound its parent establishes
            guard_nodes = list(nodes)
            p = fi.parent
            while p is not None:
                guard_nodes.extend(own_nodes(p.node))
                p = p.parent
            aliases: Dict[str, str] = {}
            for n in nodes:
                if (
                    isinstance(n, ast.Assign)
                    and len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Name)
                ):
                    a = _container_attr(n.value)
                    if a is not None:
                        aliases[n.targets[0].id] = a
            for n in nodes:
                if not (
                    isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr in _GROW_ATTRS
                ):
                    continue
                recv = n.func.value
                attr = _container_attr(recv)
                if attr is None and isinstance(recv, ast.Name):
                    attr = aliases.get(recv.id)
                if attr is None:
                    continue
                # self.wal.append(...) where wal is a project class
                # DEFINING append: not a container — the growth (if
                # any) is inside that method, analyzed there.
                if fi.cls:
                    t = df.resolve_attr_class(fi.cls, [attr])
                    if t and df.lookup_method(t, n.func.attr):
                        continue
                names = {k for k, v in aliases.items() if v == attr}
                if _has_bound_or_shed(guard_nodes, attr, names):
                    continue
                out.append(
                    Finding(
                        rule=self.name,
                        path=fi.path,
                        line=n.lineno,
                        message=(
                            f"self.{attr} grows in {fi.qualname} on the "
                            f"serving path (reachable from {kind} root "
                            f"{root}) with no bound check or shed path "
                            "in this function; an overload grows it "
                            "without limit (cap it and shed, or "
                            "suppress with a comment saying what bounds "
                            "it)"
                        ),
                    )
                )
        return out


# ---------------------------------------------------------------------------
# blocking-in-callback
# ---------------------------------------------------------------------------

# The durability layer's whole contract is sync-on-pump (group commit):
# its fsyncs are the product, not a stall bug.  engine_pump is the
# engine pipeline's dedicated device-wait thread: blocking there is the
# design — it exists precisely so the scheduler loop never blocks on a
# readback (distributed/engine_pump.py).
_BLOCK_ALLOW_MODULES = {"wal", "disk", "engine_pump"}


def _blocking_what(call: ast.Call) -> Optional[str]:
    d = dotted_name(call.func)
    f = call.func
    if d is not None and (d == "time.sleep" or d.endswith(".time.sleep")):
        return "time.sleep()"
    leaf: Optional[str]
    if isinstance(f, ast.Attribute):
        leaf = f.attr
    elif isinstance(f, ast.Name):
        leaf = f.id
    else:
        return None
    if leaf in ("fsync", "fdatasync"):
        return f"os.{leaf}()"
    if leaf == "sendall":
        return "blocking socket sendall()"
    if leaf == "run_call":
        return "run_call() cross-thread rendezvous"
    if isinstance(f, ast.Attribute):
        recv = dotted_name(f.value) or ""
        low = recv.lower()
        if leaf == "acquire" and (
            "lock" in low or "cond" in low or low.endswith("cv")
        ):
            for kw in call.keywords:
                if (
                    kw.arg == "blocking"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is False
                ):
                    return None
            if call.args and (
                isinstance(call.args[0], ast.Constant)
                and call.args[0].value is False
            ):
                return None
            return f"blocking {recv}.acquire()"
        if leaf == "wait" and (low == "sched" or low.endswith(".sched")):
            return f"{recv}.wait() (the loop waiting on itself deadlocks)"
    return None


@register
class BlockingInCallbackRule(Rule):
    name = "blocking-in-callback"
    doc = (
        "fsync / time.sleep / blocking sends / lock-acquire / "
        "run_call reached from a scheduler or timer callback stall the "
        "single loop thread every reply rides on (WAL/disk sync points "
        "are allowlisted; anything else needs an explicit pragma)."
    )

    def check(self, project: Project) -> List[Finding]:
        df = get_dataflow(project)
        out: List[Finding] = []
        for fid, (kind, root) in df.reachable().items():
            fi = df.funcs[fid]
            if fi.module in _BLOCK_ALLOW_MODULES:
                continue
            for n in own_nodes(fi.node):
                if not isinstance(n, ast.Call):
                    continue
                what = _blocking_what(n)
                if what is None:
                    continue
                out.append(
                    Finding(
                        rule=self.name,
                        path=fi.path,
                        line=n.lineno,
                        message=(
                            f"{what} in {fi.qualname} runs on the "
                            f"scheduler loop thread (reachable from "
                            f"{kind} root {root}); it stalls every "
                            "reply on this node while it blocks"
                        ),
                    )
                )
        return out


# ---------------------------------------------------------------------------
# wire-schema
# ---------------------------------------------------------------------------


def _is_codec_sink(call: ast.Call) -> bool:
    d = dotted_name(call.func)
    if d is None:
        return False
    parts = d.split(".")
    return (
        parts[-1] in ("encode", "encode_oob")
        and len(parts) >= 2
        and parts[-2] == "codec"
    )


@register
class WireSchemaRule(Rule):
    name = "wire-schema"
    doc = (
        "string-tagged frames that flow into codec.encode/encode_oob "
        "(legacy 0x80 and out-of-band 0x01 paths alike) are collected "
        "project-wide; every decoder branch must agree with every "
        "encoder arity for the tag, across module boundaries "
        "(same-module drift stays frame-arity's report)."
    )

    def check(self, project: Project) -> List[Finding]:
        from .rules import _branch_has_len_guard

        df = get_dataflow(project)
        edges = df.call_edges()
        # Functions in an encoding context: call a codec sink directly,
        # or call (one level) a project function that does.
        direct: Set[FuncId] = set()
        for fi in df.funcs.values():
            for n in own_nodes(fi.node):
                if isinstance(n, ast.Call) and _is_codec_sink(n):
                    direct.add(fi.fid)
                    break
        contexts = set(direct)
        for fid, tgts in edges.items():
            if tgts & direct:
                contexts.add(fid)
        # tag → {arity}, and tag → {path} for the cross-module filter.
        wire_ar: Dict[str, Set[int]] = {}
        wire_paths: Dict[str, Set[str]] = {}
        for fid in contexts:
            fi = df.funcs[fid]
            for n in own_nodes(fi.node):
                for t in ast.walk(n):
                    if (
                        isinstance(t, ast.Tuple)
                        and t.elts
                        and isinstance(t.elts[0], ast.Constant)
                        and isinstance(t.elts[0].value, str)
                    ):
                        tag = t.elts[0].value
                        wire_ar.setdefault(tag, set()).add(len(t.elts))
                        wire_paths.setdefault(tag, set()).add(fi.path)
        if not wire_ar:
            return []
        out: List[Finding] = []
        seen: Set[Tuple[str, int]] = set()
        for mod in project.modules:
            path = str(mod.path)
            own = self._lexical_arities(mod.tree)
            for branch in self._decode_branches(mod.tree):
                name, tag, test, body, _line = branch
                arities = wire_ar.get(tag)
                if not arities:
                    continue
                if not (wire_paths.get(tag, set()) - {path}):
                    continue  # no cross-module encoder: frame-arity turf
                lo = min(arities)
                own_ar = own.get(tag, set())
                guarded = _branch_has_len_guard([test, *body], name)
                for node in body:
                    for n in ast.walk(node):
                        if (
                            isinstance(n, ast.Subscript)
                            and isinstance(n.value, ast.Name)
                            and n.value.id == name
                            and isinstance(n.slice, ast.Constant)
                            and isinstance(n.slice.value, int)
                            and n.slice.value >= lo
                            and not guarded
                        ):
                            if own_ar and n.slice.value >= min(own_ar):
                                continue  # frame-arity reports this one
                            key = (path, n.lineno)
                            if key in seen:
                                continue
                            seen.add(key)
                            out.append(
                                Finding(
                                    rule=self.name,
                                    path=path,
                                    line=n.lineno,
                                    message=(
                                        f"decoder reads {name}"
                                        f"[{n.slice.value}] for tag "
                                        f'"{tag}" but cross-module '
                                        "encoders ship arities "
                                        f"{sorted(arities)} into "
                                        "codec.encode/encode_oob; guard "
                                        "the access with len()"
                                    ),
                                )
                            )
                        if (
                            isinstance(n, ast.Assign)
                            and len(n.targets) == 1
                            and isinstance(n.targets[0], ast.Tuple)
                            and isinstance(n.value, ast.Name)
                            and n.value.id == name
                        ):
                            k = len(n.targets[0].elts)
                            if k in arities:
                                continue
                            if own_ar and k not in own_ar:
                                continue  # frame-arity reports this one
                            key = (path, n.lineno)
                            if key in seen:
                                continue
                            seen.add(key)
                            out.append(
                                Finding(
                                    rule=self.name,
                                    path=path,
                                    line=n.lineno,
                                    message=(
                                        f"decoder unpacks {k} fields "
                                        f'for tag "{tag}" but '
                                        "cross-module encoders ship "
                                        f"arities {sorted(arities)} "
                                        "into codec.encode/encode_oob"
                                    ),
                                )
                            )
        return out

    @staticmethod
    def _lexical_arities(tree: ast.Module) -> Dict[str, Set[int]]:
        arities: Dict[str, Set[int]] = {}
        for n in ast.walk(tree):
            if (
                isinstance(n, ast.Tuple)
                and n.elts
                and isinstance(n.elts[0], ast.Constant)
                and isinstance(n.elts[0].value, str)
            ):
                arities.setdefault(n.elts[0].value, set()).add(len(n.elts))
        return arities

    @staticmethod
    def _decode_branches(tree: ast.Module):
        from .rules import _tag_of_test

        for n in ast.walk(tree):
            if isinstance(n, ast.If):
                hit = _tag_of_test(n.test)
                if hit:
                    yield (*hit, n.test, n.body, n.lineno)
            elif isinstance(n, ast.IfExp):
                hit = _tag_of_test(n.test)
                if hit:
                    yield (*hit, n.test, [n.body], n.lineno)
