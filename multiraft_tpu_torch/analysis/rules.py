"""graftlint rules: each encodes a bug class this codebase shipped
(PyTorch port of ``multiraft_tpu/analysis/rules.py``).

Rule catalogue (names are what ``# graftlint: disable=<name>`` takes):

* ``wire-width`` — a length/count packed into a fixed-width u16/u32
  wire field without a dominating bounds check.  A key-length bug of
  the reference: ``np.uint16`` silently wraps, the server reads a short
  key and the frame deserializes into garbage downstream.
* ``frame-arity`` — encoder tuple arities vs. decoder unpack/index
  arities for string-tagged RPC frames must agree (indices beyond the
  minimum encoded arity need a ``len()`` guard).  Guards against wire
  drift when a field is added to one side only.
* ``control-exempt`` — every ``add_service("X", …Control)``
  registration must have ``"X."`` in the chaos ``CONTROL_PREFIXES``
  exemption set; a control plane subject to its own chaos can
  partition away the antidote and wedge the run.

The reference's ``donated-alias`` and ``jit-purity`` have no
counterpart: they check JAX buffer donation and side effects inside
``jax.jit``, and this package donates no buffer and traces nothing (its
tick is eager and functional).

The lock rules (``lock-order``, ``unlocked-write``) live in
``lockgraph.py``.
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

# ---------------------------------------------------------------------------
# wire-width
# ---------------------------------------------------------------------------

_LEN_NAME = re.compile(r"(^|_)(n|len|count|num|rows?)($|_)|_len$|^len")
_GUARD_NAME = re.compile(r"^MAX_|_MAX$|LIMIT|^CAP_|_CAP$")
_U16_BOUNDS = {2**16, 2**16 - 1}
_U32_BOUNDS = {2**32, 2**32 - 1}
_U16_DTYPES = {"<u2", "u2", ">u2", "uint16"}
_U32_DTYPES = {"<u4", "u4", ">u4", "uint32"}


def _is_len_like(expr: ast.AST) -> bool:
    for n in ast.walk(expr):
        if isinstance(n, ast.Call):
            d = dotted_name(n.func)
            if d == "len":
                return True
        if isinstance(n, ast.Name) and _LEN_NAME.search(n.id):
            return True
    return False


def _module_dtype_widths(tree: ast.Module) -> Dict[str, int]:
    """Module-level ``_U16 = np.dtype("<u2")`` style aliases → width."""
    widths: Dict[str, int] = {}
    for stmt in tree.body:
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
            continue
        tgt = stmt.targets[0]
        if not isinstance(tgt, ast.Name):
            continue
        v = stmt.value
        if (
            isinstance(v, ast.Call)
            and dotted_name(v.func) is not None
            and dotted_name(v.func).endswith("dtype")
            and v.args
            and isinstance(v.args[0], ast.Constant)
        ):
            spec = str(v.args[0].value)
            if spec in _U16_DTYPES:
                widths[tgt.id] = 16
            elif spec in _U32_DTYPES:
                widths[tgt.id] = 32
    return widths


def _struct_formats(tree: ast.Module) -> Dict[str, str]:
    """Module-level ``X = struct.Struct("<fmt")`` aliases → format."""
    fmts: Dict[str, str] = {}
    for stmt in tree.body:
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
            continue
        tgt = stmt.targets[0]
        if not isinstance(tgt, ast.Name):
            continue
        v = stmt.value
        if (
            isinstance(v, ast.Call)
            and dotted_name(v.func) in ("struct.Struct", "Struct")
            and v.args
            and isinstance(v.args[0], ast.Constant)
        ):
            fmts[tgt.id] = str(v.args[0].value)
    return fmts


def _fmt_arg_types(fmt: str) -> List[str]:
    """Struct format → one type char per packed argument."""
    out: List[str] = []
    count = ""
    for ch in fmt:
        if ch in "<>=!@ ":
            continue
        if ch.isdigit():
            count += ch
            continue
        n = int(count) if count else 1
        count = ""
        if ch == "s":
            out.append("s")  # one bytes arg regardless of count
        elif ch == "x":
            continue
        else:
            out.extend(ch * n)
    return out


def _dtype_arg_width(
    node: ast.AST, aliases: Dict[str, int]
) -> Optional[int]:
    if isinstance(node, ast.Name):
        return aliases.get(node.id)
    d = dotted_name(node)
    if d is not None:
        if d.endswith("uint16"):
            return 16
        if d.endswith("uint32"):
            return 32
    if (
        isinstance(node, ast.Call)
        and dotted_name(node.func) is not None
        and dotted_name(node.func).endswith("dtype")
        and node.args
        and isinstance(node.args[0], ast.Constant)
    ):
        spec = str(node.args[0].value)
        if spec in _U16_DTYPES:
            return 16
        if spec in _U32_DTYPES:
            return 32
    return None


def _has_width_guard(fn: ast.AST, width: int) -> bool:
    bounds = _U16_BOUNDS if width == 16 else _U32_BOUNDS
    for n in ast.walk(fn):
        if isinstance(n, ast.Compare):
            operands = [n.left, *n.comparators]
            for op in operands:
                c = const_int(op)
                if c is not None and c in bounds:
                    return True
                if isinstance(op, ast.Name) and _GUARD_NAME.search(op.id):
                    return True
                d = dotted_name(op)
                if d is not None and _GUARD_NAME.search(
                    d.rsplit(".", 1)[-1]
                ):
                    return True
    return False


@register
class WireWidthRule(Rule):
    name = "wire-width"
    doc = (
        "a length/count cast to u16/u32 for the wire must be dominated "
        "by a bounds check in the same function; fixed-width casts "
        "silently wrap."
    )

    def check(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        for mod in project.modules:
            aliases = _module_dtype_widths(mod.tree)
            fmts = _struct_formats(mod.tree)
            for fn in ast.walk(mod.tree):
                if not isinstance(
                    fn, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    continue
                for call in ast.walk(fn):
                    if not isinstance(call, ast.Call):
                        continue
                    for width, expr, line in self._sinks(
                        call, aliases, fmts
                    ):
                        if not _is_len_like(expr):
                            continue
                        if _has_width_guard(fn, width):
                            continue
                        out.append(
                            Finding(
                                rule=self.name,
                                path=str(mod.path),
                                line=line,
                                message=(
                                    f"length/count packed as u{width} "
                                    "without a bounds check in this "
                                    "function; the cast wraps silently "
                                    f"past 2**{width} (guard with an "
                                    "explicit limit and raise)"
                                ),
                            )
                        )
        return out

    def _sinks(
        self,
        call: ast.Call,
        aliases: Dict[str, int],
        fmts: Dict[str, str],
    ):
        """Yield (width, packed_expr, line) for fixed-width pack sites."""
        d = dotted_name(call.func)
        if d is None:
            return
        # np.uint16(x) / np.uint32(x)
        if d.endswith("uint16") and call.args:
            yield 16, call.args[0], call.lineno
        elif d.endswith("uint32") and call.args:
            yield 32, call.args[0], call.lineno
        # np.asarray(x, dtype) / np.array(x, dtype)
        elif d.endswith("asarray") or d.endswith(".array"):
            dtype_node = None
            if len(call.args) >= 2:
                dtype_node = call.args[1]
            for kw in call.keywords:
                if kw.arg == "dtype":
                    dtype_node = kw.value
            if dtype_node is not None and call.args:
                w = _dtype_arg_width(dtype_node, aliases)
                if w is not None:
                    yield w, call.args[0], call.lineno
        # struct.pack("fmt", ...) and StructAlias.pack(...)
        elif d.endswith(".pack") or d == "pack":
            fmt = None
            args = call.args
            if d in ("struct.pack", "pack") and args:
                if isinstance(args[0], ast.Constant):
                    fmt = str(args[0].value)
                    args = args[1:]
            else:
                base = d.rsplit(".", 1)[0]
                fmt = fmts.get(base)
            if fmt is None:
                return
            types = _fmt_arg_types(fmt)
            for ch, arg in zip(types, args):
                if ch == "H":
                    yield 16, arg, call.lineno
                elif ch in ("I", "L"):
                    yield 32, arg, call.lineno


# ---------------------------------------------------------------------------
# frame-arity
# ---------------------------------------------------------------------------


def _tag_of_test(test: ast.AST) -> Optional[Tuple[str, str]]:
    """``name[0] == "tag"`` → (name, tag)."""
    for n in ast.walk(test):
        if not isinstance(n, ast.Compare):
            continue
        if len(n.ops) != 1 or not isinstance(n.ops[0], ast.Eq):
            continue
        left, right = n.left, n.comparators[0]
        for sub, const in ((left, right), (right, left)):
            if (
                isinstance(sub, ast.Subscript)
                and isinstance(sub.value, ast.Name)
                and isinstance(sub.slice, ast.Constant)
                and sub.slice.value == 0
                and isinstance(const, ast.Constant)
                and isinstance(const.value, str)
            ):
                return sub.value.id, const.value
    return None


def _branch_has_len_guard(branch_nodes, name: str) -> bool:
    for root in branch_nodes:
        for n in ast.walk(root):
            if isinstance(n, ast.Compare):
                for op in [n.left, *n.comparators]:
                    if (
                        isinstance(op, ast.Call)
                        and dotted_name(op.func) == "len"
                        and op.args
                        and isinstance(op.args[0], ast.Name)
                        and op.args[0].id == name
                    ):
                        return True
    return False


@register
class FrameArityRule(Rule):
    name = "frame-arity"
    doc = (
        "string-tagged wire tuples: decoder index/unpack arities must "
        "agree with every encoder arity for the same tag (extra fields "
        "need a len() guard)."
    )

    def check(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        for mod in project.modules:
            arities = self._encode_arities(mod)
            if not arities:
                continue
            for branch in self._decode_branches(mod):
                name, tag, test, body, line = branch
                if tag not in arities:
                    continue
                lo = min(arities[tag])
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
                            out.append(
                                Finding(
                                    rule=self.name,
                                    path=str(mod.path),
                                    line=n.lineno,
                                    message=(
                                        f'decoder reads {name}[{n.slice.value}] '
                                        f'for tag "{tag}" but the encoder '
                                        f"produces arities {sorted(arities[tag])}; "
                                        "guard the access with len()"
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
                            if k not in arities[tag]:
                                out.append(
                                    Finding(
                                        rule=self.name,
                                        path=str(mod.path),
                                        line=n.lineno,
                                        message=(
                                            f"decoder unpacks {k} fields "
                                            f'for tag "{tag}" but the '
                                            "encoder produces arities "
                                            f"{sorted(arities[tag])}"
                                        ),
                                    )
                                )
        return out

    def _encode_arities(self, mod: ModuleInfo) -> Dict[str, Set[int]]:
        arities: Dict[str, Set[int]] = {}
        for n in ast.walk(mod.tree):
            if (
                isinstance(n, ast.Tuple)
                and n.elts
                and isinstance(n.elts[0], ast.Constant)
                and isinstance(n.elts[0].value, str)
            ):
                arities.setdefault(n.elts[0].value, set()).add(len(n.elts))
        return arities

    def _decode_branches(self, mod: ModuleInfo):
        for n in ast.walk(mod.tree):
            if isinstance(n, ast.If):
                hit = _tag_of_test(n.test)
                if hit:
                    yield (*hit, n.test, n.body, n.lineno)
            elif isinstance(n, ast.IfExp):
                hit = _tag_of_test(n.test)
                if hit:
                    yield (*hit, n.test, [n.body], n.lineno)


# ---------------------------------------------------------------------------
# control-exempt
# ---------------------------------------------------------------------------


@register
class ControlExemptRule(Rule):
    name = "control-exempt"
    doc = (
        "every add_service registration of a *Control service must "
        "appear in CONTROL_PREFIXES, or chaos can partition away its "
        "own control plane."
    )

    def check(self, project: Project) -> List[Finding]:
        prefixes = self._prefixes(project)
        if prefixes is None:
            return []
        out: List[Finding] = []
        for mod in project.modules:
            for fn_or_mod in [mod.tree, *ast.walk(mod.tree)]:
                if not isinstance(
                    fn_or_mod,
                    (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef),
                ):
                    continue
                # local name → True if assigned from a *Control() call
                control_vars: Set[str] = set()
                for n in ast.walk(fn_or_mod):
                    if isinstance(n, ast.Assign) and self._is_control_ctor(
                        n.value
                    ):
                        for t in n.targets:
                            if isinstance(t, ast.Name):
                                control_vars.add(t.id)
                for n in ast.walk(fn_or_mod):
                    if not (
                        isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr == "add_service"
                        and len(n.args) >= 2
                        and isinstance(n.args[0], ast.Constant)
                        and isinstance(n.args[0].value, str)
                    ):
                        continue
                    svc = n.args[0].value
                    obj = n.args[1]
                    is_control = self._is_control_ctor(obj) or (
                        isinstance(obj, ast.Name) and obj.id in control_vars
                    )
                    if is_control and f"{svc}." not in prefixes:
                        out.append(
                            Finding(
                                rule=self.name,
                                path=str(mod.path),
                                line=n.lineno,
                                message=(
                                    f'control service "{svc}" is not in '
                                    "CONTROL_PREFIXES "
                                    f"{sorted(prefixes)}; its RPCs are "
                                    "subject to chaos and cannot heal a "
                                    "partitioned fleet"
                                ),
                            )
                        )
        return out

    @staticmethod
    def _is_control_ctor(node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        d = dotted_name(node.func)
        return d is not None and d.rsplit(".", 1)[-1].endswith("Control")

    @staticmethod
    def _prefixes(project: Project) -> Optional[Set[str]]:
        found: Optional[Set[str]] = None
        for mod in project.modules:
            for stmt in mod.tree.body:
                if (
                    isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and stmt.targets[0].id == "CONTROL_PREFIXES"
                    and isinstance(stmt.value, (ast.Tuple, ast.List, ast.Set))
                ):
                    vals = {
                        e.value
                        for e in stmt.value.elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)
                    }
                    found = (found or set()) | vals
        return found
