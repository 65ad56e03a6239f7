"""The checks that the benchmark's yardstick stays apart from what it
measures.

:func:`forbidden_modules`: a run loaded neither JAX nor the JAX package.
Each loaded module's top-level name, the part before the first dot, is
compared whole, so ``multiraft_tpu_torch`` (the port) passes and
``multiraft_tpu`` (the JAX package) does not.

:func:`program_imports`: a reference module imports neither the program
nor JAX, by itself or through the benchmark's own modules it imports.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterable, Iterator, List, Optional

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "multiraft_tpu"})
PROGRAM = FORBIDDEN | {"multiraft_tpu_torch"}
PACKAGE = Path(__file__).resolve().parent  # the ``cellbench`` package


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def program_imports(path: Path, name: str) -> List[str]:
    """The imports of the program, JAX or the JAX package (top-level names
    in :data:`PROGRAM`) made by the module ``name`` at ``path`` and, in
    turn, by every module of the ``cellbench`` package that it imports,
    each as ``<file>: <module>``.  Read from the sources: ``import``,
    ``from ... import`` and calls of ``__import__`` or ``import_module``
    with a literal name."""
    found, seen = [], set()
    todo = [(Path(path), name)]
    while todo:
        f, mod = todo.pop()
        if f.resolve() in seen:
            continue
        seen.add(f.resolve())
        for imp in _imports(f, mod):
            top = imp.split(".", 1)[0]
            if top in PROGRAM:
                found.append(f"{f.name}: {imp}")
            elif top == PACKAGE.name:
                todo.extend(_package_files(imp))
    return sorted(set(found))


def _imports(path: Path, name: str) -> Iterator[str]:
    """Dotted names that the module ``name`` at ``path`` imports."""
    is_pkg = path.name == "__init__.py"
    here = name.split(".") if is_pkg else name.split(".")[:-1]
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                up = here[: len(here) - (node.level - 1)]
                base = ".".join(up + ([node.module] if node.module else []))
            yield base
            yield from (f"{base}.{a.name}" for a in node.names if a.name != "*")
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            called = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            arg = node.args[0]
            if called in ("__import__", "import_module") and isinstance(arg, ast.Constant) \
                    and isinstance(arg.value, str):
                yield arg.value


def _package_files(dotted: str):
    """The files of the ``cellbench`` package that importing ``dotted``
    runs: each package on the way and the module itself, with names."""
    parts = dotted.split(".")[1:]
    out = [(PACKAGE / "__init__.py", PACKAGE.name)]
    for i in range(1, len(parts) + 1):
        p, mod = PACKAGE.joinpath(*parts[:i]), ".".join([PACKAGE.name] + parts[:i])
        if (p / "__init__.py").is_file():
            out.append((p / "__init__.py", mod))
        elif p.with_suffix(".py").is_file():
            out.append((p.with_suffix(".py"), mod))
    return out
