"""The check that a run loaded neither JAX nor the JAX package.

Each loaded module's top-level name, the part before the first dot, is
compared whole, so ``multiraft_tpu_torch`` (the port) passes and
``multiraft_tpu`` (the JAX package) does not.
"""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "multiraft_tpu"})


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
