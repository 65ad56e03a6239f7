"""The environment knobs the PyTorch engine reads.

A subset of the reference package's typed ``MRT_*`` registry: the same
names, types and defaults, read with the same semantics (set and not
falsey is ON; ``"" / 0 / false / no / off`` are OFF; unset means the
declared default).  The port declares no knob of its own.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

__all__ = ["BOOL_KNOBS", "knob_bool"]

# name -> declared default (all ``bool``).
BOOL_KNOBS: Dict[str, bool] = {
    "MRT_CHECK_QUORUM": True,  # check-quorum leader self-demotion
    "MRT_MEMBERSHIP": True,  # joint-consensus membership change
    "MRT_PREVOTE": True,  # PreVote election mode
    "MRT_ENGINE_PIPELINE": True,  # fused multi-tick stepping
}

_FALSEY = frozenset({"", "0", "false", "no", "off"})


def knob_bool(name: str, default: Optional[bool] = None) -> bool:
    if name not in BOOL_KNOBS:
        raise KeyError(f"undeclared knob {name}")
    raw = os.environ.get(name)
    if raw is None:
        return bool(BOOL_KNOBS[name] if default is None else default)
    return raw.strip().lower() not in _FALSEY
