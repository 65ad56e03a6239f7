"""Porcupine operation records written by the batched KV service.

Copies of the record types in the reference package
(``multiraft_tpu/porcupine/model.py`` ``Operation`` and
``multiraft_tpu/porcupine/kv.py`` ``OP_*``, ``KvInput``, ``KvOutput``),
field for field, so a recorded history can be handed to a porcupine
checker.  The checker itself is not part of this package.
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["Operation", "KvInput", "KvOutput", "OP_GET", "OP_PUT", "OP_APPEND"]

OP_GET = 0
OP_PUT = 1
OP_APPEND = 2


@dataclasses.dataclass
class Operation:
    """One client operation with its real-time interval."""

    client_id: int
    input: Any
    call: float  # invocation time
    output: Any
    ret: float  # response time


@dataclasses.dataclass(frozen=True)
class KvInput:
    op: int = OP_GET
    key: str = ""
    value: str = ""


@dataclasses.dataclass(frozen=True)
class KvOutput:
    value: str = ""
