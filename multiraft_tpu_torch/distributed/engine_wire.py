"""Shared wire layer for the engine serving stack: command
dataclasses, deterministic key→group routing, opcode maps, and the
local-mesh helper (PyTorch port of
``multiraft_tpu/distributed/engine_wire.py``).  The wire dataclasses go
on the wire under the reference package's module name
(:func:`~multiraft_tpu_torch.transport.codec.wire_module`), so either
package's clerks talk to either package's servers.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any

from ..porcupine.types import OP_APPEND, OP_GET, OP_PUT
from ..transport import codec

__all__ = [
    "OK",
    "ERR_TIMEOUT",
    "ERR_BUSY",
    "EngineCmdArgs",
    "EngineCmdReply",
    "busy_reply",
    "retry_after_of",
    "route_group",
    "make_mesh",
]

OK = "OK"
ERR_TIMEOUT = "ErrTimeout"
# Admission-control shed: the dispatch layer refused the request before
# any handler saw it.  The reply carries a retry_after_s hint; clerks
# honor it with jitter (engine_clerks._busy_delay) instead of hammering.
ERR_BUSY = "ErrBusy"

_OPCODE = {"Get": OP_GET, "Put": OP_PUT, "Append": OP_APPEND}
_OPNAME = {v: k for k, v in _OPCODE.items()}


@codec.registered
@dataclasses.dataclass
class EngineCmdArgs:
    op: str = "Get"
    key: str = ""
    value: str = ""
    client_id: int = 0
    command_id: int = 0


@codec.registered
@dataclasses.dataclass
class EngineCmdReply:
    err: str = OK
    value: str = ""
    # Widened in round 8 (admission control).  Pickle bypasses
    # __init__, so a reply encoded by a pre-round-8 peer decodes
    # WITHOUT this attribute — always read it via retry_after_of(),
    # never reply.retry_after_s directly.
    retry_after_s: float = 0.0


def busy_reply(retry_after_s: float) -> EngineCmdReply:
    """The shed reply the dispatch layer sends in place of a handler
    result when admission refuses a request."""
    return EngineCmdReply(err=ERR_BUSY, retry_after_s=float(retry_after_s))


def retry_after_of(reply: Any) -> float:
    """Decode-compatible read of the retry hint: replies encoded by
    older peers lack the field entirely (pickle restores __dict__, not
    dataclass defaults)."""
    return float(getattr(reply, "retry_after_s", 0.0) or 0.0)


def route_group(key: str, G: int) -> int:
    """Deterministic key→group routing shared by every process (a
    stable hash — Python's builtin is salted per process)."""
    return zlib.crc32(key.encode()) % G


def make_mesh(n_devices: int, device: Any = None) -> Any:
    """A 1-D ``groups`` mesh (:class:`~multiraft_tpu_torch.engine.mesh.Mesh`)
    for the multi-card serving path (``--mesh-devices``): the server's
    state lives split across ``n_devices`` shards, each ticking on its
    own, and the same driver/pump/checkpoint path serves one card and
    several alike.

    ``device`` ``None`` or ``"cuda"``: the first ``n_devices`` visible
    cards, one shard each; asking for more cards than are visible is
    refused, never served from the CPU.  ``"cpu"`` (tests):
    ``n_devices`` shards on the CPU."""
    import torch

    from ..engine.mesh import Mesh

    if n_devices <= 0:
        raise ValueError(f"mesh_devices must be positive, got {n_devices}")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return Mesh([dev] * n_devices)
    if dev.type != "cuda":
        raise ValueError(f"make_mesh: no mesh on {dev.type} devices")
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_devices > visible:
        raise ValueError(
            f"mesh_devices={n_devices} > {visible} visible devices"
        )
    return Mesh([torch.device("cuda", i) for i in range(n_devices)])
