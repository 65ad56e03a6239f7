"""Carry engine state between the reference (JAX) package and this one.

Everything crosses as numpy, so neither package imports the other: the
caller passes ``np.asarray`` of each JAX field (or ``dataclasses.asdict``
of a JAX ``EngineConfig``) in, and gets numpy back out.  Planes keep
their dtypes (int32 and bool), so a state converted both ways is the
same state.

Checkpoints cross the same way.  A checkpoint is a pickle, and the
reference's names the reference's classes; :func:`load_checkpoint`
reads it with each of those classes mapped, by name and without
importing the reference, to its counterpart here
(:data:`CHECKPOINT_CLASSES`), and refuses any reference class that has
none.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import IO, Any, Dict, Mapping, Union

import numpy as np
import torch

from .engine.core import EngineConfig, EngineState, Mailbox

__all__ = [
    "CHECKPOINT_CLASSES",
    "ReferenceEngineConfig",
    "config_from_fields",
    "load_checkpoint",
    "key_from_numpy",
    "mailbox_from_numpy",
    "mailbox_to_numpy",
    "state_from_numpy",
    "state_to_numpy",
]

Device = Union[str, torch.device]


def config_from_fields(fields: Mapping[str, Any]) -> EngineConfig:
    """A port ``EngineConfig`` from the reference's fields:
    ``use_pallas`` becomes ``use_kernels``; ``pallas_interpret`` (the
    Pallas interpreter switch) has no counterpart and is dropped."""
    f = dict(fields)
    if "use_pallas" in f:
        f["use_kernels"] = f.pop("use_pallas")
    f.pop("pallas_interpret", None)
    names = {x.name for x in dataclasses.fields(EngineConfig)}
    unknown = set(f) - names
    if unknown:
        raise ValueError(f"unknown EngineConfig fields: {sorted(unknown)}")
    return EngineConfig(**f)


def _tensor(a: Any, device: Device) -> torch.Tensor:
    a = np.array(a, order="C")  # a private copy (0-d stays 0-d)
    if a.dtype not in (np.int32, np.bool_):
        raise TypeError(f"engine planes are int32 or bool, got {a.dtype}")
    return torch.from_numpy(a).to(device)


def state_from_numpy(d: Mapping[str, Any], device: Device) -> EngineState:
    return EngineState(**{k: _tensor(d[k], device) for k in EngineState._fields})


def mailbox_from_numpy(d: Mapping[str, Any], device: Device) -> Mailbox:
    return Mailbox(**{k: _tensor(d[k], device) for k in Mailbox._fields})


def state_to_numpy(state: EngineState) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def mailbox_to_numpy(mb: Mailbox) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in mb._asdict().items()}


def key_from_numpy(key: Any) -> torch.Tensor:
    """A port PRNG key (host-resident uint32[2]) from a raw JAX key."""
    k = np.asarray(key)
    if k.shape != (2,) or k.dtype != np.uint32:
        raise TypeError(f"expected a uint32[2] key, got {k.dtype}{list(k.shape)}")
    return torch.from_numpy(k.copy())


# Reference class (module, name) -> this package's counterpart, for
# every class a reference checkpoint pickles: the engine config, the
# driver's payload carriers, the KV service's ops and tickets, firehose
# frames, the porcupine records in a service's recorded histories, and
# the sharded services' configs, replicas, shard slots, ops and tickets.
_SHARDKV = ("ShardTicket", "_ClientOp", "_CtrlOp", "_ConfigOp", "_InsertOp",
            "_DeleteOp", "_ConfirmOp", "_ShardSlot", "_Replica")

CHECKPOINT_CLASSES: Dict[tuple, tuple] = {
    ("multiraft_tpu.engine.core", "EngineConfig"):
        ("multiraft_tpu_torch.convert", "ReferenceEngineConfig"),
    ("multiraft_tpu.engine.host", "PayloadSlice"):
        ("multiraft_tpu_torch.engine.host", "PayloadSlice"),
    ("multiraft_tpu.engine.host", "PayloadRun"):
        ("multiraft_tpu_torch.engine.host", "PayloadRun"),
    ("multiraft_tpu.engine.kv", "KVOp"):
        ("multiraft_tpu_torch.engine.kv", "KVOp"),
    ("multiraft_tpu.engine.kv", "Ticket"):
        ("multiraft_tpu_torch.engine.kv", "Ticket"),
    ("multiraft_tpu.engine.firehose", "FirehoseFrame"):
        ("multiraft_tpu_torch.engine.firehose", "FirehoseFrame"),
    ("multiraft_tpu.porcupine.model", "Operation"):
        ("multiraft_tpu_torch.porcupine.types", "Operation"),
    ("multiraft_tpu.porcupine.kv", "KvInput"):
        ("multiraft_tpu_torch.porcupine.types", "KvInput"),
    ("multiraft_tpu.porcupine.kv", "KvOutput"):
        ("multiraft_tpu_torch.porcupine.types", "KvOutput"),
    ("multiraft_tpu.services.shardctrler", "Config"):
        ("multiraft_tpu_torch.services.shardctrler", "Config"),
    ("multiraft_tpu.engine.split_shard", "_NoOp"):
        ("multiraft_tpu_torch.engine.split_shard", "_NoOp"),
    **{("multiraft_tpu.engine.shardkv", name):
       ("multiraft_tpu_torch.engine.shardkv", name) for name in _SHARDKV},
}


class ReferenceEngineConfig:
    """Stands in for the reference's frozen ``EngineConfig`` while a
    checkpoint is unpickled: it keeps the pickled fields, and
    :meth:`to_port` turns them into this package's config through
    :func:`config_from_fields` (``use_pallas`` becomes
    ``use_kernels``)."""

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.fields = dict(state)

    def to_port(self) -> EngineConfig:
        return config_from_fields(self.fields)


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str) -> Any:
        if module.split(".")[0] == "multiraft_tpu":
            try:
                module, name = CHECKPOINT_CLASSES[(module, name)]
            except KeyError:
                raise pickle.UnpicklingError(
                    f"checkpoint holds {module}.{name}, a reference class "
                    f"with no counterpart in multiraft_tpu_torch"
                ) from None
        return super().find_class(module, name)


def load_checkpoint(f: IO[bytes]) -> Dict[str, Any]:
    """Unpickle a checkpoint blob written by either package's
    ``EngineDriver.save``, with reference classes mapped to this
    package's; ``blob["cfg"]`` comes back as this package's config."""
    blob = _CheckpointUnpickler(f).load()
    if isinstance(blob, dict) and isinstance(
        blob.get("cfg"), ReferenceEngineConfig
    ):
        blob["cfg"] = blob["cfg"].to_port()
    return blob
