"""Carry engine state between the reference (JAX) package and this one.

Everything crosses as numpy, so neither package imports the other: the
caller passes ``np.asarray`` of each JAX field (or ``dataclasses.asdict``
of a JAX ``EngineConfig``) in, and gets numpy back out.  Planes keep
their dtypes (int32 and bool), so a state converted both ways is the
same state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from .engine.core import EngineConfig, EngineState, Mailbox

__all__ = [
    "config_from_fields",
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
