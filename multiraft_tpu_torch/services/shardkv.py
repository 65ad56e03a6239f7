"""Constants of the sharded KV service (a copy of what the sharded
engine needs from ``multiraft_tpu/services/shardkv.py``; the simulated
server is not part of this package): the error strings, the per-shard
serving states and ``key2shard``."""

from __future__ import annotations

from .shardctrler import NSHARDS

__all__ = [
    "key2shard",
    "OK",
    "ERR_NO_KEY",
    "ERR_WRONG_GROUP",
    "ERR_WRONG_LEADER",
    "ERR_TIMEOUT",
    "ERR_NOT_READY",
    "GET",
    "PUT",
    "APPEND",
    "SERVING",
    "PULLING",
    "BEPULLING",
    "GCING",
]

OK = "OK"
ERR_NO_KEY = "ErrNoKey"
ERR_WRONG_GROUP = "ErrWrongGroup"  # (reference: shardkv/common.go:12-18)
ERR_WRONG_LEADER = "ErrWrongLeader"
ERR_TIMEOUT = "ErrTimeout"
ERR_NOT_READY = "ErrNotReady"

GET = "Get"
PUT = "Put"
APPEND = "Append"

# Shard states.
SERVING = 0
PULLING = 1
BEPULLING = 2
GCING = 3


def key2shard(key: str) -> int:
    """(reference: shardkv/client.go:22-29 — first byte mod NSHARDS)"""
    return (ord(key[0]) if key else 0) % NSHARDS
