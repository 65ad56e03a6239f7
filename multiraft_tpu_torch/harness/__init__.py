"""Test harnesses over the simulated network: the generic replica
cluster (cluster.py) and the Raft, kvraft, shardctrler and shardkv
fixtures built on it."""

from .cluster import Cluster
from .ctrler_harness import CtrlerHarness
from .kv_harness import KVHarness
from .raft_harness import RaftHarness
from .shardkv_harness import ShardKVHarness

__all__ = [
    "Cluster",
    "CtrlerHarness",
    "KVHarness",
    "RaftHarness",
    "ShardKVHarness",
]
