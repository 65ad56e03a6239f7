"""Test harnesses: sim-backend drivers (cluster.py, raft_harness.py,
kv_harness.py, ctrler_harness.py, shardkv_harness.py), the real-socket
nemesis (nemesis.py), the fleet observability scraper (observe.py),
the postmortem bundle collector (bundle.py), and the load-curve
aggregator + knee finder over open-loop sweeps (loadcurve.py)."""

from .bundle import collect_bundle
from .cluster import Cluster
from .ctrler_harness import CtrlerHarness
from .kv_harness import KVHarness
from .loadcurve import build_loadcurve, find_knee, max_sustainable, run_sweep
from .nemesis import (
    ChaosClient,
    Nemesis,
    NemesisVerificationError,
    make_schedule,
    run_clerk_load,
)
from .observe import FleetObserver
from .raft_harness import RaftHarness
from .shardkv_harness import ShardKVHarness

__all__ = [
    "ChaosClient",
    "Cluster",
    "CtrlerHarness",
    "FleetObserver",
    "KVHarness",
    "Nemesis",
    "NemesisVerificationError",
    "RaftHarness",
    "ShardKVHarness",
    "build_loadcurve",
    "collect_bundle",
    "find_knee",
    "make_schedule",
    "max_sustainable",
    "run_clerk_load",
    "run_sweep",
]
