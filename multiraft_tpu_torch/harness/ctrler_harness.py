"""shardctrler test fixture (reference: shardctrler/config.go)."""

from __future__ import annotations

import random

from ..raft.persister import Persister
from ..services.shardctrler import CtrlerClerk, ShardCtrler
from ..sim.scheduler import Scheduler
from ..transport.network import Network
from .cluster import Cluster

__all__ = ["CtrlerHarness"]


class CtrlerHarness:
    def __init__(self, n: int, unreliable: bool = False, seed: int = 0) -> None:
        self.sched = Scheduler()
        self.net = Network(self.sched, seed=seed)
        self.net.set_reliable(not unreliable)
        self.n = n
        self.rng = random.Random(seed ^ 0xC71E)

        def factory(ends, i, persister: Persister, srv_seed: int):
            srv = ShardCtrler(self.sched, ends, i, persister, seed=srv_seed)
            return srv, {"ShardCtrler": srv, "Raft": srv.rf}

        self.cluster = Cluster(
            self.sched, self.net, "ctl", n, factory, self.rng, seed=seed
        )
        self.cluster.start_all()

    @property
    def servers(self):
        return self.cluster.handles

    def make_client(self) -> CtrlerClerk:
        return CtrlerClerk(self.sched, self.cluster.make_client_ends())

    def run(self, gen):
        return self.sched.run_until(self.sched.spawn(gen))

    def cleanup(self) -> None:
        self.cluster.kill_all()
        self.net.cleanup()
