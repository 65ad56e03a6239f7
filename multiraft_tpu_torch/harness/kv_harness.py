"""kvraft test fixture (reference: kvraft/config.go).

A thin wrapper over :class:`~multiraft_tpu_torch.harness.cluster.Cluster`
adding kvraft clerk construction (reference: kvraft/config.go:194-212)
and the same partition/crash surface the reference exposes
(reference: kvraft/config.go:177-189,258-326).
"""

from __future__ import annotations

import random
from typing import List

from ..raft.persister import Persister
from ..services.kvraft import Clerk, KVServer
from ..sim.scheduler import Scheduler
from ..transport.network import Network
from .cluster import Cluster

__all__ = ["KVHarness"]


class KVHarness:
    def __init__(
        self,
        n: int,
        unreliable: bool = False,
        maxraftstate: int = -1,
        seed: int = 0,
    ) -> None:
        self.sched = Scheduler()
        self.net = Network(self.sched, seed=seed)
        self.net.set_reliable(not unreliable)
        self.n = n
        self.rng = random.Random(seed ^ 0xBEEF)
        self.maxraftstate = maxraftstate

        def factory(ends, i, persister: Persister, srv_seed: int):
            srv = KVServer(
                self.sched,
                ends,
                i,
                persister,
                maxraftstate=self.maxraftstate,
                seed=srv_seed,
            )
            return srv, {"KVServer": srv, "Raft": srv.rf}

        self.cluster = Cluster(
            self.sched, self.net, "kv", n, factory, self.rng, seed=seed
        )
        self.cluster.start_all()
        self._clerk_ids: dict = {}

    # -- delegation to the cluster ---------------------------------------

    @property
    def servers(self):
        return self.cluster.handles

    def start_server(self, i: int) -> None:
        self.cluster.start_server(i)

    def shutdown_server(self, i: int) -> None:
        self.cluster.shutdown_server(i)

    def connect_all(self) -> None:
        self.cluster.connect_all()

    def partition(self, p1: List[int], p2: List[int]) -> None:
        self.cluster.partition(p1, p2)

    def random_partition(self) -> None:
        self.cluster.random_partition()

    def current_leader(self) -> int:
        return self.cluster.current_leader()

    def log_size(self) -> int:
        return self.cluster.log_size()

    def snapshot_size(self) -> int:
        return self.cluster.snapshot_size()

    # -- clerks ----------------------------------------------------------

    def make_client(self) -> Clerk:
        ends = self.cluster.make_client_ends()
        ck = Clerk(self.sched, ends)
        self._clerk_ids[ck] = self.cluster._last_clerk_id
        return ck

    def connect_client(self, ck: Clerk, to: List[int]) -> None:
        self.cluster.restrict_client(self._clerk_ids[ck], to)

    # -- misc -------------------------------------------------------------

    def op_total(self) -> int:
        return self.net.get_total_count()

    def cleanup(self) -> None:
        self.cluster.kill_all()
        self.net.cleanup()

    def run(self, gen):
        return self.sched.run_until(self.sched.spawn(gen))
