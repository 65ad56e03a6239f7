"""Generic replicated-service cluster fixture.

One :class:`Cluster` manages n replicas of a Raft-backed service inside
a (possibly shared) simulated network — the common machinery behind the
kvraft, shardctrler, and shardkv harnesses (reference: the parallel
``config.go`` files in kvraft/, shardctrler/, shardkv/; the shardkv
harness builds one controller cluster plus several KV group clusters in
a single network, shardkv/config.go:338-382).

Server names are ``(tag, i)``; endpoint names are incarnation-fresh so
crash/restart leaves zombie instances whose replies can never land.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional

from ..raft.persister import Persister
from ..sim.scheduler import Scheduler
from ..transport.network import ClientEnd, Network, Server, Service

__all__ = ["Cluster"]

# factory(ends, i, persister, seed) -> (handle, {service_name: obj})
Factory = Callable[[List[ClientEnd], int, Persister, int], tuple]


class Cluster:
    def __init__(
        self,
        sched: Scheduler,
        net: Network,
        tag: Any,
        n: int,
        factory: Factory,
        rng: random.Random,
        seed: int = 0,
    ) -> None:
        self.sched = sched
        self.net = net
        self.tag = tag
        self.n = n
        self.factory = factory
        self.rng = rng
        self.seed = seed
        self.handles: List[Optional[Any]] = [None] * n
        self.saved: List[Persister] = [Persister() for _ in range(n)]
        self.endnames: List[List[Any]] = [[None] * n for _ in range(n)]
        self.groups = [0] * n  # partition side per server
        self._incarnation = 0
        self._next_clerk = 0
        self.clerk_endnames: Dict[Any, List[Any]] = {}

    def server_name(self, i: int) -> Any:
        return (self.tag, i)

    # -- lifecycle --------------------------------------------------------

    def start_server(self, i: int) -> Any:
        if self.handles[i] is not None:
            self.shutdown_server(i)
        self._incarnation += 1
        inc = self._incarnation
        ends = []
        for j in range(self.n):
            name = (self.tag, i, j, inc)
            self.endnames[i][j] = name
            end = self.net.make_end(name)
            self.net.connect(name, self.server_name(j))
            ends.append(end)
        persister = self.saved[i].copy()
        self.saved[i] = persister
        handle, services = self.factory(
            ends, i, persister, self.seed * 977 + inc
        )
        self.handles[i] = handle
        server = Server()
        for svc_name, obj in services.items():
            server.add_service(Service(obj, name=svc_name))
        self.net.add_server(self.server_name(i), server)
        self._apply_edges()
        return handle

    def shutdown_server(self, i: int) -> None:
        self.net.delete_server(self.server_name(i))
        self.saved[i] = self.saved[i].copy()
        if self.handles[i] is not None:
            self.handles[i].kill()
            self.handles[i] = None

    def start_all(self) -> None:
        for i in range(self.n):
            self.start_server(i)
        self.connect_all()

    def kill_all(self) -> None:
        for h in self.handles:
            if h is not None:
                h.kill()

    # -- connectivity -----------------------------------------------------

    def _apply_edges(self) -> None:
        for i in range(self.n):
            for j in range(self.n):
                if self.endnames[i][j] is not None:
                    self.net.enable(
                        self.endnames[i][j], self.groups[i] == self.groups[j]
                    )

    def connect_all(self) -> None:
        self.groups = [0] * self.n
        self._apply_edges()

    def partition(self, p1: List[int], p2: List[int]) -> None:
        for i in p1:
            self.groups[i] = 0
        for i in p2:
            self.groups[i] = 1
        self._apply_edges()

    def random_partition(self) -> None:
        p1, p2 = [], []
        for i in range(self.n):
            (p1 if self.rng.random() < 0.5 else p2).append(i)
        self.partition(p1, p2)

    # -- clients ----------------------------------------------------------

    def make_client_ends(
        self, owner: Any = None, shuffle: bool = True
    ) -> List[ClientEnd]:
        """Endpoints from a fresh client to every server in this cluster
        (shuffled order exercises leader search)."""
        self._next_clerk += 1
        cid = (self.tag, "ck", self._next_clerk, owner)
        order = list(range(self.n))
        if shuffle:
            self.rng.shuffle(order)
        ends, names = [], []
        for j in order:
            name = (cid, j)
            end = self.net.make_end(name)
            self.net.connect(name, self.server_name(j))
            self.net.enable(name, True)
            ends.append(end)
            names.append(name)
        self.clerk_endnames[cid] = names
        self._last_clerk_id = cid
        return ends

    def restrict_client(self, cid: Any, to: List[int]) -> None:
        allowed = set(to)
        for name in self.clerk_endnames[cid]:
            _, j = name
            self.net.enable(name, j in allowed)

    # -- queries ----------------------------------------------------------

    def current_leader(self) -> int:
        best, best_term = -1, -1
        for i, h in enumerate(self.handles):
            if h is not None:
                term, is_leader = h.rf.get_state()
                if is_leader and term > best_term:
                    best, best_term = i, term
        return best

    def log_size(self) -> int:
        return max(p.raft_state_size() for p in self.saved)

    def snapshot_size(self) -> int:
        return max(p.snapshot_size() for p in self.saved)
