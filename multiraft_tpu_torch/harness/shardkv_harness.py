"""shardkv test fixture (reference: shardkv/config.go:204-382).

One network hosting a 3-server controller cluster plus ``ngroups`` KV
group clusters; ``join``/``leave`` drive real controller clerk ops
(reference: shardkv/config.go:306-334); groups can be shut down and
restarted wholesale with persisted state."""

from __future__ import annotations

import random
from typing import Any, Dict, List

from ..raft.persister import Persister
from ..services.shardctrler import CtrlerClerk, ShardCtrler
from ..services.shardkv import ShardClerk, ShardKVServer
from ..sim.scheduler import Scheduler
from ..transport.network import ClientEnd, Network
from .cluster import Cluster

__all__ = ["ShardKVHarness"]


class ShardKVHarness:
    def __init__(
        self,
        n: int = 3,
        ngroups: int = 3,
        unreliable: bool = False,
        maxraftstate: int = -1,
        seed: int = 0,
    ) -> None:
        self.sched = Scheduler()
        self.net = Network(self.sched, seed=seed)
        self.net.set_reliable(not unreliable)
        self.n = n
        self.ngroups = ngroups
        self.maxraftstate = maxraftstate
        self.rng = random.Random(seed ^ 0x5A4D)
        self.seed = seed
        self._end_counter = 0

        def ctrler_factory(ends, i, persister: Persister, srv_seed: int):
            srv = ShardCtrler(self.sched, ends, i, persister, seed=srv_seed)
            return srv, {"ShardCtrler": srv, "Raft": srv.rf}

        self.ctl = Cluster(
            self.sched, self.net, "ctl", 3, ctrler_factory, self.rng, seed=seed
        )
        self.ctl.start_all()

        self.gids = [100 + k for k in range(ngroups)]
        self.groups: Dict[int, Cluster] = {}
        for gid in self.gids:
            self.groups[gid] = self._make_group(gid)
            self.groups[gid].start_all()

        self.ctl_ck = CtrlerClerk(self.sched, self._ctrler_ends())

    # -- plumbing ---------------------------------------------------------

    def make_end(self, servername: Any) -> ClientEnd:
        """Fresh uniquely-named endpoint to any server
        (reference: shardkv/config.go make_end closure)."""
        self._end_counter += 1
        name = ("dyn", self._end_counter, servername)
        end = self.net.make_end(name)
        self.net.connect(name, servername)
        self.net.enable(name, True)
        return end

    def _ctrler_ends(self) -> List[ClientEnd]:
        return [self.make_end(self.ctl.server_name(j)) for j in range(3)]

    def _make_group(self, gid: int) -> Cluster:
        def factory(ends, i, persister: Persister, srv_seed: int):
            srv = ShardKVServer(
                self.sched,
                ends,
                i,
                persister,
                gid=gid,
                ctrler_ends=self._ctrler_ends(),
                make_end=self.make_end,
                maxraftstate=self.maxraftstate,
                seed=srv_seed,
            )
            return srv, {"ShardKV": srv, "Raft": srv.rf}

        return Cluster(
            self.sched,
            self.net,
            ("skv", gid),
            self.n,
            factory,
            self.rng,
            seed=self.seed + gid,
        )

    def group_servers(self, gid: int) -> List[Any]:
        return [self.groups[gid].server_name(i) for i in range(self.n)]

    # -- membership (reference: shardkv/config.go:306-334) ----------------

    def join(self, gid: int) -> None:
        self.run(self.ctl_ck.join({gid: self.group_servers(gid)}))

    def joinm(self, gids: List[int]) -> None:
        servers = {gid: self.group_servers(gid) for gid in gids}
        self.run(self.ctl_ck.join(servers))

    def leave(self, gid: int) -> None:
        self.run(self.ctl_ck.leave([gid]))

    def leavem(self, gids: List[int]) -> None:
        self.run(self.ctl_ck.leave(list(gids)))

    # -- group lifecycle --------------------------------------------------

    def shutdown_group(self, gid: int) -> None:
        for i in range(self.n):
            self.groups[gid].shutdown_server(i)

    def start_group(self, gid: int) -> None:
        for i in range(self.n):
            self.groups[gid].start_server(i)
        self.groups[gid].connect_all()

    # -- clients ----------------------------------------------------------

    def make_client(self) -> ShardClerk:
        return ShardClerk(self.sched, self._ctrler_ends(), self.make_end)

    # -- stats ------------------------------------------------------------

    def total_group_storage(self) -> int:
        """Raft state + snapshot bytes across all group replicas
        (Challenge 1 gate, reference: shardkv/test_test.go:794-810)."""
        total = 0
        for gid in self.gids:
            for p in self.groups[gid].saved:
                total += p.raft_state_size() + p.snapshot_size()
        return total

    def run(self, gen):
        return self.sched.run_until(self.sched.spawn(gen))

    def cleanup(self) -> None:
        for c in self.groups.values():
            c.kill_all()
        self.ctl.kill_all()
        self.net.cleanup()
