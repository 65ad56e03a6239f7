"""Placed-fleet harness: an :class:`~multiraft_tpu_torch.distributed.
engine_cluster.EngineFleetCluster` with the placement controller wired
on top (ARCHITECTURE §14).

Two pieces:

* :class:`PlacementMap` — the Raft-replicated placement map as a
  blocking facade.  The map itself is a sim-substrate cluster of
  :class:`~multiraft_tpu_torch.distributed.placement.PlacementCtrler`
  replicas (same Scheduler/Network machinery as every other sim RSM
  in the repo); all sim activity is pumped on whichever caller thread
  holds the lock, via ``run_until(spawn(clerk_gen))``.  Killing the
  map's current leader (``kill_leader``) and watching the controller
  keep working is the "survives its own leader dying" test.

* :class:`PlacedFleet` — fleet processes (started with spare engine
  slots for adoption) + the map + a
  :class:`~multiraft_tpu_torch.distributed.placement.PlacementController`
  thread scraping them over a dedicated
  :class:`~multiraft_tpu_torch.distributed.tcp.RpcNode`.
  ``kill_mesh_process`` is the chaos verb: SIGKILL one process and let
  the controller's failure detector re-place its groups onto
  survivors (empty adoption — the fleet crash model, see
  distributed/placement.py's module docstring).

Plus the in-process form: :class:`InProcessFleet` (several
:class:`~multiraft_tpu_torch.engine.shardkv.BatchedShardKV` instances
sharing one gid space, remote hooks wired directly) and
:class:`LocalFleetTransport` (the controller's transport duck type
over those instances) — the deterministic, socket-free substrate the
tier-1 placement tests and ``scripts/placement_scenario.py`` run on.

PyTorch port of ``multiraft_tpu/harness/fleet.py``.  Both fleets take
``device``: :class:`PlacedFleet` passes it to its fleet processes
(default ``"cuda"``: a child without a card fails before ``ready``),
and :class:`InProcessFleet` builds its engines on it (``None`` means
``cuda``, which raises without a card); tests pass ``"cpu"``.  Two
more deviations keep a large placed fleet's map affordable:
:class:`PlacedFleet` writes its initial map once the map's Raft has a
leader, and passes ``map_maxraftstate`` to the map's replicas (default
-1, no snapshots, as the reference; every write of a map that never
snapshots persists its whole log, the first full map included).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..distributed.placement import (
    PlacementClerk,
    PlacementController,
    PlacementCtrler,
    TcpFleetTransport,
)
from ..sim.scheduler import Scheduler
from ..transport.network import Network
from .cluster import Cluster

__all__ = [
    "PlacementMap",
    "PlacedFleet",
    "InProcessFleet",
    "InProcFleetClerk",
    "LocalFleetTransport",
]


class PlacementMap:
    """Blocking facade over the replicated placement map (module
    docstring).  Verbs mirror the controller's ``store`` duck type:
    ``query / set_map / begin / commit / abort``."""

    def __init__(self, n: int = 3, seed: int = 0,
                 initial: Optional[Dict[int, int]] = None,
                 maxraftstate: int = -1) -> None:
        self.sched = Scheduler()
        self.net = Network(self.sched, seed=seed)
        self.net.set_reliable(True)
        self.n = n

        def factory(ends, i, persister, srv_seed):
            srv = PlacementCtrler(
                self.sched, ends, i, persister, seed=srv_seed,
                maxraftstate=maxraftstate,
            )
            return srv, {"Placement": srv, "Raft": srv.rf}

        self.cluster = Cluster(
            self.sched, self.net, "plc", n, factory,
            random.Random(seed ^ 0x9A7), seed=seed,
        )
        self.cluster.start_all()
        self._lock = threading.Lock()
        self._clerk = PlacementClerk(
            self.sched, self.cluster.make_client_ends()
        )
        if initial:
            self.set_map(initial)

    def _run(self, gen):
        # One lock around all sim pumping: the controller thread and
        # the test thread both drive this scheduler, never concurrently.
        with self._lock:
            return self.sched.run_until(self.sched.spawn(gen))

    def wait_leader(self, step_s: float = 0.05, limit_s: float = 30.0) -> None:
        """Run the sim until the map has a leader (virtual time).  A
        store verb issued before that spins its clerk through every
        replica, encoding its arguments each time."""
        with self._lock:
            end = self.sched.now + limit_s
            while self.leader() is None and self.sched.now < end:
                self.sched.run_for(step_s)

    # -- store verbs ----------------------------------------------------

    def query(self):
        r = self._run(self._clerk.query())
        return (
            r.version, dict(r.placement), dict(r.pending), list(r.history)
        )

    def set_map(self, placement: Dict[int, int]) -> int:
        return self._run(self._clerk.set_map(placement)).version

    def begin(self, gid: int, dst: int, reason: str) -> None:
        self._run(self._clerk.begin(gid, dst, reason))

    def dispatch(self, gid: int) -> None:
        self._run(self._clerk.dispatch(gid))

    def commit(self, gid: int) -> int:
        return self._run(self._clerk.commit(gid)).version

    def abort(self, gid: int) -> None:
        self._run(self._clerk.abort(gid))

    # -- reconfig intents (replace-dead-replica policy) ------------------

    def reconfig_intents(self) -> Dict[int, Tuple[int, int, str]]:
        return dict(self._run(self._clerk.query()).reconfigs)

    def rbegin(self, gid: int, dead_peer: int, new_peer: int) -> None:
        self._run(self._clerk.rbegin(gid, dead_peer, new_peer))

    def rphase(self, gid: int, phase: str) -> None:
        self._run(self._clerk.rphase(gid, phase))

    def rdone(self, gid: int) -> None:
        self._run(self._clerk.rdone(gid))

    def rabort(self, gid: int) -> None:
        self._run(self._clerk.rabort(gid))

    # -- chaos ----------------------------------------------------------

    def leader(self) -> Optional[int]:
        for i, h in enumerate(self.cluster.handles):
            if h is None:
                continue
            _, is_leader = h.rf.get_state()
            if is_leader:
                return i
        return None

    def kill_leader(self) -> Optional[int]:
        """Shut down the map's current leader replica; the next store
        verb pumps the survivors through an election."""
        with self._lock:
            lead = None
            for i, h in enumerate(self.cluster.handles):
                if h is not None and h.rf.get_state()[1]:
                    lead = i
                    break
            if lead is not None:
                self.cluster.shutdown_server(lead)
            return lead

    def restart_replica(self, i: int) -> None:
        with self._lock:
            self.cluster.start_server(i)

    def cleanup(self) -> None:
        self.cluster.kill_all()
        self.net.cleanup()


class PlacedFleet:
    """Fleet + map + controller, one lifecycle (module docstring)."""

    def __init__(
        self,
        assignment: Sequence[Sequence[int]],
        *,
        spare_slots: int = 2,
        seed: int = 0,
        ctrl_replicas: int = 3,
        host: str = "127.0.0.1",
        mesh_devices: int = 0,
        chaos_seed: Optional[int] = None,
        controller_kwargs: Optional[dict] = None,
        shipping: bool = False,
        ship_sync: Optional[bool] = None,
        ship_window_s: Optional[float] = None,
        data_dir: Optional[str] = None,
        replicas: int = 3,
        voters: Optional[Sequence[int]] = None,
        device: str = "cuda",
        map_maxraftstate: int = -1,
    ) -> None:
        from ..distributed.engine_cluster import EngineFleetCluster

        # Sync shipping gates acks through EngineDurability's
        # extra_sync_gate — without a WAL there is no ack gate to hang
        # it on, and "zero acknowledged-write loss" would silently not
        # hold.  Provision a data_dir rather than no-op the guarantee.
        self._own_data_dir = None
        if ship_sync and data_dir is None:
            import tempfile

            data_dir = self._own_data_dir = tempfile.mkdtemp(
                prefix="mrt-placed-fleet-"
            )
        self.cluster = EngineFleetCluster(
            assignment, host=host, seed=seed, spare_slots=spare_slots,
            mesh_devices=mesh_devices, chaos_seed=chaos_seed,
            shipping=shipping, ship_sync=ship_sync,
            ship_window_s=ship_window_s, data_dir=data_dir,
            replicas=replicas, voters=voters, device=device,
        )
        self.ctrl_replicas = ctrl_replicas
        self.map_maxraftstate = map_maxraftstate
        self.seed = seed
        self._controller_kwargs = dict(controller_kwargs or {})
        self.pmap: Optional[PlacementMap] = None
        self.controller: Optional[PlacementController] = None
        self.node = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        from ..distributed.tcp import RpcNode

        self.cluster.start_all()
        initial = {
            g: i
            for i, gl in enumerate(self.cluster.assignment)
            for g in gl
        }
        self.pmap = PlacementMap(
            n=self.ctrl_replicas, seed=self.seed ^ 0x51A,
            maxraftstate=self.map_maxraftstate,
        )
        # The whole map is written once a leader exists: written before,
        # the clerk's retries re-encode it for every replica in turn.
        self.pmap.wait_leader()
        self.pmap.set_map(initial)
        self.node = RpcNode()
        transport = TcpFleetTransport(
            self.node,
            [(self.cluster.host, p) for p in self.cluster.ports],
        )
        self.controller = PlacementController(
            transport, self.pmap, obs=self.node.obs,
            **self._controller_kwargs,
        )
        self.controller.start()

    def shutdown(self) -> None:
        if self.controller is not None:
            self.controller.stop()
            self.controller = None
        if self.node is not None:
            self.node.close()
            self.node = None
        if self.pmap is not None:
            self.pmap.cleanup()
            self.pmap = None
        self.cluster.shutdown()
        if self._own_data_dir is not None:
            import shutil

            shutil.rmtree(self._own_data_dir, ignore_errors=True)
            self._own_data_dir = None

    # -- surface ---------------------------------------------------------

    def clerk(self):
        return self.cluster.clerk()

    def admin(self, kind: str, arg, timeout: float = 60.0) -> None:
        self.cluster.admin(kind, arg, timeout=timeout)

    def placement(self) -> Tuple[int, Dict[int, int]]:
        version, placement, _, _ = self.pmap.query()
        return version, placement

    def history(self) -> List[Tuple[int, int, int, int, str]]:
        return self.pmap.query()[3]

    def kill_mesh_process(self, i: int) -> None:
        """SIGKILL fleet process ``i``.  Its groups go dark until the
        controller's ``dead_s`` deadline fires and re-places them onto
        survivors; the process stays dead (never restarted by the
        placement layer)."""
        self.cluster.kill(i)

    def kill_replica(self, gid: int, peer: int) -> bool:
        """Permanently kill ONE engine replica of ``gid`` at its
        current owner process (the process lives on) — the fault the
        controller's replace-dead-replica policy heals via joint
        consensus.  Routed through the controller's own transport."""
        tr = self.controller.transport
        _, placement = self.placement()
        proc = placement.get(gid)
        return proc is not None and tr.kill_replica(proc, gid, peer)


# ---------------------------------------------------------------------------
# In-process fleet (deterministic, socket-free)
# ---------------------------------------------------------------------------


class InProcessFleet:
    """Several :class:`~multiraft_tpu_torch.engine.shardkv.BatchedShardKV`
    instances sharing one global gid space — the in-process analog of
    an :class:`~multiraft_tpu_torch.distributed.engine_cluster.
    EngineFleetCluster`, with the shard-migration hooks wired directly
    between instances (same gating as the networked service) but
    placement-aware: the owner lookup follows groups as the controller
    moves them, and a killed instance's hooks answer like a dead
    process (no replies, ever)."""

    def __init__(
        self,
        assignment: Sequence[Sequence[int]],
        spare_slots: int = 1,
        seed: int = 0,
        replicas: int = 3,
        voters: Optional[Sequence[int]] = None,
        device: Optional[str] = None,
    ) -> None:
        from ..engine.core import EngineConfig
        from ..engine.host import EngineDriver
        from ..engine.shardkv import BatchedShardKV

        self.assignment = [list(g) for g in assignment]
        self.instances: List[Any] = []
        self.killed: set = set()
        # State-plane wiring (enable_shipping): proc -> StatePlane /
        # StandbyStore.  Empty = shipping off (the default crash model).
        self.planes: Dict[int, Any] = {}
        self.standbys: Dict[int, Any] = {}
        for i, gl in enumerate(self.assignment):
            cfg = EngineConfig(
                G=len(gl) + 1 + spare_slots, P=replicas, L=64, E=8,
                INGEST=8,
            )
            driver = EngineDriver(cfg, seed=seed + 131 * i, device=device)
            if voters is not None and len(set(voters)) < replicas:
                # Spare ENGINE REPLICA slots (self-healing replica
                # sets): only ``voters`` vote, the remaining rows park
                # dead until the placement controller seats a learner
                # in one to replace a permanently killed voter.
                driver.seed_config(voters)
            if not driver.run_until_quiet_leaders(max_ticks=2000):
                raise RuntimeError(f"instance {i} leaders never settled")
            self.instances.append(BatchedShardKV(driver, gids=gl))
        self._wire()

    def owner_of(self, gid: int):
        """The live instance hosting ``gid`` right now (placement-aware,
        unlike the static map in tests/test_engine_fleet.py)."""
        for p, inst in enumerate(self.instances):
            if p in self.killed:
                continue
            if gid in inst._g2l:
                return inst
        return None

    def proc_of(self, gid: int) -> Optional[int]:
        for p, inst in enumerate(self.instances):
            if p not in self.killed and gid in inst._g2l:
                return p
        return None

    def _wire(self) -> None:
        fleet = self
        for inst in self.instances:
            pending: Dict[tuple, Any] = {}

            def remote_fetch(src_gid, shard, num, _me=inst):
                peer = fleet.owner_of(src_gid)
                if peer is None or peer is _me:
                    return None
                rep = peer.reps.get(src_gid)
                if rep is None or rep.cur.num < num:
                    return None  # ErrNotReady
                return (
                    dict(rep.shards[shard].data),
                    dict(rep.shards[shard].latest),
                )

            def remote_delete(src_gid, shard, num, _pending=pending):
                from ..engine.shardkv import OK

                peer = fleet.owner_of(src_gid)
                if peer is None:
                    return True  # dead or dropped: nothing to delete
                key = (src_gid, shard, num)
                t = _pending.get(key)
                if t is None:
                    _pending[key] = peer.delete_shard(src_gid, shard, num)
                    return None
                if not t.done:
                    return None
                del _pending[key]
                return (not t.failed) and t.err == OK

            inst.remote_fetch = remote_fetch
            inst.remote_delete = remote_delete

    # -- state plane -----------------------------------------------------

    def enable_shipping(
        self,
        rules=None,
        *,
        window_s: Optional[float] = None,
        tail_cap: Optional[int] = None,
        sync: bool = False,
        labels: Optional[Dict[int, str]] = None,
        obs=None,
    ) -> Dict[int, Any]:
        """Wire a :class:`~multiraft_tpu_torch.distributed.stateplane.
        StatePlane` shipper and a ``StandbyStore`` receiver onto every
        instance; delivery is a direct call into the standby's store
        (dead standbys answer ``None``, like a dead process).  Shipping
        runs inside :meth:`pump_all`, so any test that pumps the fleet
        ships for free."""
        from ..distributed.stateplane import StandbyStore, StatePlane

        fleet = self
        self.standbys = {
            p: StandbyStore(obs=obs) for p in range(len(self.instances))
        }

        def send(sb: int, payload: bytes):
            if sb in fleet.killed:
                return None
            return fleet.standbys[sb].receive(payload)

        for p, inst in enumerate(self.instances):
            plane = StatePlane(
                inst, me=p, n_procs=len(self.instances), send=send,
                rules=rules, labels=labels, window_s=window_s,
                tail_cap=tail_cap, sync=sync, obs=obs,
            )
            plane.attach()
            self.planes[p] = plane
        return self.planes

    # -- fleet ops -------------------------------------------------------

    def admin(self, kind: str, arg) -> None:
        """Mirror one config op to every live instance (same order →
        identical config histories)."""
        for p, inst in enumerate(self.instances):
            if p not in self.killed:
                inst.admin_sync(kind, arg)

    def pump_all(self, n: int = 5) -> None:
        for p, inst in enumerate(self.instances):
            if p not in self.killed:
                inst.pump(n)
                plane = self.planes.get(p)
                if plane is not None:
                    plane.ship_round()

    def settle(self, max_rounds: int = 800) -> None:
        from ..services.shardkv import SERVING

        live = [
            inst for p, inst in enumerate(self.instances)
            if p not in self.killed
        ]
        target = live[0].query_latest().num
        for _ in range(max_rounds):
            self.pump_all()
            done = True
            for inst in live:
                cfg = inst.query_latest()
                for g in list(inst.gids):
                    if g not in cfg.groups or inst.is_sealed(g):
                        continue
                    rep = inst.reps[g]
                    if rep.cur.num != target or any(
                        sh.state != SERVING
                        for sh in rep.shards.values()
                    ):
                        done = False
            if done:
                return
        raise TimeoutError(f"fleet did not settle at config {target}")

    def kill(self, p: int) -> None:
        """Mark instance ``p`` dead: no more pumps, its hooks stop
        answering, its memory is never read again (the crash model)."""
        self.killed.add(p)

    def kill_replica(self, gid: int, peer: int) -> bool:
        """Chaos verb: permanently kill ONE engine replica of ``gid``
        (the process lives; the replica row never ticks again) — the
        fault the controller's replace-dead-replica policy heals."""
        inst = self.owner_of(gid)
        return inst is not None and inst.kill_replica_gid(gid, peer)

    def clerk(self, client_id: int = 1) -> "InProcFleetClerk":
        return InProcFleetClerk(self, client_id=client_id)


class InProcFleetClerk:
    """Cross-instance clerk with LIVE routing: key → shard → gid from
    the latest config, gid → instance from the fleet's current
    placement (retrying ErrWrongGroup, so it follows migrations the
    same way the socket clerk's placement refresh does)."""

    def __init__(self, fleet: InProcessFleet, client_id: int = 1) -> None:
        self.fleet = fleet
        self.client_id = client_id
        self.command_id = 0

    def _run(self, op: str, key: str, value: str = ""):
        from ..engine.shardkv import ERR_WRONG_GROUP
        from ..services.shardkv import key2shard

        if op != "Get":
            self.command_id += 1
        fleet = self.fleet
        for _ in range(600):
            live = [
                i for p, i in enumerate(fleet.instances)
                if p not in fleet.killed
            ]
            if not live:
                break
            cfg = live[0].query_latest()
            gid = cfg.shards[key2shard(key)]
            inst = fleet.owner_of(gid)
            if inst is None or inst.is_sealed(gid):
                fleet.pump_all(2)
                continue
            t = inst.submit(
                gid, op, key, value,
                client_id=self.client_id, command_id=self.command_id,
            )
            if t is None:
                fleet.pump_all(2)
                continue
            waited = 0
            while not t.done and waited < 400:
                fleet.pump_all(2)
                waited += 2
            if t.done and not t.failed and t.err != ERR_WRONG_GROUP:
                return t
        raise TimeoutError(f"{op}({key!r}) never served")

    def get(self, key: str) -> str:
        from ..engine.shardkv import OK

        t = self._run("Get", key)
        return t.value if t.err == OK else ""

    def put(self, key: str, value: str) -> None:
        self._run("Put", key, value)

    def append(self, key: str, value: str) -> None:
        self._run("Append", key, value)


class LocalFleetTransport:
    """The controller's fleet-transport duck type
    (distributed/placement.py) over an :class:`InProcessFleet` —
    synchronous, deterministic, no sockets.  ``groups()`` computes the
    same windowed commit rates ``Obs.groups`` serves, from each
    driver's commit frontier between scrapes."""

    def __init__(self, fleet: InProcessFleet) -> None:
        self.fleet = fleet
        # proc -> (t_prev_s, commit list) of the previous scrape.
        self._prev: Dict[int, Tuple[float, List[int]]] = {}

    @property
    def n_procs(self) -> int:
        return len(self.fleet.instances)

    def addr(self, proc: int) -> Tuple[str, int]:
        return ("inproc", proc)

    def ping(self, proc: int) -> bool:
        return proc not in self.fleet.killed

    def groups(self, proc: int) -> Optional[Dict[str, Any]]:
        import numpy as np

        if proc in self.fleet.killed:
            return None
        inst = self.fleet.instances[proc]
        G = inst.driver.cfg.G
        commit = [
            int(c)
            for c in np.asarray(
                inst.driver.last_metrics["commit_index"]
            ).tolist()
        ]
        now = time.perf_counter()
        prev = self._prev.get(proc)
        if prev is None or len(prev[1]) != G or now <= prev[0]:
            rate = [0.0] * G
        else:
            dt = now - prev[0]
            rate = [
                max(0.0, (c - p) / dt) for c, p in zip(commit, prev[1])
            ]
        self._prev[proc] = (now, commit)
        gids = [inst._l2g.get(g, -1) for g in range(G)]
        out = {
            "G": G,
            "gids": gids,
            "commit": commit,
            "commit_rate": rate,
        }
        # Membership columns (mirror Obs.groups): per-replica liveness,
        # the voter union, and the reconfig/sealed exemption flags the
        # controller's healer and the wedge watch consume.
        from ..engine.core import LEADER

        st = inst.driver.np_state()
        vo = st.get("voters_old")
        if vo is not None:
            vn = st["voters_new"]
            joint = st["joint"]
            cfg_idx = st["cfg_idx"]
            alive = st["alive"]
            lead = (st["role"] == LEADER) & alive
            P = int(vo.shape[1])
            union = vo | vn
            row = np.where(
                lead.any(axis=1), lead.argmax(axis=1), union.argmax(axis=1)
            )
            bits = union[np.arange(G), row]
            out["replica_alive"] = alive.tolist()
            out["voters"] = [
                [q for q in range(P) if (int(b) >> q) & 1] for b in bits
            ]
            out["joint"] = joint.any(axis=1).tolist()
            out["reconfig"] = (
                joint.any(axis=1)
                | (cfg_idx.max(axis=1) > np.asarray(commit))
            ).tolist()
        out["sealed"] = [
            bool(gids[g] > 0 and inst.is_sealed(gids[g])) for g in range(G)
        ]
        return out

    def pull_group(self, proc: int, gid: int):
        if proc in self.fleet.killed:
            return None
        inst = self.fleet.instances[proc]
        if gid not in inst._g2l:
            return None
        return inst.export_group(gid)

    def unseal_group(self, proc: int, gid: int,
                     force: bool = False) -> None:
        if proc not in self.fleet.killed:
            self.fleet.instances[proc].unseal_group(gid, force)

    def adopt_group(self, proc: int, gid: int, blob) -> bool:
        if proc in self.fleet.killed:
            return False
        inst = self.fleet.instances[proc]
        if gid in inst.reps:
            return True  # idempotent retry
        if inst.free_slots() < 1:
            return False
        inst.adopt_gid(gid, blob)
        return True

    def drop_group(self, proc: int, gid: int) -> bool:
        if proc in self.fleet.killed:
            return True  # dead: its slots died with it
        inst = self.fleet.instances[proc]
        if gid not in inst._g2l:
            return True
        for _ in range(400):
            if inst.group_quiesced(gid):
                inst.drop_gid(gid)
                plane = self.fleet.planes.get(proc)
                if plane is not None:
                    plane.forget_group(gid)
                return True
            inst.pump(2)
        return False

    # -- state plane (distributed/stateplane.py) -------------------------

    def standby_state(self, proc: int, gid: int):
        """The standby's shipped-state freshness for ``gid`` (None when
        the proc is dead, shipping is off, or it holds nothing) — the
        controller's ``_freshest_dst`` probe."""
        if proc in self.fleet.killed:
            return None
        store = self.fleet.standbys.get(proc)
        return store.freshness(gid) if store is not None else None

    def recover_group(self, proc: int, gid: int) -> Optional[str]:
        """Stateful failover leg: adopt ``gid`` on ``proc`` from its
        shipped snapshot+tail.  Returns ``"recovered"`` on success,
        ``"empty"`` when no shipped state exists (the controller falls
        back to explicit empty adoption), ``None`` on transient
        failure (retry next sweep)."""
        from ..distributed.stateplane import recovery_blob, replay_tail

        fleet = self.fleet
        if proc in fleet.killed:
            return None
        store = fleet.standbys.get(proc)
        held = store.get(gid) if store is not None else None
        if held is None:
            return "empty"
        snap, tail = held
        inst = fleet.instances[proc]
        if gid not in inst.reps:
            blob = recovery_blob(snap, inst.query_latest())
            if blob is None and not tail:
                return "empty"
            if inst.free_slots() < 1:
                return None
            inst.adopt_gid(gid, blob)
        if tail:
            # Re-submit through the group's own log with the original
            # session ids — dedup (restored from the snapshot) makes a
            # repeated attempt exactly-once.
            replay_tail(inst, gid, tail,
                        pump=lambda: fleet.pump_all(2))
        store.drop(gid)
        return "recovered"

    def push_placement(self, proc: int, version: int, addr_map) -> bool:
        # In-process routing is live (owner_of), so there is no peer
        # map to rebuild — recording the push keeps the controller's
        # contract observable for tests.  The process's state plane
        # stops choosing standbys that host nothing, as a fleet
        # server's does (EngineShardKVService.place).
        self.last_push = (version, dict(addr_map))
        plane = self.fleet.planes.get(proc)
        if plane is not None and proc not in self.fleet.killed:
            plane.set_live(a[1] for a in addr_map.values())
        return proc not in self.fleet.killed

    # -- membership-change verbs (self-healing replica sets) -------------

    def _inst(self, proc: int):
        if proc in self.fleet.killed:
            return None
        return self.fleet.instances[proc]

    def replica_config(self, proc: int, gid: int):
        inst = self._inst(proc)
        return None if inst is None else inst.config_of_gid(gid)

    def add_learner(self, proc: int, gid: int, peer: int) -> bool:
        inst = self._inst(proc)
        return inst is not None and inst.add_learner_gid(gid, peer)

    def learner_match(self, proc: int, gid: int, peer: int):
        inst = self._inst(proc)
        return None if inst is None else inst.learner_match_gid(gid, peer)

    def begin_joint(self, proc: int, gid: int, voters) -> bool:
        inst = self._inst(proc)
        return inst is not None and inst.begin_joint_gid(gid, voters)

    def kill_replica(self, proc: int, gid: int, peer: int) -> bool:
        inst = self._inst(proc)
        return inst is not None and inst.kill_replica_gid(gid, peer)
