"""In-process drive harness for SPLIT deployments (engine/split.py,
engine/split_shard.py): several 'processes' (drivers + services +
peerings) in one interpreter with a deterministic manual slab shuttle —
the same extract/inject machinery the socket servers run, minus the
sockets.  PyTorch port of ``multiraft_tpu/harness/split_harness.py``;
the port's split tests and ``chip_smoke.py`` drive their split pairs
through it, so the retry/dedup discipline lives here exactly once.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

__all__ = ["SplitShardRig"]


class SplitShardRig:
    """Drives a set of :class:`~multiraft_tpu_torch.engine.split_shard.
    SplitShardKV` sides.  ``sides`` is a list of ``(service, peering)``
    pairs built with the SAME owners map; ``alive[i] = False`` models a
    kill -9 of process ``i`` (its pump stops, its slabs stop flowing —
    exactly what the socket form loses)."""

    # Stable admin identity: retries of one logical admin op may land
    # at DIFFERENT sides across failovers; a fixed (client, command)
    # pair dedups them exactly-once through the replicated ctrler log.
    ADMIN_CLIENT = 424242
    CLIENT = 777

    def __init__(self, sides: Sequence[Tuple[Any, Any]],
                 on_slab: Optional[Callable[[Any], None]] = None) -> None:
        self.sides = list(sides)
        self.alive = [True] * len(self.sides)
        # Called with every slab a live side extracts (the port's hook
        # for counting the boundary traffic; the reference has none).
        self.on_slab = on_slab
        self._cmd = 0
        self._admin_cmd = 0

    # -- the shuttle -------------------------------------------------------

    def shuttle(self, rounds: int = 1) -> None:
        """One round = each live side pumps one tick, then its boundary
        slabs are delivered to the other live sides (dead sides neither
        pump nor receive)."""
        for _ in range(rounds):
            for i, (svc, peering) in enumerate(self.sides):
                if not self.alive[i]:
                    continue
                svc.pump(1)
                for proc, slab in peering.extract().items():
                    if self.on_slab is not None:
                        self.on_slab(slab)
                    if self.alive[proc]:
                        self.sides[proc][1].inject(slab)

    def kill(self, i: int) -> None:
        self.alive[i] = False

    # -- election settling -------------------------------------------------

    def settle(self, G: int, max_rounds: int = 600) -> None:
        """Shuttle until every engine group has exactly one leader
        across the live sides."""
        for _ in range(max_rounds):
            self.shuttle()
            per_side = [
                s[0].driver.leaders_per_group()
                for i, s in enumerate(self.sides)
                if self.alive[i]
            ]
            if all(
                sum(int(a[g]) for a in per_side) == 1 for g in range(G)
            ):
                return
        raise TimeoutError("split groups did not elect a single leader")

    # -- admin / client drive ---------------------------------------------

    def admin(self, kind: str, arg: Any, max_rounds: int = 2000) -> None:
        """Drive a ctrler op at whichever live side owns the ctrler
        leader, retrying under ONE (client, command) identity across
        failovers — so a retry that lands at a different side dedups
        against a commit the caller never saw acked.  The command id
        comes from the RIG's counter and is always passed explicitly:
        letting the accepting side auto-allocate would collide two
        successive admin ops accepted by different sides (each side's
        local counter starts at 0) and the second would be silently
        dedup-swallowed as a duplicate."""
        self._admin_cmd += 1
        cid = self._admin_cmd
        t = None
        for _ in range(max_rounds):
            if t is not None and t.done and not t.failed:
                return
            if t is None or t.done:
                for i, (svc, _) in enumerate(self.sides):
                    if self.alive[i]:
                        nt = svc.ctrl_local(
                            kind, arg, command_id=cid,
                            client_id=self.ADMIN_CLIENT,
                        )
                        if nt is not None:
                            t = nt
                            break
            self.shuttle()
        raise TimeoutError(f"ctrler {kind} never committed")

    def client_op(self, op: str, key: str, value: str = "",
                  max_rounds: int = 2000) -> str:
        """The reference clerk loop across sides: route by the latest
        config, submit at the owning group's leader side, retry on
        wrong-group/lost-leader under one (client, command) so
        resubmits stay exactly-once."""
        from ..services.shardkv import key2shard

        self._cmd += 1
        cid = self._cmd
        t = None
        for _ in range(max_rounds):
            if t is not None and t.done and not t.failed and t.err == "OK":
                return t.value
            if t is None or t.done:
                t = None
                live = [s for i, s in enumerate(self.sides) if self.alive[i]]
                if live:
                    cfg = live[0][0].query_latest()
                    gid = cfg.shards[key2shard(key)]
                    for svc, _ in live:
                        if gid in svc.reps:
                            nt = svc.submit_local(
                                gid, op, key, value,
                                client_id=self.CLIENT, command_id=cid,
                            )
                            if nt is not None:
                                t = nt
                                break
            self.shuttle()
        raise TimeoutError(f"{op}({key!r}) never committed")

    # -- migration observation --------------------------------------------

    def migrating(self) -> bool:
        """Any live side observes any non-SERVING shard slot."""
        from ..services.shardkv import SERVING

        return any(
            sl.state != SERVING
            for i, (svc, _) in enumerate(self.sides) if self.alive[i]
            for rep in svc.reps.values()
            for sl in rep.shards.values()
        )

    def wait_migrating(self, max_rounds: int = 1500) -> bool:
        for _ in range(max_rounds):
            self.shuttle()
            if self.migrating():
                return True
        return False

    def wait_migrated(self, gids: Sequence[int],
                      max_rounds: int = 4000) -> None:
        """Shuttle until every live side's replicas are SERVING-stable
        at the latest config (migration + Challenge-1 GC complete)."""
        from ..services.shardkv import SERVING

        for _ in range(max_rounds):
            self.shuttle()
            live = [s for i, s in enumerate(self.sides) if self.alive[i]]
            latest = max(s[0].configs[-1].num for s in live)
            if all(
                svc.reps[gid].cur.num == latest
                and all(
                    sl.state == SERVING
                    for sl in svc.reps[gid].shards.values()
                )
                for svc, _ in live
                for gid in gids
            ):
                return
        raise TimeoutError("migration never completed")
