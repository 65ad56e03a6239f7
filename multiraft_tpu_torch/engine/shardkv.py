"""Sharded multi-group KV on the batched engine — the routing analog
(PyTorch port of ``multiraft_tpu/engine/shardkv.py``).

The sim backend runs the sharded stack as one process per server with
leader tickers (services/shardkv.py).  This module is the TPU-native
form (SURVEY §2.1: "shard→group table is a small device array — the
EP/expert-routing analog"): one :class:`~multiraft_tpu_torch.engine.host.
EngineDriver` consensus-orders *every* replica group's log on device —
engine group 0 is the config RSM (the shardctrler), engine groups
``1..G-1`` are replica groups with ``gid == engine group index`` — and
a per-pump host sweep replaces the reference's three leader tickers
(config poll / shard pull / GC, reference: shardkv server tickers;
see the reference's services/shardkv.py:310-397 for the sim
equivalents).

Semantics match the sim backend (and therefore the reference's shardkv
test spec, SURVEY §4.4):

* per-shard serving states SERVING / PULLING / BEPULLING / GCING;
* configs apply strictly in order, only when no migration is in flight;
* Challenge 1 — migrated shards are *deleted* at the old owner once the
  new owner has them (DeleteShard → ConfirmGC handshake through both
  groups' logs);
* Challenge 2 — unaffected shards serve during migration, and freshly
  inserted shards serve (GCING) before the old copy is deleted;
* per-shard client dedup tables migrate with the shard data.

Deliberate divergences (documented):

* The "pull shard" and "query config" RPCs become direct host reads of
  the source group's *applied* state — all groups share the host
  process, so the network hop of the sim backend is an identity; the
  read is gated on the source having applied the same config number,
  which is exactly the ErrNotReady handshake of the sim's pull RPC.
  Cross-host group placement rides the distributed transport instead,
  not this module.
* Proposals are deduplicated by outstanding-ticket bookkeeping rather
  than timer cadence; duplicate applies are idempotent regardless.

Two differences from the reference in how the same state is built, both
for the headline deployment (G=10,000 engine groups, a config naming
every gid): the orchestration sweep hands every replica the applied
config object itself instead of a clone each (applied configs are never
mutated, and a clone per replica costs O(groups) apiece, O(G²) per
config change), and :meth:`BatchedShardKV.submit_frame` maps global gids
to local groups through a lookup array instead of a loop over every
hosted gid.  Every value equals the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..porcupine.types import (
    OP_APPEND,
    OP_GET,
    OP_PUT,
    KvInput,
    KvOutput,
    Operation,
)
from ..services.shardctrler import NSHARDS, Config, rebalance
from ..services.shardkv import (
    BEPULLING,
    GCING,
    PULLING,
    SERVING,
    key2shard,
)
from .firehose import FH_OK, FH_WRONG_GROUP, FirehoseFrame
from .frontier import FrontierService
from .host import EngineDriver, PayloadSlice

__all__ = [
    "ShardTicket",
    "BatchedShardKV",
    "BatchedShardClerk",
    "route_keys",
]

OK = "OK"
ERR_NO_KEY = "ErrNoKey"
ERR_WRONG_GROUP = "ErrWrongGroup"
ERR_NOT_READY = "ErrNotReady"

GET, PUT, APPEND = "Get", "Put", "Append"

_PORCUPINE_OPCODE = {GET: OP_GET, PUT: OP_PUT, APPEND: OP_APPEND}


@dataclasses.dataclass
class ShardTicket:
    """Resolution of one proposed command.  ``failed`` means the command
    lost its log slot to a leader change and never committed — the
    caller resubmits (dedup tables make write retries exactly-once)."""

    group: int
    done: bool = False
    failed: bool = False
    err: str = OK
    value: str = ""
    done_tick: int = 0
    command_id: int = 0  # set on ctrler tickets so retries can dedup


# Host payload records bound to (group, index) by the driver.  Every op
# carries a ticket slot so evictions (lost log slots) can fail it.


@dataclasses.dataclass
class _ClientOp:
    op: str
    key: str
    value: str
    client_id: int
    command_id: int
    ticket: Optional[ShardTicket] = None


@dataclasses.dataclass
class _CtrlOp:
    kind: str  # "join" | "leave" | "move"
    arg: Any
    client_id: int
    command_id: int
    ticket: Optional[ShardTicket] = None


@dataclasses.dataclass
class _ConfigOp:
    config: Config
    ticket: Optional[ShardTicket] = None


@dataclasses.dataclass
class _InsertOp:
    config_num: int
    shard: int
    data: Dict[str, str]
    latest: Dict[int, int]
    ticket: Optional[ShardTicket] = None


@dataclasses.dataclass
class _DeleteOp:
    config_num: int
    shard: int
    ticket: Optional[ShardTicket] = None


@dataclasses.dataclass
class _ConfirmOp:
    config_num: int
    shard: int
    ticket: Optional[ShardTicket] = None


@dataclasses.dataclass
class _ShardSlot:
    state: int = SERVING
    data: Dict[str, str] = dataclasses.field(default_factory=dict)
    latest: Dict[int, int] = dataclasses.field(default_factory=dict)


class _Replica:
    """Host-side applied state of one replica group (gid = engine
    group index)."""

    def __init__(self, gid: int) -> None:
        self.gid = gid
        self.cur = Config(num=0, shards=[0] * NSHARDS, groups={})
        self.prev = self.cur
        self.shards: Dict[int, _ShardSlot] = {
            s: _ShardSlot() for s in range(NSHARDS)
        }
        # Outstanding internal proposals (ticket per kind/shard).
        self.pending_config: Optional[ShardTicket] = None
        self.pending_insert: Dict[int, ShardTicket] = {}
        self.pending_delete: Dict[int, ShardTicket] = {}
        self.pending_confirm: Dict[int, ShardTicket] = {}
        # Tick when the oldest still-live proposal batch went out
        # (0 = none outstanding) — the _orchestrate stall detector.
        self.pending_since = 0
        # Group-migration seal (BatchedShardKV.export_group): a sealed
        # replica's applied state is frozen — every post-seal apply is a
        # WRONG_GROUP no-op — so the exported blob is stable across
        # export retries without draining the log.
        self.sealed = False
        # Set the moment an export blob leaves this process: from then
        # on an adopt RPC MAY have been dispatched, and unsealing would
        # risk two serving copies (unseal_group enforces this).
        self.export_dispatched = False

    def can_serve(self, shard: int) -> bool:
        """Challenge 2 gate (mirror of services/shardkv.py:225-232).
        ``getattr``: checkpoints pickled before the placement layer
        restore replicas without a ``sealed`` attribute."""
        if getattr(self, "sealed", False):
            return False
        return self.cur.shards[shard] == self.gid and self.shards[
            shard
        ].state in (SERVING, GCING)


def route_keys(
    table: torch.Tensor, key_hashes: Union[torch.Tensor, np.ndarray]
) -> torch.Tensor:
    """Vectorized client-op routing: key hash → shard → engine group.

    ``table`` is the i32[NSHARDS] shard→gid array maintained by
    :meth:`BatchedShardKV.shard_table`; this is the device half of the
    reference's ``key2shard`` + config lookup
    (reference: shardkv/client.go:22-29, 68-129) for batched firehoses.
    The hashes move to the table's device; ``torch.remainder`` keeps
    the reference's floor-mod sign for negative hashes (``fmod`` would
    not).  Returns int32 gids on the table's device.
    """
    h = torch.as_tensor(key_hashes, device=table.device)
    return table[torch.remainder(h, NSHARDS).long()]


class BatchedShardKV(FrontierService):
    """The full sharded stack on one batched engine.

    Engine group 0 = config RSM; local engine groups ``1..`` host the
    replica groups.  By default every global gid lives in this instance
    (``gid == engine group index``, the single-chip deployment).  In
    **fleet mode** — several chip-owning processes splitting one global
    gid space — pass ``gids`` (the subset hosted here, mapped onto local
    engine groups in order) and wire the two remote-migration hooks:

    * ``remote_fetch(src_gid, shard, config_num) → (data, latest) | None``
      — called each orchestration sweep while a PULLING shard's source
      gid is not local.  The hook owns the async RPC: return ``None``
      while in flight / source not caught up, and the blobs exactly
      once when ready (the sweep immediately logs the InsertOp).
    * ``remote_delete(src_gid, shard, config_num) → bool | None`` —
      Challenge-1 GC at a remote old owner.  ``None`` = in flight,
      ``True`` = deleted (confirm proceeds), ``False`` = ErrNotReady
      (re-asked next sweep).

    Config consistency across a fleet is by construction: every process
    applies the same admin ops in the same order through its own config
    RSM (``rebalance`` is deterministic), mirroring how every reference
    shardkv group converges on the same shardctrler history.
    """

    def __init__(
        self, driver: EngineDriver, gids: Optional[List[int]] = None
    ) -> None:
        if driver.cfg.G < 2:
            raise ValueError("BatchedShardKV needs G >= 2 (ctrler + >=1 group)")
        super().__init__(driver)
        G = driver.cfg.G
        if gids is None:
            self.gids = list(range(1, G))
        else:
            if len(set(gids)) != len(gids) or 0 in gids:
                raise ValueError("gids must be unique and nonzero")
            if len(gids) > G - 1:
                raise ValueError(
                    f"{len(gids)} gids need G >= {len(gids) + 1} engine groups"
                )
            self.gids = list(gids)
        # Global gid ↔ local engine group (group 0 is the config RSM).
        self._g2l = {gid: i + 1 for i, gid in enumerate(self.gids)}
        self._l2g = {i + 1: gid for i, gid in enumerate(self.gids)}
        # Config RSM applied state (group 0).
        self.configs: List[Config] = [
            Config(num=0, shards=[0] * NSHARDS, groups={})
        ]
        self._ctrl_latest: Dict[int, int] = {}
        self.reps: Dict[int, _Replica] = {g: _Replica(g) for g in self.gids}
        self._route = torch.zeros(
            NSHARDS, dtype=torch.int32, device=driver.device
        )
        self._ctrl_cmd = 0
        # Ctrler session identity for admin proposals.  Single-instance
        # deployments use 0; split-group deployments (engine/
        # split_shard.py) set a per-process id — two processes sharing
        # client 0 would collide in the ctrler dedup table and silently
        # swallow each other's joins.
        self._ctrl_client_id = 0
        self._orchestrate_enabled = True
        # Recovery gate (durable server replay): config advance keeps
        # running, but PULLS and the GC/confirm handshake must not.
        # A pull completing mid-replay would copy a slot BEFORE its
        # redo records landed, losing acked writes; the GC handshake
        # mid-replay can involve a REMOTE old owner, and during replay
        # the server's scheduler loop is blocked — the RPC could never
        # resolve, wedging recovery forever.  Replay instead re-applies
        # committed GCING→SERVING transitions from WAL "confirm"
        # records (see on_confirm / EngineShardKVService.replay_wal),
        # so config advance never needs a live handshake; a slot whose
        # confirm had NOT committed pre-crash simply stays GCING until
        # the post-replay pump loop re-runs the handshake live.
        self.migration_paused = False
        # Fleet-mode hooks (see class docstring); None = single-instance.
        self.remote_fetch = None
        self.remote_delete = None
        # Durability hooks (the reference's distributed/engine_server.py):
        # fired at apply time when a migration actually mutates shard
        # state —
        # the WAL must cover an inserted blob before the old owner may
        # be told to GC it (the only remaining copy otherwise dies with
        # an untimely crash), and replayed deletes clear stale
        # BEPULLING slots that would wedge config advance after a
        # restore from an older checkpoint.
        self.on_insert = None  # (gid, shard, config_num, data, latest)
        self.on_delete = None  # (gid, shard, config_num)
        # Fired when a committed confirm actually flips GCING→SERVING.
        # The WAL record lets recovery re-apply the transition locally
        # instead of re-running the (possibly cross-process) GC
        # handshake — the handshake's peer may be unreachable while the
        # restarting server's loop is blocked in replay.
        self.on_confirm = None  # (gid, shard, config_num)
        # Fired in apply (= commit) order — the durable WAL must be a
        # commit-ordered redo log, not submit-ordered (evict-and-
        # resubmit can commit in a different order than submission).
        self.on_write = None   # (gid, _ClientOp), non-duplicate applies
        self.on_ctrl = None    # (_CtrlOp), non-duplicate config applies

    # -- checkpoint (pairs with EngineDriver.save/restore) ----------------

    def state_dict(self) -> Dict[str, Any]:
        import copy

        blob = super().state_dict()
        # Deep-copy: the checkpoint must not alias live host state
        # (tickets inside reps resolve after the snapshot is taken).
        blob["configs"] = copy.deepcopy(self.configs)
        blob["ctrl_latest"] = dict(self._ctrl_latest)
        blob["reps"] = copy.deepcopy(self.reps)
        blob["route"] = self._route.cpu().numpy().copy()
        blob["ctrl_cmd"] = self._ctrl_cmd
        blob["orchestrate"] = self._orchestrate_enabled
        blob["gids"] = list(self.gids)
        # After adopt/drop the gid→slot mapping is no longer the
        # constructor's enumeration order — it must travel too.
        blob["g2l"] = dict(self._g2l)
        return blob

    def load_state_dict(self, blob: Dict[str, Any]) -> None:
        import copy

        super().load_state_dict(blob)
        self.configs = list(blob["configs"])
        self._ctrl_latest = dict(blob["ctrl_latest"])
        # Copy (never alias) so re-loading the same blob starts from the
        # checkpoint, not from this incarnation's later mutations.
        self.reps = copy.deepcopy(blob["reps"])
        # Pending-op tickets in the checkpoint are deepcopy clones — the
        # driver's payload bindings hold *different* ticket objects, so
        # an eviction after restore would resolve the payload's clone
        # while rep.pending_* stayed live forever, wedging orchestration.
        # Clear them: re-proposal is idempotent (config-num and
        # shard-state gates make duplicates no-ops).
        for rep in self.reps.values():
            rep.pending_config = None
            rep.pending_insert.clear()
            rep.pending_delete.clear()
            rep.pending_confirm.clear()
        # torch.tensor copies: never alias the unpickled buffer.
        self._route = torch.tensor(
            np.asarray(blob["route"]), dtype=torch.int32,
            device=self.driver.device,
        )
        self._ctrl_cmd = blob["ctrl_cmd"]
        self._orchestrate_enabled = blob["orchestrate"]
        # gid → engine-group mapping travels with the checkpoint (older
        # blobs predate fleet mode: identity mapping).  A checkpoint
        # whose gid set diverges from the constructor's is refused loudly
        # — silently adopting it would keep serving the old assignment
        # while peers/routing were built from the new spec (same
        # loud-beats-lucky stance as EngineDriver.restore's mesh check).
        saved_gids = blob.get("gids")
        if saved_gids is not None and sorted(saved_gids) != sorted(self.gids):
            raise ValueError(
                f"checkpoint hosts gids {list(saved_gids)} but this "
                f"instance was built for gids {self.gids}; restart with "
                "the checkpoint's gid set (or a fresh data dir)"
            )
        # Restore the checkpoint's gid→engine-group mapping: after
        # adopt/drop (placement layer) it is no longer the constructor's
        # enumeration order.  Older blobs lack "g2l": the constructor's
        # mapping stands (and the list-equality guard above kept order).
        saved_g2l = blob.get("g2l")
        if saved_g2l is not None:
            self.gids = list(saved_gids)
            self._g2l = {int(g): int(l) for g, l in saved_g2l.items()}
            self._l2g = {l: g for g, l in self._g2l.items()}
        elif saved_gids is not None and list(saved_gids) != self.gids:
            raise ValueError(
                "checkpoint predates the placement layer but its gid "
                "ORDER diverges from this instance's; restart with the "
                "checkpoint's gid order"
            )

    # -- client/admin surface ---------------------------------------------

    def submit(self, gid: int, op: str, key: str, value: str = "",
               client_id: int = 0, command_id: int = 0) -> ShardTicket:
        t = ShardTicket(group=gid)
        self.driver.start(
            self._g2l[gid],
            _ClientOp(op=op, key=key, value=value, client_id=client_id,
                      command_id=command_id, ticket=t),
        )
        return t

    def delete_shard(self, src_gid: int, shard: int,
                     config_num: int) -> ShardTicket:
        """Propose Challenge-1 deletion in a *local* old owner's log on
        behalf of a remote puller — the serving side of a fleet peer's
        ``remote_delete`` (the cross-process form of orchestration
        step (c) below)."""
        t = ShardTicket(group=src_gid)
        self.driver.start(
            self._g2l[src_gid],
            _DeleteOp(config_num=config_num, shard=shard, ticket=t),
        )
        return t

    def confirm_shard(self, gid: int, shard: int,
                      config_num: int) -> ShardTicket:
        """Propose a GC confirm (GCING→SERVING) directly in ``gid``'s
        log — the recovery path's re-application of a confirm the WAL
        proves already committed pre-crash (the delete leg of the
        handshake already ran then; re-running it against a possibly
        unreachable peer would wedge replay).  Idempotent: a no-op when
        the slot is past GCING or the config has moved on."""
        t = ShardTicket(group=gid)
        self.driver.start(
            self._g2l[gid],
            _ConfirmOp(config_num=config_num, shard=shard, ticket=t),
        )
        return t

    def _ctrl(self, kind: str, arg: Any,
              command_id: Optional[int] = None,
              client_id: Optional[int] = None) -> ShardTicket:
        """Propose a ctrler op.  Pass the ``command_id`` of a failed
        ticket to retry it — the ctrler dedup table then guarantees
        exactly-once application even if the original did commit.
        ``client_id`` overrides the session the dedup keys on: a
        network admin clerk passes ITS unique id so its (id, cmd)
        pairs can never collide with another clerk's (or another
        process's) numbering — see split_shard_server.admin."""
        if command_id is None:
            self._ctrl_cmd += 1
            command_id = self._ctrl_cmd
        else:
            # Keep the auto counter ahead of externally supplied ids
            # (fleet admin) — otherwise a later auto-allocated id lands
            # below _ctrl_latest and is silently dedup-dropped as OK.
            self._ctrl_cmd = max(self._ctrl_cmd, command_id)
        if client_id is None:
            client_id = self._ctrl_client_id
        t = ShardTicket(group=0, command_id=command_id)
        self.driver.start(
            0, _CtrlOp(kind=kind, arg=arg, client_id=client_id,
                       command_id=command_id, ticket=t)
        )
        return t

    def join(self, gids: List[int],
             command_id: Optional[int] = None) -> ShardTicket:
        """Add replica groups (reference: shardctrler Join).  Group
        "server names" are synthesized from the engine group index."""
        servers = {g: [f"engine-group-{g}"] for g in gids}
        return self._ctrl("join", servers, command_id)

    def leave(self, gids: List[int],
              command_id: Optional[int] = None) -> ShardTicket:
        return self._ctrl("leave", list(gids), command_id)

    def move(self, shard: int, gid: int,
             command_id: Optional[int] = None) -> ShardTicket:
        return self._ctrl("move", (shard, gid), command_id)

    def query_latest(self) -> Config:
        """Latest *committed* config (direct read of the applied config
        RSM — the in-process form of the clerk's Query)."""
        return self.configs[-1].clone()

    def get_fast(self, key: str) -> ShardTicket:
        """Linearizable read served from the applied frontier WITHOUT a
        log entry — the sharded form of ``BatchedKV.get``'s ReadIndex
        collapse (this service is the sole acker of every write across
        all groups, so the applied frontier covers every acknowledged
        op), additionally gated on shard ownership exactly like the
        logged path's apply-time re-check: only a replica whose applied
        config owns the shard in a serving state may answer
        (`_apply_client` above; Challenge 2 gate).  During migration the
        caller sees ``ErrWrongGroup`` and retries, as with logged ops."""
        shard = key2shard(key)
        # Host-side routing: configs[-1].shards and _route are assigned
        # together in _apply_ctrl, and a device readback here would put
        # a sync on the zero-device-work path.
        gid = self.configs[-1].shards[shard]
        t = ShardTicket(group=gid, done=True, done_tick=self.driver.tick)
        rep = self.reps.get(gid)
        if rep is None or not rep.can_serve(shard):
            t.err = ERR_WRONG_GROUP
            return t
        sh = rep.shards[shard]
        if key in sh.data:
            t.value = sh.data[key]
        else:
            t.err = ERR_NO_KEY
        return t

    def shard_table(self) -> torch.Tensor:
        """Device shard→gid routing table for :func:`route_keys`."""
        return self._route

    # -- group placement (whole-group migration between fleet processes) --
    #
    # The placement controller (the reference's distributed/placement.py)
    # moves a whole raft group between processes: seal+export at the
    # source, adopt
    # into a spare engine slot at the destination, drop at the source.
    # Sealing freezes the replica without draining: every post-seal
    # apply is a WRONG_GROUP no-op (can_serve is False), unacked, so
    # clients retry at the destination and the per-shard dedup tables —
    # which travel inside the blob — keep the retries exactly-once.

    def free_slots(self) -> int:
        """Spare engine groups available for :meth:`adopt_gid`."""
        return (self.driver.cfg.G - 1) - len(self._g2l)

    def is_sealed(self, gid: int) -> bool:
        rep = self.reps.get(gid)
        return rep is not None and getattr(rep, "sealed", False)

    # -- replica membership (engine/host.py joint consensus) --------------
    #
    # Gid-level facades over the EngineDriver admin ops, shaped for the
    # placement controller's replace-dead-replica legs: every verb is
    # idempotent (a retried leg after a controller crash or lost reply
    # answers the same way), and ``begin_joint_gid`` treats "already in
    # joint toward this target" / "already settled at this target" as
    # success rather than the engine's one-change-at-a-time refusal.

    def replica_health(self, gid: int) -> Optional[Dict[str, Any]]:
        """Per-replica liveness + the group's voter sets: ``{"alive":
        [bool]*P, "voters_old", "voters_new", "joint", "epoch"}`` —
        the controller's dead-voter detection signal.  The config view
        is the leader's when one exists (max across rows otherwise:
        mid-election health must still name the voters)."""
        g = self._g2l.get(gid)
        if g is None:
            return None
        d = self.driver
        st = d.np_state()
        lead = d.leader_of(g, st)
        row = lead if lead is not None else int(
            (st["voters_old"][g] | st["voters_new"][g]).argmax()
        )
        unpack = lambda b: sorted(
            q for q in range(d.cfg.P) if (int(b) >> q) & 1
        )
        return {
            "alive": st["alive"][g].astype(bool).tolist(),
            "voters_old": unpack(st["voters_old"][g, row]),
            "voters_new": unpack(st["voters_new"][g, row]),
            "joint": bool(st["joint"][g].any()),
            "epoch": int(st["cfg_epoch"][g, row]),
            "leader": -1 if lead is None else int(lead),
        }

    def config_of_gid(self, gid: int) -> Optional[Dict[str, Any]]:
        g = self._g2l.get(gid)
        if g is None:
            return None
        try:
            return self.driver.config_of(g)
        except RuntimeError:
            return None  # no leader right now: caller retries

    def add_learner_gid(self, gid: int, p: int) -> bool:
        """Seat ``p`` as a fresh learner of ``gid``.  Idempotent: if
        ``p`` is already a live non-voter (a previous attempt landed
        but the reply was lost), answers True without re-wiping it —
        a re-wipe mid-catch-up would discard replication progress."""
        g = self._g2l.get(gid)
        if g is None:
            return False
        d = self.driver
        st = d.np_state()
        lead = d.leader_of(g, st)
        if lead is None:
            return False
        voter = ((int(st["voters_old"][g, lead])
                  | int(st["voters_new"][g, lead])) >> p) & 1
        if not voter and bool(st["alive"][g, p]):
            return True  # already seated by a prior attempt
        try:
            d.add_learner(g, p)
        except (RuntimeError, ValueError):
            return False
        return True

    def learner_match_gid(self, gid: int, p: int) -> Optional[tuple]:
        g = self._g2l.get(gid)
        if g is None:
            return None
        try:
            return self.driver.learner_match(g, p)
        except RuntimeError:
            return None

    def begin_joint_gid(self, gid: int, new_voters) -> bool:
        """Enter the joint phase toward ``new_voters``.  Idempotent:
        already joint toward this exact target, or already settled AT
        the target, answers True — the controller's crash-resume
        re-drive of a leg whose first attempt landed."""
        g = self._g2l.get(gid)
        if g is None:
            return False
        target = sorted(set(int(q) for q in new_voters))
        c = self.config_of_gid(gid)
        if c is None:
            return False
        if c["joint"] and c["voters_new"] == target:
            return True
        if not c["joint"] and c["voters_old"] == target:
            return True  # transition already completed
        try:
            self.driver.begin_joint(g, target)
        except (RuntimeError, ValueError):
            return False
        return True

    def kill_replica_gid(self, gid: int, p: int) -> bool:
        """Permanently kill replica row ``p`` of ``gid`` (the nemesis
        verb behind replace-dead-replica chaos: the row stays dead
        until a reconfig reseats the slot as a fresh incarnation)."""
        g = self._g2l.get(gid)
        if g is None:
            return False
        self.driver.set_alive(g, int(p), False)
        return True

    def export_group(self, gid: int) -> Optional[Dict[str, Any]]:
        """Seal ``gid`` and return its serialized applied state, or
        ``None`` if it cannot seal yet (mid-migration, config proposal
        in flight, or behind the latest config — the caller retries).
        Idempotent: an already-sealed group returns the same frozen
        state again (the seal stops every mutation), so a lost reply
        costs nothing."""
        rep = self.reps.get(gid)
        if rep is None:
            return None
        if not getattr(rep, "sealed", False):
            if self._live(rep.pending_config):
                return None
            if any(sh.state != SERVING for sh in rep.shards.values()):
                return None
            if self.configs[-1].num > rep.cur.num:
                return None  # catching up; export the settled state
            rep.sealed = True
        # Once the blob is returned it may be handed to an adopt RPC;
        # from here on only a force-unseal may revive this replica.
        rep.export_dispatched = True
        return {
            "gid": gid,
            "cur": rep.cur.clone(),
            "prev": rep.prev.clone(),
            "shards": {
                s: (sh.state, dict(sh.data), dict(sh.latest))
                for s, sh in rep.shards.items()
            },
        }

    def snapshot_group(self, gid: int) -> Optional[Dict[str, Any]]:
        """Non-sealing export: a deep-copied :meth:`export_group`-shaped
        blob of ``gid``'s applied state, or ``None`` while the group is
        mid-migration / behind config (same stability preconditions as
        export, so the blob never captures a half-applied handoff).
        The state-plane shipper calls this on a cadence — the group
        keeps serving, so the copy is only a point-in-time snapshot and
        the shipped WAL tail covers the writes after it."""
        rep = self.reps.get(gid)
        if rep is None or getattr(rep, "sealed", False):
            return None
        if self._live(rep.pending_config):
            return None
        if any(sh.state != SERVING for sh in rep.shards.values()):
            return None
        if self.configs[-1].num > rep.cur.num:
            return None
        return {
            "gid": gid,
            "cur": rep.cur.clone(),
            "prev": rep.prev.clone(),
            "shards": {
                s: (sh.state, dict(sh.data), dict(sh.latest))
                for s, sh in rep.shards.items()
            },
        }

    def unseal_group(self, gid: int, force: bool = False) -> None:
        """Abort a migration whose blob was NEVER dispatched to a
        destination — once an adopt RPC may have been dispatched,
        unsealing would fork the group (two serving copies), so a
        post-dispatch unseal raises unless the caller proves the
        destination can never adopt (``force=True``, the controller's
        dead-destination resume leg)."""
        rep = self.reps.get(gid)
        if rep is None:
            return
        if (getattr(rep, "sealed", False)
                and getattr(rep, "export_dispatched", False)
                and not force):
            raise RuntimeError(
                f"gid {gid}: export blob already dispatched — unsealing "
                "could fork the group; pass force=True only when the "
                "destination is provably dead"
            )
        rep.sealed = False
        rep.export_dispatched = False

    def adopt_gid(self, gid: int, blob: Optional[Dict[str, Any]] = None) -> int:
        """Host ``gid`` in a spare engine slot.  ``blob`` is a frozen
        :meth:`export_group` state; ``None`` adopts EMPTY (dead-source
        failover): the fresh replica starts AT the latest config with
        empty SERVING shards rather than replaying the config history —
        it holds no data to hand off, the historical handoffs happened
        in the group's previous incarnation (whose peers will never
        re-run them), and a replay would wedge the leaving-shard slots
        in BEPULLING forever waiting for delete requests that were
        already sent and answered.  The group's own shard data died
        with its process (the non-durable fleet crash model; see the
        placement module docstring).  Returns the local engine group
        index."""
        if gid == 0:
            raise ValueError("engine group 0 is the config RSM")
        if gid in self._g2l:
            raise ValueError(f"gid {gid} already hosted here")
        used = set(self._g2l.values())
        free = [l for l in range(1, self.driver.cfg.G) if l not in used]
        if not free:
            raise RuntimeError(
                f"no spare engine slot for gid {gid} "
                f"(G={self.driver.cfg.G}, hosting {sorted(self._g2l)})"
            )
        loc = free[0]
        rep = _Replica(gid)
        if blob is not None:
            rep.cur = blob["cur"].clone()
            rep.prev = blob["prev"].clone()
            for s, (state, data, latest) in blob["shards"].items():
                rep.shards[int(s)] = _ShardSlot(
                    state=state, data=dict(data), latest=dict(latest)
                )
        else:
            latest = self.query_latest()
            rep.cur = latest.clone()
            rep.prev = rep.cur
        # Bounded by construction: the free-slot check above caps
        # hosted groups at the engine's fixed G-1 slots.
        self.gids.append(gid)  # graftlint: disable=unbounded-queue
        self._g2l[gid] = loc
        self._l2g[loc] = gid
        self.reps[gid] = rep
        return loc

    def group_quiesced(self, gid: int) -> bool:
        """True when ``gid``'s slot has applied everything committed —
        the :meth:`drop_gid` gate (a sealed group's tail applies are
        WRONG_GROUP no-ops, but they must RESOLVE before the slot is
        reused or their tickets would wedge)."""
        loc = self._g2l[gid]
        commit = int(
            np.asarray(self.driver.last_metrics["commit_index"])[loc]
        )
        return self.applied_upto[loc] >= commit

    def drop_gid(self, gid: int) -> None:
        """Free ``gid``'s engine slot after a migration (or an abandoned
        adoption).  Callers pump until :meth:`group_quiesced` first.
        Entries accepted-but-uncommitted in the old log may still commit
        after the slot is re-adopted — they apply against the NEW gid's
        replica as WRONG_GROUP no-ops (its config does not assign their
        shards to it), so slot reuse is safe."""
        loc = self._g2l.pop(gid)
        del self._l2g[loc]
        self.gids.remove(gid)
        del self.reps[gid]

    # -- admin convenience (pump until the ctrler op commits) -------------

    def admin_sync(self, kind: str, arg: Any, max_ticks: int = 3000) -> None:
        mk = {
            "join": lambda cid: self.join(arg, command_id=cid),
            "leave": lambda cid: self.leave(arg, command_id=cid),
            "move": lambda cid: self.move(*arg, command_id=cid),
        }[kind]
        t = mk(None)
        waited = 0
        while waited < max_ticks:
            self.pump(5)
            waited += 5
            if t.done and not t.failed:
                return
            if t.failed:
                t = mk(t.command_id)  # retry under the same dedup id
        raise TimeoutError(f"ctrler {kind} did not commit in {max_ticks} ticks")

    # -- pumping (frontier/sweep machinery in FrontierService) -------------

    def pump(self, n_ticks: int = 1, orchestrate: bool = True) -> None:
        self._orchestrate_enabled = orchestrate
        super().pump(n_ticks)

    def after_step(self, n_ticks: int = 1, orchestrate=None) -> None:
        """Pipelined-pump entry (FrontierService.after_step): the
        engine advance happened at dispatch; this is the host half.
        ``orchestrate=None`` keeps the gate :meth:`pump` set (the base
        pump routes through here), a bool overrides it — the pipelined
        serving loop passes True explicitly."""
        if orchestrate is not None:
            self._orchestrate_enabled = orchestrate
        super().after_step(n_ticks)

    def _post_pump(self) -> None:
        if self._orchestrate_enabled:
            self._orchestrate()

    def _on_evicted(self, payload: Any) -> None:
        if isinstance(payload, PayloadSlice):
            # Firehose rows that lost their slots: the CLIENT retries
            # them (row-level RETRY errs; per-shard session dedup keeps
            # the retry exactly-once even across a migration, because
            # the dedup tables travel with the shard).
            payload.frame.rows_failed(payload.rows)
            return
        t = getattr(payload, "ticket", None)
        if t is not None and not t.done:
            t.done = True
            t.failed = True

    # -- columnar firehose (engine/firehose.py) --------------------------

    def submit_frame(self, blob: bytes) -> FirehoseFrame:
        """Columnar frame for the SHARDED service: the ``group`` column
        carries GLOBAL gids (the client routes key→shard→gid from its
        config, reference clerk loop shardkv/client.go:68-129); rows
        addressed to a gid this instance does not host resolve
        immediately as WRONG_GROUP (the client re-queries the config
        and re-routes).  Write rows enter each local group's log as
        contiguous runs; ownership is re-checked per row AT APPLY TIME
        (`_apply_slice`), exactly like the per-op path."""
        f = FirehoseFrame(blob, self.driver.tick)
        wr = f.write_rows
        if not len(wr):
            return f
        gids = f.groups[wr].astype(np.int64)
        # A sorted lookup over the hosted gids: the reference's loop
        # over every hosted gid is O(G x rows) per frame.
        n = len(self._g2l)
        hosted = np.fromiter(self._g2l.keys(), np.int64, n)
        locs = np.fromiter(self._g2l.values(), np.int64, n)
        order = np.argsort(hosted)
        hosted, locs = hosted[order], locs[order]
        local = np.full(len(gids), -1, np.int64)
        if n:
            pos = np.minimum(np.searchsorted(hosted, gids), n - 1)
            hit = hosted[pos] == gids
            local[hit] = locs[pos[hit]]
        bad = wr[local < 0]
        if len(bad):
            f.rows_done(bad, np.full(len(bad), FH_WRONG_GROUP, np.uint8))
        good_rows = wr[local >= 0]
        good_local = local[local >= 0]
        if not len(good_rows):
            return f
        order = np.argsort(good_local, kind="stable")
        rows_sorted = good_rows[order]
        gs = good_local[order]
        bounds = np.nonzero(np.diff(gs))[0] + 1
        starts = np.concatenate([[0], bounds])
        ends = np.concatenate([bounds, [len(gs)]])
        for s, e in zip(starts.tolist(), ends.tolist()):
            self.driver.start_run(int(gs[s]), f, rows_sorted[s:e])
        return f

    def _apply_slice(self, g: int, idx: int, sl, now: int) -> None:
        """Bulk apply of one committed firehose slice to a replica
        group: per row the kvraft-with-shards semantics (ownership
        gate + per-shard dup table + mutate — `_apply_client`);
        everything around them per-slice."""
        assert g != 0, "the config RSM's log never carries firehose rows"
        f = sl.frame
        gid = self._l2g.get(g)
        if gid is None:
            self._on_evicted(sl)  # slot freed by drop_gid (see _apply)
            return
        rep = self.reps[gid]
        errs = np.empty(len(sl.rows), np.uint8)
        ops_l = f.ops_l
        keys = f.keys
        vals = f.vals
        clients_l = f.clients_l
        commands_l = f.commands_l
        on_write = self.on_write
        for j, r in enumerate(sl.rows.tolist()):
            key = keys[r]
            shard = key2shard(key)
            if not rep.can_serve(shard):
                errs[j] = FH_WRONG_GROUP
                continue
            sh = rep.shards[shard]
            cid = clients_l[r]
            cmd = commands_l[r]
            if cmd > 0 and sh.latest.get(cid, -1) >= cmd:
                errs[j] = FH_OK  # duplicate write: already applied
                continue
            if ops_l[r] == OP_PUT:
                sh.data[key] = vals[r]
            else:
                sh.data[key] = sh.data.get(key, "") + vals[r]
            if cmd > 0:
                sh.latest[cid] = cmd
            if on_write is not None:
                on_write(rep.gid, _ClientOp(
                    op=PUT if ops_l[r] == OP_PUT else APPEND,
                    key=key, value=vals[r], client_id=cid, command_id=cmd,
                ))
            errs[j] = FH_OK
        f.rows_done(sl.rows, errs)

    # -- apply path --------------------------------------------------------

    def _resolve(self, op: Any, now: int, err: str = OK, value: str = "") -> None:
        t = op.ticket
        if t is not None and not t.done:
            t.done = True
            t.err = err
            t.value = value
            t.done_tick = now

    def _apply(self, g: int, idx: int, op: Any, now: int) -> None:
        if op is None:
            return  # binding lost to a leader change before commit
        if g == 0:
            self._apply_ctrl(op, now)
        else:
            gid = self._l2g.get(g)
            if gid is None:
                # Slot freed by drop_gid: an accepted-but-uncommitted
                # tail entry committed late.  Its group is gone — fail
                # the ticket so the caller re-routes.
                self._on_evicted(op)
                return
            self._apply_replica(self.reps[gid], op, now)

    def _apply_ctrl(self, op: Any, now: int) -> None:
        if not isinstance(op, _CtrlOp):
            return
        if self._ctrl_latest.get(op.client_id, -1) >= op.command_id:
            self._resolve(op, now)  # duplicate join/leave/move: no-op
            return
        self._ctrl_latest[op.client_id] = op.command_id
        cfg = self.configs[-1].clone()
        cfg.num += 1
        if op.kind == "join":
            cfg.groups.update({g: list(s) for g, s in op.arg.items()})
            cfg.shards = rebalance(cfg.shards, cfg.groups)
        elif op.kind == "leave":
            for gid in op.arg:
                cfg.groups.pop(gid, None)
            cfg.shards = rebalance(cfg.shards, cfg.groups)
        else:  # move
            shard, gid = op.arg
            cfg.shards[shard] = gid
        self.configs.append(cfg)
        self._route = torch.tensor(
            cfg.shards, dtype=torch.int32, device=self.driver.device
        )
        if self.on_ctrl is not None:
            self.on_ctrl(op)
        self._resolve(op, now)

    def _apply_replica(self, rep: _Replica, op: Any, now: int) -> None:
        if isinstance(op, _ClientOp):
            self._apply_client(rep, op, now)
        elif isinstance(op, _ConfigOp):
            # Strictly in-order, never mid-migration
            # (mirror of services/shardkv.py:459-477).  A sealed replica
            # is frozen: its exported blob must not race a config flip.
            if (
                not getattr(rep, "sealed", False)
                and op.config.num == rep.cur.num + 1
                and all(
                    sh.state == SERVING for sh in rep.shards.values()
                )
            ):
                rep.prev = rep.cur
                rep.cur = op.config
                for s in range(NSHARDS):
                    was = rep.prev.shards[s] == rep.gid
                    mine = op.config.shards[s] == rep.gid
                    if mine and not was:
                        rep.shards[s].state = (
                            SERVING if rep.prev.shards[s] == 0 else PULLING
                        )
                    elif was and not mine:
                        rep.shards[s].state = BEPULLING
            rep.pending_config = None
            self._resolve(op, now)
        elif isinstance(op, _InsertOp):
            sh = rep.shards[op.shard]
            if op.config_num == rep.cur.num and sh.state == PULLING:
                sh.data = dict(op.data)
                sh.latest = dict(op.latest)
                sh.state = GCING  # serve before the old copy is deleted
                if self.on_insert is not None:
                    self.on_insert(rep.gid, op.shard, op.config_num,
                                   sh.data, sh.latest)
            rep.pending_insert.pop(op.shard, None)
            self._resolve(op, now)
        elif isinstance(op, _DeleteOp):
            # Runs in the OLD owner's log.  ErrNotReady if this group
            # hasn't seen the config yet (it would still be serving).
            if op.config_num > rep.cur.num:
                self._resolve(op, now, err=ERR_NOT_READY)
                return
            if op.config_num == rep.cur.num:
                sh = rep.shards[op.shard]
                if sh.state == BEPULLING:
                    rep.shards[op.shard] = _ShardSlot()  # Challenge 1
                    if self.on_delete is not None:
                        self.on_delete(rep.gid, op.shard, op.config_num)
            self._resolve(op, now)  # < cur.num: already gone, idempotent
        elif isinstance(op, _ConfirmOp):
            sh = rep.shards[op.shard]
            if op.config_num == rep.cur.num and sh.state == GCING:
                sh.state = SERVING
                if self.on_confirm is not None:
                    self.on_confirm(rep.gid, op.shard, op.config_num)
            rep.pending_confirm.pop(op.shard, None)
            self._resolve(op, now)

    def _apply_client(self, rep: _Replica, op: _ClientOp, now: int) -> None:
        shard = key2shard(op.key)
        sh = rep.shards[shard]
        # Ownership re-checked at apply time: the config may have moved
        # between proposal and commit (reference: shardkv apply path).
        if not rep.can_serve(shard):
            self._resolve(op, now, err=ERR_WRONG_GROUP)
            return
        if op.op != GET and sh.latest.get(op.client_id, -1) >= op.command_id:
            self._resolve(op, now)  # duplicate write: already applied
            return
        if op.op == GET:
            if op.key in sh.data:
                self._resolve(op, now, value=sh.data[op.key])
            else:
                self._resolve(op, now, err=ERR_NO_KEY)
            return
        if op.op == PUT:
            sh.data[op.key] = op.value
        else:
            sh.data[op.key] = sh.data.get(op.key, "") + op.value
        sh.latest[op.client_id] = op.command_id
        if self.on_write is not None:
            self.on_write(rep.gid, op)
        self._resolve(op, now)

    # -- migration orchestration (the batched form of the tickers) ---------

    @staticmethod
    def _live(t: Optional[ShardTicket]) -> bool:
        return t is not None and not t.done

    # Ticks a proposal batch may sit unresolved before _orchestrate
    # abandons and re-proposes it.  Liveness, not correctness: an entry
    # accepted under a leader that then lost quorum keeps its old term
    # after the next election, and Raft's commit rule never counts it —
    # only a NEW current-term entry drags it over the commit line.  An
    # idle group generates none (payload bindings are index-keyed, so
    # the kernel cannot inject a leader no-op), and every orchestrate
    # verb is gated on the live ticket — a deadlock observed as a
    # revived group stuck one config behind forever.  Re-proposing is
    # safe: every internal op is config-num/state gated, so the stale
    # duplicate applies as a no-op and still resolves its ticket.
    PROPOSAL_STALL_TICKS = 200

    def _orchestrate(self) -> None:
        latest = self.configs[-1]
        for gid in list(self.gids):
            rep = self.reps[gid]
            if getattr(rep, "sealed", False):
                continue  # frozen for export: no proposals of any kind
            pend = [rep.pending_config,
                    *rep.pending_insert.values(),
                    *rep.pending_delete.values(),
                    *rep.pending_confirm.values()]
            if not any(self._live(t) for t in pend):
                rep.pending_since = 0
            elif getattr(rep, "pending_since", 0) == 0:
                rep.pending_since = self.driver.tick
            elif (
                self.driver.tick - rep.pending_since
                > self.PROPOSAL_STALL_TICKS
            ):
                rep.pending_config = None
                rep.pending_insert.clear()
                rep.pending_delete.clear()
                rep.pending_confirm.clear()
                rep.pending_since = 0
            # (a) config advance — only participating (or about to
            # participate) groups need to track configs.
            if (
                latest.num > rep.cur.num
                and not self._live(rep.pending_config)
                and all(sh.state == SERVING for sh in rep.shards.values())
            ):
                # The applied config itself, not a clone (see the
                # module docstring): it is never mutated.
                nxt = self.configs[rep.cur.num + 1]
                t = ShardTicket(group=gid)
                rep.pending_config = t
                self.driver.start(self._g2l[gid], _ConfigOp(config=nxt, ticket=t))
            # (b) shard pull: read the source group's applied state once
            # it has applied the same config (the ErrNotReady gate).  A
            # source gid hosted by another fleet process goes through
            # the remote_fetch hook instead of the direct host read.
            for s in range(NSHARDS):
                sh = rep.shards[s]
                if sh.state == PULLING and not self._live(
                    rep.pending_insert.get(s)
                ):
                    if self.migration_paused:
                        continue  # recovery: no pulls until redo completes
                    src_gid = rep.prev.shards[s]
                    src = self.reps.get(src_gid)
                    if src is not None:
                        if src.cur.num < rep.cur.num:
                            continue  # source hasn't caught up; retry later
                        pull_data = dict(src.shards[s].data)
                        pull_latest = dict(src.shards[s].latest)
                    elif self.remote_fetch is not None:
                        got = self.remote_fetch(src_gid, s, rep.cur.num)
                        if got is None:
                            continue  # RPC in flight / source not ready
                        pull_data, pull_latest = dict(got[0]), dict(got[1])
                    else:
                        continue  # source unknown and no fleet hook
                    t = ShardTicket(group=gid)
                    rep.pending_insert[s] = t
                    self.driver.start(
                        self._g2l[gid],
                        _InsertOp(
                            config_num=rep.cur.num,
                            shard=s,
                            data=pull_data,
                            latest=pull_latest,
                            ticket=t,
                        ),
                    )
                # (c) GC handshake: delete at the old owner, then
                # confirm locally (Challenge 1).  A remote old owner is
                # deleted through the remote_delete hook — Challenge 1
                # crosses process boundaries too.
                elif sh.state == GCING:
                    if self.migration_paused:
                        continue  # recovery: WAL confirm records stand in
                    dt = rep.pending_delete.get(s)
                    if dt is None or (dt.done and (dt.failed or dt.err != OK)):
                        src_gid = rep.prev.shards[s]
                        if src_gid in self.reps:
                            t = ShardTicket(group=src_gid)
                            rep.pending_delete[s] = t
                            self.driver.start(
                                self._g2l[src_gid],
                                _DeleteOp(config_num=rep.cur.num, shard=s,
                                          ticket=t),
                            )
                        elif self.remote_delete is not None:
                            st = self.remote_delete(src_gid, s, rep.cur.num)
                            if st is not None:
                                # Done ticket carries the outcome; a
                                # not-ready outcome re-enters this branch
                                # next sweep and re-asks the hook.
                                rep.pending_delete[s] = ShardTicket(
                                    group=src_gid, done=True,
                                    err=OK if st else ERR_NOT_READY,
                                )
                        else:
                            # No fleet: an unknown source was never
                            # joined here — nothing to delete.
                            rep.pending_delete[s] = ShardTicket(
                                group=0, done=True, err=OK
                            )
                    elif (
                        dt.done
                        and dt.err == OK
                        and not self._live(rep.pending_confirm.get(s))
                    ):
                        t = ShardTicket(group=gid)
                        rep.pending_confirm[s] = t
                        self.driver.start(
                            self._g2l[gid],
                            _ConfirmOp(config_num=rep.cur.num, shard=s,
                                       ticket=t),
                        )
                elif sh.state == SERVING:
                    rep.pending_delete.pop(s, None)


class BatchedShardClerk:
    """Client of :class:`BatchedShardKV` with the reference clerk's
    retry loop (re-query config on ErrWrongGroup, resubmit on lost
    leadership; reference: shardkv/client.go:68-129) and optional
    porcupine recording on sampled shards."""

    def __init__(
        self,
        skv: BatchedShardKV,
        client_id: int,
        record_shards: Optional[List[int]] = None,
    ) -> None:
        self.skv = skv
        self.client_id = client_id
        self.command_id = 0
        self._record = set(record_shards or [])
        self.histories: Dict[int, List[Operation]] = {
            s: [] for s in self._record
        }

    # -- async sessions (for concurrent-client tests) ----------------------

    # Ticks before an unresolved ticket is re-submitted under the same
    # (client_id, command_id).  A ticket can wedge forever without
    # this: if its entry is truncated by a leader change, the ticket
    # only fails when a new acceptance re-binds its log index — which
    # never happens once client traffic drains.  The reference clerk's
    # timeout-retry loop (shardkv/client.go:68-129) covers the same
    # hole; dedup makes the duplicate harmless.
    RESUBMIT_TICKS = 300

    class Session:
        def __init__(self, clerk: "BatchedShardClerk", op: str, key: str,
                     value: str, command_id: int) -> None:
            self.clerk = clerk
            self.op, self.key, self.value = op, key, value
            self.command_id = command_id
            self.call_tick = clerk.skv.driver.tick
            self.submit_tick = self.call_tick
            self.ticket: Optional[ShardTicket] = None
            self.done = False
            self.result = ""
            self._submit()

        def _submit(self) -> None:
            self.submit_tick = self.clerk.skv.driver.tick
            cfg = self.clerk.skv.query_latest()
            gid = cfg.shards[key2shard(self.key)]
            if gid not in self.clerk.skv.reps:
                self.ticket = None  # shard unassigned; retry after pump
                return
            self.ticket = self.clerk.skv.submit(
                gid, self.op, self.key, self.value,
                client_id=self.clerk.client_id, command_id=self.command_id,
            )

        def poll(self) -> bool:
            """Advance after a pump; True when the op has a final reply."""
            if self.done:
                return True
            t = self.ticket
            if t is None:
                self._submit()
                return False
            if not t.done:
                tick = self.clerk.skv.driver.tick
                if tick - self.submit_tick >= BatchedShardClerk.RESUBMIT_TICKS:
                    self._submit()  # wedged ticket: retry, dedup-safe
                return False
            if t.failed or t.err == ERR_WRONG_GROUP:
                self._submit()  # same command_id: dedup makes it safe
                return False
            self.done = True
            self.result = t.value if t.err == OK else ""
            self.clerk._record_op(self)
            return True

    def begin(self, op: str, key: str, value: str = "") -> "Session":
        self.command_id += 1
        return self.Session(self, op, key, value, self.command_id)

    def _record_op(self, s: "Session") -> None:
        shard = key2shard(s.key)
        if shard in self._record:
            self.histories[shard].append(
                Operation(
                    client_id=self.client_id,
                    input=KvInput(op=_PORCUPINE_OPCODE[s.op], key=s.key,
                                  value=s.value),
                    call=float(s.call_tick),
                    output=KvOutput(value=s.result),
                    ret=float(self.skv.driver.tick) + 0.5,
                )
            )

    def get_fast(self, key: str, max_ticks: int = 4000) -> str:
        """ReadIndex fast read with the clerk retry loop: instant when
        the routed owner is serving; pumps through migration windows
        (ErrWrongGroup) like any other clerk op.  Recorded in the
        porcupine history with its full call→return interval."""
        call = self.skv.driver.tick
        waited = 0
        while True:
            t = self.skv.get_fast(key)
            if t.err in (OK, ERR_NO_KEY):
                value = t.value if t.err == OK else ""
                shard = key2shard(key)
                if shard in self._record:
                    self.histories[shard].append(
                        Operation(
                            client_id=self.client_id,
                            input=KvInput(op=OP_GET, key=key),
                            call=float(call),
                            output=KvOutput(value=value),
                            ret=float(self.skv.driver.tick) + 0.5,
                        )
                    )
                return value
            if waited >= max_ticks:
                raise TimeoutError(
                    f"get_fast({key!r}): no serving owner in {max_ticks} ticks"
                )
            self.skv.pump(5)
            waited += 5

    # -- blocking convenience ----------------------------------------------

    def _run(self, op: str, key: str, value: str = "",
             max_ticks: int = 4000) -> str:
        s = self.begin(op, key, value)
        waited = 0
        while waited < max_ticks:
            self.skv.pump(5)
            waited += 5
            if s.poll():
                return s.result
        raise TimeoutError(f"{op}({key!r}) unresolved after {max_ticks} ticks")

    def get(self, key: str) -> str:
        return self._run(GET, key)

    def put(self, key: str, value: str) -> None:
        self._run(PUT, key, value)

    def append(self, key: str, value: str) -> None:
        self._run(APPEND, key, value)
