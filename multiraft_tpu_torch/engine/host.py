"""Host-side driver for the batched engine (PyTorch port of
``multiraft_tpu/engine/host.py``).

Owns the tick loop: feeds the outbox back as the next inbox through the
tensorized fault model (drop masks, per-edge partitions, liveness),
maintains the Start() backlog and the host-side payload store keyed
``(group, index)`` (the device only orders terms and indices), and
accumulates metrics.

The driver runs on one device, named at construction: ``device=None``
means ``"cuda"``, and a driver asked for a card that is not there
raises instead of carrying on on the CPU.  Or it runs on a
:class:`~.mesh.Mesh`: the groups split over the mesh's devices, each
shard ticking on its own (engine/mesh.py).  ``driver.state`` and
``driver.inbox`` then read as the global values, assembled on the
mesh's first device, and an assignment splits the value back, so every
host operation below works unchanged on a mesh; the tick loop itself
keeps to the per-shard lists.  The PRNG key stays on the
host, so per-tick key derivation costs no device launch; device values
reach the host only through :attr:`EngineDriver.last_metrics`,
:meth:`EngineDriver.np_state` and the fused batches' fetch, and each
returns numpy.

This is also where crash/restart surgery happens: a "crashed" replica is
marked dead (mask) and, on restart, its volatile state is reset while
its persistent columns (term, vote, log, base) survive.  Every such
write is out of place: the plane is cloned, then assigned, because the
tick passes unchanged planes through and a caller, a monitor or an
in-flight batch may still hold the old tensor.
"""

from __future__ import annotations

import os
import pickle
import time
from collections import defaultdict
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..utils import prng
from ..utils.knobs import knob_bool
from ..utils.metrics import Metrics
from .core import (
    FOLLOWER,
    LEADER,
    SCALAR_METRIC_KEYS,
    EngineConfig,
    EngineState,
    Mailbox,
    empty_mailbox,
    init_state,
    seed_voters,
    tick_impl,
)
from . import membership

__all__ = [
    "EngineDriver",
    "PayloadRun",
    "PayloadSlice",
    "apply_faults",
    "mask_active",
    "resolve_device",
]


class PayloadRun:
    """A pending firehose run: ``rows`` (original frame row indices,
    submission order) of ``frame`` awaiting log slots in one group.
    Each accept batch takes a prefix as one :class:`PayloadSlice`."""

    __slots__ = ("frame", "rows", "consumed")

    def __init__(self, frame: Any, rows: "np.ndarray") -> None:
        self.frame = frame
        self.rows = rows
        self.consumed = 0

    @property
    def remaining(self) -> int:
        return len(self.rows) - self.consumed

    def take(self, k: int) -> "PayloadSlice":
        s = PayloadSlice(self.frame, self.rows[self.consumed: self.consumed + k])
        self.consumed += k
        return s


class PayloadSlice:
    """A bound contiguous range of log slots carrying firehose rows,
    keyed in ``driver.payloads`` by its FIRST (group, index)."""

    __slots__ = ("frame", "rows")

    def __init__(self, frame: Any, rows: "np.ndarray") -> None:
        self.frame = frame
        self.rows = rows

    @property
    def count(self) -> int:
        return len(self.rows)

    def split_head(self, k: int) -> "PayloadSlice":
        """Split off the first ``k`` rows; self keeps the tail."""
        head = PayloadSlice(self.frame, self.rows[:k])
        self.rows = self.rows[k:]
        return head


# The message channels' liveness fields; every fault transform is a mask
# over exactly these.
_ACTIVE_FIELDS = tuple(f for f in Mailbox._fields if f.endswith("_active"))

# Channel prefix -> all fields of that channel (e.g. "ar_" -> ar_active,
# ar_term, ..., ar_snap).  The reorder fault mode lifts whole messages —
# every field of a channel slot — out of the stream and redelivers them
# ticks later, so it needs the grouping, not just the active bits.
_CHANNELS = {
    f[: -len("active")]: tuple(
        g for g in Mailbox._fields if g.startswith(f[: -len("active")])
    )
    for f in _ACTIVE_FIELDS
}


def mask_active(mb: Mailbox, fn) -> Mailbox:
    """Apply ``fn(field_name, bool_tensor) -> bool_tensor`` over every
    ``*_active`` channel of the mailbox."""
    return mb._replace(**{k: fn(k, getattr(mb, k)) for k in _ACTIVE_FIELDS})


def apply_faults(
    mailbox: Mailbox,
    key: torch.Tensor,
    drop_prob: float,
    cfg: EngineConfig,
    g0: int = 0,
) -> Mailbox:
    """Drop each in-flight message independently with ``drop_prob``:
    one uniform draw per channel from ``split(key, 4)``, compared in
    float32 as the reference does.  ``mailbox`` may be the block of
    groups ``g0..`` of the whole outbox (a mesh shard): its draws are
    then that block's rows of the whole outbox's draw."""
    shape = (mailbox.ar_active.shape[0], cfg.P, cfg.P)
    offset = g0 * cfg.P * cfg.P
    keys = prng.split(key, len(_ACTIVE_FIELDS))
    p = float(np.float32(drop_prob))

    def drop(name, a):
        k = keys[_ACTIVE_FIELDS.index(name)]
        return a & (prng.uniform(k, shape, a.device, offset) >= p)

    return mask_active(mailbox, drop)


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """``None`` means the card; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "EngineDriver: no CUDA device is available; pass device='cpu' "
            "to run the engine on the CPU"
        )
    return dev


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _np_gather(shards: Sequence, fields: Optional[Sequence[str]] = None):
    """Per-shard states or mailboxes as one dict of global numpy planes."""
    first = shards[0]._asdict()
    out = {}
    for k in first if fields is None else fields:
        if first[k].dim() == 0:
            out[k] = _np(first[k])
        else:
            out[k] = np.concatenate([_np(getattr(s, k)) for s in shards])
    return out


def _metric_np(metrics: Dict[str, Any], k: str) -> np.ndarray:
    """One metric on the host.  On a mesh a metric is a list of
    per-shard values: scalar lanes reduce (max for ``max_term``, the sum
    for the others), per-group blocks concatenate."""
    v = metrics[k]
    if not isinstance(v, list):
        return _np(v)
    from .mesh import reduce_scalar

    if k in SCALAR_METRIC_KEYS:
        return np.asarray(reduce_scalar(k, [_np(x)[0] for x in v]), np.int32)
    return np.concatenate([_np(x) for x in v])


def _set(t: torch.Tensor, *writes) -> torch.Tensor:
    """A copy of ``t`` with ``(index, value)`` writes applied in order:
    the out-of-place form of the reference's chained ``.at[...].set``.
    A tensor ``value`` stays on the device (no host round trip)."""
    t = t.clone()
    for index, value in writes:
        t[index] = value
    return t


class EngineDriver:
    def __init__(
        self,
        cfg: EngineConfig,
        seed: int = 0,
        device: Union[None, str, torch.device] = None,
        mesh=None,
        check_zero_collectives: bool = True,
    ) -> None:
        """``mesh``: an optional :class:`~.mesh.Mesh`.  The driver then
        splits its groups over the mesh's devices (``device`` must be
        None) and, by default, checks on one step at construction that
        no shard's tick reaches outside its shard
        (:func:`~.mesh.assert_zero_collectives`)."""
        if mesh is not None:
            device = self._mesh_device(cfg, mesh, device)
        self.device = resolve_device(device)
        self._init_host(cfg, seed)
        state = init_state(cfg, prng.fold_in(self.key, 0), self.device)
        inbox = empty_mailbox(cfg, self.device)
        if mesh is None:
            self.state, self.inbox = state, inbox
            return
        self._attach_mesh(mesh, state, inbox)
        if check_zero_collectives:
            from .mesh import assert_zero_collectives

            assert_zero_collectives(
                self._mesh_tick, self._state_shards, self._inbox_shards,
                self._mesh_cmds(False), self.key,
            )

    @staticmethod
    def _mesh_device(cfg: EngineConfig, mesh, device) -> torch.device:
        """Validate a mesh for ``cfg``; its first device holds the
        driver's global views."""
        from .mesh import local_config

        if device is not None:
            raise ValueError(
                "EngineDriver: a mesh driver takes its devices from the "
                "mesh; pass device=None"
            )
        if cfg.use_kernels:
            # The reference cannot either: its Pallas calls do not
            # lower under jax.shard_map (check_vma refuses their
            # out_shape), and bench.py turns them off in mesh mode.
            raise ValueError(
                "EngineDriver: use_kernels=True with a mesh — the mesh "
                "runs the plain tick, as the reference's mesh runs "
                "without its Pallas kernels; pass use_kernels=False"
            )
        local_config(cfg, mesh)  # G % n != 0 raises
        for dev in mesh.devices:
            resolve_device(dev)
        return mesh.devices[0]

    def _attach_mesh(self, mesh, state: EngineState, inbox: Mailbox) -> None:
        from .mesh import make_sharded_tick, shard_arrays

        self.mesh = mesh
        self._mesh_tick = make_sharded_tick(self.cfg, mesh)
        self._state_shards = shard_arrays(self.cfg, mesh, state)
        self._inbox_shards = shard_arrays(self.cfg, mesh, inbox)
        self._state_view = self._inbox_view = None
        self._commits_dev = [0] * mesh.size

    # -- global state and inbox (split over the shards on a mesh) --------

    @property
    def state(self) -> EngineState:
        if self.mesh is None:
            return self._state
        if self._state_view is None:
            from .mesh import gather_arrays

            self._state_view = gather_arrays(self._state_shards, self.device)
        return self._state_view

    @state.setter
    def state(self, st: EngineState) -> None:
        if self.mesh is None:
            self._state = st
            return
        self._state_shards = self._rescatter(
            st, self._state_view, self._state_shards
        )
        self._state_view = st

    @property
    def inbox(self) -> Mailbox:
        if self.mesh is None:
            return self._inbox
        if self._inbox_view is None:
            from .mesh import gather_arrays

            self._inbox_view = gather_arrays(self._inbox_shards, self.device)
        return self._inbox_view

    @inbox.setter
    def inbox(self, mb: Mailbox) -> None:
        if self.mesh is None:
            self._inbox = mb
            return
        self._inbox_shards = self._rescatter(
            mb, self._inbox_view, self._inbox_shards
        )
        self._inbox_view = mb

    def _rescatter(self, new, view, shards) -> list:
        """Split an assigned global value over the shards.  A plane that
        is the very tensor of the last global view read is unchanged:
        its shards keep their tensors."""
        from .mesh import shard_plane

        parts = {
            k: shard_plane(self.cfg, self.mesh, v)
            for k, v in new._asdict().items()
            if view is None or getattr(view, k) is not v
        }
        if not parts:
            return shards
        return [
            s._replace(**{k: p[i] for k, p in parts.items()})
            for i, s in enumerate(shards)
        ]

    def _init_host(self, cfg: EngineConfig, seed: int) -> None:
        self.cfg = cfg
        self.mesh = None
        self._mesh_tick = None
        self._state_shards = self._inbox_shards = None
        self._state_view = self._inbox_view = None
        self._edge_shards: Optional[list] = None
        self.key = prng.PRNGKey(seed)  # host-resident uint32[2]
        self.drop_prob = 0.0
        # Per-edge enables [G, src, dst] (labrpc per-ClientEnd enable);
        # a partitioned replica stays live but no message crosses a
        # disabled edge.  ``replica_conn`` is partition_replica's view.
        self.edge_up = np.ones((cfg.G, cfg.P, cfg.P), bool)
        self.replica_conn = np.ones((cfg.G, cfg.P), bool)
        self._edge_dev: Optional[torch.Tensor] = None  # lazy device copy
        # Long-reordering mode (labrpc: 2/3 of replies delayed): each
        # in-flight message is independently pulled from the stream with
        # ``reorder_prob`` and redelivered reorder_min..reorder_max ticks
        # later, behind messages sent after it.  Held messages die if
        # their edge partitions or either endpoint restarts in flight.
        self.reorder_prob = 0.0
        self.reorder_min, self.reorder_max = 2, 8
        self._np_rng = np.random.default_rng(seed ^ 0x5EED)
        self._delayed: list = []  # (release, prefix, (g,src,dst), fields)
        self.total_commits = 0
        self.backlog = np.zeros(cfg.G, np.int64)  # pending Start()s
        # Host-side payloads: (group, index) -> command.
        self.payloads: Dict[tuple, Any] = {}
        self._pending_payloads: Dict[int, list] = defaultdict(list)
        # Per-group bind high-water mark (see _bind_accepted).
        self._max_bound: Dict[int, int] = {}
        self._last_metrics: Dict[str, Any] = {}
        self._commits_dev: Any = 0
        # Counters: ticks always; per-tick wall latency samples
        # (``tick_wall_s``) while a tracer is attached.
        self.metrics = Metrics()
        self.tick = 0  # host mirror of the device tick counter
        # Called with the old payload when a (group, index) binding is
        # overwritten (the command lost its slot to a leader change).
        self.on_payload_evicted: Optional[Any] = None
        # Called as (g, idx, term) when a payload binds at ingest.
        self.on_payload_bound: Optional[Any] = None
        # Optional utils.trace.Tracer: each tick becomes a wall-clock
        # span carrying its metrics.  Both paths write a step's spans
        # when it ends, from one read of its ticks' metrics: the fused
        # path from its stacked record, the serial loop from the
        # commits/leaders it kept.
        self.tracer = None
        # Fused multi-tick stepping; MRT_ENGINE_PIPELINE=0 is the kill
        # switch (serial per-tick stepping).
        self._pipeline_on = knob_bool("MRT_ENGINE_PIPELINE")
        # Dispatched-but-not-completed PendingTicks, oldest first.
        self._inflight: list = []

    # -- last tick's metrics, as numpy ----------------------------------

    @property
    def last_metrics(self) -> Dict[str, Any]:
        """The last tick's metrics.  A serial step leaves them on the
        device; the first read copies them to numpy (one sync)."""
        m = self._last_metrics
        if any(isinstance(v, (torch.Tensor, list)) for v in m.values()):
            m = self._last_metrics = {k: _metric_np(m, k) for k in m}
        return m

    @last_metrics.setter
    def last_metrics(self, m: Dict[str, Any]) -> None:
        self._last_metrics = m

    # -- fault injection --------------------------------------------------

    def set_alive(self, g: int, p: int, alive: bool) -> None:
        """Crash (or revive) replica (g, p): the mask form of labrpc's
        per-server disable."""
        self.state = self.state._replace(
            alive=_set(self.state.alive, ((g, p), bool(alive)))
        )

    def set_edge(self, g: int, src: int, dst: int, up: bool) -> None:
        """Enable/disable the directed message edge src→dst in group g.
        A later ``partition_replica`` on either endpoint recomputes
        group g's edges from per-replica connectivity."""
        self.edge_up[g, src, dst] = up
        self._edges_changed()

    def partition_replica(self, g: int, p: int, connected: bool) -> None:
        """Cut (or heal) live replica (g, p): an edge is up iff both
        endpoints are connected (labrpc connect() semantics)."""
        self.replica_conn[g, p] = connected
        conn = self.replica_conn[g]
        self.edge_up[g] = conn[:, None] & conn[None, :]
        self._edges_changed()

    def _edges_changed(self) -> None:
        """In-flight messages on now-disabled edges die immediately —
        including those held in the reorder delay queue: a cut-then-heal
        between two ticks must not resurrect them."""
        self._edge_dev = None
        self._edge_shards = None
        if not self.edge_up.all():
            self.inbox = self._mask_partitions(self.inbox)
        if self._delayed:
            self._delayed = [
                it for it in self._delayed if self.edge_up[it[2]]
            ]

    def _edge_mask(self) -> torch.Tensor:
        if self._edge_dev is None:
            # A copy: edge_up is mutable host state.
            self._edge_dev = torch.tensor(self.edge_up, device=self.device)
        return self._edge_dev

    def _mask_partitions(self, mb: Mailbox) -> Mailbox:
        m = self._edge_mask()
        return mask_active(mb, lambda _, a: a & m)

    def _mask_partitions_sharded(self, outs: list) -> list:
        """The edge mask on each shard's own block of groups."""
        if self._edge_shards is None:
            gl = self.cfg.G // self.mesh.size
            self._edge_shards = [
                torch.tensor(self.edge_up[i * gl:(i + 1) * gl], device=dev)
                for i, dev in enumerate(self.mesh.devices)
            ]
        return [
            mask_active(mb, lambda _, a, m=m: a & m)
            for mb, m in zip(outs, self._edge_shards)
        ]

    def set_reorder(
        self, prob: float, min_ticks: int = 2, max_ticks: int = 8
    ) -> None:
        """Enable labrpc-style long reordering on the tensor transport:
        each message is delayed ``min_ticks..max_ticks`` ticks with
        probability ``prob`` (labrpc uses 2/3), arriving after traffic
        sent later — the non-FIFO delivery the conflict-backoff and
        staleness guards must survive."""
        if not 0.0 <= prob <= 1.0 or min_ticks < 1 or max_ticks < min_ticks:
            raise ValueError("set_reorder: bad parameters")
        self.reorder_prob = float(prob)
        self.reorder_min, self.reorder_max = int(min_ticks), int(max_ticks)

    def _apply_reorder(self, mb: Mailbox) -> Mailbox:
        """Host-side delay queue over the dense mailbox.  A held message
        is redelivered once its release tick passes *and* its slot is
        free that tick (otherwise it waits).  The draws follow the
        reference's order — channels in ``_CHANNELS`` order, picks
        row-major, one ``integers`` draw per picked message — so the
        same seed holds the same messages.  Test-path only: copies the
        mailbox to the host, so keep it off for throughput runs."""
        if not self._reorder_due():
            return mb  # nothing to pick, nothing due: skip the copy
        host = {f: np.array(_np(getattr(mb, f))) for f in Mailbox._fields}
        host = self._reorder_host(host)
        return Mailbox(
            **{f: torch.tensor(v, device=self.device) for f, v in host.items()}
        )

    def _apply_reorder_sharded(self, outs: list) -> list:
        """:meth:`_apply_reorder` over the shards' outboxes: the delay
        queue works on the global view, on the host, and each shard gets
        its block back on its own device."""
        if not self._reorder_due():
            return outs
        host = self._reorder_host(_np_gather(outs))
        gl = self.cfg.G // self.mesh.size
        return [
            Mailbox(**{
                f: torch.tensor(v[i * gl:(i + 1) * gl], device=dev)
                for f, v in host.items()
            })
            for i, dev in enumerate(self.mesh.devices)
        ]

    def _reorder_due(self) -> bool:
        return self.reorder_prob > 0.0 or any(
            release <= self.tick for release, *_ in self._delayed
        )

    def _reorder_host(self, host: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        rng = self._np_rng
        if self.reorder_prob > 0.0:
            for prefix, fields in _CHANNELS.items():
                act = host[prefix + "active"]
                pick = act & (rng.random(act.shape) < self.reorder_prob)
                for g, s, dst in np.argwhere(pick):
                    release = self.tick + int(
                        rng.integers(self.reorder_min, self.reorder_max + 1)
                    )
                    payload = {f: host[f][g, s, dst].copy() for f in fields}
                    # Every entry carries a release tick at most
                    # tick + reorder_max, so the queue holds at most
                    # reorder_max ticks of traffic.
                    self._delayed.append(  # graftlint: disable=unbounded-queue
                        (release, prefix, (int(g), int(s), int(dst)), payload)
                    )
                act[pick] = False
        if self._delayed:
            held = []
            for item in self._delayed:
                release, prefix, (g, s, dst), payload = item
                if not self.edge_up[g, s, dst]:
                    continue  # partitioned while in flight: message dies
                if release <= self.tick and not host[prefix + "active"][g, s, dst]:
                    for f, v in payload.items():
                        host[f][g, s, dst] = v
                else:
                    held.append(item)
            self._delayed = held
        return host

    def _drop_delayed_of(self, g: int, p: int) -> None:
        """Held messages to or from replica (g, p) die with it."""
        self._delayed = [
            it
            for it in self._delayed
            if not (it[2][0] == g and p in (it[2][1], it[2][2]))
        ]

    def restart_replica(self, g: int, p: int) -> None:
        """Crash-restart: persistent columns (term/vote/log/base) survive;
        volatile leadership state resets (reference: raft/raft.go:69
        readPersist on Make)."""
        st = self.state
        at = (g, p)
        self.state = st._replace(
            role=_set(st.role, (at, FOLLOWER)),
            votes=_set(st.votes, (at, False)),
            pre_votes=_set(st.pre_votes, (at, False)),
            # Conservative lease on rebirth: wait out ELECT_MIN before
            # granting prevotes (volatile, like the vote tallies).
            last_heard=_set(st.last_heard, (at, st.tick_no)),
            # The check-quorum clock is leadership-scoped (reseeded at
            # become_leader), so rebirth just zeroes it.
            last_ack=_set(st.last_ack, (at, 0)),
            # Applied rewinds to the snapshot floor: the service replays
            # the log above base (commit knowledge is volatile in Raft).
            commit=_set(st.commit, (at, st.base[g, p])),
            applied=_set(st.applied, (at, st.base[g, p])),
            alive=_set(st.alive, (at, True)),
        )
        # In-flight messages to/from the old incarnation die — including
        # any held in the reorder delay queue.
        self.inbox = membership.drop_edges(self.inbox, *self._one_row(g, p))
        self._drop_delayed_of(g, p)

    def reset_replica(self, g: int, p: int) -> None:
        """Wipe slot (g, p) to a FRESH INCARNATION — the re-add path
        (a removed peer index reused for a new server), not the
        crash-restart path (:meth:`restart_replica`, where persistent
        state survives): :func:`.membership.reset_replica` on one row,
        which also clears the other replicas' columns about p, and the
        held messages of the old incarnation dropped.  ``alive`` is left
        False — :meth:`add_learner` raises it once the config view is
        seeded."""
        rows, slots = self._one_row(g, p)
        self.state, self.inbox = membership.reset_replica(
            self.cfg, self.state, self.inbox, rows, slots, alive=False
        )
        self._drop_delayed_of(g, p)

    # -- membership change (joint consensus) -------------------------------

    def _require_membership(self) -> None:
        if not self.cfg.membership_on:
            raise RuntimeError(
                "membership change requires EngineConfig.membership and "
                "the plain reduction path (use_kernels=False) — the CUDA "
                "tally/commit kernels are mask-unaware"
            )

    def config_of(self, g: int, p: Optional[int] = None) -> Dict[str, Any]:
        """Replica (g, p)'s config view (the leader's when p is None):
        voter index sets, joint flag, epoch and the latest config
        entry's log index."""
        if p is None:
            p = self.leader_of(g)
            if p is None:
                raise RuntimeError(f"group {g} has no leader")
        st = self.np_state()
        bits_old = int(st["voters_old"][g, p])
        bits_new = int(st["voters_new"][g, p])

        def unpack(b: int) -> list:
            return [q for q in range(self.cfg.P) if (b >> q) & 1]

        return {
            "peer": int(p),
            "voters_old": unpack(bits_old),
            "voters_new": unpack(bits_new),
            "joint": bool(st["joint"][g, p]),
            "epoch": int(st["cfg_epoch"][g, p]),
            "cfg_idx": int(st["cfg_idx"][g, p]),
        }

    def add_learner(self, g: int, p: int) -> None:
        """AddServer step 1: (re)seat slot (g, p) as a NON-VOTING
        learner of group g — a fresh incarnation (see
        :meth:`reset_replica`) whose config view mirrors the leader's,
        so it knows it is not a voter and never campaigns.  Catch-up is
        the ordinary replication path; promotion (:meth:`begin_joint`)
        should wait for :meth:`learner_match` to close on the leader's
        last index."""
        self._require_membership()
        lead = self.leader_of(g)
        if lead is None:
            raise RuntimeError(f"add_learner: group {g} has no leader")
        if lead == p:
            raise ValueError(f"add_learner: ({g},{p}) is the leader")
        st = self.np_state()
        if ((int(st["voters_old"][g, lead]) | int(st["voters_new"][g, lead]))
                >> p) & 1:
            raise ValueError(
                f"add_learner: peer {p} is a voter of group {g}; remove "
                f"it from the config before reseating the slot"
            )
        rows, slots = self._one_row(g, p)
        self.state, self.inbox, _ = membership.seat_learners(
            self.cfg, self.state, self.inbox, rows, slots
        )
        self._drop_delayed_of(g, p)

    def learner_match(self, g: int, p: int) -> tuple:
        """(leader's match for p, leader's last index) — the catch-up
        gauge ``begin_joint`` callers poll before promoting."""
        lead = self.leader_of(g)
        if lead is None:
            raise RuntimeError(f"learner_match: group {g} has no leader")
        st = self.np_state()
        last = int(st["base"][g, lead] + st["log_len"][g, lead])
        return int(st["match_idx"][g, lead, p]), last

    def begin_joint(self, g: int, new_voters) -> int:
        """AddServer/RemoveServer step 2: append the C_old,new config
        entry at group g's leader (host surgery on the leader's row; it
        takes effect on append).  From the next tick the leader
        replicates it like any entry; once it commits under BOTH quorums
        the tick appends the C_new exit entry.  Returns the joint
        entry's log index."""
        self._require_membership()
        new_voters = sorted(set(int(q) for q in new_voters))
        if not new_voters:
            raise ValueError("begin_joint: empty target voter set")
        if any(q < 0 or q >= self.cfg.P for q in new_voters):
            raise ValueError(
                f"begin_joint: voters {new_voters} out of range "
                f"0..{self.cfg.P - 1}"
            )
        lead = self.leader_of(g)
        if lead is None:
            raise RuntimeError(f"begin_joint: group {g} has no leader")
        st = self.np_state()
        if bool(st["joint"][g, lead]):
            raise RuntimeError(
                f"begin_joint: group {g} already has a config change in "
                f"flight (one at a time — Raft §6)"
            )
        mask = 0
        for q in new_voters:
            mask |= 1 << q
        if mask == int(st["voters_old"][g, lead]):
            raise ValueError("begin_joint: target equals current config")
        if self.cfg.L - 2 - self.cfg.E - int(st["log_len"][g, lead]) < 1:
            raise RuntimeError(
                f"begin_joint: group {g} leader log has no headroom"
            )
        rows, masks = self._one_row(g, mask)
        self.state, _ = membership.begin_joint(self.cfg, self.state, rows, masks)
        return int(st["base"][g, lead] + st["log_len"][g, lead]) + 1

    def _one_row(self, g: int, value: int):
        """Group ``g`` and one value as index tensors for
        :mod:`.membership`, on the state's device."""
        dev = self.state.term.device
        return (torch.tensor([g], dtype=torch.int64, device=dev),
                torch.tensor([value], dtype=torch.int64, device=dev))

    def seed_config(self, voters) -> None:
        """Bootstrap-time config: make ``voters`` (a peer index list)
        the voter set of EVERY group, leaving the remaining slots as
        dead spares a later :meth:`add_learner` can reseat.  Call before
        the first tick (a live group changes members through
        ``add_learner``/``begin_joint``)."""
        self._require_membership()
        voters = sorted(set(int(q) for q in voters))
        if not voters or any(q < 0 or q >= self.cfg.P for q in voters):
            raise ValueError(f"seed_config: bad voter set {voters}")
        if int(self.state.tick_no) != 0:
            raise RuntimeError("seed_config: cluster already ticked")
        self.state = seed_voters(self.state, voters, self.cfg.P)

    def reconfiguring(self) -> np.ndarray:
        """Per-group bool: a membership change is in flight — the group
        is in the joint phase, or its latest config entry has not yet
        committed (its commit frontier may legitimately stall while it
        waits on BOTH quorums)."""
        st = self.np_state()
        return (
            st["joint"].any(axis=1)
            | (st["cfg_idx"].max(axis=1) > st["commit"].max(axis=1))
        )

    # -- Start() ----------------------------------------------------------

    def start(self, g: int, command: Any = None) -> None:
        """Queue a command for group g."""
        self.backlog[g] += 1
        # Drained by the tick's ingest at INGEST commands a group a
        # tick; admission control in front of the servers bounds a
        # sustained overload.
        self._pending_payloads[g].append(command)  # graftlint: disable=unbounded-queue

    def start_bulk(self, counts: np.ndarray) -> None:
        self.backlog += counts

    def start_run(self, g: int, frame: Any, rows: "np.ndarray") -> None:
        """Queue a contiguous RUN of firehose-frame rows for group ``g``:
        one pending entry and one backlog bump of ``len(rows)``."""
        self.backlog[g] += len(rows)
        self._pending_payloads[g].append(PayloadRun(frame, rows))

    def _evict_rebound_range(self, g: int, lo: int, hi: int) -> None:
        """A fresh accept is about to bind slots ``[lo, hi]`` of group
        ``g``: every existing binding overlapping ``[lo, ...)`` is stale
        (the log was truncated below it).  A slice keyed below ``lo`` can
        straddle into the range; its length is bounded by cfg.INGEST, so
        a bounded backward scan finds it, and its prefix below ``lo``
        stays bound."""
        pay = self.payloads
        for idx in range(max(1, lo - self.cfg.INGEST + 1), hi + 1):
            old = pay.get((g, idx))
            if old is None:
                continue
            if isinstance(old, PayloadSlice):
                end = idx + old.count - 1
                if end < lo:
                    continue  # wholly below the rewrite: still valid
                if idx < lo:
                    tail = PayloadSlice(old.frame, old.rows[lo - idx:])
                    old.rows = old.rows[: lo - idx]
                    if self.on_payload_evicted:
                        self.on_payload_evicted(tail)
                    continue
                pay.pop((g, idx))
                if self.on_payload_evicted:
                    self.on_payload_evicted(old)
            elif idx >= lo:
                pay.pop((g, idx))
                if self.on_payload_evicted:
                    self.on_payload_evicted(old)

    def _bind_accepted(
        self, g: int, k: int, s0: int, term: Optional[int]
    ) -> None:
        """Bind ``k`` accepted slots ``s0+1..s0+k`` of group ``g`` to
        pending payloads/runs, evicting stale bindings first when the
        accept starts at or below the group's bind high-water mark (a
        truncation rebind)."""
        assert k <= self.cfg.INGEST, (
            f"accept batch k={k} exceeds cfg.INGEST={self.cfg.INGEST} "
            f"for group {g}"
        )
        lo, hi = s0 + 1, s0 + k
        mb = self._max_bound.get(g, 0)
        if self.payloads and lo <= mb:
            self._evict_rebound_range(g, lo, hi)
        if hi > mb:
            self._max_bound[g] = hi
        pend = self._pending_payloads.get(g)
        if not pend:
            return
        off = 0
        while off < k and pend:
            head = pend[0]
            slot = (g, s0 + 1 + off)
            if isinstance(head, PayloadRun):
                take = min(head.remaining, k - off)
                self.payloads[slot] = head.take(take)
                if head.remaining == 0:
                    pend.pop(0)
                if term is not None:
                    for j in range(take):
                        self.on_payload_bound(slot[0], slot[1] + j, term)
                off += take
            else:
                self.payloads[slot] = pend.pop(0)
                if term is not None:
                    self.on_payload_bound(slot[0], slot[1], term)
                off += 1

    # -- tick loop --------------------------------------------------------

    def step(self, n: int = 1) -> Dict[str, Any]:
        """Advance ``n`` ticks: the fused loop for multi-tick calls on a
        pipeline-enabled driver, the serial loop otherwise.  Both give
        identical results.  Batches still in flight complete first, in
        dispatch order."""
        while self._inflight:
            p = self._inflight[0]
            self.complete_ticks(p, p.fetch())
        if n > 1 and self.fused_eligible():
            pending = self.dispatch_ticks(n)
            return self.complete_ticks(pending, pending.fetch())
        return self._step_serial(n)

    def fused_eligible(self) -> bool:
        """True when the fused path may run: pipeline enabled, no mesh
        (its scalar metrics arrive as per-shard lanes) and no reorder
        chaos active or held."""
        return (
            self._pipeline_on
            and self.mesh is None
            and self.reorder_prob == 0.0
            and not self._delayed
        )

    def _mesh_cmds(self, have_backlog: bool) -> list:
        """This tick's Start() intake, one ``i32[G/n]`` per shard."""
        gl = self.cfg.G // self.mesh.size
        if have_backlog:
            cmds = np.minimum(self.backlog, self.cfg.INGEST).astype(np.int32)
            return [
                torch.tensor(cmds[i * gl:(i + 1) * gl], device=dev)
                for i, dev in enumerate(self.mesh.devices)
            ]
        return [
            torch.zeros(gl, dtype=torch.int32, device=dev)
            for dev in self.mesh.devices
        ]

    def _tick_mesh(self, tick_key: torch.Tensor, have_backlog: bool):
        """One tick over the mesh: each shard's tick, then the fault
        model on each shard's outbox: the drops and the edge mask are
        the whole outbox's, sliced; the reorder queue works on the
        global view."""
        cfg = self.cfg
        gl = cfg.G // self.mesh.size
        states, outs, metrics = self._mesh_tick(
            self._state_shards, self._inbox_shards,
            self._mesh_cmds(have_backlog), tick_key,
        )
        if self.drop_prob > 0.0:
            fk = prng.fold_in(tick_key, 0xFA)
            outs = [
                apply_faults(mb, fk, self.drop_prob, cfg, g0=i * gl)
                for i, mb in enumerate(outs)
            ]
        if not self.edge_up.all():
            outs = self._mask_partitions_sharded(outs)
        if self.reorder_prob > 0.0 or self._delayed:
            outs = self._apply_reorder_sharded(outs)
        self._state_shards, self._inbox_shards = states, outs
        self._state_view = self._inbox_view = None
        self._commits_dev = [
            a + c for a, c in zip(self._commits_dev, metrics["commits"])
        ]
        return metrics

    def _step_serial(self, n: int = 1) -> Dict[str, Any]:
        assert not self._inflight, (
            "serial step with fused tick batches in flight — complete "
            "them first, or the two tick streams interleave"
        )
        self.metrics.inc("ticks", n)
        traced = []  # (start, metrics, backlog) a tick
        for _ in range(n):
            self.tick += 1
            t_wall = time.perf_counter() if self.tracer else 0.0
            tick_key = prng.fold_in(self.key, self.tick)
            have_backlog = bool(self.backlog.any())
            if self.mesh is not None:
                metrics = self._tick_mesh(tick_key, have_backlog)
            else:
                metrics = self._tick_one(tick_key, have_backlog)
            if have_backlog:
                # Host sync only while commands are in flight.
                accepted = _metric_np(metrics, "accepted")
                starts = _metric_np(metrics, "start_index")
                terms = (
                    _metric_np(metrics, "accept_term")
                    if self.on_payload_bound else None
                )
                for g in np.nonzero(accepted)[0]:
                    k = int(accepted[g])
                    self.backlog[g] -= k
                    self._bind_accepted(
                        int(g), k, int(starts[g]),
                        int(terms[g]) if terms is not None else None,
                    )
            self.last_metrics = metrics
            if self.tracer:
                traced.append((t_wall, metrics, int(self.backlog.sum())))
        if traced:
            self._emit_serial_spans(traced)
        return self.last_metrics

    def _emit_serial_spans(self, traced) -> None:
        """Tracer spans and counters for a serial step's ticks, written
        once all are enqueued.  On one device, a single read brings
        their commits and leaders to the host together with the last
        tick's metrics (``last_metrics``).  A tick's span runs from its
        start on the host to the next one's; the last ends when the
        read returns."""
        if self.mesh is None:
            last = self._last_metrics
            flat = _np(torch.cat(
                [torch.stack([m[k] for _, m, _ in traced for k in ("commits", "leaders")])]
                + [v.reshape(-1) for v in last.values()]
            ))
            vals = flat[: 2 * len(traced)].reshape(-1, 2)
            off, host_last = vals.size, {}
            for k, v in last.items():
                host_last[k] = flat[off: off + v.numel()].reshape(v.shape)
                off += v.numel()
            self._last_metrics = host_last
        else:  # per-shard lanes, reduced on the host
            vals = [(_metric_np(m, "commits"), _metric_np(m, "leaders"))
                    for _, m, _ in traced]
        now = time.perf_counter()
        ends = [t for t, *_ in traced[1:]] + [now]
        tick0 = self.tick - len(traced)
        for i, ((t0, _, backlog), t1) in enumerate(zip(traced, ends)):
            commits, leaders = int(vals[i][0]), int(vals[i][1])
            self.metrics.observe("tick_wall_s", t1 - t0)
            self.tracer.span(
                "tick",
                t0 * 1e6,
                (t1 - t0) * 1e6,
                track="engine",
                tick=tick0 + 1 + i,
                commits=commits,
                leaders=leaders,
            )
            self.tracer.counter(
                "consensus", t1 * 1e6, {"commits": commits, "backlog": backlog},
            )

    def _tick_one(self, tick_key: torch.Tensor, have_backlog: bool):
        """One tick on the one device, then the fault model."""
        cfg = self.cfg
        if have_backlog:
            new_cmds = torch.tensor(
                np.minimum(self.backlog, cfg.INGEST).astype(np.int32),
                device=self.device,
            )
        else:
            new_cmds = torch.zeros(cfg.G, dtype=torch.int32, device=self.device)
        state, outbox, metrics = tick_impl(
            cfg, self.state, self.inbox, new_cmds, tick_key
        )
        if self.drop_prob > 0.0:
            outbox = apply_faults(
                outbox, prng.fold_in(tick_key, 0xFA), self.drop_prob, cfg
            )
        if not self.edge_up.all():
            outbox = self._mask_partitions(outbox)
        if self.reorder_prob > 0.0 or self._delayed:
            outbox = self._apply_reorder(outbox)
        self.state, self.inbox = state, outbox
        # Accumulate on device; converted lazily by readers.
        self._commits_dev = self._commits_dev + metrics["commits"]
        return metrics

    # -- fused pipeline (engine/pipeline.py) ------------------------------

    def dispatch_ticks(self, n: int):
        """Enqueue a fused ``n``-tick batch on the device without waiting
        for it.  The host tick counter and state/inbox advance now;
        payload binding and backlog bookkeeping wait for
        :meth:`complete_ticks` with the fetched record."""
        from .pipeline import PendingTicks, step_ticks

        if self.mesh is not None:
            raise RuntimeError(
                "dispatch_ticks: a mesh driver steps serially (step())"
            )
        t_dispatch = time.perf_counter()
        self.metrics.inc("ticks", n)
        tick0 = self.tick
        bl = torch.tensor(
            np.minimum(self.backlog, np.int64(2**31 - 1)).astype(np.int32),
            device=self.device,
        )
        for p in self._inflight:
            # Batches in flight consume part of the host backlog when
            # they complete; the device must not ingest those again.
            bl = (bl - p.accepts_dev).clamp(min=0)
        with_edges = not bool(self.edge_up.all())
        state, inbox, _bl_left, rec = step_ticks(
            self.cfg, self.state, self.inbox, n,
            self.drop_prob if self.drop_prob > 0.0 else None,
            self._edge_mask() if with_edges else None,
            bl, tick0, self.key,
        )
        self.state, self.inbox = state, inbox
        self.tick = tick0 + n
        pending = PendingTicks(
            n=n, tick0=tick0, rec=rec,
            accepts_dev=rec["accepted"].sum(dim=0, dtype=torch.int32),
            t_dispatch=t_dispatch,
        )
        # Bounded by the serving pipeline depth: the pump dispatches only
        # while fewer batches are in flight, and step() drains them all.
        self._inflight.append(pending)  # graftlint: disable=unbounded-queue
        return pending

    def complete_ticks(self, pending, host_rec) -> Dict[str, Any]:
        """Fold a fetched batch back into host bookkeeping: per-tick
        backlog decrements and payload binding replayed in tick order,
        the commit accumulator, last_metrics and (with a tracer) the
        batch's per-tick spans.  Must run in dispatch order."""
        assert self._inflight and self._inflight[0] is pending, (
            "complete_ticks out of dispatch order"
        )
        self._inflight.pop(0)
        accepted = host_rec["accepted"]  # i32[n, G]
        starts = host_rec["start_index"]
        terms = host_rec["accept_term"] if self.on_payload_bound else None
        # Row-major nonzero: tick-major, group-minor — the serial order.
        for i, g in zip(*np.nonzero(accepted)):
            k = int(accepted[i, g])
            self.backlog[g] -= k
            self._bind_accepted(
                int(g), k, int(starts[i, g]),
                int(terms[i, g]) if terms is not None else None,
            )
        self._commits_dev = self._commits_dev + int(host_rec["commits"].sum())
        self.last_metrics = {k: v[-1] for k, v in host_rec.items()}
        if self.tracer:
            self._emit_tick_spans(pending, host_rec)
        return self.last_metrics

    def _emit_tick_spans(self, pending, rec) -> None:
        """Tracer spans for a completed fused batch: the ticks ran on
        the device back to back, so the batch's wall time is spread
        evenly across them.  Commit/leader fields come from the stacked
        record — no extra device syncs."""
        n = pending.n
        now = time.perf_counter()
        per = max(now - pending.t_dispatch, 1e-9) / n
        t = pending.t_dispatch
        commits_total = int(rec["commits"].sum())
        for i in range(n):
            self.metrics.observe("tick_wall_s", per)
            self.tracer.span(
                "tick",
                t * 1e6,
                per * 1e6,
                track="engine",
                tick=pending.tick0 + 1 + i,
                commits=int(rec["commits"][i]),
                leaders=int(rec["leaders"][i]),
            )
            t += per
        self.tracer.counter(
            "consensus", now * 1e6,
            {"commits": commits_total, "backlog": int(self.backlog.sum())},
        )

    @property
    def commits_total(self) -> int:
        c = self._commits_dev
        if isinstance(c, list):  # one accumulator per mesh shard
            return sum(int(x) for x in c) + self.total_commits
        return int(c) + self.total_commits

    def run_until_quiet_leaders(self, max_ticks: int = 500) -> bool:
        """Advance until every group has exactly one live leader."""
        stride = 5  # check every few ticks: readbacks are host syncs
        for _ in range(0, max_ticks, stride):
            self.step(stride)
            if self.leaders_per_group().min() >= 1:
                if self.leaders_at_max_term_per_group().max() <= 1:
                    return True
        return False

    # -- checkpoint / resume ----------------------------------------------
    #
    # Whole-engine suspend/resume: an atomic capture of the whole cluster
    # at a tick boundary (state + in-flight mailbox + host bookkeeping),
    # so restoring it is pausing and resuming the world.  The blob is the
    # reference's, key for key and type for type, so either package reads
    # the other's checkpoints (see convert.CHECKPOINT_CLASSES).

    # v2: EngineState gained pre_votes/last_heard; Mailbox vr_pre/vp_pre.
    # v3: EngineState gained last_ack.
    # v4: EngineState gained voters_old/voters_new/joint/cfg_epoch/cfg_idx
    # and Mailbox the ar_cfg_* lanes (joint-consensus membership).
    CKPT_VERSION = 4

    def save(self, path: str, extra: Optional[Dict[str, Any]] = None) -> str:
        """Atomically write a full checkpoint.  ``extra`` carries
        service-level state (e.g. ``BatchedKV.state_dict()``) so engine
        and services checkpoint at the same tick boundary."""
        if self._inflight:
            # state/inbox already reflect the dispatched batches but the
            # backlog/payload bookkeeping does not: a checkpoint here
            # would tear the tick boundary.
            raise RuntimeError(
                "save() with fused tick batches in flight — drain the "
                "pipeline (complete_ticks) before checkpointing"
            )
        blob = {
            "version": self.CKPT_VERSION,
            "mesh_devices": self.mesh.size if self.mesh is not None else 0,
            "cfg": self.cfg,
            "state": self.np_state(),
            "inbox": self.np_inbox(),
            "tick": self.tick,
            "key": _np(self.key),
            "backlog": self.backlog,
            "payloads": self.payloads,
            "pending_payloads": dict(self._pending_payloads),
            "edge_up": self.edge_up,
            "replica_conn": self.replica_conn,
            "drop_prob": self.drop_prob,
            "reorder": (self.reorder_prob, self.reorder_min, self.reorder_max),
            # The reorder RNG's position: a resumed run draws the same
            # picks and delays as the uninterrupted one.
            "np_rng": self._np_rng.bit_generator.state,
            "delayed": self._delayed,
            "commits_total": self.commits_total,
            "extra": extra or {},
        }
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(blob, f, protocol=pickle.HIGHEST_PROTOCOL)
            f.flush()
            # A deliberate sync on the loop thread: a durable server
            # truncates its WAL right after this returns, so the
            # checkpoint must be on disk first.
            os.fsync(f.fileno())  # graftlint: disable=blocking-in-callback
        os.replace(tmp, path)  # atomic: a crash mid-save keeps the old one
        # Make the rename itself durable: a caller may truncate its own
        # log right after this returns, and POSIX gives no cross-file
        # ordering on power loss.
        dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)  # graftlint: disable=blocking-in-callback
        finally:
            os.close(dfd)
        return path

    @classmethod
    def restore(
        cls,
        path: str,
        device: Union[None, str, torch.device] = None,
        mesh=None,
    ) -> "EngineDriver":
        """Rebuild a driver from :meth:`save` — this package's or the
        reference's (its classes map to this package's by name, see
        :func:`~multiraft_tpu_torch.convert.load_checkpoint`).  The
        driver lands on ``device`` (``None``: the card), or on ``mesh``,
        and continues from the exact saved tick; the checkpoint's
        ``extra`` dict is ``driver.restored_extra``.

        A checkpoint taken from a mesh driver must be restored onto a
        mesh of the same size — coming back on one device would put the
        whole state where a part of it was; a one-device checkpoint may
        be split onto a mesh."""
        from .. import convert

        with open(path, "rb") as f:
            blob = convert.load_checkpoint(f)
        if blob.get("version") != cls.CKPT_VERSION:
            raise ValueError(
                f"checkpoint version {blob.get('version')} != {cls.CKPT_VERSION}"
            )
        saved_mesh = blob.get("mesh_devices", 0)
        if saved_mesh and mesh is None:
            raise ValueError(
                f"checkpoint was taken from a {saved_mesh}-device mesh "
                f"driver; pass restore(..., mesh=) with a "
                f"{saved_mesh}-device mesh to re-shard it"
            )
        if saved_mesh and mesh is not None and mesh.size != saved_mesh:
            raise ValueError(
                f"checkpoint was taken on {saved_mesh} devices but "
                f"restore got a {mesh.size}-device mesh"
            )
        d = object.__new__(cls)  # skip __init__: no throwaway device state
        if mesh is not None:
            device = cls._mesh_device(blob["cfg"], mesh, device)
        d.device = resolve_device(device)
        d._init_host(blob["cfg"], seed=0)
        state = convert.state_from_numpy(blob["state"], d.device)
        inbox = convert.mailbox_from_numpy(blob["inbox"], d.device)
        if mesh is None:
            d.state, d.inbox = state, inbox
        else:
            d._attach_mesh(mesh, state, inbox)
        d.tick = blob["tick"]
        d.key = convert.key_from_numpy(blob["key"])
        d.backlog = blob["backlog"]
        d.payloads = blob["payloads"]
        d._pending_payloads = defaultdict(list, blob["pending_payloads"])
        # Rebuild the bind high-water marks from the restored bindings
        # (a zeroed mark would skip the rebind eviction scan and let a
        # post-restore truncation apply a stale slice).
        d._max_bound = {}
        for (g, idx), p in d.payloads.items():
            end = idx + (p.count - 1 if isinstance(p, PayloadSlice) else 0)
            if end > d._max_bound.get(g, 0):
                d._max_bound[g] = end
        d.edge_up = blob["edge_up"]
        d.replica_conn = blob["replica_conn"]
        d._edge_dev = None
        d.drop_prob = blob["drop_prob"]
        d.reorder_prob, d.reorder_min, d.reorder_max = blob["reorder"]
        d._np_rng.bit_generator.state = blob["np_rng"]
        d._delayed = blob["delayed"]
        d.total_commits = blob["commits_total"]
        d.restored_extra = blob["extra"]
        return d

    # -- inspection (host readbacks) ------------------------------------

    def np_state(
        self, fields: Optional[Sequence[str]] = None
    ) -> Dict[str, np.ndarray]:
        """The state's planes on the host (``fields``: only those)."""
        if self.mesh is not None:
            return _np_gather(self._state_shards, fields)
        st = self.state._asdict()
        return {k: _np(st[k]) for k in (st if fields is None else fields)}

    def np_inbox(self) -> Dict[str, np.ndarray]:
        """The in-flight mailbox's planes on the host."""
        if self.mesh is not None:
            return _np_gather(self._inbox_shards)
        return {k: _np(v) for k, v in self.inbox._asdict().items()}

    def leaders_per_group(self) -> np.ndarray:
        st = self.np_state()
        return ((st["role"] == LEADER) & st["alive"]).sum(axis=1)

    def leaders_at_max_term_per_group(self) -> np.ndarray:
        st = self.np_state()
        lead = (st["role"] == LEADER) & st["alive"]
        # Leaders are unique per *term*; count leaders in the max term.
        max_term = np.where(lead, st["term"], -1).max(axis=1, keepdims=True)
        return (lead & (st["term"] == max_term)).sum(axis=1)

    def leader_of(
        self, g: int, st: Optional[Dict[str, np.ndarray]] = None
    ) -> Optional[int]:
        """The live leader of group ``g`` with the highest term, if any.
        Pass a pre-read ``st`` when asking about many groups."""
        if st is None:
            st = self.np_state()
        lead = np.nonzero((st["role"][g] == LEADER) & st["alive"][g])[0]
        if len(lead) == 0:
            return None
        terms = st["term"][g][lead]
        return int(lead[np.argmax(terms)])

    def log_terms_of(
        self, g: int, p: int, st: Optional[Dict[str, np.ndarray]] = None
    ) -> Dict[int, int]:
        """Absolute index -> term for replica (g, p)'s ring window.
        Pass a pre-read ``st`` when reading many replicas."""
        if st is None:
            st = self.np_state()
        base, ln = int(st["base"][g, p]), int(st["log_len"][g, p])
        ring = st["log_term"][g, p]
        return {
            i: int(ring[i % self.cfg.L]) for i in range(base + 1, base + ln + 1)
        }

    def check_log_matching(self, g: int) -> None:
        """Safety: all replicas agree on terms up to their common window
        below min(commit) (Log Matching + State Machine Safety)."""
        st = self.np_state()
        floor = int(min(st["commit"][g]))
        views = [self.log_terms_of(g, p, st) for p in range(self.cfg.P)]
        for i in range(int(max(st["base"][g])) + 1, floor + 1):
            terms = {v[i] for v in views if i in v}
            assert len(terms) <= 1, (
                f"group {g}: index {i} has conflicting committed terms {terms}"
            )
