"""Host-side driver for the batched engine (PyTorch port of
``multiraft_tpu/engine/host.py``).

Owns the tick loop: feeds the outbox back as the next inbox through the
tensorized fault model (drop masks, per-edge partitions, liveness),
maintains the Start() backlog and the host-side payload store keyed
``(group, index)`` (the device only orders terms and indices), and
accumulates metrics.

The driver runs on one device, named at construction: ``device=None``
means ``"cuda"``, and a driver asked for a card that is not there
raises instead of carrying on on the CPU.  The PRNG key stays on the
host, so per-tick key derivation costs no device launch; device values
reach the host only through :attr:`EngineDriver.last_metrics`,
:meth:`EngineDriver.np_state` and the fused batches' fetch, and each
returns numpy.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..utils import prng
from ..utils.knobs import knob_bool
from ..utils.metrics import Metrics
from .core import (
    LEADER,
    EngineConfig,
    EngineState,
    Mailbox,
    empty_mailbox,
    init_state,
    tick_impl,
)

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


def mask_active(mb: Mailbox, fn) -> Mailbox:
    """Apply ``fn(field_name, bool_tensor) -> bool_tensor`` over every
    ``*_active`` channel of the mailbox."""
    return mb._replace(**{k: fn(k, getattr(mb, k)) for k in _ACTIVE_FIELDS})


def apply_faults(
    mailbox: Mailbox, key: torch.Tensor, drop_prob: float, cfg: EngineConfig
) -> Mailbox:
    """Drop each in-flight message independently with ``drop_prob``:
    one uniform draw per channel from ``split(key, 4)``, compared in
    float32 as the reference does."""
    shape = (cfg.G, cfg.P, cfg.P)
    keys = prng.split(key, len(_ACTIVE_FIELDS))
    p = float(np.float32(drop_prob))

    def drop(name, a):
        k = keys[_ACTIVE_FIELDS.index(name)]
        return a & (prng.uniform(k, shape, a.device) >= p)

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


class EngineDriver:
    def __init__(
        self,
        cfg: EngineConfig,
        seed: int = 0,
        device: Union[None, str, torch.device] = None,
    ) -> None:
        self.device = resolve_device(device)
        self._init_host(cfg, seed)
        self.state: EngineState = init_state(
            cfg, prng.fold_in(self.key, 0), self.device
        )
        self.inbox: Mailbox = empty_mailbox(cfg, self.device)

    def _init_host(self, cfg: EngineConfig, seed: int) -> None:
        self.cfg = cfg
        self.key = prng.PRNGKey(seed)  # host-resident uint32[2]
        self.drop_prob = 0.0
        # Per-edge enables [G, src, dst] (labrpc per-ClientEnd enable);
        # a partitioned replica stays live but no message crosses a
        # disabled edge.  ``replica_conn`` is partition_replica's view.
        self.edge_up = np.ones((cfg.G, cfg.P, cfg.P), bool)
        self.replica_conn = np.ones((cfg.G, cfg.P), bool)
        self._edge_dev: Optional[torch.Tensor] = None  # lazy device copy
        # Reorder chaos is not ported yet: kept at its off values so
        # fused_eligible reads as the reference's does.
        self.reorder_prob = 0.0
        self._delayed: list = []
        self.total_commits = 0
        self.backlog = np.zeros(cfg.G, np.int64)  # pending Start()s
        # Host-side payloads: (group, index) -> command.
        self.payloads: Dict[tuple, Any] = {}
        self._pending_payloads: Dict[int, list] = defaultdict(list)
        # Per-group bind high-water mark (see _bind_accepted).
        self._max_bound: Dict[int, int] = {}
        self._last_metrics: Dict[str, Any] = {}
        self._commits_dev: Any = 0
        self.metrics = Metrics()
        self.tick = 0  # host mirror of the device tick counter
        # Called with the old payload when a (group, index) binding is
        # overwritten (the command lost its slot to a leader change).
        self.on_payload_evicted: Optional[Any] = None
        # Called as (g, idx, term) when a payload binds at ingest.
        self.on_payload_bound: Optional[Any] = None
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
        if any(isinstance(v, torch.Tensor) for v in m.values()):
            m = self._last_metrics = {k: _np(v) for k, v in m.items()}
        return m

    @last_metrics.setter
    def last_metrics(self, m: Dict[str, Any]) -> None:
        self._last_metrics = m

    # -- fault injection --------------------------------------------------

    def set_alive(self, g: int, p: int, alive: bool) -> None:
        """Crash (or revive) replica (g, p): the mask form of labrpc's
        per-server disable."""
        a = self.state.alive.clone()
        a[g, p] = bool(alive)
        self.state = self.state._replace(alive=a)

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
        """In-flight messages on now-disabled edges die immediately."""
        self._edge_dev = None
        if not self.edge_up.all():
            self.inbox = self._mask_partitions(self.inbox)

    def _edge_mask(self) -> torch.Tensor:
        if self._edge_dev is None:
            # A copy: edge_up is mutable host state.
            self._edge_dev = torch.tensor(self.edge_up, device=self.device)
        return self._edge_dev

    def _mask_partitions(self, mb: Mailbox) -> Mailbox:
        m = self._edge_mask()
        return mask_active(mb, lambda _, a: a & m)

    # -- Start() ----------------------------------------------------------

    def start(self, g: int, command: Any = None) -> None:
        """Queue a command for group g."""
        self.backlog[g] += 1
        self._pending_payloads[g].append(command)

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
        """True when the fused path may run: pipeline enabled and no
        reorder chaos active or held."""
        return (
            self._pipeline_on
            and self.reorder_prob == 0.0
            and not self._delayed
        )

    def _step_serial(self, n: int = 1) -> Dict[str, Any]:
        assert not self._inflight, (
            "serial step with fused tick batches in flight — complete "
            "them first, or the two tick streams interleave"
        )
        cfg = self.cfg
        self.metrics.inc("ticks", n)
        for _ in range(n):
            self.tick += 1
            tick_key = prng.fold_in(self.key, self.tick)
            have_backlog = bool(self.backlog.any())
            if have_backlog:
                new_cmds = torch.tensor(
                    np.minimum(self.backlog, cfg.INGEST).astype(np.int32),
                    device=self.device,
                )
            else:
                new_cmds = torch.zeros(
                    cfg.G, dtype=torch.int32, device=self.device
                )
            state, outbox, metrics = tick_impl(
                cfg, self.state, self.inbox, new_cmds, tick_key
            )
            if self.drop_prob > 0.0:
                outbox = apply_faults(
                    outbox, prng.fold_in(tick_key, 0xFA), self.drop_prob, cfg
                )
            if not self.edge_up.all():
                outbox = self._mask_partitions(outbox)
            self.state, self.inbox = state, outbox
            if have_backlog:
                # Host sync only while commands are in flight.
                accepted = _np(metrics["accepted"])
                starts = _np(metrics["start_index"])
                terms = (
                    _np(metrics["accept_term"])
                    if self.on_payload_bound else None
                )
                for g in np.nonzero(accepted)[0]:
                    k = int(accepted[g])
                    self.backlog[g] -= k
                    self._bind_accepted(
                        int(g), k, int(starts[g]),
                        int(terms[g]) if terms is not None else None,
                    )
            # Accumulate on device; converted lazily by readers.
            self._commits_dev = self._commits_dev + metrics["commits"]
            self.last_metrics = metrics
        return self.last_metrics

    # -- fused pipeline (engine/pipeline.py) ------------------------------

    def dispatch_ticks(self, n: int):
        """Enqueue a fused ``n``-tick batch on the device without waiting
        for it.  The host tick counter and state/inbox advance now;
        payload binding and backlog bookkeeping wait for
        :meth:`complete_ticks` with the fetched record."""
        from .pipeline import PendingTicks, step_ticks

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
        )
        self._inflight.append(pending)
        return pending

    def complete_ticks(self, pending, host_rec) -> Dict[str, Any]:
        """Fold a fetched batch back into host bookkeeping: per-tick
        backlog decrements and payload binding replayed in tick order,
        the commit accumulator and last_metrics.  Must run in dispatch
        order."""
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
        return self.last_metrics

    @property
    def commits_total(self) -> int:
        return int(self._commits_dev) + self.total_commits

    def run_until_quiet_leaders(self, max_ticks: int = 500) -> bool:
        """Advance until every group has exactly one live leader."""
        stride = 5  # check every few ticks: readbacks are host syncs
        for _ in range(0, max_ticks, stride):
            self.step(stride)
            if self.leaders_per_group().min() >= 1:
                if self.leaders_at_max_term_per_group().max() <= 1:
                    return True
        return False

    # -- inspection (host readbacks) ------------------------------------

    def np_state(self) -> Dict[str, np.ndarray]:
        return {k: _np(v) for k, v in self.state._asdict().items()}

    def leaders_per_group(self) -> np.ndarray:
        st = self.np_state()
        return ((st["role"] == LEADER) & st["alive"]).sum(axis=1)

    def leaders_at_max_term_per_group(self) -> np.ndarray:
        st = self.np_state()
        lead = (st["role"] == LEADER) & st["alive"]
        # Leaders are unique per *term*; count leaders in the max term.
        max_term = np.where(lead, st["term"], -1).max(axis=1, keepdims=True)
        return (lead & (st["term"] == max_term)).sum(axis=1)

    def leader_of(self, g: int) -> Optional[int]:
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
