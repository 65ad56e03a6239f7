"""The groups-sharded engine (PyTorch port of ``multiraft_tpu/engine/mesh.py``).

The groups axis is embarrassingly parallel: consensus traffic never
crosses a group boundary, so the engine splits its groups into ``n``
contiguous blocks, one per entry of a :class:`Mesh`, and advances each
block with its own tick on its own device.  The reference runs the tick
under ``jax.shard_map``; here each shard's tick is an ordinary call of
:func:`~.core.tick_impl` on that shard's tensors, and the semantics are
the reference's, shard for shard:

* every per-group plane (leading dim ``G``) is split; ``tick_no`` and the
  PRNG key are replicated;
* each shard ticks with the LOCAL config (``G // n`` groups) and the SAME
  key, so every shard draws the same ``[G/n, P]`` election jitter, and
  the tick's global predicates (the uniform-suffix flag) are evaluated
  per shard — which is what the reference's mesh does, and why a mesh
  driver is not value-identical to a one-device driver;
* scalar metrics come back as one lane per shard (``[1]`` each); hosts
  reduce them.  Per-group metrics stay per shard.

A shard's tick touches no tensor of another shard, copies nothing across
devices and never synchronises with the host: :func:`assert_zero_collectives`
checks all three on a live step (the counterpart of the reference's HLO
check for collectives).

Devices may repeat: ``Mesh(["cpu"] * 8)`` is the tests' 8-shard mesh on
the one CPU device, and ``Mesh(["cuda:0"] * 4)`` puts four shards on one
card — which exercises the partitioning, not multi-card scaling.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakTensorKeyDictionary

from ..utils import prng
from .core import (
    I32,
    METRIC_KEYS,
    TRACE_KEYS,
    EngineConfig,
    _trace_record,
    tick_impl,
)

__all__ = [
    "Mesh",
    "group_pspec",
    "local_config",
    "shard_plane",
    "shard_arrays",
    "gather_arrays",
    "make_sharded_tick",
    "make_sharded_run_ticks",
    "make_sharded_run_ticks_traced",
    "assert_zero_collectives",
    "reduce_scalar",
]

Device = Union[str, torch.device]


class Mesh:
    """An ordered tuple of devices on the one axis ``"groups"``; shard
    ``i`` lives on ``devices[i]``.  Devices may repeat."""

    def __init__(self, devices: Sequence[Device]) -> None:
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("Mesh: at least one device")
        self.devices = devs

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def local_config(cfg: EngineConfig, mesh: Mesh) -> EngineConfig:
    """The config one shard ticks with: ``G // n`` groups."""
    n = mesh.size
    if cfg.G % n != 0:
        raise ValueError(
            f"G={cfg.G} must divide evenly over {n} mesh devices"
        )
    return dataclasses.replace(cfg, G=cfg.G // n)


def group_pspec(cfg: EngineConfig, x: torch.Tensor) -> tuple:
    """The partition of one engine plane: ``("groups",)`` (split on its
    leading axis) iff that axis is the groups axis, else ``()``
    (replicated)."""
    return ("groups",) if x.dim() >= 1 and x.shape[0] == cfg.G else ()


def shard_plane(cfg: EngineConfig, mesh: Mesh, x: torch.Tensor) -> list:
    """One plane as one tensor per shard: a leading-``G`` plane in ``n``
    contiguous blocks, each copied to its device; any other plane
    (``tick_no``) replicated."""
    gl = local_config(cfg, mesh).G
    return [
        (x[i * gl:(i + 1) * gl] if group_pspec(cfg, x) else x).to(dev, copy=True)
        for i, dev in enumerate(mesh.devices)
    ]


def shard_arrays(cfg: EngineConfig, mesh: Mesh, tree) -> list:
    """Split a state or mailbox (a NamedTuple of tensors) into one value
    per shard (:func:`shard_plane` on each plane)."""
    parts = {k: shard_plane(cfg, mesh, v) for k, v in tree._asdict().items()}
    return [
        type(tree)(**{k: p[i] for k, p in parts.items()})
        for i in range(mesh.size)
    ]


def gather_arrays(shards: Sequence, device: Device):
    """The global value of per-shard states or mailboxes, on ``device``:
    sharded planes concatenated, replicated planes from shard 0."""
    first = shards[0]
    out = {}
    for k, v in first._asdict().items():
        if v.dim() == 0:
            out[k] = v.to(device)
        else:
            out[k] = torch.cat([getattr(s, k).to(device) for s in shards])
    return type(first)(**out)


class ShardedTick:
    """``step(shards, inboxes, new_cmds, key) -> (shards, outboxes,
    metrics)``: each shard's tick on its own tensors with the local
    config and the replicated key.  ``new_cmds`` is one ``i32[G/n]`` per
    shard.  ``metrics[k]`` is a list with one entry per shard: ``[1]``
    for the scalar keys, ``[G/n]`` for the per-group ones."""

    def __init__(self, cfg: EngineConfig, mesh: Mesh) -> None:
        self.cfg = cfg
        self.mesh = mesh
        self.lcfg = local_config(cfg, mesh)
        # Set by assert_zero_collectives for the one audited step.
        self._audit: Optional["_Audit"] = None

    def local(self, i: int, state, inbox, new_cmds, key):
        audit = self._audit
        if audit is not None:
            audit.enter(i, (state, inbox, new_cmds))
        try:
            st, mb, m = tick_impl(self.lcfg, state, inbox, new_cmds, key)
            m = {k: (v[None] if v.dim() == 0 else v) for k, v in m.items()}
        finally:
            if audit is not None:
                audit.leave()
        return st, mb, m

    def __call__(self, shards, inboxes, new_cmds, key):
        n = self.mesh.size
        if not (len(shards) == len(inboxes) == len(new_cmds) == n):
            raise ValueError(f"sharded tick: expected {n} shards")
        states, outboxes = [], []
        metrics: Dict[str, list] = {k: [] for k in METRIC_KEYS}
        for i in range(n):
            st, mb, m = self.local(i, shards[i], inboxes[i], new_cmds[i], key)
            states.append(st)
            outboxes.append(mb)
            for k in METRIC_KEYS:
                metrics[k].append(m[k])
        return states, outboxes, metrics


def make_sharded_tick(cfg: EngineConfig, mesh: Mesh) -> ShardedTick:
    """The full engine tick over the mesh: see :class:`ShardedTick`.
    ``G % n != 0`` raises ``ValueError``."""
    return ShardedTick(cfg, mesh)


def _full_cmds(lcfg: EngineConfig, mesh: Mesh, ingest_per_tick: int) -> list:
    return [
        torch.full((lcfg.G,), ingest_per_tick, dtype=I32, device=dev)
        for dev in mesh.devices
    ]


def make_sharded_run_ticks(
    cfg: EngineConfig, mesh: Mesh, n_ticks: int, ingest_per_tick: int
) -> Callable:
    """The multi-tick loop (the bench path) over the mesh: each shard
    runs ``n_ticks`` local ticks, tick ``i`` keyed ``fold_in(key, i)``,
    under a constant firehose.  Returns ``run(shards, inboxes, key) ->
    (shards, inboxes)``."""
    tick = ShardedTick(cfg, mesh)

    def run(shards, inboxes, key):
        cmds = _full_cmds(tick.lcfg, mesh, ingest_per_tick)
        for i in range(n_ticks):
            shards, inboxes, _ = tick(shards, inboxes, cmds, prng.fold_in(key, i))
        return shards, inboxes

    run.sharded_tick = tick
    return run


def make_sharded_run_ticks_traced(
    cfg: EngineConfig, mesh: Mesh, n_ticks: int, ingest_per_tick: int
) -> Callable:
    """:func:`make_sharded_run_ticks` plus each shard's per-tick
    ``TRACE_KEYS`` record (``run_ticks_traced``'s).  Returns
    ``run(shards, inboxes, key) -> (shards, inboxes, recs)`` where
    ``recs[k]`` holds one ``i32[n_ticks, G/n]`` per shard: the groups
    axis of the global ``[n_ticks, G]`` record."""
    tick = ShardedTick(cfg, mesh)

    def run(shards, inboxes, key):
        cmds = _full_cmds(tick.lcfg, mesh, ingest_per_tick)
        per_tick: List[List[dict]] = [[] for _ in mesh.devices]
        for i in range(n_ticks):
            shards, inboxes, m = tick(shards, inboxes, cmds, prng.fold_in(key, i))
            for s, rs in enumerate(per_tick):
                rs.append(_trace_record({k: v[s] for k, v in m.items()}))
        recs = {
            key_: [torch.stack([r[key_] for r in rs]) for rs in per_tick]
            for key_ in TRACE_KEYS
        }
        return shards, inboxes, recs

    run.sharded_tick = tick
    return run


# ---------------------------------------------------------------------------
# The zero-collective check
# ---------------------------------------------------------------------------

# Ops that read a device value back to the host (or size an output by
# one): each is a synchronisation a tick must not make.
_HOST_SYNCS = frozenset({
    "aten::_local_scalar_dense",
    "aten::item",
    "aten::is_nonzero",
    "aten::equal",
    "aten::nonzero",
    "aten::masked_select",
    "aten::unique_consecutive",
    "aten::_unique2",
    "aten::unique_dim",
    "aten::bincount",
    "aten::repeat_interleave",
})
_COPIES = frozenset({
    "aten::_to_copy", "aten::copy_", "aten::_copy_from",
    "aten::_copy_from_and_resize",
})


class CollectiveError(AssertionError):
    """A shard's tick reached outside its shard."""


def _tensors(tree) -> list:
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    return out


class _Audit(TorchDispatchMode):
    """Tags every tensor with the shard it belongs to and fails on an op
    inside shard ``i`` that touches another shard's tensor, copies across
    devices, or syncs with the host."""

    def __init__(self) -> None:
        super().__init__()
        self.owner = WeakTensorKeyDictionary()
        self.shard: Optional[int] = None
        self.ops = 0

    def tag(self, i: int, tree) -> None:
        for t in _tensors(tree):
            self.owner[t] = i

    def enter(self, i: int, inputs) -> None:
        self.tag(i, inputs)
        self.shard = i

    def leave(self) -> None:
        self.shard = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        i = self.shard
        if i is not None:
            self.ops += 1
            name = func._schema.name
            if name in _HOST_SYNCS:
                raise CollectiveError(
                    f"shard {i}: {func} synchronises with the host"
                )
            ins = _tensors((args, kwargs))
            for t in ins:
                j = self.owner.get(t)
                if j is not None and j != i:
                    raise CollectiveError(
                        f"shard {i}: {func} reads a tensor of shard {j}"
                    )
            if name in _COPIES and ins:
                if name == "aten::_to_copy":
                    src = ins[0].device
                    dst = torch.device(kwargs.get("device") or src)
                else:  # copy_(dst, src) and the _copy_from forms
                    dst = ins[0].device
                    src = ins[1].device if len(ins) > 1 else dst
                if dst != src:
                    raise CollectiveError(
                        f"shard {i}: {func} copies {src} -> {dst}"
                    )
        out = func(*args, **kwargs)
        if i is not None:
            self.tag(i, out)
        return out


def assert_zero_collectives(step: Any, *example) -> int:
    """Run ``step(*example)`` once (a :class:`ShardedTick`, or a run
    function from ``make_sharded_run_ticks*``) and fail if any op inside
    a shard's tick touches a tensor of another shard, copies across
    devices, or synchronises with the host.  Returns the number of ops
    the shards dispatched.  The step's outputs are discarded."""
    tick = getattr(step, "sharded_tick", step)
    if not isinstance(tick, ShardedTick):
        raise TypeError("assert_zero_collectives: not a sharded step")
    audit = _Audit()
    tick._audit = audit
    try:
        with audit:
            step(*example)
    finally:
        tick._audit = None
    if audit.ops == 0:
        raise CollectiveError("assert_zero_collectives: no shard op ran")
    return audit.ops


def reduce_scalar(key: str, lanes) -> int:
    """A scalar metric from its per-shard lanes, on the host: ``max``
    for ``max_term``, the sum for the others."""
    vals = [int(v) for v in lanes]
    return max(vals) if key == "max_term" else sum(vals)
