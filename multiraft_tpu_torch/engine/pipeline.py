"""Fused multi-tick stepping for the serving path (PyTorch port of
``multiraft_tpu/engine/pipeline.py``).

The serial :meth:`EngineDriver.step` loop syncs with the host twice per
tick while commands are in flight: the backlog clip that builds
``new_cmds`` goes up, the accepted/starts/terms record comes down.
:func:`step_ticks` enqueues ``n`` ticks back to back instead, carrying
the backlog decrement on the device (``new_cmds`` is recomputed per
tick from the carried backlog, so accepted commands are never
re-ingested) and stacking the per-tick metrics, so the host syncs once
per batch and replays the payload binding from the stacked record.  The
drop and partition masks ride inside the loop with the same keys as the
serial loop, so a faulted run fuses to the same result.

The reference runs the batch as one jitted ``lax.scan``; here it is a
Python loop that only enqueues device work: no value is read back
inside it, so the host returns as soon as the launches are queued.
Results are identical to ``n`` serial steps (the same per-tick keys
``fold_in(key, tick0 + 1 + i)``, the same ingest clip, the same
decrement order).

:class:`PendingTicks` is the dispatch/complete split on top of it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..utils import prng
from .core import EngineConfig, EngineState, Mailbox, tick_impl
from .host import apply_faults, mask_active

__all__ = ["step_ticks", "PendingTicks"]


def step_ticks(
    cfg: EngineConfig,
    state: EngineState,
    inbox: Mailbox,
    n_ticks: int,
    drop_prob: Optional[float],  # None: no drops
    edge_mask: Optional[torch.Tensor],  # bool[G,P,P]; None: no partitions
    backlog: torch.Tensor,  # i32[G]: host backlog (clipped), carried
    tick0: int,  # host tick BEFORE this batch
    key: torch.Tensor,
):
    """``n_ticks`` consensus rounds enqueued back to back, with the
    backlog carried on the device and every per-tick metric stacked
    (``rec[k]`` has a leading ``[n_ticks]`` axis).

    Returns ``(state, inbox, backlog_left, rec)``."""
    ms = []
    for i in range(n_ticks):
        # Tick i of this batch is host tick tick0 + 1 + i.
        tick_key = prng.fold_in(key, tick0 + 1 + i)
        new_cmds = backlog.clamp(max=cfg.INGEST)
        state, inbox, m = tick_impl(cfg, state, inbox, new_cmds, tick_key)
        if drop_prob is not None:
            inbox = apply_faults(
                inbox, prng.fold_in(tick_key, 0xFA), drop_prob, cfg
            )
        if edge_mask is not None:
            inbox = mask_active(inbox, lambda _, a: a & edge_mask)
        backlog = backlog - m["accepted"]
        ms.append(m)
    rec = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
    return state, inbox, backlog, rec


class PendingTicks:
    """A dispatched, not-yet-completed fused tick batch.

    :meth:`fetch` blocks until the stacked metrics are on the host; it
    touches no driver state, so it is safe off the owning thread.  The
    result then goes back to :meth:`EngineDriver.complete_ticks`.
    ``accepts_dev`` stays on the device: later dispatches subtract it
    from the host backlog so an in-flight batch's accepted commands are
    never ingested twice.  Nothing writes ``rec`` or ``accepts_dev`` in
    place.
    """

    __slots__ = (
        "n", "tick0", "rec", "accepts_dev", "t_dispatch", "t_loop_cpu",
    )

    def __init__(
        self,
        n: int,
        tick0: int,
        rec: Dict[str, torch.Tensor],
        accepts_dev: torch.Tensor,
        t_dispatch: float,
    ) -> None:
        self.n = n
        self.tick0 = tick0
        self.rec = rec
        self.accepts_dev = accepts_dev
        # Host wall clock (perf_counter) when the batch was dispatched:
        # the tracer spreads the batch's wall time over its ticks.
        self.t_dispatch = t_dispatch
        # Loop-side CPU the dispatch burned (the serving loop's share
        # of this pump; completion adds its own) — set by the caller.
        self.t_loop_cpu = 0.0

    def fetch(self) -> Dict[str, np.ndarray]:
        """Block until the batch's stacked metrics are host-resident."""
        return {k: v.cpu().numpy() for k, v in self.rec.items()}
