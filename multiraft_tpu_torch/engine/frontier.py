"""Shared scaffolding for services on the batched engine (PyTorch port
of ``multiraft_tpu/engine/frontier.py``).

Batched services (:class:`~multiraft_tpu_torch.engine.kv.BatchedKV`)
follow the same loop: advance the device tick, pop committed ``(group, index)`` payload
bindings in order and apply them, and periodically fail tickets whose
binding was truncated by a leader change (the batched analog of kvraft
waiters resolving ErrWrongLeader on term change,
reference: kvraft/server.go:98-128).  This base class owns that loop so
the sweep condition and eviction contract live in exactly one place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from .host import EngineDriver, PayloadSlice

__all__ = ["FrontierService"]


class FrontierService:
    """Applies the committed frontier of an :class:`EngineDriver` to a
    host-side state machine.  Subclasses implement ``_apply`` (one
    committed payload) and ``_on_evicted`` (a payload that lost its log
    slot and can never commit as bound), and may hook ``_post_pump``
    (runs after each frontier sweep — orchestration goes here)."""

    ORPHAN_SWEEP_TICKS = 64

    def __init__(self, driver: EngineDriver) -> None:
        self.driver = driver
        self.applied_upto = [0] * driver.cfg.G
        driver.on_payload_evicted = self._on_evicted
        self._sweep_countdown = self.ORPHAN_SWEEP_TICKS
        # Entries applied by the LAST pump's sweep — the serving pump
        # loops read it as their work-pending signal (adaptive pump
        # cadence: hot while traffic flows, idle interval otherwise).
        self.last_applied = 0
        # Split-group mode (engine/split.py): applied payloads are KEPT
        # so a lagging remote peer's resend can still ship them; the
        # peering GCs below the ring floor instead.  Default False: the
        # pop keeps host memory bounded under a sustained firehose.
        self.retain_payloads = False

    # -- subclass hooks ----------------------------------------------------

    def _apply(self, g: int, idx: int, payload: Any, now: int) -> None:
        raise NotImplementedError

    def _apply_slice(self, g: int, idx: int, sl: PayloadSlice, now: int) -> None:
        """Apply one bound firehose slice (``sl.count`` consecutive
        committed indices starting at ``idx``).  Services that accept
        firehose frames override with a bulk apply; the default keeps
        non-firehose services correct if a slice ever reaches them."""
        raise NotImplementedError(
            f"{type(self).__name__} does not accept firehose slices"
        )

    def _on_evicted(self, payload: Any) -> None:
        raise NotImplementedError

    def _post_pump(self) -> None:
        pass

    def _pre_sweep(self) -> None:
        """Runs between the device step and the apply sweep (split mode
        raises the device's host-paced applied frontier here)."""
        pass

    # -- checkpoint hooks (pair with EngineDriver.save/restore) -----------

    def state_dict(self) -> Dict[str, Any]:
        """Service state to checkpoint alongside the engine — pass as
        ``driver.save(path, extra=svc.state_dict())`` so both snapshot
        the same tick boundary.  Subclasses extend."""
        return {"applied_upto": list(self.applied_upto)}

    def load_state_dict(self, blob: Dict[str, Any]) -> None:
        self.applied_upto = list(blob["applied_upto"])

    # -- the loop ----------------------------------------------------------

    def pump(self, n_ticks: int = 1) -> None:
        """Advance the engine and apply the committed frontier
        (DeferredConsensus.pump)."""
        self.driver.step(n_ticks)
        self.after_step(n_ticks)

    def after_step(self, n_ticks: int = 1) -> None:
        """The host half of :meth:`pump`: everything after the engine
        advance — frontier sweep, apply, orphan sweep.  The pipelined
        serving loop calls this from ``complete_ticks`` handoff (the
        engine advance happened on dispatch), the synchronous path via
        :meth:`pump`.  Requires ``driver.last_metrics`` to reflect the
        ticks being accounted for (numpy: the driver reads its device
        values back once)."""
        self._pre_sweep()
        commit = np.asarray(self.driver.last_metrics["commit_index"])
        now = self.driver.tick
        applied = 0
        for g in range(self.driver.cfg.G):
            upto = int(commit[g])
            while self.applied_upto[g] < upto:
                idx = self.applied_upto[g] + 1
                # pop: an applied payload is never needed again (host
                # memory stays bounded under a sustained firehose) —
                # unless split-group resends still need it (see
                # retain_payloads above).
                if self.retain_payloads:
                    payload = self.driver.payloads.get((g, idx))
                else:
                    payload = self.driver.payloads.pop((g, idx), None)
                if isinstance(payload, PayloadSlice):
                    # Bulk path: the slice covers consecutive indices;
                    # apply the committed prefix whole and re-key any
                    # uncommitted tail at the split point.
                    assert not self.retain_payloads, (
                        "firehose slices are pop-applied; split-group "
                        "services (retain_payloads) have no firehose "
                        "surface"
                    )
                    avail = upto - idx + 1
                    if payload.count > avail:
                        tail_key = (g, idx + avail)
                        stale = self.driver.payloads.get(tail_key)
                        if stale is not None:
                            self._on_evicted(stale)
                        self.driver.payloads[tail_key] = payload
                        payload = payload.split_head(avail)
                    self._apply_slice(g, idx, payload, now)
                    self.applied_upto[g] = idx + payload.count - 1
                    applied += payload.count
                else:
                    self._apply(g, idx, payload, now)
                    self.applied_upto[g] = idx
                    applied += 1
        self.last_applied = applied
        self._post_pump()
        # Periodically fail bindings orphaned by log truncation (a
        # leader change can strand tail bindings that no future accept
        # will overwrite if the group goes quiet).
        self._sweep_countdown -= n_ticks
        if self._sweep_countdown <= 0:
            self._sweep_countdown = self.ORPHAN_SWEEP_TICKS
            self.sweep_orphans()

    def sweep_orphans(self) -> int:
        """Fail tickets whose bound (group, index) log entry no longer
        exists in the current leader's log — it was truncated by a
        leader change and can never commit as bound.  Returns the number
        of tickets failed.

        Slice-aware: a firehose slice wholly beyond the log end is
        evicted whole; one straddling it is truncated (the surviving
        prefix stays bound).  Stale bindings shadowed below the applied
        frontier (their slots were rewritten and applied through a
        fresher binding) are failed too, so their rows resolve promptly
        instead of waiting out the frame deadline."""
        if not self.driver.payloads:
            return 0
        st = self.driver.np_state()
        failed = 0
        last_cache: Dict[int, Optional[int]] = {}
        for (g, idx) in list(self.driver.payloads.keys()):
            if g not in last_cache:
                p = self.driver.leader_of(g)
                last_cache[g] = (
                    None
                    if p is None
                    else int(st["base"][g, p] + st["log_len"][g, p])
                )
            last = last_cache[g]
            payload = self.driver.payloads.get((g, idx))
            count = payload.count if isinstance(payload, PayloadSlice) else 1
            if (
                not self.retain_payloads
                and idx + count - 1 <= self.applied_upto[g]
            ):
                # Stale: the frontier passed this whole binding via a
                # fresher covering binding — these rows lost their
                # slots and can never apply as bound.  (Split-group
                # mode RETAINS applied payloads for peer resends —
                # below-frontier there is the normal state, not stale.)
                self._on_evicted(self.driver.payloads.pop((g, idx)))
                failed += 1
                continue
            if last is None:
                continue
            if idx > last:
                self._on_evicted(self.driver.payloads.pop((g, idx)))
                failed += 1
            elif idx + count - 1 > last:
                # Straddles the log end: fail the truncated tail only.
                keep = last - idx + 1
                tail = PayloadSlice(payload.frame, payload.rows[keep:])
                payload.rows = payload.rows[:keep]
                self._on_evicted(tail)
                failed += 1
        return failed
