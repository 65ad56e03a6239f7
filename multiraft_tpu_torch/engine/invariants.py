"""Raft safety-invariant monitor for the batched engine (PyTorch port
of ``multiraft_tpu/engine/invariants.py``).

Because the entire cluster state is two host readbacks away, a monitor
can assert the four Raft safety properties on every tick, under
arbitrary fault schedules:

* **Election safety** — at most one leader per (group, term), ever.
* **Committed-term durability** (Leader Completeness + State Machine
  Safety) — the first time any replica commits index *i*, the term of
  *i* is recorded; no replica may ever commit a different term at *i*.
* **Log Matching** — if two replicas hold the same term at index *i*,
  their logs are identical at every index ≤ *i* both hold (Raft §5.3).
* **Monotonicity** — ``term`` never decreases (persistent state);
  ``commit`` never decreases while a replica stays up (it may lawfully
  rewind to the snapshot floor across a crash/restart, which the
  monitor is told about via :meth:`note_restart`).

The checks are plain Python over :meth:`EngineDriver.np_state`, so one
observe costs O(G·P·L) host work: at thousands of groups, observe every
few dozen ticks rather than every tick (the invariants are stable under
sampling).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .core import LEADER
from .host import EngineDriver

__all__ = ["InvariantMonitor"]


class InvariantMonitor:
    """Cross-tick safety monitor over an :class:`EngineDriver`.

    Call :meth:`observe` after every tick (or batch of ticks — the
    invariants are stable under sampling, but per-tick catches
    violations at their first observable state).  Raises
    ``AssertionError`` with a precise diagnosis on any violation.
    """

    def __init__(self, driver: EngineDriver) -> None:
        self.d = driver
        G, P = driver.cfg.G, driver.cfg.P
        # (group, term) -> leader replica id.
        self.leader_of_term: Dict[Tuple[int, int], int] = {}
        # (group, index) -> term committed there (write-once).
        self.committed_term: Dict[Tuple[int, int], int] = {}
        self.prev_term = np.zeros((G, P), np.int64)
        self.prev_commit = np.zeros((G, P), np.int64)
        # Replicas restarted since the last observe(), mapped to their
        # snapshot floor at restart time: commit may rewind, but never
        # below that floor.
        self._restarted: Dict[Tuple[int, int], int] = {}

    def note_restart(self, g: int, p: int) -> None:
        self._restarted[(g, p)] = int(self.d.state.base[g, p])

    def prune_below_snapshot_floor(self) -> int:
        """Drop committed-term records below each group's cluster-wide
        snapshot floor (min ``base`` over replicas): no replica still
        holds those ring slots, so the records can never be re-checked.
        Bounds memory for soak-length runs; returns entries dropped."""
        base = self.d.state.base.detach().cpu().numpy()
        floor = base.min(axis=1)  # [G]
        before = len(self.committed_term)
        self.committed_term = {
            (g, i): t
            for (g, i), t in self.committed_term.items()
            if i > floor[g]
        }
        return before - len(self.committed_term)

    # -- the four checks ---------------------------------------------------

    def observe(self, st=None) -> None:
        """``st``: optionally pass a pre-fetched :meth:`EngineDriver.
        np_state` dict to avoid a second device→host sync when the
        caller already read the state this tick."""
        if st is None:
            st = self.d.np_state()
        cfg = self.d.cfg
        term = st["term"].astype(np.int64)
        commit = st["commit"].astype(np.int64)
        self._check_election_safety(st)
        self._check_monotonicity(term, commit)
        views = [
            [self.d.log_terms_of(g, p, st) for p in range(cfg.P)]
            for g in range(cfg.G)
        ]
        self._check_committed_terms(st, views)
        self._check_log_matching(st, views)
        self.prev_term = term
        self.prev_commit = commit
        self._restarted.clear()

    def _check_election_safety(self, st) -> None:
        lead = (st["role"] == LEADER) & st["alive"]
        for g, p in zip(*np.nonzero(lead)):
            t = int(st["term"][g, p])
            prev = self.leader_of_term.setdefault((int(g), t), int(p))
            assert prev == int(p), (
                f"election safety: group {g} term {t} has two leaders "
                f"{prev} and {p}"
            )

    def _check_monotonicity(self, term, commit) -> None:
        bad_t = term < self.prev_term
        assert not bad_t.any(), (
            f"term rewound at {np.argwhere(bad_t).tolist()} "
            f"({self.prev_term[bad_t]} -> {term[bad_t]})"
        )
        bad_c = commit < self.prev_commit
        for g, p in np.argwhere(bad_c):
            floor = self._restarted.get((int(g), int(p)))
            assert floor is not None, (
                f"commit rewound at ({g},{p}) without a restart: "
                f"{self.prev_commit[g, p]} -> {commit[g, p]}"
            )
            assert commit[g, p] >= floor, (
                f"restart rewound commit at ({g},{p}) below its snapshot "
                f"floor {floor}: -> {commit[g, p]}"
            )

    def _check_committed_terms(self, st, views) -> None:
        cfg = self.d.cfg
        for g in range(cfg.G):
            for p in range(cfg.P):
                c = int(st["commit"][g, p])
                base = int(st["base"][g, p])
                v = views[g][p]
                # A replica's own window always covers (base, last];
                # commit past the log end is never legal.
                assert c <= base + int(st["log_len"][g, p]), (
                    f"commit past log end at ({g},{p}): commit {c}, "
                    f"window (base {base}, len {int(st['log_len'][g, p])})"
                )
                for i in range(base + 1, c + 1):
                    t = v[i]
                    rec = self.committed_term.setdefault((g, i), t)
                    assert rec == t, (
                        f"state-machine safety: group {g} index {i} "
                        f"committed term {rec}, but replica {p} has "
                        f"committed term {t}"
                    )

    def _check_log_matching(self, st, views) -> None:
        cfg = self.d.cfg
        for g in range(cfg.G):
            for a in range(cfg.P):
                for b in range(a + 1, cfg.P):
                    va, vb = views[g][a], views[g][b]
                    shared = sorted(set(va) & set(vb), reverse=True)
                    # Highest shared index with equal terms pins the
                    # whole shared prefix below it (Raft §5.3).
                    for i in shared:
                        if va[i] == vb[i]:
                            for j in shared:
                                if j <= i:
                                    assert va[j] == vb[j], (
                                        f"log matching: group {g} "
                                        f"replicas {a}/{b} agree at "
                                        f"{i} (term {va[i]}) but differ "
                                        f"at {j}: {va[j]} vs {vb[j]}"
                                    )
                            break
