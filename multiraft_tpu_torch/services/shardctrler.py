"""The shard controller's configuration record and rebalancer (a copy of
what the sharded engine needs from ``multiraft_tpu/services/
shardctrler.py``; the replicated controller server and its clerk are
not part of this package).

``rebalance`` runs inside the replicated apply path, so every replica
must compute the identical assignment: its tie-breaks are the
reference's, unchanged (reference: shardctrler/common.go:53-132).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List

__all__ = [
    "NSHARDS",
    "Config",
    "rebalance",
    "QUERY",
    "JOIN",
    "LEAVE",
    "MOVE",
]


def _nshards() -> int:
    """``MULTIRAFT_NSHARDS`` read as the reference reads it: a set,
    non-empty value is parsed as a float and truncated, else 10
    (reference: shardctrler/common.go:23)."""
    raw = os.environ.get("MULTIRAFT_NSHARDS")
    return int(float(raw)) if raw else 10


NSHARDS = _nshards()

QUERY = "Query"
JOIN = "Join"
LEAVE = "Leave"
MOVE = "Move"


@dataclasses.dataclass
class Config:
    """(reference: shardctrler/common.go:27-31)"""

    num: int = 0
    shards: List[int] = dataclasses.field(
        default_factory=lambda: [0] * NSHARDS
    )
    groups: Dict[int, List[str]] = dataclasses.field(default_factory=dict)

    def clone(self) -> "Config":
        return Config(
            num=self.num,
            shards=list(self.shards),
            groups={g: list(s) for g, s in self.groups.items()},
        )


def rebalance(shards: List[int], groups: Dict[int, List[str]]) -> List[int]:
    """Minimal-movement shard rebalance
    (reference: shardctrler/common.go:53-132).

    1. Shards owned by departed/unknown groups go to the least-loaded
       group.
    2. While the load spread exceeds 1, move one shard from the most-
       to the least-loaded group.

    Deterministic tie-breaks (sorted gids) because this runs inside the
    replicated apply path on every replica."""
    if not groups:
        return [0] * NSHARDS
    counts = {gid: 0 for gid in sorted(groups)}
    out = list(shards)
    for s, g in enumerate(out):
        if g in counts:
            counts[g] += 1
        else:
            out[s] = 0

    def min_gid() -> int:
        return min(counts, key=lambda g: (counts[g], g))

    def max_gid() -> int:
        return max(counts, key=lambda g: (counts[g], -g))

    for s in range(NSHARDS):
        if out[s] == 0:
            g = min_gid()
            out[s] = g
            counts[g] += 1
    while True:
        mx, mn = max_gid(), min_gid()
        if counts[mx] - counts[mn] <= 1:
            break
        for s in range(NSHARDS):
            if out[s] == mx:
                out[s] = mn
                counts[mx] -= 1
                counts[mn] += 1
                break
    return out
