"""The one traffic generator: a mix is a JSON file of parameters under
``cellbench/traffic/``, read by :func:`load`; the functions below turn
it, a configuration's group count and ``--seed`` into the run's inputs.

Keys of a mix file:

* ``ingest``: ``{"hot_share", "hot", "cold"}`` -- the first
  ``hot_share`` of the groups offer ``hot`` Start() commands a tick, the
  rest ``cold`` (the skew vector of ``run_config5`` in
  ``multiraft_tpu_torch/bench.py`` at commit 73b8d79);
* ``events``: ``null``, or ``{"module": <name>, ...}`` -- the events
  between ticks, made by ``cellbench/events/<name>.py`` from the other
  keys (see :mod:`cellbench.events`);
* ``kills``: ``null``, or ``{"share", "every_ticks"}`` -- the same as
  ``"events": {"module": "leader_kills", "share": ..., "every_ticks":
  ...}``: every ``every_ticks`` ticks the leaders of a fresh ``share`` of
  the groups, drawn without replacement, are killed and the previous
  victims revived (the victim choice of ``run_config5``);
* ``boot_ticks``: ticks without ingest that elect the first leaders;
* ``fill_ticks``: loaded ticks before the window (with events, one round
  whose effects the window's first round may undo);
* ``drain_ticks``: loaded ticks after the window, without new events, in
  which the window's last victims may still recover.
* ``source``, optional: where the mix's rates come from, as text.

The failure count of a mix (:class:`Count`) is a file of its own,
``cellbench/counts/<mix>.json``.

Every seed gets the same sizes, rates and event counts; the seed moves
the election timers, the events' rows and the sampled groups.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np

SAMPLE_GROUPS = 64  # groups the reference replays


@dataclass(frozen=True)
class Mix:
    hot_share: float
    hot: int
    cold: int
    events: Optional[str]  # the event module's name; None: no events
    boot_ticks: int
    fill_ticks: int
    drain_ticks: int
    event_params: dict = field(default_factory=dict)


def load(path: Path) -> Mix:
    d = json.loads(Path(path).read_text())
    ing = d["ingest"]
    events, params = None, {}
    if d.get("events"):
        params = dict(d["events"])
        events = params.pop("module")
    elif d.get("kills"):
        events, params = "leader_kills", dict(d["kills"])
    return Mix(
        hot_share=float(ing["hot_share"]), hot=int(ing["hot"]),
        cold=int(ing["cold"]), events=events, event_params=params,
        boot_ticks=int(d["boot_ticks"]), fill_ticks=int(d["fill_ticks"]),
        drain_ticks=int(d["drain_ticks"]),
    )


@dataclass(frozen=True)
class Count:
    """The span over which a run counts ``attempted`` and ``failed``: the
    entries accepted, and the event rounds begun, in the window's first
    ``window_ticks`` ticks, each judged by the records at the end of
    window tick ``window_ticks + outcome_ticks - 1``.  Both ends lie in
    the window, whose events are a function of the tick's number alone,
    so the count does not depend on how many ticks the window held."""

    window_ticks: int
    outcome_ticks: int

    @property
    def ticks(self) -> int:
        """Window ticks the whole count needs."""
        return self.window_ticks + self.outcome_ticks

    @classmethod
    def load(cls, path: Path) -> "Count":
        d = json.loads(Path(path).read_text())
        return cls(window_ticks=int(d["window_ticks"]), outcome_ticks=int(d["outcome_ticks"]))


def key_seed(seed: int) -> int:
    """The engine's int32 PRNG seed drawn from ``--seed`` (any size)."""
    return int(np.random.default_rng([seed % 2**64, 0]).integers(0, 2**31))


def ingest(mix: Mix, G: int) -> np.ndarray:
    """int32[G]: Start() commands each group offers a tick."""
    v = np.full(G, mix.cold, np.int32)
    v[: int(G * mix.hot_share)] = mix.hot
    return v


def hot_groups(mix: Mix, G: int) -> int:
    return int(G * mix.hot_share) if mix.hot != mix.cold else 0


class Victims:
    """A fresh ``share`` of the ``G`` groups for each round, drawn without
    replacement in round order from the seed, so that round ``r``'s rows
    do not depend on how many rounds a window holds.  Round 0 is the
    fill's; round ``r >= 1`` is at window tick ``(r - 1) * every_ticks``."""

    def __init__(self, share: float, G: int, seed: int) -> None:
        self.n = max(1, int(G * share))
        self.G = G
        self._rng = np.random.default_rng([seed % 2**64, 1])
        self._rounds: List[np.ndarray] = []

    def round(self, r: int) -> np.ndarray:
        while len(self._rounds) <= r:
            self._rounds.append(np.sort(
                self._rng.choice(self.G, size=self.n, replace=False)))
        return self._rounds[r]


def sample(mix: Mix, G: int, seed: int, events=None,
           n: int = SAMPLE_GROUPS) -> np.ndarray:
    """int64[<=n]: the groups the reference replays, drawn from the seed:
    with events, half among the rows of the fill's and the window's first
    two rounds (``events.rows``); the rest split between hot and cold
    groups."""
    rng = np.random.default_rng([seed % 2**64, 2])
    n = min(n, G)
    picked: set = set()
    if events is not None:
        pool = np.unique(np.concatenate([events.rows(r) for r in range(3)]))
        picked.update(rng.choice(pool, size=min(n // 2, len(pool)),
                                 replace=False).tolist())
    hot = hot_groups(mix, G)
    classes = [np.arange(hot), np.arange(hot, G)] if hot else [np.arange(G)]
    left = n - len(picked)
    for i, pool in enumerate(classes):
        want = left // len(classes) + (1 if i < left % len(classes) else 0)
        pool = np.setdiff1d(pool, np.fromiter(picked, np.int64, len(picked)))
        picked.update(rng.choice(pool, size=min(want, len(pool)),
                                 replace=False).tolist())
    return np.sort(np.fromiter(picked, np.int64, len(picked)))
