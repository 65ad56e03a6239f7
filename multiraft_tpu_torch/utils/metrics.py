"""Named counters for the PyTorch engine driver.

The subset of the reference registry (``multiraft_tpu/utils/metrics.py``)
that :class:`~multiraft_tpu_torch.engine.host.EngineDriver` touches: the
driver counts ``ticks`` here.  Latency histograms and sample reservoirs
arrive with the tracer spans in a later slice.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

__all__ = ["Metrics"]


class Metrics:
    """Named integer counters."""

    def __init__(self) -> None:
        self.counters: Dict[str, int] = defaultdict(int)

    def inc(self, name: str, by: int = 1) -> None:
        self.counters[name] += by

    def snapshot(self) -> Dict[str, int]:
        return dict(self.counters)
