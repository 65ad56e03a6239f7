"""Affinity-aware CPU counting for the single-core accommodations."""

from __future__ import annotations

import os

__all__ = ["usable_cpus"]


def usable_cpus() -> int:
    """CPUs actually available to THIS process — the affinity mask
    (cgroup/taskset-aware), not the host core count: a process pinned
    to one core of a 64-core host must take the single-CPU paths
    (transport spin off, hot pump off) or it steals its co-located
    peers' only core."""
    try:
        return len(os.sched_getaffinity(0)) or 1
    except (AttributeError, OSError):  # non-Linux fallback
        return os.cpu_count() or 1
