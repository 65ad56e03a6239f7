"""The environment knobs the PyTorch port reads.

A subset of the reference package's typed ``MRT_*`` registry
(``multiraft_tpu/utils/knobs.py``): every knob a module of this package
reads, with the reference's name, type and default, read with the same
semantics.  The port declares no knob of its own.

* ``bool`` — set-and-not-falsey is ON; ``"" / 0 / false / no / off``
  (case-insensitive) are OFF; unset means the declared default.
* ``int`` / ``float`` — parsed; unset, empty or unparsable values fall
  back to the default.
* ``str`` — unset or empty means the default (``None`` for "feature
  off" path knobs like ``MRT_TRACE_DIR``).

A default of ``None`` on a non-``str`` knob marks a DYNAMIC knob: the
default depends on the host or a sibling knob, and the call site must
pass ``default=``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

__all__ = ["KNOBS", "BOOL_KNOBS", "knob_bool", "knob_float", "knob_int", "knob_str"]

# name -> (type, declared default); the owning module follows each.
KNOBS: Dict[str, Tuple[str, object]] = {
    "MRT_ADMISSION": ("bool", True),  # distributed.admission
    "MRT_ADMIT_BURST": ("float", None),  # distributed.admission
    "MRT_ADMIT_INFLIGHT": ("int", 512),  # distributed.admission
    "MRT_ADMIT_RATE": ("float", 1600.0),  # distributed.admission
    "MRT_ADMIT_RETRY_S": ("float", 0.05),  # distributed.admission
    "MRT_ADMIT_SESSION_RATE": ("float", None),  # distributed.admission
    "MRT_BROWNOUT_FACTORS": ("str", ''),  # distributed.admission
    "MRT_DEBUG": ("bool", False),  # distributed.cluster
    "MRT_PIPELINE_DEPTH": ("int", 2),  # distributed.engine_pump
    "MRT_PUMP_IDLE_S": ("float", 0.002),  # distributed.engine_pump
    "MRT_PUMP_TICKS": ("int", 0),  # distributed.engine_pump
    "MRT_FLIGHTREC_DIR": ("str", None),  # distributed.flightrec
    "MRT_FLIGHTREC_SLOTS": ("int", 8192),  # distributed.flightrec
    "MRT_SERVER_LOG_DIR": ("str", None),  # distributed.launch
    "MRT_OBS_MAX_EVENTS": ("int", 50000),  # distributed.observe
    "MRT_STAGECLOCK": ("bool", True),  # distributed.observe
    "MRT_BROWNOUT_DOWN": ("int", 8),  # distributed.overload
    "MRT_BROWNOUT_UP": ("int", 2),  # distributed.overload
    "MRT_OVERLOAD_BACKLOG": ("float", 4096.0),  # distributed.overload
    "MRT_OVERLOAD_INTERVAL": ("float", 0.25),  # distributed.overload
    "MRT_OVERLOAD_P99_MS": ("float", 100.0),  # distributed.overload
    "MRT_OVERLOAD_REPLYQ": ("float", 1024.0),  # distributed.overload
    "MRT_OVERLOAD_WAL": ("float", 4096.0),  # distributed.overload
    "MRT_OVERLOAD_WATCH": ("bool", True),  # distributed.overload
    "MRT_PROFILE": ("bool", True),  # distributed.profile
    "MRT_PROFILE_DEPTH": ("int", 48),  # distributed.profile
    "MRT_PROFILE_HZ": ("float", None),  # distributed.profile
    "MRT_PROFILE_MAX_STACKS": ("int", 5000),  # distributed.profile
    "MRT_PUMP_HOT": ("bool", None),  # distributed.realtime
    "MRT_SANITIZE": ("bool", False),  # distributed.sanitize
    "MRT_SANITIZE_CB_BUDGET_MS": ("float", 250.0),  # distributed.sanitize
    "MRT_SANITIZE_STRICT": ("bool", False),  # distributed.sanitize
    "MRT_SHIP_SYNC": ("bool", False),  # distributed.stateplane
    "MRT_SHIP_TAIL_CAP": ("int", 512),  # distributed.stateplane
    "MRT_SHIP_WINDOW_S": ("float", 5.0),  # distributed.stateplane
    "MRT_TAIL": ("bool", True),  # distributed.tail
    "MRT_TAIL_RESERVOIR": ("int", 64),  # distributed.tail
    "MRT_TAIL_SLO_CAP": ("int", 4096),  # distributed.tail
    "MRT_TAIL_SLO_MS": ("float", 250.0),  # distributed.tail
    "MRT_TAIL_TOPK": ("int", 16),  # distributed.tail
    "MRT_DEBUG_RPC": ("bool", False),  # distributed.tcp
    "MRT_REPLY_Q_CAP": ("int", 4096),  # distributed.tcp
    "MRT_SPIN_US": ("int", None),  # distributed.tcp
    "MRT_TRACE_DIR": ("str", None),  # distributed.tcp
    "MRT_WIRE_LEGACY": ("bool", False),  # distributed.tcp
    "MRT_WEDGE_INTERVAL": ("float", 0.25),  # distributed.wedge
    "MRT_WEDGE_TICKS": ("int", 8),  # distributed.wedge
    "MRT_WEDGE_WATCH": ("bool", True),  # distributed.wedge
    "MRT_CPUSAT_PERMILLE": ("int", 850),  # analysis.postmortem
    "MRT_PLACE_COOLDOWN_S": ("float", 5.0),  # distributed.placement
    "MRT_PLACE_DEAD_S": ("float", 3.0),  # distributed.placement
    "MRT_PLACE_MAX_MOVES": ("int", 1),  # distributed.placement
    "MRT_PLACE_MIN_GAIN": ("float", 0.25),  # distributed.placement
    "MRT_PLACE_REPLACE": ("bool", True),  # distributed.placement
    "MRT_PLACE_REPLACE_DEADLINE_S": ("float", 30.0),  # distributed.placement
    "MRT_PLACE_SCRAPE_S": ("float", 0.5),  # distributed.placement
    "MRT_POSTMORTEM_DIR": ("str", None),  # harness.nemesis
    "MRT_CHECK_QUORUM": ("bool", True),  # engine.core
    "MRT_MEMBERSHIP": ("bool", True),  # engine.core
    "MRT_PREVOTE": ("bool", True),  # engine.core
    "MRT_ENGINE_PIPELINE": ("bool", True),  # engine.host
}

# The bool knobs with their defaults.
BOOL_KNOBS: Dict[str, bool] = {
    name: bool(default) for name, (typ, default) in KNOBS.items() if typ == "bool"
}

_FALSEY = frozenset({"", "0", "false", "no", "off"})


def _declared(name: str, typ: str) -> object:
    if name not in KNOBS:
        raise KeyError(f"undeclared knob {name}")
    declared_type, default = KNOBS[name]
    if declared_type != typ:
        raise TypeError(f"knob {name} is {declared_type}, read as {typ}")
    return default


def knob_str(name: str, default: Optional[str] = None) -> Optional[str]:
    declared = _declared(name, "str")
    raw = os.environ.get(name, "")
    if raw:
        return raw
    return default if default is not None else declared  # type: ignore[return-value]


def knob_int(name: str, default: Optional[int] = None) -> int:
    declared = _declared(name, "int")
    fallback = default if default is not None else declared
    if fallback is None:
        raise TypeError(f"dynamic knob {name} needs an explicit default=")
    raw = os.environ.get(name, "")
    try:
        return int(raw) if raw else int(fallback)  # type: ignore[call-overload]
    except ValueError:
        return int(fallback)  # type: ignore[call-overload]


def knob_float(name: str, default: Optional[float] = None) -> float:
    declared = _declared(name, "float")
    fallback = default if default is not None else declared
    if fallback is None:
        raise TypeError(f"dynamic knob {name} needs an explicit default=")
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw else float(fallback)  # type: ignore[arg-type]
    except ValueError:
        return float(fallback)  # type: ignore[arg-type]


def knob_bool(name: str, default: Optional[bool] = None) -> bool:
    declared = _declared(name, "bool")
    raw = os.environ.get(name)
    if raw is None:
        return bool(declared if default is None else default)
    return raw.strip().lower() not in _FALSEY
