"""Comparisons shared by the port's parity tests (numpy only, no JAX).

Imported as ``torch_parity`` (pytest puts ``tests/`` on ``sys.path``),
not as ``tests.torch_parity``: an installed regular package named
``tests`` would shadow this directory's namespace package."""

import numpy as np


def same_delayed(a, b) -> bool:
    """Whether two reorder delay queues hold the same messages in the same
    order: release tick, peer, edge and every field of the held frame,
    dtype included."""
    if len(a) != len(b):
        return False
    for (ra, pa, ea, fa), (rb, pb, eb, fb) in zip(a, b):
        if (ra, pa, ea) != (rb, pb, eb) or list(fa) != list(fb):
            return False
        for k in fa:
            x, y = np.asarray(fa[k]), np.asarray(fb[k])
            if x.dtype != y.dtype or not np.array_equal(x, y):
                return False
    return True


def canon(x):
    """A package-neutral, comparable form of a service structure: numpy
    arrays (and tensors, and JAX arrays) by dtype, shape and bytes;
    dataclasses and other records by class name and fields; dicts
    without their order; lists and tuples kept apart (the slab and
    payload wire forms must have the reference's Python types)."""
    if x is None or isinstance(x, (bool, int, float, str, bytes)):
        return x
    if isinstance(x, np.generic):
        return ("np", x.dtype.str, x.item())
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.shape, x.tobytes())
    if hasattr(x, "detach") and hasattr(x, "cpu"):  # a torch tensor
        return canon(x.detach().cpu().numpy())
    if hasattr(x, "__array__"):  # a JAX array
        return canon(np.asarray(x))
    if isinstance(x, dict):
        return ("dict", tuple(sorted(((canon(k), canon(v)) for k, v in x.items()),
                                     key=lambda kv: repr(kv[0]))))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(canon(v) for v in x))
    name = type(x).__name__
    if hasattr(x, "__dataclass_fields__"):
        return (name, tuple((f, canon(getattr(x, f))) for f in x.__dataclass_fields__))
    if hasattr(x, "__dict__"):
        return (name, canon(vars(x)))
    slots = getattr(type(x), "__slots__", None)
    if slots is not None:
        return (name, tuple((s, canon(getattr(x, s, None))) for s in slots))
    raise TypeError(f"canon: no form for {name}")


def _host(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def engine_world(d) -> dict:
    """One driver's whole state in comparable form: every state and inbox
    plane, the tick, backlog, payload bindings and pending payloads,
    the reorder queue and its RNG, and the commit total."""
    w = {"s." + k: canon(v) for k, v in d.np_state().items()}
    w.update({"i." + k: canon(_host(v)) for k, v in d.inbox._asdict().items()})
    w.update(
        tick=d.tick, backlog=d.backlog.tolist(), payloads=canon(d.payloads),
        pending=canon({g: v for g, v in d._pending_payloads.items() if v}),
        delayed=canon(d._delayed), rng=canon(d._np_rng.bit_generator.state),
        commits=d.commits_total,
    )
    return w


# Service attributes held equal between the packages: the frontier, the
# config RSM, every replica, the route table, the clerks' sessions and,
# for split services, the peering's payload candidates and the no-op
# barrier state.
SERVICE_FIELDS = (
    "applied_upto", "last_applied", "configs", "_ctrl_latest", "_ctrl_cmd",
    "reps", "_route", "gids", "_g2l", "data", "sessions", "histories",
    "_stall", "_noop_tickets", "_flush_countdown",
)


def service_world(svc) -> dict:
    w = {f: canon(getattr(svc, f)) for f in SERVICE_FIELDS if hasattr(svc, f)}
    peering = getattr(svc, "peering", None)
    if peering is not None:
        w["cands"] = canon(peering._cands)
        w["stage"] = canon(peering._stage_mask)
    w["engine"] = engine_world(svc.driver)
    return w


def first_difference(a: dict, b: dict):
    """The first key whose values differ, or None."""
    for k in a:
        if k not in b or a[k] != b[k]:
            return k
    for k in b:
        if k not in a:
            return k
    return None


class PumpRecorder:
    """Records ``service_world`` after every ``pump`` of each service it
    watches (the pump method is wrapped on the instance, so the
    service's own calls, a clerk's and ``admin_sync``'s are recorded
    too).  :meth:`check` asserts that the watched services went through
    the same worlds, pump by pump, and clears the record."""

    def __init__(self, *services) -> None:
        self.services = services
        self.worlds = [[] for _ in services]
        for svc, rec in zip(services, self.worlds):
            self._wrap(svc, rec)

    @staticmethod
    def _wrap(svc, rec) -> None:
        inner = svc.pump

        def pump(*a, **k):
            inner(*a, **k)
            rec.append(service_world(svc))

        svc.pump = pump

    def check(self, where="") -> int:
        first = self.worlds[0]
        for other in self.worlds[1:]:
            assert len(first) == len(other), (where, "pump counts", len(first), len(other))
            for i, (a, b) in enumerate(zip(first, other)):
                k = first_difference(a, b)
                assert k is None, (where, "pump", i, "differs at", k)
        n = len(first)
        for rec in self.worlds:
            rec.clear()
        return n
