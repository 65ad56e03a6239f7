"""The window's end-to-end arithmetic from the per-tick records.

The records are the engine's ``TRACE_KEYS`` for every tick and group:
``accepted`` (entries a leader accepted), ``ing_hi`` (the last index it
accepted), ``commit`` (the group's highest commit index).  The latency
algebra follows ``multiraft_tpu_torch/engine/bench_verify.py`` at commit
73b8d79: an entry's accepting tick is its last binding (a binding that a
later leader supersedes was truncated), and the entries bound at tick
``s`` and committed at tick ``t`` are the overlap of ``(lo_s, hi_s]``
with ``(C[t-1], C[t]]``.  Here churned and calm groups go through one
vectorised pass: the binding at ``s`` survives up to ``min(hi_s, m_s)``,
``m_s`` being the lowest start of any later binding in the group (a
later leader that starts below an index either rebinds it or truncates
it), so every surviving entry is counted once, at its last binding, as
``bench_verify`` counts it.  Ticks are mapped to milliseconds through
per-tick device timestamps, so a stalled tick moves every latency that
spans it.  Everything is torch, on the records' device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

I32_MAX = 2**31 - 1


def survivors(acc: torch.Tensor, hi: torch.Tensor):
    """``(lo, end)`` [N, G]: the binding of tick ``t`` covers ``(lo, hi]``;
    ``(lo, end]`` is the part no later binding in the window supersedes
    (empty where nothing was accepted)."""
    lo = hi - acc
    starts = torch.where(acc > 0, lo, I32_MAX)
    later = starts.flip(0).cummin(0).values.flip(0)  # min over t' >= t
    later = torch.cat([later[1:], torch.full_like(later[:1], I32_MAX)])
    end = torch.where(acc > 0, torch.minimum(hi, later), lo)
    return lo, torch.maximum(end, lo)


def weighted_quantile(values: np.ndarray, weights: np.ndarray, q: float) -> float:
    """The smallest value at or below which at least ``q`` of the weight
    lies (nearest rank)."""
    if values.size == 0 or weights.sum() <= 0:
        return float("nan")
    order = np.argsort(values, kind="stable")
    cum = np.cumsum(weights[order])
    i = int(np.searchsorted(cum, q * cum[-1], side="left"))
    return float(values[order][min(i, len(order) - 1)])


def writes(acc: torch.Tensor, hi: torch.Tensor, C: torch.Tensor,
           C0: torch.Tensor, T_ms: Optional[np.ndarray]) -> Dict[str, object]:
    """Entries over the window's ``N`` ticks (the records' rows).

    ``C0`` is each group's commit before the window's first tick and
    ``T_ms[t]`` the device time at the end of tick ``t`` (None on a run
    without a device clock).  Returns the committed count (all entries
    whose commit falls in the window), the entries accepted in the
    window and how each ended (committed, truncated by a leader change,
    still in flight), and the latency distribution of those committed:
    counts by (commit tick, ticks taken), and its p50 and p99 in ticks
    and, with ``T_ms``, in milliseconds."""
    N = acc.shape[0]
    acc, hi, C = acc.to(torch.int32), hi.to(torch.int32), C.to(torch.int32)
    C0 = C0.to(torch.int32)
    lo, end = survivors(acc, hi)
    accepted = int(acc.sum(dtype=torch.int64))
    kept = int((end - lo).sum(dtype=torch.int64))
    c_end = C[-1]
    done = int((torch.minimum(end, c_end) - lo).clamp(min=0).sum(dtype=torch.int64))
    committed_all = int((c_end - C0).sum(dtype=torch.int64))
    Cprev = torch.cat([C0[None], C[:-1]])
    pairs_t: List[np.ndarray] = []
    pairs_k: List[np.ndarray] = []
    pairs_n: List[np.ndarray] = []
    counted = 0
    k = 0
    while counted < done and k < N:
        n = (torch.minimum(end[: N - k], C[k:]) - torch.maximum(lo[: N - k], Cprev[k:]))
        n = n.clamp(min=0).sum(dim=1, dtype=torch.int64).cpu().numpy()
        nz = np.nonzero(n)[0]
        if nz.size:
            pairs_t.append(nz + k)
            pairs_k.append(np.full(nz.size, k, np.int64))
            pairs_n.append(n[nz])
            counted += int(n[nz].sum())
        k += 1
    t = np.concatenate(pairs_t) if pairs_t else np.zeros(0, np.int64)
    ks = np.concatenate(pairs_k) if pairs_k else np.zeros(0, np.int64)
    w = np.concatenate(pairs_n) if pairs_n else np.zeros(0, np.int64)
    hist: Dict[int, int] = {}
    for kk, nn in zip(ks.tolist(), w.tolist()):
        hist[kk] = hist.get(kk, 0) + nn
    out = {
        "hist_ticks": hist,
        "committed": committed_all,
        "accepted": accepted,
        "accepted_committed": done,
        "truncated": accepted - kept,
        "in_flight": kept - done,
        "measured": counted,
        "unplaced": done - counted,
        "ticks_p50": weighted_quantile(ks.astype(float), w, 0.50),
        "ticks_p99": weighted_quantile(ks.astype(float), w, 0.99),
        "ms_p50": None,
        "ms_p99": None,
    }
    if T_ms is not None and t.size:
        ms = T_ms[t] - T_ms[t - ks]
        out["ms_p50"] = weighted_quantile(ms, w, 0.50)
        out["ms_p99"] = weighted_quantile(ms, w, 0.99)
    return out


def settled(acc: torch.Tensor, hi: torch.Tensor, C: torch.Tensor, span: int) -> Dict[str, int]:
    """The entries accepted in the records' first ``span`` ticks, judged
    by the whole records: ``committed`` by their last tick (and not
    superseded), or ``truncated`` by a later binding in them.  Those still
    in flight are in neither."""
    acc, hi, C = acc.to(torch.int32), hi.to(torch.int32), C.to(torch.int32)
    lo, end = survivors(acc, hi)
    lo, end = lo[:span], end[:span]
    accepted = int(acc[:span].sum(dtype=torch.int64))
    kept = int((end - lo).sum(dtype=torch.int64))
    done = int((torch.minimum(end, C[-1]) - lo).clamp(min=0).sum(dtype=torch.int64))
    return {"committed": done, "truncated": accepted - kept}


def failover(C: torch.Tensor, rounds: Sequence[tuple],
             T_ms: Optional[np.ndarray], C0: torch.Tensor) -> Dict[str, object]:
    """Time without service after each kill.

    ``C`` [M, G] is the commit record over the window and the drain;
    ``rounds`` holds ``(tick, groups, hit, kill_ms)`` for each kill round
    of the window: before tick ``tick`` the leaders of ``groups`` (the
    ``hit`` ones) were killed at device time ``kill_ms``.  A kill is
    served again at the end of the first tick whose commit index passes
    the one before the kill; one never served counts to the end of the
    records and as unserved."""
    M = C.shape[0]
    ticks: List[np.ndarray] = []
    times: List[np.ndarray] = []
    unserved = 0
    for tick, groups, hit, kill_ms in rounds:
        g = groups[hit]
        if g.numel() == 0:
            continue
        before = (C0 if tick == 0 else C[tick - 1])[g]
        seg = C[tick:, g]
        prev = torch.cat([before[None], seg[:-1]])
        adv = seg > prev
        served = adv.any(dim=0)
        first = torch.where(served, adv.to(torch.int8).argmax(dim=0), M - 1 - tick)
        first = first.cpu().numpy().astype(np.int64)
        served = served.cpu().numpy()
        unserved += int((~served).sum())
        ticks.append(first + 1)
        if T_ms is not None:
            times.append(T_ms[tick + first] - kill_ms)
    tk = np.concatenate(ticks) if ticks else np.zeros(0, np.int64)
    out = {
        "kills": int(tk.size),
        "unserved": unserved,
        "ticks_p50": float(np.percentile(tk, 50, method="inverted_cdf")) if tk.size else None,
        "ticks_p99": float(np.percentile(tk, 99, method="inverted_cdf")) if tk.size else None,
        "ms_p50": None,
        "ms_p99": None,
    }
    if times:
        ms = np.concatenate(times)
        out["ms_p50"] = float(np.percentile(ms, 50, method="inverted_cdf"))
        out["ms_p99"] = float(np.percentile(ms, 99, method="inverted_cdf"))
    return out
