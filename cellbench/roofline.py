"""Peaks of the card and the least work of the tick and of each kernel.

Frozen copies, from commit 73b8d79: :func:`bytes_per_tick` of
``multiraft_tpu_torch/benchmarks/roofline.py``, and :func:`commit_bound`
and :func:`tally_bound` of ``chip_smoke.py`` (lines 382-430), which count
only the bytes these inputs need, in 32-byte sectors where a read
depends on the data.
"""

from __future__ import annotations

from typing import Optional

import torch

# NVIDIA H100 SXM data sheet: HBM3 bytes per second; non-tensor
# FP32/INT32 operations per second.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "scalar_ops_per_s": 67e12},
}
H100 = "NVIDIA H100 80GB HBM3"


def peak(card: str) -> Optional[dict]:
    """The card's peaks, or None for a card the table does not hold."""
    return PEAKS.get(card)


def bytes_per_tick(G: int, P: int, L: int, E: int, passes_log: float = 1.0) -> int:
    """One-pass bytes a tick touches: every state and mailbox tensor read
    once and written once, the log ring read ``passes_log`` times."""
    i32 = 4
    log = G * P * L * i32
    ar_terms = G * P * P * E * i32
    lanes = 20 * G * P * P * i32
    gp = 14 * G * P * i32
    gpp = 3 * G * P * P * i32
    state = log + gp + gpp
    mailbox = ar_terms + lanes
    return int((state + (passes_log - 1) * log) + mailbox + state + mailbox)


def _bound_ms(nbytes: int, ops: int, card: str) -> float:
    pk = PEAKS[card]
    return max(nbytes / pk["bytes_per_s"], ops / pk["scalar_ops_per_s"]) * 1e3


def _sector_bytes(index: torch.Tensor, itemsize: int = 4) -> int:
    return torch.unique(index.reshape(-1) * itemsize // 32).numel() * 32


def commit_bound(args, quorum: int, card: str = H100) -> float:
    """Least ms of one quorum-commit call on these inputs."""
    eff_match, term, commit, base, base_term, log_term, is_leader = args
    G, P, _ = eff_match.shape
    L = log_term.shape[-1]
    q = torch.sort(eff_match, dim=-1).values[..., P - quorum]
    rows = torch.arange(G * P, device=q.device, dtype=torch.int64).reshape(G, P)
    lead = rows[is_leader]
    adv = is_leader & (q > commit)
    at_base = adv & (q == base)
    in_ring = adv & (q != base)
    ring_words = rows[in_ring] * L + torch.remainder(q[in_ring], L).long()
    nbytes = (
        is_leader.numel() + commit.numel() * 4 + commit.numel() * 4
        + _sector_bytes(lead[:, None] * P + torch.arange(P, device=q.device))
        + 2 * _sector_bytes(rows[adv]) + _sector_bytes(rows[at_base])
        + _sector_bytes(ring_words)
    )
    ops = G * P * 4 + lead.numel() * (P * P + 12)
    return _bound_ms(nbytes, ops, card)


def tally_bound(args, card: str = H100) -> float:
    """Least ms of one vote-tally call on these inputs."""
    votes, role, alive = args
    G, P, _ = votes.shape
    rows = torch.arange(G * P, device=votes.device, dtype=torch.int64)
    cand = rows[((role == 1) & alive).reshape(-1)]
    votes_read = cand[:, None] * P + torch.arange(P, device=votes.device)
    nbytes = (role.numel() * 4 + alive.numel() + G * P
              + _sector_bytes(votes_read, itemsize=1))
    ops = G * P * 4 + cand.numel() * (P + 2)
    return _bound_ms(nbytes, ops, card)
