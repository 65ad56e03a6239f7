"""Roofline accounting for the engine tick on the card (the PyTorch port
of ``benchmarks/roofline.py``).

Two parts:

* ARITHMETIC: :func:`bytes_per_tick`, the bytes one tick touches from
  the tensor shapes.  The dominant planes are the log ring ``log_term
  [G,P,L] i32`` and the append-channel mailbox ``ar_terms [G,P,P,E] i32``
  (+ ~20 [G,P,P] lane fields).  The tick reads state and inbox and
  writes state and outbox; ring reads appear in several phases, so the
  ring's passes are a parameter and the bound a range.
  :func:`tick_bound_ms` turns the bytes into the least time the card's
  memory could take for them.

* EXPERIMENT: :func:`measure`, ms per tick across ring (L) and E/INGEST
  sweeps at fixed G.  If the tick tracks the L-dependent byte count it
  is bandwidth-bound; if it is flat in L, the ceiling is elsewhere
  (launches, the serial chain of phases).

    python -m multiraft_tpu_torch.benchmarks.roofline [G] [--device cuda|cpu]

prints the card's name and power limit, then one JSON line per
operating point with its ms per tick, commits/s, bytes per tick, the
achieved rate and its share of the H100's HBM rate.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

__all__ = ["H100_BYTES_PER_S", "bytes_per_tick", "tick_bound_ms", "measure", "main"]

# H100 SXM HBM3, bytes per second.
H100_BYTES_PER_S = 3.35e12


def bytes_per_tick(G: int, P: int, L: int, E: int, passes_log: float = 2.0):
    """Shape-derived traffic estimate (bytes) for one tick: every
    state/mailbox tensor read once + written once, with the log ring
    counted ``passes_log`` times on the read side (ring reads appear
    in the vote, append-handle and append-send phases)."""
    i32 = 4
    log = G * P * L * i32
    ar_terms = G * P * P * E * i32
    lanes = 20 * G * P * P * i32  # vr/vp/ar/ap scalar lane fields
    gp = 14 * G * P * i32        # term/vote/role/commit/... columns
    gpp = 3 * G * P * P * i32    # next/match/votes
    state = log + gp + gpp
    mailbox = ar_terms + lanes
    # read state (+extra log passes) + read inbox + write state + write outbox
    return (state + (passes_log - 1) * log) + mailbox + state + mailbox


def tick_bound_ms(G: int, P: int, L: int, E: int, passes_log: float = 1.0,
                  bytes_per_s: float = H100_BYTES_PER_S) -> float:
    """The least ms one tick can take on the card: its bytes (the ring
    read ``passes_log`` times) over the memory rate."""
    return bytes_per_tick(G, P, L, E, passes_log) / bytes_per_s * 1e3


def measure(cfg, n_ticks: int = 200, reps: int = 3, device=None):
    """``(best_s_per_tick, commits_per_sec_at_best)`` on ``device`` (None
    means the card).  The timing fence is a commit readback, which waits
    for the chunk and proves that it committed work."""
    from ..engine.core import empty_mailbox, init_state, run_ticks
    from ..engine.host import resolve_device
    from ..utils import prng

    dev = resolve_device(device)

    def commits(st):
        return int(st.commit.amax(dim=1).sum())  # forces the sync

    key = prng.PRNGKey(5)
    state = init_state(cfg, key, dev)
    inbox = empty_mailbox(cfg, dev)
    state, inbox = run_ticks(cfg, state, inbox, n_ticks, 0, key)  # elect
    state, inbox = run_ticks(
        cfg, state, inbox, n_ticks, cfg.INGEST, prng.fold_in(key, 1)
    )  # fill
    c0 = commits(state)
    best = float("inf")
    rate = 0.0
    for r in range(reps):
        t0 = time.perf_counter()
        state, inbox = run_ticks(
            cfg, state, inbox, n_ticks, cfg.INGEST, prng.fold_in(key, 2 + r)
        )
        c1 = commits(state)
        dt = time.perf_counter() - t0
        assert c1 > c0, "no commits in a timed chunk — measurement invalid"
        if dt / n_ticks < best:
            best = dt / n_ticks
            rate = (c1 - c0) / dt
        c0 = c1
    return best, rate


SWEEPS = (
    # L sweep at fixed E/INGEST: bandwidth-bound <=> time tracks L.
    dict(L=48, E=8, INGEST=8),
    dict(L=64, E=8, INGEST=8),
    dict(L=112, E=8, INGEST=8),
    dict(L=224, E=8, INGEST=8),
    # operating points around the bench's.
    dict(L=80, E=20, INGEST=20),
    dict(L=112, E=28, INGEST=28),
    dict(L=128, E=32, INGEST=32),
    dict(L=192, E=48, INGEST=48),
)


def main(argv=None) -> None:
    from ..engine.core import EngineConfig
    from ..engine.host import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("G", nargs="?", type=int, default=10_000)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--ticks", type=int, default=200)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = "cpu"
    if dev.type == "cuda":
        from ..bench import card_line

        card = card_line()
        print(f"card: {card}", flush=True)
    for s in SWEEPS:
        cfg = EngineConfig(G=args.G, P=3, HB_TICKS=9,
                           use_kernels=dev.type == "cuda", **s)
        per_tick, commits_s = measure(cfg, n_ticks=args.ticks, device=dev)
        ms = per_tick * 1e3
        b2 = bytes_per_tick(args.G, 3, s["L"], s["E"], passes_log=2.0)
        print(
            json.dumps({
                "G": args.G, **s, "device": dev.type, "card": card,
                "ms_per_tick": round(ms, 4),
                "commits_per_sec": round(commits_s, 0),
                "bytes_per_tick_est": b2,
                "est_GBps": round(b2 / (ms * 1e-3) / 1e9, 1),
                "frac_h100_roofline": round(b2 / (ms * 1e-3) / H100_BYTES_PER_S, 4),
                "bound_ms_1x_3x": [
                    round(tick_bound_ms(args.G, 3, s["L"], s["E"], p), 4)
                    for p in (1.0, 3.0)
                ],
            }),
            flush=True,
        )


if __name__ == "__main__":
    main(sys.argv[1:])
