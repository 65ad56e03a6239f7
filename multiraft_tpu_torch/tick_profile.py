"""Where a tick's time goes on the card.

Runs the engine at the headline deployment (G=10,000 groups x P=3,
L=192, E=48, INGEST=48, the kernel path) under a full firehose, then
profiles a window of fused ticks with ``torch.profiler``::

    python -m multiraft_tpu_torch.tick_profile [--ticks 20] [--G 10000]

Prints the card's name and power limit, the wall time per tick, the
device's busy time per tick (the sum of kernel times), the idle share,
the kernel launches per tick and the kernels that take the most device
time, then one JSON line with the same numbers.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from .engine.core import EngineConfig
from .engine.host import EngineDriver


def _device_us(e) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(e, name, None)
        if v is not None:
            return float(v)
    return 0.0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--G", type=int, default=10_000)
    ap.add_argument("--ticks", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tick_profile: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    cfg = EngineConfig(G=args.G, P=3, L=192, E=48, INGEST=48, HB_TICKS=9,
                       use_kernels=True)
    d = EngineDriver(cfg, seed=0, device="cuda")
    assert d.run_until_quiet_leaders(500)
    n = args.ticks
    d.start_bulk(np.full(cfg.G, cfg.INGEST * 4 * n, np.int64))
    d.step(n)  # warm: allocator, kernels, library
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        d.step(n)
        wall = time.perf_counter() - t0
    kernels = [
        e for e in prof.key_averages()
        if _device_us(e) > 0 and e.device_type == torch.autograd.DeviceType.CUDA
    ]
    busy_us = sum(_device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    seen = busy_us > 0  # the profiler may see no device time at all
    out = {
        "card": card,
        "G": cfg.G,
        "ticks": n,
        "wall_ms_per_tick": wall / n * 1e3,
        "device_busy_ms_per_tick": busy_us / n / 1e3 if seen else None,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall if seen else None,
        "kernel_launches_per_tick": launches / n if seen else None,
    }
    print(f"card: {card}")
    for k, v in out.items():
        print(f"{k}: {v}")
    print("top kernels by device time (us per tick, launches per tick):")
    for e in sorted(kernels, key=_device_us, reverse=True)[:12]:
        print(f"  {_device_us(e) / n:9.2f}  {e.count / n:6.1f}  {e.key[:90]}")
    for e in kernels:
        for name in ("quorum_commit_kernel", "vote_tally_kernel"):
            if name in e.key:
                per = _device_us(e) / max(e.count, 1)
                out[name + "_us_per_launch"] = per
                print(f"{name}: {per:.2f} us per launch, {e.count / n:.1f} per tick")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
