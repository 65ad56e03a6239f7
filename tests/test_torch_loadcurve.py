"""The port's load-curve aggregator (``harness/loadcurve.py``): the
knee finder, the sustainable-rate cut, the curve report and the
windowed scrape folding, each equal to the reference's on the same
numpy-seeded inputs (exact: the outputs are the same floats), plus the
reference's own unit cases on the port."""

from __future__ import annotations

import numpy as np
import pytest

import multiraft_tpu.harness.loadcurve as ref_lc
import multiraft_tpu.utils.metrics as ref_metrics
from multiraft_tpu_torch.harness.loadcurve import (
    build_loadcurve,
    find_knee,
    gauge_peaks,
    max_sustainable,
    stage_stats,
    window_hists,
)
from multiraft_tpu_torch.utils.metrics import Hist


def _curve(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 9))
    rates = sorted(float(r) for r in rng.choice(np.arange(50, 20000, 50), n, replace=False))
    base = float(rng.uniform(1, 10))
    p99 = [round(base * (1 + float(rng.exponential(0.2))) * (1 + 40 * max(0.0, r / rates[-1] - 0.6)), 3)
           for r in rates]
    if rng.random() < 0.2:
        p99[int(rng.integers(n))] = None
    return rates, p99


@pytest.mark.parametrize("seed", range(24))
def test_knee_and_curve_equal_the_reference(seed):
    rates, p99 = _curve(seed)
    target = float(np.random.default_rng(seed + 1000).choice([5.0, 20.0, 50.0, 250.0]))
    clean = [p if p is not None else 0.0 for p in p99]
    assert find_knee(rates, clean) == ref_lc.find_knee(rates, clean)
    assert max_sustainable(rates, p99, target_ms=target) == ref_lc.max_sustainable(
        rates, p99, target_ms=target)
    steps = [{"offered_rate": r, "achieved_ops_per_sec": r * 0.97,
              "client_p50_ms": (p or 0.0) / 2, "client_p99_ms": p}
             for r, p in zip(rates, p99)]
    assert build_loadcurve(steps, p99_target_ms=target) == ref_lc.build_loadcurve(
        steps, p99_target_ms=target)


def _scrape(hist_cls, per_name_obs):
    hists = {}
    for name, values in per_name_obs.items():
        h = hist_cls()
        for v in values:
            h.observe(v)
        hists[name] = h
    return {"proc:1": {"hists": hists, "gauges": {"gauge.replyq": 3.0},
                       "now_us": 0.0}}


@pytest.mark.parametrize("seed", range(6))
def test_window_fold_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    a = {"stage.engine_s": list(rng.exponential(2e-3, 40)),
         "stage.wire_s": list(rng.exponential(5e-5, 10))}
    b = {k: v + list(rng.exponential(8e-3, 30)) for k, v in a.items()}
    b["cpu.handler_s"] = list(rng.exponential(1e-4, 12))
    ours = stage_stats(window_hists(_scrape(Hist, a), _scrape(Hist, b)))
    theirs = ref_lc.stage_stats(ref_lc.window_hists(
        _scrape(ref_metrics.Hist, a), _scrape(ref_metrics.Hist, b)))
    assert ours == theirs


def test_finds_hockey_stick_bend():
    rates = [250, 500, 1000, 2000, 4000, 8000]
    p99 = [5.0, 5.2, 5.5, 9.0, 80.0, 600.0]
    assert find_knee(rates, p99) in (3, 4)


def test_degenerate_inputs():
    assert find_knee([1, 2], [1.0, 2.0]) is None
    assert find_knee([1, 2, 3], [4.0, 4.0, 4.0]) is None
    assert find_knee([2, 2, 2], [1.0, 2.0, 3.0]) is None


def test_missing_process_skipped_and_gauge_peaks():
    after = _scrape(Hist, {"stage.engine_s": [1e-3]})
    after["proc:2"] = {"missing": True}
    win = window_hists({}, after)
    assert win["stage.engine_s"].count == 1
    assert gauge_peaks(after) == {"gauge.replyq": 3.0}
