"""The harness reads every cell as it did before events, references and
the failure count became files: the per-tick records, the sampled final
state and the window's writes and failover statistics of each cell,
run on the CPU at a small size with a window of exactly 250 ticks, hash
to the values the earlier harness gave (commit c951698; for
``r3.uniform_churn``, whose mix then named its kills by the ``kills``
key, the earlier harness with that mix)."""

from __future__ import annotations

import hashlib
import json

import pytest
import torch

from cellbench import harness, manifest, traffic

DT = 1 / 64  # fake seconds a tick: a binary fraction, so the sums are exact
WINDOW_TICKS = 250
G = 48
SEED = 2**31 + 77

PINNED = {
    "c5.skew_churn": {"records": "698e053db5123b1bbfae808f", "state": "b45a4460d5e7ffc511c35d9c",
                      "writes": "d1aef9388f4f4a7953af6606", "failover": "30fc015d921bc3cd031ea9f3"},
    "r3.uniform_steady": {"records": "11887f8962f58dc99d03c038",
                          "state": "6b79cf5ab5eefdd1dbb7c770",
                          "writes": "57f533f146911ce042bab49c",
                          "failover": "74234e98afe7498fb5daf1f3"},
    "c5.skew_steady": {"records": "d049a5b2c0df228e795c6ec9", "state": "37ec1f3ebc53b821a8dafb93",
                       "writes": "a9af59fdb55a48a43b73c091", "failover": "74234e98afe7498fb5daf1f3"},
    "r3.uniform_churn": {"records": "c61778c98b05beaf7141f7c9",
                         "state": "c514181a76ecab7929e7d338",
                         "writes": "d96b81c593da2bc7b8b10e00",
                         "failover": "f388f57abb94e3b2f080f4b1"},
}


def tensors_digest(d):
    h = hashlib.sha256()
    for k in sorted(d):
        t = d[k].to(torch.int64).contiguous()
        h.update(k.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()[:24]


def dict_digest(d):
    return hashlib.sha256(json.dumps(d, sort_keys=True, default=str).encode()).hexdigest()[:24]


def digests(name, seed, monkeypatch):
    """One small run whose window holds exactly ``WINDOW_TICKS`` ticks: the
    harness's clock advances by ``DT`` with each tick and at no other time."""
    clock = {"t": 0.0}

    class FakeTime:
        @staticmethod
        def perf_counter():
            return clock["t"]

    prog = harness.program_step()

    def step(*args):
        clock["t"] += DT
        return prog(*args)

    seen = {}
    real_compare = harness.compare

    def compare(prog_state, prog_recs, ref_state, ref_recs):
        seen["state"], seen["records"] = tensors_digest(prog_state), tensors_digest(prog_recs)
        return real_compare(prog_state, prog_recs, ref_state, ref_recs)

    monkeypatch.setattr(harness, "time", FakeTime)
    monkeypatch.setattr(harness, "compare", compare)
    out = harness.run(manifest.cell(name), seed, WINDOW_TICKS * DT, False, "cpu",
                      step=step, conf_override={"G": G})
    assert out.window.ticks == WINDOW_TICKS and out.correct
    return out, {"records": seen["records"], "state": seen["state"],
                 "writes": dict_digest(out.writes), "failover": dict_digest(out.failover)}


@pytest.mark.parametrize("name", list(PINNED))
def test_cell_reads_as_the_earlier_harness_read_it(name, monkeypatch):
    out, got = digests(name, SEED, monkeypatch)
    assert got == PINNED[name]
    # A window shorter than the failure count's span counts what it covers.
    c = traffic.Count.load(manifest.cell(name).count_path)
    span = min(c.window_ticks, WINDOW_TICKS - c.outcome_ticks)
    assert (out.count["span"], out.count["judged_at"]) == (span, span + c.outcome_ticks)
