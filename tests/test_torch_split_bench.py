"""The port's split-group rig (``benchmarks/split_bench.py``) against the
reference's, on the CPU.

At tiny shapes with ``device="cpu"`` each leg returns the reference's
output keys under the same arguments (the split failover adds
``acked_writes`` and ``lost_acked_writes``: every acknowledged append
reads back once, in order).  Without a device the rig wants the card.
"""

import json

import pytest
import torch

import benchmarks.split_bench as ref_sp
from multiraft_tpu.distributed.native import native_available
from multiraft_tpu_torch.benchmarks import split_bench as sp

# Small shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the host's cores.
torch.set_num_threads(1)

needs_native = pytest.mark.skipif(
    not native_available(), reason="native transport did not build"
)


def test_slab_overhead_returns_the_references_keys():
    G = 4
    ours = sp.bench_slab_overhead(G, ticks=40, device="cpu")
    ref = ref_sp.bench_slab_overhead(G, ticks=40)
    assert set(ours) == set(ref) == {
        "slab_G", "whole_chip_ms_per_tick", "split_ms_per_tick_per_side",
        "slab_overhead_x",
    }
    assert ours["slab_G"] == ref["slab_G"] == G
    assert ours["whole_chip_ms_per_tick"] > 0
    assert ours["split_ms_per_tick_per_side"] > 0


def test_slab_overhead_wants_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sp.bench_slab_overhead(4, ticks=1)


@needs_native
@pytest.mark.timeout_s(180)
def test_split_serving_returns_the_references_keys():
    ours = sp.bench_serving(4, 20, frame=8, device="cpu")
    ref = ref_sp.bench_serving(4, 20, frame=8)
    assert set(ours) == set(ref)
    for k in ("serving_G", "serving_ops", "frame"):
        assert ours[k] == ref[k], k
    assert ours["per_op_ops_per_sec"] > 0 and ours["framed_ops_per_sec"] > 0


@needs_native
@pytest.mark.timeout_s(180)
def test_split_failover_loses_no_acknowledged_write():
    ours = sp.bench_failover(4, device="cpu")
    ref = ref_sp.bench_failover(4)
    assert set(ref) <= set(ours)
    assert set(ours) - set(ref) == {"acked_writes", "lost_acked_writes"}
    assert ours["acked_writes"] == 40 and ours["lost_acked_writes"] == 0
    assert ours["failover_window_ms"] > 0


@needs_native
@pytest.mark.timeout_s(180)
def test_split_main_prints_every_leg(capsys, monkeypatch):
    import functools

    # main's legs at its arguments, the slab leg cut to 20 ticks.
    monkeypatch.setattr(sp, "bench_slab_overhead",
                        functools.partial(sp.bench_slab_overhead, ticks=20))
    sp.main(["split_bench", "4", "12", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out)
    assert {"slab_overhead_x", "per_op_ops_per_sec", "framed_ops_per_sec",
            "failover_window_ms", "lost_acked_writes"} <= set(line)
    assert line["slab_G"] == line["serving_G"] == 4
    assert line["serving_ops"] == 12 and line["lost_acked_writes"] == 0
