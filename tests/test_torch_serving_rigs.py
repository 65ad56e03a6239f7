"""The port's serving rigs (``benchmarks/serving_throughput.py`` and
``benchmarks/serving_breakdown.py``) against the reference's, on the CPU.

At tiny shapes with ``device="cpu"`` each rig returns the reference's
output keys under the same arguments, and where results are exact they
are equal: every firehose row acknowledged, the op and frame counts,
the porcupine verdict.  Without a device the rigs want the card.  The
socket window at G=16 mirrors ``tests/test_serving_gap.py`` and is
``slow`` as that test is.
"""

import json

import pytest
import torch

import benchmarks.serving_breakdown as ref_sb
import benchmarks.serving_throughput as ref_st
from multiraft_tpu.distributed.native import native_available
from multiraft_tpu_torch.benchmarks import serving_breakdown as sb
from multiraft_tpu_torch.benchmarks import serving_throughput as st

# Small shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the host's cores.
torch.set_num_threads(1)

needs_native = pytest.mark.skipif(
    not native_available(), reason="native transport did not build"
)

INPROC = dict(G=16, ingest=8, clerks=2, frames_per_clerk=2, frame=256)
# Exact on both packages; the rest are wall-clock rates.
INPROC_EXACT = ("mode", "G", "ingest", "clerks", "frame", "ops", "ops_ok")


def test_firehose_inprocess_acks_every_row_as_the_reference():
    """``tests/test_firehose.py::test_firehose_inprocess_bench_smoke`` on
    both packages."""
    ours = st.bench_firehose_inprocess(**INPROC, device="cpu")
    ref = ref_st.bench_firehose_inprocess(**INPROC)
    assert set(ours) == set(ref)
    assert ours["ops_ok"] == ours["ops"] == 2 * 2 * 256
    for k in INPROC_EXACT:
        assert ours[k] == ref[k], k
    assert ours["ops_per_sec"] > 0


def test_firehose_inprocess_restores_the_pump_knob(monkeypatch):
    import os

    monkeypatch.delenv("MRT_PUMP_HOT", raising=False)
    st.bench_firehose_inprocess(G=8, ingest=8, clerks=1, frames_per_clerk=1,
                                frame=64, device="cpu")
    assert "MRT_PUMP_HOT" not in os.environ
    monkeypatch.setenv("MRT_PUMP_HOT", "0")
    st.bench_firehose_inprocess(G=8, ingest=8, clerks=1, frames_per_clerk=1,
                                frame=64, device="cpu")
    assert os.environ["MRT_PUMP_HOT"] == "0"


def test_the_in_process_rigs_want_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.bench_firehose_inprocess(G=8, ingest=8, clerks=1,
                                    frames_per_clerk=1, frame=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sb.bench_service(8, 8)


def test_pack_clerk_frames_are_the_references():
    for G, clerk, n, frame in ((16, 1, 2, 64), (256, 3, 1, 300)):
        assert st._pack_clerk_frames(G, clerk, n, frame) == (
            ref_st._pack_clerk_frames(G, clerk, n, frame)
        )


def test_codec_breakdown_has_the_references_keys():
    ours, ref = sb.bench_codec(64, reps=5), ref_sb.bench_codec(64, reps=5)
    assert set(ours) == set(ref) == {
        "codec_req_frame_ms", "codec_rep_frame_ms", "codec_us_per_op",
    }
    assert all(v > 0 for v in ours.values())


def test_service_breakdown_has_the_references_keys():
    ours = sb.bench_service(16, n_frames=8, clerks=4, device="cpu")
    ref = ref_sb.bench_service(16, n_frames=8, clerks=4)
    assert set(ours) == set(ref)
    assert ours["service_frames"] == ref["service_frames"] == 8
    with pytest.raises(ValueError, match="exceeds the service cap"):
        sb.bench_service(sb_cap() + 1, device="cpu")
    with pytest.raises(ValueError, match="must be >= clerks"):
        sb.bench_service(8, n_frames=2, clerks=4, device="cpu")


def sb_cap() -> int:
    from multiraft_tpu_torch.distributed.engine_server import EngineKVService

    return EngineKVService.MAX_BATCH


def test_breakdown_main_prints_the_references_line(capsys):
    sb.main(["serving_breakdown", "8", "16", "--device", "cpu"])
    ours = json.loads(capsys.readouterr().out)
    # The reference's line: the frame, bench_codec's keys and
    # bench_service's (both held equal above).
    assert set(ours) == {"frame"} | set(ref_sb.bench_codec(16, reps=1)) | {
        "service_frames", "service_ops_per_sec", "service_ms_per_frame",
    }
    assert ours["frame"] == 16 and ours["service_frames"] == 8


@needs_native
@pytest.mark.timeout_s(180)
@pytest.mark.parametrize("frame", [0, 4])
def test_clerk_bench_returns_the_references_keys(frame):
    ours = st.bench(2, 6, frame=frame, device="cpu")
    ref = ref_st.bench(2, 6, frame=frame)
    assert set(ours) == set(ref) and set(ours["wire"]) == set(ref["wire"])
    for k in ("clerks", "ops", "frame"):
        assert ours[k] == ref[k], k
    assert ours["ops_per_sec"] > 0 and ours["wire"]["rpc_flushes"] > 0


@needs_native
@pytest.mark.timeout_s(180)
def test_firehose_sockets_acks_every_row_as_the_reference():
    kw = dict(n_clients=2, frames_per_client=2, frame=256, G=16, ingest=8,
              verify=True)
    ours = st.bench_firehose_sockets(**kw, device="cpu")
    ref = ref_st.bench_firehose_sockets(**kw)
    assert set(ours) == set(ref) and set(ours["wire"]) == set(ref["wire"])
    assert ours["ops_ok"] == ref["ops_ok"] == 2 * 2 * 256
    assert ours["porcupine"] == ref["porcupine"] == "ok"
    assert ours["verifier_ops"] == ref["verifier_ops"] == 60
    for k in ("mode", "clients", "G", "ingest", "frame"):
        assert ours[k] == ref[k], k


@pytest.mark.slow
@needs_native
@pytest.mark.timeout_s(300)
def test_sockets_within_floor_fraction_of_inprocess():
    """``tests/test_serving_gap.py`` on the port at G=16: every row
    acknowledged, porcupine ok, the wire fast path engaged, and the
    socketed rate no collapse against the in-process ceiling."""
    G, ingest, frame = 16, 24, 4096
    inproc = st.bench_firehose_inprocess(G=G, ingest=ingest, clerks=2,
                                         frames_per_clerk=3, frame=frame,
                                         device="cpu")
    socks = st.bench_firehose_sockets(n_clients=2, frames_per_client=3,
                                      frame=frame, G=G, ingest=ingest,
                                      verify=True, device="cpu")
    ctx = json.dumps({"inprocess": inproc, "sockets": socks})
    assert socks["ops_ok"] == 2 * 3 * frame, ctx
    assert socks["porcupine"] == "ok", ctx
    wire = socks["wire"]
    assert wire["rpc_flushes"] > 0, ctx
    assert wire["frames_per_flush_mean"] >= 1.0, ctx
    assert wire["rpc_oob_buffers"] > 0, ctx
    assert socks["ops_per_sec"] >= 0.05 * inproc["ops_per_sec"], ctx


@needs_native
@pytest.mark.timeout_s(180)
def test_throughput_main_prints_the_references_line(capsys):
    st.main(["serving_throughput", "2", "6", "4", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out)
    # The reference's line: bench()'s keys (held equal above) and the
    # framed run's two (serving_throughput.py:486-494).
    assert set(line) == {
        "clerks", "ops", "frame", "ops_per_sec", "mean_latency_ms", "wire",
        "framed_ops_per_sec", "framed_mean_latency_ms",
    }
    assert line["frame"] == 4 and line["ops"] == 12 and line["clerks"] == 2
