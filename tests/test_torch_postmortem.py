"""The port's postmortem pipeline: the doctor
(``analysis/postmortem.py``), the bundle collector (``harness/bundle.py``)
and the fleet observer it scrapes with (``harness/observe.py``).

* The reference's doctor cases of ``tests/test_flightrec.py`` on the
  port: the analyses over a synthetic two-process bundle, the report,
  the CLI, corrupt rings; and the tier-1 integration case that SIGKILLs
  a live port engine process (CPU) mid-traffic, collects a bundle and
  reads the dead process's last committed op back out of its ring.
* Parity: the same bundle — written once by each package's flight
  recorder — analyzes to the same result and the same report text in
  both packages' doctors, for the synthetic bundle and for rings of
  PLACE, SHIP and CONFIG records.
"""

from __future__ import annotations

import json
import os
import struct

import pytest

from multiraft_tpu_torch.analysis import postmortem
from multiraft_tpu_torch.distributed import flightrec
from multiraft_tpu_torch.distributed.flightrec import FlightRecorder, read_ring
from multiraft_tpu_torch.distributed.native import native_available
from multiraft_tpu_torch.utils.trace import Tracer

needs_native = pytest.mark.skipif(
    not native_available(), reason="native transport did not build"
)


def _make_bundle(tmp_path, FlightRecorder=FlightRecorder, flightrec=flightrec):
    """A two-process bundle: one clean closer, one unclean death with
    an fsync gap and a chaos drop burst."""
    bdir = tmp_path / "bundle"
    rings = bdir / "rings"
    rings.mkdir(parents=True)

    dead = FlightRecorder(str(rings / "flight-1111.ring"), slots=64,
                          name="engine-dead")
    # Forge the header pid (offset 20 in <8sIIIId64s) so the ring
    # pairs with the synthetic manifest idents below.
    struct.pack_into("<I", dead._mm, 20, 1111)
    dead.record(flightrec.ROLE, code=0, a=2, b=3, c=9)
    for i in range(1, 8):
        dead.record(flightrec.WAL_APPEND, a=i, b=64)
        if i <= 5:
            dead.record(flightrec.WAL_FSYNC, a=i, b=120)
    dead.record(flightrec.COMMIT, code=2, a=55, b=7, tag="00dead.7")
    for _ in range(6):
        dead.record(flightrec.CHAOS,
                    code=flightrec.CHAOS_KIND_CODES["drop"], a=1,
                    tag="reply")
    dead.close()  # no NODE_CLOSE record: unclean

    live = FlightRecorder(str(rings / "flight-2222.ring"), slots=64,
                          name="engine-live")
    struct.pack_into("<I", live._mm, 20, 2222)
    live.record(flightrec.WAL_APPEND, a=1, b=64)
    live.record(flightrec.WAL_FSYNC, a=1, b=100)
    live.record(flightrec.NODE_CLOSE, tag="engine-live")
    live.close()

    manifest = {
        "reason": "unit-test failure",
        "host_pid": os.getpid(),
        "addrs": ["127.0.0.1:1", "127.0.0.1:2"],
        "offsets_us": {"127.0.0.1:1": 10.0, "127.0.0.1:2": -5.0},
        "idents": {
            "127.0.0.1:1": {"pid": 1111, "name": "engine-dead"},
            "127.0.0.1:2": {"pid": 2222, "name": "engine-live"},
        },
        "unreachable": ["127.0.0.1:1"],
        "rings": ["flight-1111.ring", "flight-2222.ring"],
    }
    (bdir / "manifest.json").write_text(json.dumps(manifest))
    snapshots = {
        "127.0.0.1:1": {"missing": True, "pid": 1111,
                        "name": "engine-dead"},
        "127.0.0.1:2": {
            "name": "engine-live", "pid": 2222, "metrics": {},
            "groups": {"G": 3, "leader": [0, 1, -1],
                       "term": [3, 3, 2], "commit": [9, 4, 2],
                       "applied": [9, 1, 2], "log_len": [9, 4, 2],
                       "snap_index": [0, 0, 0]},
        },
    }
    (bdir / "snapshots.json").write_text(json.dumps(snapshots))
    return bdir


class TestDoctor:
    def test_analyze_finds_the_right_anomalies(self, tmp_path):
        bundle = postmortem.load_bundle(str(_make_bundle(tmp_path)))
        assert len(bundle["rings"]) == 2
        analysis = postmortem.analyze(bundle)
        kinds = {a["kind"] for a in analysis["anomalies"]}
        assert "unclean_death" in kinds
        assert "fsync_gap" in kinds
        assert "chaos_burst" in kinds
        assert analysis["first_anomaly"]["aligned"]

        dead = next(p for p in analysis["procs"] if p["pid"] == 1111)
        assert not dead["clean_close"]
        assert dead["addr"] == "127.0.0.1:1"
        assert dead["wal"] == {"appended": 7, "synced": 5, "gap": 2}
        assert dead["last_commit"]["tag"] == "00dead.7"
        assert dead["roles"][0] == {"role": 2, "term": 3, "commit": 9}
        live = next(p for p in analysis["procs"] if p["pid"] == 2222)
        assert live["clean_close"]

        # Commit/apply lag from the final scrape's Obs.groups columns.
        assert analysis["lag"]["127.0.0.1:2"]["max_lag"] == 3
        assert analysis["lag"]["127.0.0.1:2"]["group"] == 1
        assert analysis["lag"]["127.0.0.1:1"]["missing"]

    def test_report_names_the_dead_process(self, tmp_path):
        bundle = postmortem.load_bundle(str(_make_bundle(tmp_path)))
        report = postmortem.build_report(bundle, postmortem.analyze(bundle))
        assert "UNCLEAN DEATH" in report
        assert "engine-dead @ 127.0.0.1:1" in report
        assert "2 append(s) NOT fsync'd" in report
        assert "rid 00dead.7" in report or "00dead.7" in report
        assert "FIRST ANOMALY" in report
        assert "MISSING" in report  # dead at collection time

    def test_cli_end_to_end(self, tmp_path, capsys):
        bdir = _make_bundle(tmp_path)
        rc = postmortem.main([str(bdir), "--rid", "00dead.7"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "FIRST ANOMALY" in out
        assert "rid 00dead.7: 1 record(s)" in out
        assert (bdir / "report.txt").exists()
        assert (bdir / "flight_trace.json.gz").exists()
        doc = Tracer.load(str(bdir / "flight_trace.json.gz"))
        names = {
            (e["args"] or {}).get("name")
            for e in doc["traceEvents"] if e.get("ph") == "M"
        }
        assert any("engine-dead" in (n or "") for n in names)

    def test_cli_on_bare_ring_and_bad_inputs(self, tmp_path, capsys):
        bdir = _make_bundle(tmp_path)
        ring = bdir / "rings" / "flight-1111.ring"
        assert postmortem.main([str(ring), "--trace-out", "none"]) == 0
        assert postmortem.main([str(tmp_path / "nope")]) == 2
        empty = tmp_path / "empty"
        empty.mkdir()
        assert postmortem.main([str(empty)]) == 2

    def test_corrupt_ring_is_skipped_not_fatal(self, tmp_path):
        bdir = _make_bundle(tmp_path)
        (bdir / "rings" / "flight-9.ring").write_bytes(b"garbage")
        bundle = postmortem.load_bundle(str(bdir))
        assert len(bundle["rings"]) == 2
        assert any("flight-9.ring" in s for s in bundle["skipped"])


# ---------------------------------------------------------------------------
# Obs.groups (satellite: per-group introspection in every snapshot)
# ---------------------------------------------------------------------------



@pytest.mark.timeout_s(240)
def test_sigkill_leaves_readable_ring_and_doctor_names_the_dead(
    tmp_path, monkeypatch, capsys,
):
    """kill -9 an engine process under real clerk traffic; its mmap
    ring must survive, replay to the last committed op, and the
    postmortem doctor must name the dead process, its last commit, and
    its WAL frontier from the collected bundle."""
    from multiraft_tpu_torch.distributed.engine_cluster import (
        EngineProcessCluster,
    )
    from multiraft_tpu_torch.harness.bundle import collect_bundle
    from multiraft_tpu_torch.harness.observe import FleetObserver

    frec_dir = tmp_path / "frec"
    frec_dir.mkdir()
    monkeypatch.setenv("MRT_FLIGHTREC_DIR", str(frec_dir))
    # Host-process singleton must be fresh for this env (other tests
    # may have resolved it already with recording disabled).
    old_rec = flightrec._proc_rec
    flightrec._proc_rec = None

    cluster = EngineProcessCluster(
        kind="engine_kv", groups=16, seed=11,
        data_dir=str(tmp_path / "data"), device="cpu",
    )
    obs = None
    n_ops = 12
    try:
        cluster.start()
        server_pid = cluster.proc.pid
        addr = (cluster.host, cluster.port)
        obs = FleetObserver([addr])

        ck = cluster.clerk()
        try:
            for i in range(n_ops):
                ck.append("blackbox", f"({i})")
        finally:
            ck.close()

        # Scrape while alive: caches the pid ident and a clock offset
        # that will outlive the process.
        snaps = obs.snapshot_all()
        key = f"{addr[0]}:{addr[1]}"
        assert snaps[key]["pid"] == server_pid
        assert "groups" in snaps[key]  # Obs.groups rides every snapshot
        assert len(snaps[key]["groups"]["commit"]) == 16
        assert obs.clock_offset_us(addr) is not None

        cluster.kill()  # SIGKILL, no flush, no goodbye

        ring_path = frec_dir / f"flight-{server_pid}.ring"
        assert ring_path.exists(), os.listdir(frec_dir)
        rr = read_ring(str(ring_path))
        assert rr["pid"] == server_pid
        assert rr["records"], "ring empty after SIGKILL"
        assert not rr["clean_close"]

        commits = [r for r in rr["records"]
                   if r["type"] == flightrec.COMMIT]
        assert commits, "no commit records in ring"
        last = max(commits, key=lambda r: r["seq"])
        # The ring replays to the LAST acked op: command ids are
        # 1-based per clerk, so the final acked append is op n_ops.
        assert last["b"] == n_ops
        assert last["tag"], "commit record lost its rid"
        # Durable mode: every ack gated on fsync, so the WAL frontier
        # in the ring covers every acked op.
        fsyncs = [r for r in rr["records"]
                  if r["type"] == flightrec.WAL_FSYNC]
        assert fsyncs and max(r["a"] for r in fsyncs) >= n_ops

        bdir = tmp_path / "bundle"
        collect_bundle(str(bdir), observer=obs, reason="sigkill test")
        assert (bdir / "rings" / ring_path.name).exists()
        snaps2 = json.loads((bdir / "snapshots.json").read_text())
        assert snaps2[key]["missing"] is True
        assert snaps2[key]["pid"] == server_pid

        rc = postmortem.main([str(bdir)])
        assert rc == 0
        out = capsys.readouterr().out
        assert "FIRST ANOMALY" in out
        assert "UNCLEAN DEATH" in out
        assert str(server_pid) in out
        assert f"cmd {n_ops}" in out
        report = (bdir / "report.txt").read_text()
        assert key in report  # the dead process is named by address
    finally:
        if obs is not None:
            obs.close()
        cluster.shutdown()
        if flightrec._proc_rec is not None:
            flightrec._proc_rec.close()
        flightrec._proc_rec = old_rec


# ---------------------------------------------------------------------------
# Parity: one bundle, both doctors
# ---------------------------------------------------------------------------


def _packages():
    import multiraft_tpu.analysis.postmortem as ref_pm
    import multiraft_tpu.distributed.flightrec as ref_fr

    return {"ref": (ref_pm, ref_fr), "port": (postmortem, flightrec)}


def _control_ring(tmp_path, fr):
    """A controller ring of PLACE records (a ping-ponging group), SHIP
    records and a reconfig CONFIG trail cut off by an unclean death."""
    rec = fr.FlightRecorder(str(tmp_path / "rings" / "flight-3333.ring"),
                            slots=256, name="controller")
    struct.pack_into("<I", rec._mm, 20, 3333)
    for version, (gid, src, dst) in enumerate(
        [(7, 0, 1), (7, 1, 0), (7, 0, 1), (7, 1, 0), (8, 0, 1), (9, -1, 2)]
    ):
        rec.record(fr.PLACE, code=gid, a=src, b=dst, c=version + 1,
                   tag="failover" if src < 0 else "rebalance")
    for gid, tag, frontier in [(3, "snap", 4), (3, "tail", 9), (5, "tail", 2)]:
        rec.record(fr.SHIP, code=gid, a=2, b=64, c=frontier, tag=tag)
    for phase in ("learner", "catchup", "joint"):
        rec.record(fr.CONFIG, code=5, a=1, b=3, c=2, tag=phase)
    rec.close()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_doctors_agree_on_a_bundle_written_by_either_package(
    writer, tmp_path, monkeypatch
):
    monkeypatch.setenv("MRT_SHIP_WINDOW_S", "0.0")
    pkgs = _packages()
    _, fr = pkgs[writer]
    bdir = _make_bundle(tmp_path, fr.FlightRecorder, fr)
    _control_ring(bdir, fr)
    m = json.loads((bdir / "manifest.json").read_text())
    m["rings"].append("flight-3333.ring")
    (bdir / "manifest.json").write_text(json.dumps(m))
    out = {}
    for name, (pm, _) in pkgs.items():
        bundle = pm.load_bundle(str(bdir))
        analysis = pm.analyze(bundle)
        out[name] = (analysis, pm.build_report(bundle, analysis),
                     pm.rings_to_trace(bundle).events)
    assert out["ref"][0] == out["port"][0]
    assert out["ref"][1] == out["port"][1]
    assert out["ref"][2] == out["port"][2]
    kinds = {a["kind"] for a in out["port"][0]["anomalies"]}
    assert {"unclean_death", "placement_thrash", "degraded_quorum"} <= kinds
    assert "UNCLEAN DEATH" in out["port"][1]


def test_the_port_ring_is_the_reference_format(tmp_path):
    """A ring the port writes reads back identically through the
    reference's reader, record for record."""
    from multiraft_tpu.distributed.flightrec import read_ring as ref_read

    bdir = _make_bundle(tmp_path)
    for name in ("flight-1111.ring", "flight-2222.ring"):
        path = str(bdir / "rings" / name)
        assert read_ring(path) == ref_read(path)
