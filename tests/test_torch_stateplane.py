"""The port's durable state plane (``distributed/stateplane.py``).

* The unit tests of the reference's ``tests/test_stateplane.py`` run
  against the port: ship rules, the ``MRSP`` framing fuzzed by byte
  flips and truncation, the standby store, freshness ordering,
  ``StatePlane`` capture, cadence, sync gate, metrics and SHIP flight
  records; the unseal-after-dispatch fork guard and the in-process
  durable failover (ship → kill → recover) through the placement
  controller, with the engines on the CPU; and the doctor's SHIP
  analyses.  The slow socket scenario (``-m slow``) runs its fleet on
  the card when there is one.
* Parity with the reference on the same inputs (numpy-seeded): framed
  bodies are byte for byte the reference's and unframe in either
  package, the standby choice and freshness order are the reference's,
  and one write sequence ships the same payloads, byte for byte, from
  both packages' planes.
"""

from __future__ import annotations

import time
import types

import numpy as np
import pytest
import torch

import multiraft_tpu.distributed.stateplane as ref_sp
from multiraft_tpu.transport import codec as ref_codec
from multiraft_tpu_torch.distributed.stateplane import (
    DEFAULT_SPEC,
    ShipSpec,
    StandbyStore,
    StatePlane,
    choose_standbys,
    frame_blob,
    match_ship_rules,
    pick_freshest,
    unframe_blob,
)
from multiraft_tpu_torch.transport import codec


class TestShipRules:
    def test_no_rule_falls_back_to_one_standby_not_the_owner(self):
        assert match_ship_rules([], "gid-7") is DEFAULT_SPEC
        sbs = choose_standbys(7, owner=1, procs=[0, 1, 2])
        assert len(sbs) == 1 and sbs[0] != 1

    def test_pin_restricts_standbys_to_named_procs(self):
        rules = [(r"gid-3", ShipSpec(pin=(2,)))]
        assert choose_standbys(3, 0, [0, 1, 2, 3], rules) == [2]
        rules = [(r"gid-3", ShipSpec(pin=(0,)))]
        assert choose_standbys(3, 0, [0, 1, 2, 3], rules) == []

    def test_anti_affinity_never_picks_avoided_procs(self):
        rules = [(r".*", ShipSpec(copies=3, avoid=(1, 2)))]
        for gid in range(1, 9):
            sbs = choose_standbys(gid, 0, [0, 1, 2, 3, 4], rules)
            assert sbs and not set(sbs) & {0, 1, 2}

    def test_spread_takes_n_distinct_copies_rotated_by_gid(self):
        rules = [(r".*", ShipSpec(copies=2))]
        seen_first = set()
        for gid in range(1, 7):
            sbs = choose_standbys(gid, 0, [0, 1, 2, 3], rules)
            assert len(sbs) == 2 == len(set(sbs)) and 0 not in sbs
            seen_first.add(sbs[0])
        assert len(seen_first) > 1

    def test_first_match_wins_and_labels_are_matchable(self):
        rules = [
            (r"tier=gold", ShipSpec(copies=3)),
            (r"gid-\d+", ShipSpec(copies=1)),
        ]
        assert match_ship_rules(rules, "gid-4 tier=gold").copies == 3
        assert match_ship_rules(rules, "gid-4").copies == 1
        gold = choose_standbys(4, 0, [0, 1, 2, 3], rules, label="tier=gold")
        assert len(gold) == 3

    @pytest.mark.parametrize("seed", range(3))
    def test_standby_choice_is_the_references(self, seed):
        rng = np.random.default_rng(seed)
        for _ in range(50):
            procs = sorted(set(rng.integers(0, 8, size=int(rng.integers(1, 7))).tolist()))
            owner = int(rng.choice(procs))
            copies = int(rng.integers(1, 4))
            avoid = tuple(rng.integers(0, 8, size=int(rng.integers(0, 3))).tolist())
            pin = tuple(rng.integers(0, 8, size=int(rng.integers(0, 3))).tolist())
            gid = int(rng.integers(1, 10_000))
            port_rules = [(r"gid-\d*7$", ShipSpec(copies=copies, pin=pin, avoid=avoid))]
            ref_rules = [(r"gid-\d*7$", ref_sp.ShipSpec(copies=copies, pin=pin, avoid=avoid))]
            assert choose_standbys(gid, owner, procs, port_rules) == \
                ref_sp.choose_standbys(gid, owner, procs, ref_rules)


class TestShipFraming:
    def test_round_trip(self):
        body = codec.encode({"gid": 1, "records": [(1, ("Put",))]})
        assert unframe_blob(frame_blob(body)) == body
        assert unframe_blob(frame_blob(b"")) == b""

    def test_bit_flip_at_every_offset_is_discarded(self):
        buf = frame_blob(b"shipment-body-0123456789")
        for k in range(len(buf)):
            raw = bytearray(buf)
            raw[k] ^= 0xA5
            assert unframe_blob(bytes(raw)) is None, f"offset {k}"

    def test_truncation_at_every_length_is_discarded(self):
        buf = frame_blob(b"partial-delivery-payload")
        for n in range(len(buf)):
            assert unframe_blob(buf[:n]) is None, f"len {n}"

    def test_garbage_and_wrong_magic_rejected(self):
        assert unframe_blob(b"") is None
        assert unframe_blob(b"MRWL" + b"\x00" * 20) is None  # WAL magic
        assert unframe_blob(None) is None
        assert unframe_blob(b"\xff" * 64) is None

    @pytest.mark.parametrize("seed", range(3))
    def test_frames_are_the_references_and_cross_packages(self, seed):
        """A frame from either package unframes in the other, and the
        bytes are equal; damaged frames are refused by both."""
        rng = np.random.default_rng(seed)
        for _ in range(20):
            body = rng.integers(0, 256, size=int(rng.integers(0, 300)),
                                dtype=np.uint8).tobytes()
            mine, theirs = frame_blob(body), ref_sp.frame_blob(body)
            assert mine == theirs and mine[:4] == b"MRSP"
            assert ref_sp.unframe_blob(mine) == body == unframe_blob(theirs)
            k = int(rng.integers(len(mine)))
            bad = bytearray(mine)
            bad[k] ^= 0x5A
            assert unframe_blob(bytes(bad)) is None
            assert ref_sp.unframe_blob(bytes(bad)) is None


def _payload(gid, token, kind, snap_seq=0, snap=None, records=(), ts=0.0):
    return frame_blob(codec.encode({
        "gid": gid, "token": token, "kind": kind, "snap_seq": snap_seq,
        "snap": snap, "records": list(records), "ts": ts,
    }))


class TestStandbyStore:
    def test_corrupt_payload_rejected_and_never_stored(self):
        store = StandbyStore()
        good = _payload(3, "t1", "snap", snap_seq=2, snap={"gid": 3}, ts=1.0)
        bad = bytearray(good)
        bad[len(bad) // 2] ^= 0xFF
        r = store.receive(bytes(bad))
        assert r == {"ok": False, "have": -1}
        assert store.rejects == 1 and store.freshness(3) is None
        assert store.receive(good)["ok"]
        assert store.freshness(3)["snap_seq"] == 2

    def test_tail_must_extend_contiguously(self):
        store = StandbyStore()
        store.receive(_payload(5, "t1", "snap", snap_seq=0,
                               snap={"gid": 5}, ts=1.0))
        ok = store.receive(_payload(
            5, "t1", "tail", records=[(1, ("Put", "a", "1", 9, 1))], ts=2.0,
        ))
        assert ok["ok"] and ok["have"] == 1
        gap = store.receive(_payload(
            5, "t1", "tail", records=[(3, ("Put", "c", "3", 9, 3))], ts=3.0,
        ))
        assert not gap["ok"] and gap["have"] == 1
        dup = store.receive(_payload(
            5, "t1", "tail",
            records=[(1, ("Put", "a", "1", 9, 1)), (2, ("Put", "b", "2", 9, 2))],
            ts=4.0,
        ))
        assert dup["ok"] and dup["have"] == 2
        snap, tail = store.get(5)
        assert [s for s, _r in enumerate(tail, start=1)] == [1, 2]

    def test_midstream_tail_under_new_token_never_clobbers_old_state(self):
        store = StandbyStore()
        store.receive(_payload(7, "old", "snap", snap_seq=4,
                               snap={"gid": 7, "v": 1}, ts=10.0))
        r = store.receive(_payload(
            7, "new", "tail", records=[(9, ("Put", "x", "9", 1, 9))], ts=20.0,
        ))
        assert not r["ok"]
        f = store.freshness(7)
        assert f["token"] == "old" and f["snap_seq"] == 4
        store.receive(_payload(7, "new", "snap", snap_seq=8,
                               snap={"gid": 7, "v": 2}, ts=21.0))
        f = store.freshness(7)
        assert f["token"] == "new" and f["snap_seq"] == 8

    def test_base1_tail_may_establish_token_without_snapshot(self):
        store = StandbyStore()
        r = store.receive(_payload(
            2, "t1", "tail", records=[(1, ("Put", "a", "1", 3, 1))], ts=1.0,
        ))
        assert r["ok"] and r["have"] == 1
        snap, tail = store.get(2)
        assert snap is None and len(tail) == 1

    def test_snapshot_folds_covered_tail_records(self):
        store = StandbyStore()
        store.receive(_payload(4, "t1", "tail",
                               records=[(1, ("Put", "a", "1", 3, 1)),
                                        (2, ("Put", "b", "2", 3, 2))],
                               ts=1.0))
        store.receive(_payload(4, "t1", "snap", snap_seq=2,
                               snap={"gid": 4}, ts=2.0))
        snap, tail = store.get(4)
        assert snap == {"gid": 4} and tail == []
        assert store.freshness(4)["tail_seq"] == 2

    def test_reference_shipments_land_in_the_port_store(self):
        """Payloads framed and encoded by the reference are received by
        the port's store exactly as the reference's store takes them."""
        mine, theirs = StandbyStore(), ref_sp.StandbyStore()
        for args in [
            (6, "t1", "snap", 1, {"gid": 6}, (), 1.0),
            (6, "t1", "tail", 0, None, [(2, ("Put", "a", "1", 3, 2))], 2.0),
            (6, "t1", "tail", 0, None, [(4, ("Put", "b", "2", 3, 4))], 3.0),
            (6, "t2", "tail", 0, None, [(1, ("Put", "c", "3", 4, 1))], 4.0),
        ]:
            gid, tok, kind, ss, snap, recs, ts = args
            blob = ref_sp.frame_blob(ref_codec.encode({
                "gid": gid, "token": tok, "kind": kind, "snap_seq": ss,
                "snap": snap, "records": list(recs), "ts": ts,
            }))
            assert mine.receive(blob) == theirs.receive(blob)
        assert mine.freshness(6) == theirs.freshness(6)
        assert mine.get(6) == theirs.get(6)


class TestPickFreshest:
    def test_offline_and_empty_standbys_excluded(self):
        f = {"token": "t", "snap_seq": 1, "tail_seq": 3, "ts": 5.0}
        assert pick_freshest([(0, None), (1, f), (2, None)]) == [1]
        assert pick_freshest([(0, None), (1, None)]) == []

    def test_stale_incarnation_never_outranks_live_owner(self):
        stale = {"token": "old", "snap_seq": 0, "tail_seq": 99, "ts": 10.0}
        live = {"token": "new", "snap_seq": 2, "tail_seq": 3, "ts": 50.0}
        assert pick_freshest([(1, stale), (2, live)]) == [2, 1]

    def test_within_token_highest_tail_wins(self):
        a = {"token": "t", "snap_seq": 2, "tail_seq": 5, "ts": 9.0}
        b = {"token": "t", "snap_seq": 2, "tail_seq": 7, "ts": 8.0}
        assert pick_freshest([(0, a), (1, b)]) == [1, 0]

    def test_order_is_the_references(self):
        rng = np.random.default_rng(11)
        for _ in range(100):
            cands = []
            for sb in range(int(rng.integers(1, 6))):
                if rng.random() < 0.2:
                    cands.append((sb, None))
                    continue
                cands.append((sb, {
                    "token": f"t{int(rng.integers(3))}",
                    "snap_seq": int(rng.integers(4)),
                    "tail_seq": int(rng.integers(8)),
                    "ts": float(rng.integers(20)),
                }))
            assert pick_freshest(cands) == ref_sp.pick_freshest(cands)


class FakeSkv:
    def __init__(self, gids=(1,)):
        self.gids = list(gids)
        self.on_write = None
        self.snap_calls = 0

    def snapshot_group(self, gid):
        self.snap_calls += 1
        return {"gid": gid, "n": self.snap_calls}


def _op(op="Put", key="k", value="v", cid=1, cmd=1):
    return types.SimpleNamespace(op=op, key=key, value=value,
                                 client_id=cid, command_id=cmd)


class FakeObs:
    def __init__(self):
        self.counts = {}
        self.gauges = {}
        self.metrics = types.SimpleNamespace(
            inc=lambda k, v=1: self.counts.__setitem__(
                k, self.counts.get(k, 0) + v
            ),
            set=lambda k, v: self.gauges.__setitem__(k, v),
        )


class TestStatePlaneUnit:
    def _plane(self, store, skv=None, **kw):
        skv = skv or FakeSkv()
        kw.setdefault("window_s", 0.0)
        plane = StatePlane(
            skv, me=0, n_procs=2, send=lambda sb, p: store.receive(p), **kw,
        )
        return plane, skv

    def test_capture_ships_snapshot_then_tail(self):
        store = StandbyStore()
        plane, skv = self._plane(store, window_s=1000.0)
        plane.note_write(1, _op(cid=9, cmd=1))
        assert plane.ship_round(now=0.0) >= 1
        f = store.freshness(1)
        assert f is not None and f["token"] == plane.token
        plane.note_write(1, _op("Append", "k", "w", cid=9, cmd=2))
        plane.ship_round(now=0.1)
        snap, tail = store.get(1)
        assert snap is not None
        assert tail == [("Append", "k", "w", 9, 2)]

    def test_reply_for_other_gid_never_folds_in(self):
        store = StandbyStore()
        plane, _ = self._plane(store)
        plane.note_write(1, _op())
        plane._apply_reply(1, 1, {"ok": True, "have": 50, "gid": 2},
                           "tail", 1, 10)
        assert plane._acked_tail.get((1, 1), -1) == -1
        plane._apply_reply(1, 1, {"ok": False, "have": -1}, "tail", 1, 10)
        assert plane._acked_tail.get((1, 1), -1) == -1

    def test_poll_mode_folds_each_reply_under_its_own_gid(self):
        """The port's async hook (one RPC in flight per standby, the
        reply handed back through ``poll``): a reply is folded under the
        gid it names, whichever group ships next, so two groups' writes
        are covered after three rounds; the reference folds a reply
        only when the next payload is for the same group."""
        store = StandbyStore()
        wal = types.SimpleNamespace(seq=0)
        flying = {}

        def send(sb, payload):
            assert sb not in flying  # never sent while one flies
            flying[sb] = store.receive(payload)

        def poll(sb):
            return (False, flying.pop(sb)) if sb in flying else (False, None)

        plane = StatePlane(
            FakeSkv(gids=(1, 2)), me=0, n_procs=2, send=send, poll=poll,
            window_s=1000.0, sync=True, wal_seq_fn=lambda: wal.seq,
        )
        for gid in (1, 2):
            wal.seq += 1
            plane.note_write(gid, _op(cid=gid, cmd=1))
        assert not plane.covered(2)
        for r in range(3):
            plane.ship_round(now=float(r))
        assert plane.covered(1) and plane.covered(2)
        assert plane._acked_tail[(1, 1)] == 1 == plane._acked_tail[(2, 1)]

    def test_poll_mode_builds_nothing_for_a_busy_standby(self):
        store = StandbyStore()
        sent = []
        plane = StatePlane(
            FakeSkv(), me=0, n_procs=2, send=lambda sb, p: sent.append(sb),
            poll=lambda sb: (True, None), window_s=0.0,
        )
        plane.note_write(1, _op())
        for r in range(3):
            plane.ship_round(now=float(r))
        assert not sent and plane.skv.snap_calls == 0
        assert store.freshness(1) is None

    def test_a_group_hosted_again_ships_under_a_new_token(self):
        """After forget_group the group's sequence numbers start over,
        so its next stay ships under a fresh token: the standby re-bases
        on the new snapshot instead of keeping the old stay's frontier,
        which would cover writes never shipped."""
        store = StandbyStore()
        plane, _ = self._plane(store, window_s=1000.0)
        for cmd in (1, 2, 3):
            plane.note_write(1, _op(cmd=cmd))
        plane.ship_round(now=0.0)
        first = store.freshness(1)
        assert first["token"] == plane.token and first["tail_seq"] == 3
        plane.forget_group(1)
        plane.note_write(1, _op(cmd=4))
        plane.ship_round(now=1.0)
        f = store.freshness(1)
        assert f["token"] != first["token"] and f["tail_seq"] == 1
        assert plane._acked_tail[(1, 1)] == 1

    def test_sync_gate_opens_only_after_standby_ack(self):
        store = StandbyStore()
        wal = types.SimpleNamespace(seq=0)
        plane, _ = self._plane(store, sync=True, wal_seq_fn=lambda: wal.seq)
        wal.seq = 7
        plane.note_write(1, _op(cid=3, cmd=1))
        assert not plane.covered(7)
        assert plane.covered(6)
        plane.ship_round(now=0.0)
        assert plane.covered(7)

    def test_dead_standby_keeps_gate_closed_and_lag_grows(self):
        wal = types.SimpleNamespace(seq=1)
        clock = types.SimpleNamespace(t=100.0)
        plane = StatePlane(
            FakeSkv(), me=0, n_procs=2, send=lambda sb, p: None,
            sync=True, wal_seq_fn=lambda: wal.seq, window_s=0.0,
            clock=lambda: clock.t,
        )
        plane.note_write(1, _op())
        plane.ship_round()
        assert not plane.covered(1)
        clock.t += 9.0
        assert plane.max_lag_s() >= 9.0

    def test_a_standby_that_left_the_fleet_is_replaced(self):
        """Deviation from the reference (ROADMAP queue C): once the
        placement push shows a standby process hosting nothing, the
        plane re-bases the group onto the next live candidate, and the
        sync gate the dead standby held closed opens.  Without the push
        the plane behaves as the reference's."""
        wal = types.SimpleNamespace(seq=1)
        stores = {1: StandbyStore(), 2: StandbyStore()}
        dead = {2}

        def send(sb, p):
            return None if sb in dead else stores[sb].receive(p)

        plane = StatePlane(FakeSkv(gids=(1,)), me=0, n_procs=3, send=send,
                           sync=True, wal_seq_fn=lambda: wal.seq,
                           window_s=0.0)
        ref = ref_sp.StatePlane(FakeSkv(gids=(1,)), me=0, n_procs=3,
                                send=send, sync=True,
                                wal_seq_fn=lambda: wal.seq, window_s=0.0)
        for pl in (plane, ref):
            pl.note_write(1, _op(cid=3, cmd=1))
            pl.ship_round()
            # gid 1's one standby among [1, 2] is proc 2: dead.
            assert not pl.covered(1)
        assert stores[1].freshness(1) is None
        plane.set_live([0, 1])
        assert plane.live_procs == {0, 1}
        plane.ship_round()
        assert plane.covered(1)
        assert stores[1].get(1)[0] is not None  # re-based by a snapshot
        ref.ship_round()
        assert not ref.covered(1)

    def test_forget_group_releases_sync_obligations(self):
        wal = types.SimpleNamespace(seq=4)
        plane, _ = self._plane(StandbyStore(), sync=True,
                               wal_seq_fn=lambda: wal.seq)
        plane.note_write(1, _op())
        assert not plane.covered(4)
        plane.forget_group(1)
        assert plane.covered(4)

    def test_metrics_and_ship_flight_records(self, tmp_path):
        from multiraft_tpu_torch.distributed import flightrec

        rec = flightrec.FlightRecorder(str(tmp_path / "sp.ring"), slots=64,
                                       name="p0")
        obs = FakeObs()
        store = StandbyStore()
        plane, _ = self._plane(store, obs=obs, recorder=rec, window_s=1000.0)
        plane.note_write(1, _op(cid=2, cmd=1))
        plane.ship_round(now=0.0)
        plane.note_write(1, _op("Append", "k", "x", cid=2, cmd=2))
        plane.ship_round(now=0.1)
        rec.close()
        assert obs.counts.get("ship.bytes", 0) > 0
        assert obs.counts.get("ship.tail_records") == 1
        assert obs.gauges.get("ship.lag_s") == 0.0
        ring = flightrec.read_ring(rec.path)
        ships = [r for r in ring["records"] if r["type"] == flightrec.SHIP]
        assert [r["tag"] for r in ships] == ["snap", "tail"]
        assert ships[0]["code"] == 1
        assert ships[1]["a"] == 1

    def test_standby_restart_rebases_onto_snapshot(self):
        store = StandbyStore()
        plane, _ = self._plane(store, window_s=1000.0)
        plane.note_write(1, _op(cid=5, cmd=1))
        plane.ship_round(now=0.0)
        plane.note_write(1, _op("Append", "k", "y", cid=5, cmd=2))
        plane.ship_round(now=0.1)
        assert store.freshness(1)["tail_seq"] == 2
        store.drop(1)
        plane.note_write(1, _op("Append", "k", "z", cid=5, cmd=3))
        for i in range(4):
            plane.ship_round(now=0.2 + i / 10)
            if (store.freshness(1) or {}).get("tail_seq") == 3:
                break
        f = store.freshness(1)
        assert f is not None and f["tail_seq"] == 3

    @pytest.mark.parametrize("seed", range(2))
    def test_shipped_payloads_are_the_references(self, seed):
        """One numpy-seeded write sequence through both packages'
        planes (same token, same clock): every shipment is the same
        bytes, and each package's standby store accepts the other's."""
        rng = np.random.default_rng(seed)
        writes = [
            (int(rng.integers(1, 4)),
             ("Put", "Append")[int(rng.integers(2))],
             f"k{int(rng.integers(5))}", f"v{i}", int(rng.integers(1, 4)), i + 1)
            for i in range(30)
        ]
        sent = {"port": [], "ref": []}
        stores = {"port": ref_sp.StandbyStore(), "ref": StandbyStore()}
        for pkg, mod in (("port", None), ("ref", ref_sp)):
            cls = StatePlane if mod is None else mod.StatePlane
            clock = types.SimpleNamespace(t=0.0)

            def send(sb, p, pkg=pkg):
                sent[pkg].append((sb, p))
                return stores[pkg].receive(p)  # the other package's store

            plane = cls(FakeSkv(gids=(1, 2, 3)), me=0, n_procs=3, send=send,
                        window_s=1.0, clock=lambda c=clock: c.t)
            plane.token = "0.fixedtoken"
            for j, (gid, op, key, value, cid, cmd) in enumerate(writes):
                plane.note_write(gid, _op(op, key, value, cid, cmd))
                if j % 4 == 3:
                    clock.t += 0.4
                    plane.ship_round()
            clock.t += 2.0
            plane.ship_round()
        assert sent["port"] and sent["port"] == sent["ref"]
        for gid in (1, 2, 3):
            assert stores["port"].get(gid) == stores["ref"].get(gid)




# ---------------------------------------------------------------------------
# unseal_group post-dispatch: the fork guard (satellite 1)
# ---------------------------------------------------------------------------


class _MovingHost(FakeSkv):
    """A fleet server's engine side as ``pull_group``/``drop_group``
    use it: one hosted group that seals on export."""

    def __init__(self, gid, blob):
        super().__init__(gids=(gid,))
        self.reps = {gid: blob}

    def export_group(self, gid):
        return dict(self.reps[gid]) if gid in self.reps else None

    def group_quiesced(self, gid):
        return True

    def drop_gid(self, gid):
        self.reps.pop(gid)
        self.gids.remove(gid)

    def unseal_group(self, gid, force=False):
        pass


class TestDepartingOwnerKeepsItsCopy:
    """Deviation from the reference (ROADMAP queue C): a fleet server
    that drops a group it sealed for a move keeps that sealed state in
    its own standby store, so a group that moved onto its own standby
    is not lost with the destination before the destination's first
    shipment lands; the new owner's shipments, stamped later, win."""

    def _run(self, gen):
        while True:
            try:
                next(gen)
            except StopIteration as stop:
                return stop.value

    def _server(self):
        from multiraft_tpu_torch.distributed.engine_shard_server import (
            EngineShardKVService,
        )

        blob = {"gid": 7, "cur": None, "prev": None, "shards": {0: ("S", {"k": "v"}, {})}}
        host = _MovingHost(7, blob)
        plane = StatePlane(host, me=0, n_procs=2, send=lambda sb, p: None)
        for cmd in (1, 2, 3):
            plane.note_write(7, _op(cmd=cmd))
        svc = types.SimpleNamespace(
            skv=host, _plane=plane, _standby=StandbyStore(), _sealed_at={},
            m=FakeObs().metrics, sched=types.SimpleNamespace(now=0.0),
            DEADLINE_S=5.0, _rebuild_peers=lambda: None,
        )
        svc._keep_final_copy = types.MethodType(
            EngineShardKVService._keep_final_copy, svc)
        call = lambda name, args: getattr(EngineShardKVService, name)(svc, args)
        return call, svc, plane, blob

    def test_drop_after_a_pull_keeps_the_sealed_state(self):
        call, svc, plane, blob = self._server()
        token = plane._token(7)
        t0 = time.monotonic()
        assert self._run(call("pull_group", (7,))) == ("OK", blob)
        assert self._run(call("drop_group", (7,))) == ("OK",)
        f = svc._standby.freshness(7)
        assert (f["token"], f["tail_seq"], f["snap_seq"]) == (token, 3, 3)
        assert t0 <= f["ts"] <= time.monotonic() and f["has_snap"]
        assert svc._standby.get(7) == (blob, [])
        assert not svc._sealed_at and 7 not in plane._tail_seq

    def test_an_aborted_move_keeps_nothing(self):
        call, svc, plane, _ = self._server()
        self._run(call("pull_group", (7,)))
        assert call("unseal_group", (7, True)) == ("OK",)
        self._run(call("drop_group", (7,)))
        assert svc._standby.freshness(7) is None

    def test_the_new_owners_shipments_outrank_the_kept_copy(self):
        store = StandbyStore()
        store.keep(7, {"gid": 7}, "0.a", 3, ts=10.0)
        store.keep(7, {"gid": 7, "old": True}, "2.c", 9, ts=4.0)  # older: ignored
        assert store.freshness(7)["token"] == "0.a"
        stale = {"token": "2.c", "snap_seq": 9, "tail_seq": 9, "ts": 4.0,
                 "has_snap": True}
        assert pick_freshest([(0, store.freshness(7)), (2, stale)]) == [0, 2]
        newer = {"token": "1.b", "snap_seq": 0, "tail_seq": 1, "ts": 11.0,
                 "has_snap": True}
        assert pick_freshest([(0, store.freshness(7)), (2, newer)])[0] == 2
        # The new owner becoming this process's shipper replaces it.
        msg = {"gid": 7, "token": "1.b", "kind": "snap", "snap_seq": 0,
               "snap": {"gid": 7}, "records": [], "ts": 11.0}
        assert store.receive(frame_blob(codec.encode(msg)))["ok"]
        assert store.freshness(7)["token"] == "1.b"


class TestUnsealAfterDispatch:
    def test_unseal_after_export_raises_without_force(self):
        from multiraft_tpu_torch.harness.fleet import InProcessFleet

        fleet = InProcessFleet([[1]], spare_slots=1, seed=11, device="cpu")
        fleet.admin("join", [1])
        fleet.settle()
        inst = fleet.instances[0]
        blob = None
        for _ in range(200):
            blob = inst.export_group(1)
            if blob is not None:
                break
            fleet.pump_all(2)
        assert blob is not None and inst.is_sealed(1)
        # The blob may now sit in an adopt RPC: unsealing could fork
        # the group.  Only the controller's provably-dead-destination
        # resume leg (force=True) may revive it.
        with pytest.raises(RuntimeError, match="dispatched"):
            inst.unseal_group(1)
        assert inst.is_sealed(1)
        inst.unseal_group(1, force=True)
        assert not inst.is_sealed(1)


# ---------------------------------------------------------------------------
# In-process durable failover: ship → kill → recover
# ---------------------------------------------------------------------------


def _placed_fleet(seed, rules=None, sync=True):
    from multiraft_tpu_torch.distributed.placement import LocalPlacementStore
    from multiraft_tpu_torch.harness.fleet import (
        InProcessFleet,
        LocalFleetTransport,
    )
    from tests.test_torch_placement import make_controller

    fleet = InProcessFleet([[1], [2]], spare_slots=1, seed=seed, device="cpu")
    fleet.admin("join", [1])
    fleet.admin("join", [2])
    fleet.settle()
    fleet.enable_shipping(rules, window_s=0.0, sync=sync)
    store = LocalPlacementStore({1: 0, 2: 1})
    ctl = make_controller(LocalFleetTransport(fleet), store)
    return fleet, store, ctl


def _fail_over(fleet, store, ctl, victim, gids):
    fleet.kill(victim)
    ctl.dead.add(victim)
    for _ in range(8):
        ctl.step()
        _, placement, pending, _ = store.query()
        if not pending and all(
            placement[g] != victim for g in gids
        ):
            break
    _, placement, pending, history = store.query()
    assert not pending
    assert all(placement[g] != victim for g in gids)
    assert any(h[4] == "failover" for h in history)
    return placement


class TestDurableFailover:
    def test_ship_kill_recover_preserves_data_exactly_once(self):
        from multiraft_tpu_torch.services.shardkv import key2shard

        fleet, store, ctl = _placed_fleet(seed=5)
        clerk = fleet.clerk()
        clerk.put("a", "1")
        clerk.append("a", "2")
        clerk.put("b", "x")
        fleet.pump_all(4)  # ship rounds run inside pump_all

        cfg = fleet.instances[0].query_latest()
        gid = cfg.shards[key2shard("a")]
        victim = fleet.proc_of(gid)
        survivor = 1 - victim
        # The standby already holds shipped state for the victim's gid.
        assert fleet.standbys[survivor].freshness(gid) is not None

        _fail_over(fleet, store, ctl, victim,
                   [g for g in (1, 2) if fleet.proc_of(g) is None])
        # Acked writes survived the SIGKILL: recovered, not empty.
        assert clerk.get("a") == "12"
        assert ctl._obs is None or True  # controller obs optional
        # Exactly-once: the tail replayed with original session ids, so
        # the dedup table is intact — a fresh append lands exactly once.
        clerk.append("a", "3")
        assert clerk.get("a") == "123"
        # Post-recovery the fleet serves every key.
        for key in ("a", "b", "q"):
            clerk.put(key, f"post-{key}")
            assert clerk.get(key) == f"post-{key}"

    def test_no_shipped_state_falls_back_to_explicit_empty_adoption(self):
        from multiraft_tpu_torch.services.shardkv import key2shard

        # Pin every group's shipments to its OWN owner: unsatisfiable,
        # so nothing ever ships (the no-standby degenerate case).
        rules = [
            (r"gid-1", ShipSpec(pin=(0,))),
            (r"gid-2", ShipSpec(pin=(1,))),
        ]
        fleet, store, ctl = _placed_fleet(seed=6, rules=rules,
                                          sync=False)
        clerk = fleet.clerk()
        clerk.put("a", "doomed")
        fleet.pump_all(4)

        cfg = fleet.instances[0].query_latest()
        gid = cfg.shards[key2shard("a")]
        victim = fleet.proc_of(gid)
        survivor = 1 - victim
        assert fleet.standbys[survivor].freshness(gid) is None

        _fail_over(fleet, store, ctl, victim, [gid])
        # Crash model: the data died with the process — but the group
        # serves again at the LATEST config via EXPLICIT empty adoption.
        assert clerk.get("a") == ""
        clerk.put("a", "reborn")
        assert clerk.get("a") == "reborn"

    def test_controller_prefers_standby_with_freshest_state(self):
        from multiraft_tpu_torch.distributed.placement import (
            LocalPlacementStore,
        )
        from multiraft_tpu_torch.harness.fleet import (
            InProcessFleet,
            LocalFleetTransport,
        )
        from multiraft_tpu_torch.services.shardkv import key2shard
        from tests.test_torch_placement import make_controller

        # Three procs, two shipping copies per group: when the owner
        # dies, BOTH survivors hold state, and the controller routes
        # the failover to the freshest one (here equal — but an offline
        # standby must be excluded even though it holds state).
        fleet = InProcessFleet([[1], [2], [3]], spare_slots=2, seed=7, device="cpu")
        for g in (1, 2, 3):
            fleet.admin("join", [g])
        fleet.settle()
        fleet.enable_shipping([(r".*", ShipSpec(copies=2))],
                              window_s=0.0, sync=True)
        store = LocalPlacementStore({1: 0, 2: 1, 3: 2})
        tr = LocalFleetTransport(fleet)
        ctl = make_controller(tr, store, max_moves=2)
        clerk = fleet.clerk()
        clerk.put("a", "A")
        clerk.put("b", "B")
        fleet.pump_all(4)

        cfg = fleet.instances[0].query_latest()
        gid = cfg.shards[key2shard("a")]
        victim = fleet.proc_of(gid)
        others = [p for p in (0, 1, 2) if p != victim]
        # Kill one standby too: its copy is fresh but OFFLINE — the
        # controller must pick the live one.
        dead_standby = others[0]
        live = others[1]
        fleet.kill(dead_standby)
        ctl.dead.add(dead_standby)
        fleet.kill(victim)
        ctl.dead.add(victim)
        for _ in range(12):
            ctl.step()
            _, placement, pending, _ = store.query()
            if not pending and all(
                placement[g] == live for g in (1, 2, 3)
            ):
                break
        _, placement, pending, _ = store.query()
        assert all(placement[g] == live for g in placement), placement
        assert clerk.get("a") == "A"
        assert clerk.get("b") == "B"


# ---------------------------------------------------------------------------
# Observability: doctor anomaly + trace summary (satellite 4)
# ---------------------------------------------------------------------------


class TestShipObservability:
    _n = 0

    def _ring(self, tmp_path, ships, extra_gap_s=0.0, clean=False):
        from multiraft_tpu_torch.distributed import flightrec

        TestShipObservability._n += 1
        rec = flightrec.FlightRecorder(
            str(tmp_path / f"so{TestShipObservability._n}.ring"),
            slots=128, name="p0",
        )
        for gid, tag, frontier in ships:
            rec.record(flightrec.SHIP, code=gid, a=2, b=64,
                       c=frontier, tag=tag)
        if extra_gap_s:
            time.sleep(extra_gap_s)
            rec.record(flightrec.TICK, a=1)  # death happens later
        if clean:
            rec.record(flightrec.NODE_CLOSE, tag="p0")
        rec.close()
        return rec.path

    def test_doctor_flags_data_loss_window_exceeded(
        self, tmp_path, monkeypatch
    ):
        from multiraft_tpu_torch.analysis import postmortem

        monkeypatch.setenv("MRT_SHIP_WINDOW_S", "0.05")
        ring = self._ring(tmp_path, [(3, "tail", 9)], extra_gap_s=0.12)
        analysis = postmortem.analyze(postmortem.load_bundle(ring))
        hits = [a for a in analysis["anomalies"]
                if a["kind"] == "ship_window_exceeded"]
        assert len(hits) == 1
        assert "group 3" in hits[0]["detail"]
        assert "frontier 9" in hits[0]["detail"]
        proc = analysis["procs"][0]
        assert proc["shipments"][3]["last_frontier"] == 9

    def test_doctor_quiet_when_within_window_or_clean_or_no_ships(
        self, tmp_path, monkeypatch
    ):
        from multiraft_tpu_torch.analysis import postmortem

        monkeypatch.setenv("MRT_SHIP_WINDOW_S", "30.0")
        # Unclean death but the last shipment is recent: no anomaly.
        ring = self._ring(tmp_path, [(3, "snap", 4)], extra_gap_s=0.01)
        analysis = postmortem.analyze(postmortem.load_bundle(ring))
        kinds = [a["kind"] for a in analysis["anomalies"]]
        assert "ship_window_exceeded" not in kinds

        # A fleet that never shipped must not false-positive, even
        # with a tiny window.
        monkeypatch.setenv("MRT_SHIP_WINDOW_S", "0.0")
        ring = self._ring(tmp_path, [], extra_gap_s=0.01)
        analysis = postmortem.analyze(postmortem.load_bundle(ring))
        kinds = [a["kind"] for a in analysis["anomalies"]]
        assert "ship_window_exceeded" not in kinds
        assert "shipments" not in analysis["procs"][0]

        # Clean close: shutdown is not data loss.
        monkeypatch.setenv("MRT_SHIP_WINDOW_S", "0.0")
        ring = self._ring(tmp_path, [(2, "tail", 5)], extra_gap_s=0.01,
                          clean=True)
        analysis = postmortem.analyze(postmortem.load_bundle(ring))
        kinds = [a["kind"] for a in analysis["anomalies"]]
        assert "ship_window_exceeded" not in kinds

    def test_doctor_trace_has_ship_instants(self, tmp_path):
        from multiraft_tpu_torch.analysis import postmortem

        ring = self._ring(tmp_path, [(3, "snap", 7), (3, "tail", 11)])
        tracer = postmortem.rings_to_trace(postmortem.load_bundle(ring))
        inst = [e for e in tracer.events
                if e.get("ph") == "i" and e["name"].startswith("ship:")]
        assert len(inst) == 2
        assert inst[0]["args"]["kind"] == "snap"
        assert inst[1]["args"]["frontier"] == 11
        assert all(e["tid"] == "ship" for e in inst)


# The slow scenario runs its fleet on the card when there is one.
_DEVICE = "cuda" if torch.cuda.is_available() else "cpu"


# ---------------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.timeout_s(600)
def test_durable_failover_chaos_loses_zero_acked_writes(tmp_path):
    """The durable acceptance scenario over real sockets: a PlacedFleet
    with SYNC shipping (acks gate on standby coverage) takes clerk load
    while the nemesis SIGKILLs one mesh process; every acknowledged
    write from before the kill is still readable after the stateful
    failover, the fleet serves, and the racing clerk history stays
    linearizable."""
    from multiraft_tpu_torch.harness.fleet import PlacedFleet
    from multiraft_tpu_torch.harness.nemesis import run_clerk_load
    from multiraft_tpu_torch.porcupine.kv import kv_model
    from multiraft_tpu_torch.porcupine.visualization import (
        assert_linearizable,
    )

    fleet = PlacedFleet(
        [[1], [2], [3]], spare_slots=2, seed=23,
        shipping=True, ship_sync=True, ship_window_s=0.5, device=_DEVICE,
        controller_kwargs=dict(
            scrape_s=0.3, dead_s=2.0, cooldown_s=5.0,
            min_gain=0.25, max_moves=1,
        ),
    )
    try:
        fleet.start()
        for g in (1, 2, 3):
            fleet.admin("join", [g])

        # Phase 1: acknowledged writes that MUST survive the kill.
        # (Separate key space from the load phase so porcupine's
        # history stays self-contained.)
        clerk = fleet.clerk()
        durable = {f"d{c}": f"v{c}" for c in "abcdef"}
        for k, v in durable.items():
            clerk.put(k, v)

        victim = 2
        _, placement0 = fleet.placement()
        victim_gids = [g for g, p in placement0.items() if p == victim]
        assert victim_gids

        t_kill = time.monotonic()
        fleet.kill_mesh_process(victim)
        deadline = t_kill + 120.0
        while time.monotonic() < deadline:
            _, placement, pending, _ = fleet.pmap.query()
            if not pending and all(
                placement.get(g) not in (None, victim)
                for g in victim_gids
            ):
                break
            time.sleep(0.25)
        replace_s = time.monotonic() - t_kill
        _, placement, pending, history = fleet.pmap.query()
        assert all(placement[g] != victim for g in victim_gids), (
            placement, pending
        )
        assert replace_s < 120.0
        assert any(h[4] == "failover" for h in history)

        # Phase 2: ZERO acknowledged writes lost — sync shipping means
        # every acked pre-kill write was standby-covered before its ack.
        clerk2 = fleet.clerk()
        for k, v in durable.items():
            assert clerk2.get(k) == v, f"acked write {k} lost"

        # Phase 3: the fleet serves under load and linearizes.
        history_ops = run_clerk_load(
            fleet.clerk, keys=["pa", "pb", "pc"],
            n_workers=3, ops_per_worker=6, op_timeout=120.0,
        )
        assert_linearizable(
            kv_model, history_ops, timeout=60.0,
            name="durable-failover-chaos",
        )
    finally:
        fleet.shutdown()


@pytest.mark.timeout_s(240)
def test_writes_ack_on_every_group_after_a_process_dies(tmp_path):
    """A sync-shipping ``PlacedFleet`` (CPU) loses a process: after the
    failover, a write to every shard acknowledges — also on the groups
    whose standby was the dead process (the reference's would wait on
    it for good; ROADMAP queue C)."""
    from multiraft_tpu_torch.harness.fleet import PlacedFleet

    fleet = PlacedFleet(
        [[1], [2], [3]], spare_slots=2, seed=23, shipping=True,
        ship_sync=True, ship_window_s=0.5, device="cpu",
        data_dir=str(tmp_path / "d"),
        controller_kwargs=dict(scrape_s=0.3, dead_s=2.0, cooldown_s=5.0,
                               min_gain=0.25, max_moves=1),
    )
    try:
        fleet.start()
        for g in (1, 2, 3):
            fleet.admin("join", [g])
        clerk = fleet.clerk()
        keys = [f"{i}k" for i in range(10)]  # one per shard
        for k in keys:
            clerk.put(k, "a")
        fleet.kill_mesh_process(2)
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            _, placement, pending, _ = fleet.pmap.query()
            if not pending and all(p != 2 for p in placement.values()):
                break
            time.sleep(0.25)
        assert all(p != 2 for p in placement.values()), placement
        for k in keys:
            clerk.append(k, "b", timeout=60.0)
        assert [clerk.get(k) for k in keys] == ["ab"] * 10
        clerk.close()
    finally:
        fleet.shutdown()


@pytest.mark.timeout_s(120)
def test_a_recovering_group_answers_wrong_group_until_its_tail_replays():
    """Deviation from the reference (ROADMAP queue C): while
    ``recover_group`` replays a group's shipped tail, reads and writes
    of its keys are refused with ErrWrongGroup (the clerk retries)
    instead of being served from the snapshot alone; the group serves
    again once the replay ends."""
    from multiraft_tpu_torch.distributed.engine_clerks import EngineFleetClerk
    from multiraft_tpu_torch.distributed.engine_shard_server import (
        serve_engine_shardkv,
    )
    from multiraft_tpu_torch.distributed.engine_wire import EngineCmdArgs
    from multiraft_tpu_torch.distributed.tcp import RpcNode

    node = serve_engine_shardkv(0, gids=[1], peer_addrs={}, device="cpu")
    client = RpcNode()
    try:
        svc = node.engine_service
        end = client.client_end(node.host, node.port)
        r = client.sched.wait(end.call("EngineShardKV.admin", ("join", [1], 1)), 30)
        assert r.err == "OK"
        ck = EngineFleetClerk(client.sched, {1: end})
        assert client.sched.wait(client.sched.spawn(ck.put("1k", "v")), 30) == ""
        svc._recovering.add(1)
        for args in (EngineCmdArgs(op="Get", key="1k"),
                     EngineCmdArgs(op="Put", key="1k", value="w",
                                   client_id=5, command_id=1)):
            r = client.sched.wait(end.call("EngineShardKV.command", args), 30)
            assert r.err == "ErrWrongGroup", (args.op, r)
        (r,) = client.sched.wait(end.call(
            "EngineShardKV.batch", [EngineCmdArgs(op="Get", key="1k")]), 30)
        assert r.err == "ErrWrongGroup"
        svc._recovering.clear()
        r = client.sched.wait(end.call(
            "EngineShardKV.command", EngineCmdArgs(op="Get", key="1k")), 30)
        assert (r.err, r.value) == ("OK", "v")
    finally:
        client.close()
        node.close()
