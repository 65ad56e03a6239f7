"""Durability of the port's engine KV server against the reference's.

Lockstep: the reference's crash-rebuild fuzz
(``tests/test_engine_durability.py``) runs on both packages from one
seed, through each package's own ``EngineDurability`` and
``replay_kv_wal`` (the durable server's recovery path).  Ops are acked
only after a WAL sync, crashes drop every in-memory object and rebuild
from the data directory, un-acked ops are retried under their original
session ids.  After every incarnation the KV data, the sessions and the
WAL bytes of the two packages are equal, and every acked append is
there exactly once.

Across packages: a data directory (``engine.ckpt`` + ``ops.wal``)
written by the reference is recovered by the port, and one written by
the port is recovered by the reference, with equal KV data.  The
reference reads the port's checkpoint through the inverse of
``convert.CHECKPOINT_CLASSES`` (as ``test_torch_checkpoint.py`` does):
nothing in the reference changes for it.
"""

import os
import pickle
import types

import numpy as np
import pytest
import torch

import multiraft_tpu.distributed.engine_durability as ref_dur
import multiraft_tpu.distributed.engine_wire as ref_wire
import multiraft_tpu.engine.core as ref_core
import multiraft_tpu.engine.host as ref_host
import multiraft_tpu.engine.kv as ref_kv
import multiraft_tpu_torch.distributed.engine_durability as port_dur
import multiraft_tpu_torch.distributed.engine_wire as port_wire
import multiraft_tpu_torch.engine.core as port_core
import multiraft_tpu_torch.engine.host as port_host
import multiraft_tpu_torch.engine.kv as port_kv
from test_torch_checkpoint import _PortToReference

# Small shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the host's cores.
torch.set_num_threads(1)

G = 8
REF = types.SimpleNamespace(
    name="ref", dur=ref_dur, wire=ref_wire, core=ref_core, host=ref_host,
    kv=ref_kv, restore=lambda p: ref_host.EngineDriver.restore(p),
    device={},
)
PORT = types.SimpleNamespace(
    name="port", dur=port_dur, wire=port_wire, core=port_core, host=port_host,
    kv=port_kv,
    restore=lambda p: port_host.EngineDriver.restore(p, device="cpu"),
    device={"device": "cpu"},
)


class DurableRig:
    """The durable server's build and recovery path, without sockets:
    restore the checkpoint or elect from scratch, attach the WAL at
    apply time, replay it through consensus."""

    def __init__(self, pkg, data_dir: str):
        self.pkg = pkg
        ckpt = os.path.join(data_dir, "engine.ckpt")
        if os.path.exists(ckpt):
            driver = pkg.restore(ckpt)
            kv = pkg.kv.BatchedKV(driver)
            blob = driver.restored_extra.get("service")
            if blob:
                kv.load_state_dict(blob)
        else:
            cfg = pkg.core.EngineConfig(G=G, P=3, L=64, E=8, INGEST=8)
            driver = pkg.host.EngineDriver(cfg, seed=3, **pkg.device)
            kv = pkg.kv.BatchedKV(driver)
            assert driver.run_until_quiet_leaders(1500)
        dur = pkg.dur.EngineDurability(
            data_dir, driver, kv, checkpoint_every_s=0.0, fsync=False
        )
        opname = pkg.wire._OPNAME
        kv.on_write = lambda g, op: dur.log(
            ("kv", opname[op.op], op.key, op.value, op.client_id, op.command_id)
        )
        self.replayed = pkg.dur.replay_kv_wal(kv, dur, G)
        self.kv, self.dur = kv, dur

    def apply(self, op, key, value, cid, cmd):
        """Submit one write and pump it to commit (resubmitting evicted
        tickets under the same ids, as the server's handler does)."""
        pkg = self.pkg

        def submit():
            return self.kv.submit(
                pkg.wire.route_group(key, G),
                pkg.kv.KVOp(op=pkg.wire._OPCODE[op], key=key, value=value,
                            client_id=cid, command_id=cmd),
            )

        t = submit()
        for _ in range(2000):
            if t.done and not t.failed:
                return t
            if t.done:
                t = submit()
            self.kv.pump(2)
        raise AssertionError(f"{pkg.name}: {op} {key} did not commit")

    def value_of(self, key):
        return self.kv.data[self.pkg.wire.route_group(key, G)].get(key, "")

    def wal_bytes(self):
        self.dur.wal.sync()
        with open(self.dur.wal.path, "rb") as f:
            return f.read()


def _same(a: DurableRig, b: DurableRig, where):
    assert a.kv.data == b.kv.data, where
    assert a.kv.sessions == b.kv.sessions, where
    assert a.wal_bytes() == b.wal_bytes(), where


def test_crash_rebuild_fuzz_in_lockstep(tmp_path):
    """The reference's fuzz, both packages driven by one rng."""
    rng = np.random.default_rng(11)
    dirs = {p.name: str(tmp_path / p.name) for p in (REF, PORT)}
    rigs = [DurableRig(p, dirs[p.name]) for p in (REF, PORT)]
    _same(*rigs, "boot")
    clients = 3
    cmd = [0] * clients
    shadow = {}
    unacked = []
    replayed = 0
    for incarnation in range(4):
        for _ in range(20):
            ci = int(rng.integers(clients))
            key = f"c{ci}-k{int(rng.integers(3))}"  # single-writer keys
            cmd[ci] += 1
            piece = f"[{incarnation}.{cmd[ci]}]"
            op = ("Append", key, piece, 1000 + ci, cmd[ci])
            for rig in rigs:
                rig.apply(*op)
            shadow[key] = shadow.get(key, "") + piece
            acked = rng.random() < 0.8
            ckpt = rng.random() < 0.15
            for rig in rigs:
                if acked:
                    rig.dur.wal.sync()
                if ckpt:
                    rig.dur.checkpoint()
            if not acked:
                unacked.append(op)
        _same(*rigs, f"incarnation {incarnation} before the crash")
        # CRASH: drop everything in memory, rebuild from the directory.
        rigs = [DurableRig(p, dirs[p.name]) for p in (REF, PORT)]
        assert rigs[0].replayed == rigs[1].replayed
        replayed += rigs[0].replayed
        _same(*rigs, f"incarnation {incarnation} recovered")
        for op in unacked:
            for rig in rigs:
                rig.apply(*op)
        unacked = []
        for key, want in shadow.items():
            for rig in rigs:
                assert rig.value_of(key) == want, (rig.pkg.name, incarnation, key)
        _same(*rigs, f"incarnation {incarnation} after retries")
    assert replayed > 0


def _reference_checkpoint_of_port(path):
    """Rewrite a port ``engine.ckpt`` in place as the reference's."""
    with open(path, "rb") as f:
        blob = _PortToReference(f).load()
    blob["cfg"] = blob["cfg"].cfg
    with open(path, "wb") as f:
        pickle.dump(blob, f, protocol=pickle.HIGHEST_PROTOCOL)


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_data_dir_crosses_packages(tmp_path, direction):
    src_pkg, dst_pkg = (REF, PORT) if direction == "reference_to_port" else (PORT, REF)
    d = str(tmp_path / "data")
    rng = np.random.default_rng(23)
    rig = DurableRig(src_pkg, d)
    want = {}
    for i in range(30):
        key = f"x{int(rng.integers(6))}"
        op = "Put" if rng.random() < 0.3 else "Append"
        piece = f"<{i}>"
        last = (op, key, piece, 77, i + 1)
        rig.apply(*last)
        want[key] = piece if op == "Put" else want.get(key, "") + piece
        if i == 14:
            rig.dur.checkpoint()  # half in the checkpoint, half in the WAL
    rig.dur.wal.sync()
    with open(os.path.join(d, "ops.wal"), "rb") as f:
        assert f.read(4) == b"MRWL"
    src_data = rig.kv.data
    del rig
    if dst_pkg is REF:
        _reference_checkpoint_of_port(os.path.join(d, "engine.ckpt"))
    got = DurableRig(dst_pkg, d)
    assert got.replayed == 15
    for key, value in want.items():
        assert got.value_of(key) == value, key
    assert got.kv.data == src_data
    # The recovered server keeps serving: a retried old command is a
    # no-op and a new one applies once.
    got.apply(*last)
    assert got.kv.data == src_data
    got.apply("Append", last[1], "<new>", 77, 31)
    assert got.value_of(last[1]) == want[last[1]] + "<new>"
