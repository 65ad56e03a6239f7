"""The port's write-ahead log against the reference's.

The same record sequence (WAL records of the durable KV server, encoded
by each package's codec) gives byte-identical files in the two
packages, through syncs and rotations; a torn tail is recovered the
same way by both, and the next incarnation's appends replay after it;
each package replays a log the other wrote.
"""

import numpy as np
import pytest

from multiraft_tpu.distributed.wal import WriteAheadLog as RefWAL
from multiraft_tpu.transport import codec as ref_codec
from multiraft_tpu_torch.distributed.wal import WriteAheadLog as PortWAL
from multiraft_tpu_torch.transport import codec as port_codec


def _records(seed, n=60):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        op = ["Put", "Append"][int(rng.integers(2))]
        key = f"k{int(rng.integers(12))}"
        value = "".join(chr(c) for c in rng.integers(32, 0x3FF, int(rng.integers(0, 30))))
        out.append(("kv", op, key, value, int(rng.integers(0, 2**63)), i + 1))
    return out


def _write(cls, codec, path, records, seed):
    """Append ``records`` with seeded syncs and rotations; returns the
    records the log holds at the end (those after the last rotation)."""
    rng = np.random.default_rng(seed + 1000)
    w = cls(path, fsync=False)
    live = []
    for rec in records:
        seq = w.append(codec.encode(rec))
        assert seq == w.appended
        live.append(rec)
        r = rng.random()
        if r < 0.3:
            w.sync()
        elif r < 0.35:
            w.sync()
            w.rotate()
            live = []
    w.sync()
    w.close()
    return live


@pytest.mark.parametrize("seed", range(4))
def test_same_records_give_identical_files(tmp_path, seed):
    recs = _records(seed)
    ref_live = _write(RefWAL, ref_codec, str(tmp_path / "ref.wal"), recs, seed)
    port_live = _write(PortWAL, port_codec, str(tmp_path / "port.wal"), recs, seed)
    assert ref_live == port_live
    ref_bytes = (tmp_path / "ref.wal").read_bytes()
    assert (tmp_path / "port.wal").read_bytes() == ref_bytes
    assert [ref_codec.decode(b) for b in PortWAL(str(tmp_path / "port.wal"),
                                                  fsync=False).replay()] == ref_live


@pytest.mark.parametrize("tear", ["partial_header", "partial_body", "bit_flip"])
def test_torn_tail_recovered_the_same_way(tmp_path, tear):
    recs = _records(7, n=12)
    paths = {}
    for name, cls, codec in (("ref", RefWAL, ref_codec), ("port", PortWAL, port_codec)):
        p = str(tmp_path / f"{name}.wal")
        w = cls(p, fsync=False)
        for rec in recs:
            w.append(codec.encode(rec))
        w.sync()
        w.close()
        raw = bytearray(open(p, "rb").read())
        if tear == "partial_header":
            raw += b"MRWL\x00\x01"
        elif tear == "partial_body":
            raw = raw[:-5]
        else:
            raw[-3] ^= 0xFF
        open(p, "wb").write(bytes(raw))
        paths[name] = p
    assert open(paths["ref"], "rb").read() == open(paths["port"], "rb").read()
    # Both keep the same intact prefix, truncate the same tail, and the
    # next incarnation's appends replay after it.
    for name, cls, codec in (("ref", RefWAL, ref_codec), ("port", PortWAL, port_codec)):
        w = cls(paths[name], fsync=False)
        got = [codec.decode(b) for b in w.replay()]
        assert got == (recs if tear == "partial_header" else recs[:-1])
        w.append(codec.encode(("kv", "Put", "after", "tear", 1, 99)))
        w.sync()
        w.close()
    assert open(paths["ref"], "rb").read() == open(paths["port"], "rb").read()
    for cls, codec in ((RefWAL, ref_codec), (PortWAL, port_codec)):
        got = [codec.decode(b) for b in cls(paths["port"], fsync=False).replay()]
        assert got[-1] == ("kv", "Put", "after", "tear", 1, 99)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_package_replays_the_others_log(tmp_path, writer):
    recs = _records(11, n=40)
    p = str(tmp_path / "ops.wal")
    w_cls, w_codec = (RefWAL, ref_codec) if writer == "ref" else (PortWAL, port_codec)
    r_cls, r_codec = (PortWAL, port_codec) if writer == "ref" else (RefWAL, ref_codec)
    w = w_cls(p, fsync=True)
    seqs = [w.append(w_codec.encode(rec)) for rec in recs]
    assert w.synced < seqs[0]
    w.sync()
    assert w.synced == seqs[-1]
    assert [s for s, _ in w.tail(len(recs) - 3)] == seqs[-3:]
    w.close()
    reader = r_cls(p, fsync=False)
    assert [r_codec.decode(b) for b in reader.replay()] == recs
    reader.rotate()
    reader.close()
    assert list(w_cls(p, fsync=False).replay()) == []
