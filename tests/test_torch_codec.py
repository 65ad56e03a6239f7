"""The port's wire codec against the reference's, byte for byte.

For seeded values (the two wire dataclasses, the RPC frame shapes that
carry them, nested tuples and dicts, bytes blobs, numpy arrays shipped
out of band and the admission ``busy`` frame), ``encode`` and
``encode_oob`` give the reference's bytes exactly; each package decodes
the other's bytes to equal values; both refuse an unregistered class.
The port's registered classes go on the wire under the reference's
module name, and its decoder reads both names.
"""

import dataclasses
import pickle

import numpy as np
import pytest

from multiraft_tpu.distributed import engine_wire as ref_wire
from multiraft_tpu.transport import codec as ref_codec
from multiraft_tpu_torch.distributed import engine_wire as port_wire
from multiraft_tpu_torch.transport import codec as port_codec

SEEDS = range(6)


def _values(wire, seed):
    """One seeded value of every kind, built from ``wire``'s classes."""
    rng = np.random.default_rng(seed)
    text = lambda n: "".join(chr(c) for c in rng.integers(32, 0x24F, n))  # noqa: E731
    args = [
        wire.EngineCmdArgs(
            op=["Get", "Put", "Append"][int(rng.integers(3))],
            key=text(int(rng.integers(0, 12))),
            value=text(int(rng.integers(0, 40))),
            client_id=int(rng.integers(0, 2**63)),
            command_id=int(rng.integers(0, 2**31)),
        )
        for _ in range(int(rng.integers(1, 9)))
    ]
    reply = wire.EngineCmdReply(
        err=["OK", "ErrTimeout", "ErrBusy"][int(rng.integers(3))],
        value=text(int(rng.integers(0, 30))),
        retry_after_s=float(rng.random()),
    )
    col = rng.integers(-(2**31), 2**31, int(rng.integers(600, 3000))).astype(
        np.int32
    )
    blob = rng.integers(0, 256, int(rng.integers(2048, 9000)), dtype=np.uint8)
    return {
        "args": args[0],
        "reply": reply,
        "busy_reply": wire.busy_reply(float(rng.random())),
        "req": ("req", int(rng.integers(1, 10**6)), "EngineKV.command", args[0]),
        "req_traced": ("req", 7, "EngineKV.command", args[0],
                       (f"r{seed}", float(rng.random()))),
        "batch": ("req", 9, "EngineKV.batch", args),
        "rep": ("rep", 3, reply),
        "repb": ("repb", [(i, wire.EngineCmdReply(value=text(3)))
                          for i in range(int(rng.integers(1, 6)))]),
        "busy": ("busy", int(rng.integers(1, 10**6)), float(rng.random())),
        "hello": ("hello", ("oob", "repb", "busy")),
        "nested": (1, (2.5, ("x", None, True)), [b"ab", {"k": (args[-1],)}]),
        "dict": {"G": int(rng.integers(1, 10**4)), "name": text(5),
                 "vals": [float(x) for x in rng.random(4)]},
        "bytes_small": bytes(blob[:100]),
        "bytes_large": bytes(blob),
        "array": ("rep", 5, col),
        "arrays": ("repb", [(1, col), (2, blob), (3, reply)]),
        "wal_record": ("kv", "Append", text(4), text(9),
                       int(rng.integers(0, 2**63)), int(rng.integers(1, 99))),
    }


KINDS = sorted(_values(ref_wire, 0))


def _joined(segments):
    return b"".join(bytes(s) for s in segments)


def _norm(x):
    """A package-neutral form of a decoded value."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            _norm(getattr(x, f.name)) for f in dataclasses.fields(x)
        )
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.tolist())
    if isinstance(x, (bytearray, memoryview)):
        return bytes(x)
    if isinstance(x, (tuple, list)):
        return (type(x).__name__,) + tuple(_norm(v) for v in x)
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    return x


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", SEEDS)
def test_encode_gives_the_reference_bytes(kind, seed):
    ref = _values(ref_wire, seed)[kind]
    port = _values(port_wire, seed)[kind]
    assert port_codec.encode(port) == ref_codec.encode(ref)
    assert _joined(port_codec.encode_oob(port)) == _joined(
        ref_codec.encode_oob(ref)
    )


@pytest.mark.parametrize("kind", KINDS)
def test_each_package_decodes_the_others_bytes(kind):
    for seed in SEEDS[:3]:
        ref = _values(ref_wire, seed)[kind]
        port = _values(port_wire, seed)[kind]
        for enc in (ref_codec.encode, lambda v: _joined(ref_codec.encode_oob(v))):
            got = port_codec.decode(enc(ref))
            assert _norm(got) == _norm(port)
        for enc in (port_codec.encode,
                    lambda v: _joined(port_codec.encode_oob(v))):
            got = ref_codec.decode(enc(port))
            assert _norm(got) == _norm(ref)


def test_decoded_classes_are_each_packages_own():
    args = port_wire.EngineCmdArgs(op="Put", key="k", value="v")
    assert type(ref_codec.decode(port_codec.encode(args))) is ref_wire.EngineCmdArgs
    ref_args = ref_wire.EngineCmdArgs(op="Put", key="k", value="v")
    assert type(port_codec.decode(ref_codec.encode(ref_args))) is port_wire.EngineCmdArgs
    # The port also reads its classes under their own module name.
    own = pickle.dumps(args, protocol=5)
    assert b"multiraft_tpu_torch.distributed.engine_wire" in own
    assert port_codec.decode(own) == args
    wire = port_codec.encode(args)
    assert b"multiraft_tpu.distributed.engine_wire" in wire
    assert b"multiraft_tpu_torch" not in wire
    assert port_codec.wire_module(port_wire.EngineCmdArgs) == (
        "multiraft_tpu.distributed.engine_wire"
    )


@dataclasses.dataclass
class _Unregistered:
    x: int = 1


def test_both_refuse_an_unregistered_class():
    for codec in (ref_codec, port_codec):
        with pytest.raises(codec.CodecError):
            codec.encode(("req", 1, "X.y", _Unregistered()))
        with pytest.raises(codec.CodecError):
            codec.encode_oob([_Unregistered()])
    raw = pickle.dumps(("req", 1, "X.y", _Unregistered()), protocol=5)
    for codec in (ref_codec, port_codec):
        with pytest.raises(codec.CodecError, match="unregistered"):
            codec.decode(raw)
    with pytest.raises(port_codec.CodecError):
        port_codec.encode(np.array([object()], dtype=object))


def test_retry_after_of_reads_old_replies():
    old = port_wire.EngineCmdReply(err="ErrBusy")
    del old.__dict__["retry_after_s"]
    with pytest.warns(UserWarning, match="missing at encode time"):
        back = port_codec.decode(port_codec.encode(old))
    assert port_wire.retry_after_of(back) == 0.0
    assert port_wire.retry_after_of(port_wire.busy_reply(0.5)) == 0.5
