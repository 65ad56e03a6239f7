"""Self-describing wire codec with misuse linting — labgob's equivalent.

The reference wraps ``encoding/gob`` and lints two classes of silent bug:
unexported (non-serialized) struct fields and decoding into a non-default
destination (reference: labgob/labgob.go:68-113, :122-177).

Python's analog of those hazards is different, so the lints are too:

* **Unregistered message types.**  gob requires ``Register`` for interface
  values; we require every *top-level* RPC/persistence payload class to be
  registered so that wire schemas are explicit and typos in message types
  fail fast instead of decoding to garbage.
* **Value isolation.**  gob gives value semantics across the wire; naive
  in-process Python "RPC" would share mutable objects between caller and
  callee.  ``encode``/``decode`` always produce a deep, independent copy,
  so mutating a received message never aliases the sender's state.  (This
  also makes the "decode into non-default value" bug structurally
  impossible: decode always builds a fresh object.)
* **Slot-field coverage.**  If a registered class declares ``__slots__``
  or dataclass fields, encoding an instance with missing attributes warns
  — the closest analog of gob's lower-case-field warning.

Encoding is ``pickle`` under the hood (self-describing, fast, stdlib); the
registry is the schema-checking layer on top.

Out-of-band fast path
---------------------

:func:`encode_oob` is the zero-copy variant for the serving hot path: it
pickles at protocol 5 with a ``buffer_callback``, so numpy arrays and
large ``bytes`` blobs (wrapped in :class:`pickle.PickleBuffer`) ship as
raw buffer segments instead of being copied into the pickle stream.  The
return value is a list of wire *segments* — ``[header ‖ pickle-bytes,
buffer, buffer, ...]`` — which a vectored transport writes without ever
joining them.  The segments concatenate to one self-describing payload:

    0x01 ‖ u32 nbufs ‖ nbufs × u64 buffer-len ‖ pickle5 ‖ buffers...

A legacy pickle stream always starts with ``0x80`` (the PROTO opcode), so
:func:`decode` dispatches on the first byte and handles both formats.
When a payload yields no out-of-band buffers, :func:`encode_oob`
degrades to a single legacy-format segment — old peers never see the
``0x01`` format unless the caller negotiated it (tcp.py's hello
exchange).  Decode copies every buffer region into a fresh writable
``bytearray`` before handing it to the unpickler, preserving the value-
isolation guarantee: decoded buffers never alias the sender OR the
transport's receive buffer.

Wire names
----------

This is the PyTorch port's copy of the reference package's codec
(``multiraft_tpu/transport/codec.py``), and the two packages share one
wire.  Pickle names a class by its module and qualified name, and the
decoder resolves a registered class only under the module it was
written with, so this package writes each of its registered classes
under the reference package's module (``multiraft_tpu_torch.x`` goes
on the wire as ``multiraft_tpu.x``, :func:`wire_module`) and reads
either name.  The C pickler cannot write a module name other than the
class's own (it imports the module it names), so a payload that holds
such a class is pickled by :class:`_WirePickler`, the pure-Python
pickler with that one rename; every other payload takes the C pickler.
Both give the reference's bytes.
"""

from __future__ import annotations

import dataclasses
import io
import pickle
import struct
import warnings
from typing import Any, List, Tuple, Type

try:  # numpy is baked into this image, but the codec must not require it
    import numpy as _np
except Exception:  # pragma: no cover - numpy-less fallback
    _np = None  # type: ignore[assignment]

__all__ = [
    "register",
    "registered",
    "encode",
    "encode_oob",
    "decode",
    "CodecError",
    "wire_size",
    "wire_module",
]


class CodecError(TypeError):
    pass


_REGISTRY: dict[str, Type] = {}
# Primitive payloads allowed without registration (matches gob's built-in
# support for basic kinds).  bytearray/memoryview join bytes: they are
# pure buffer payloads (the OOB path produces them on decode, so a
# handler echoing one back must stay encodable).
_PRIMITIVES = (type(None), bool, int, float, str, bytes, bytearray, memoryview)

# Per-type registry-validation memo: class → dataclass field-name tuple
# (empty for non-dataclasses).  Registry lookup + dataclasses.fields()
# re-ran on EVERY encode of every frame; payload *types* are a small
# closed set, so one dict hit replaces both.  Presence of a key means
# "registered"; register() invalidates so a type registered after a
# failed encode is picked up.
_CHECK_MEMO: dict[type, Tuple[str, ...]] = {}


# This package's top-level name, and the one its classes carry on the
# wire (see "Wire names" above).
_PKG = __name__.split(".")[0]
_WIRE_PKG = "multiraft_tpu"
# Registered classes whose wire module differs from their own.
_RENAMED: set = set()
# One string object per wire module name: the pickler memoizes strings
# by identity, and the C pickler writes a module name it has written
# before as a memo reference, so an equal but distinct string each time
# would give longer bytes than the reference's.
_WIRE_NAMES: dict = {}


def wire_module(cls: Type) -> str:
    """The module a registered class is written under on the wire."""
    mod = cls.__module__
    if mod == _PKG or mod.startswith(_PKG + "."):
        name = _WIRE_NAMES.get(mod)
        if name is None:
            name = _WIRE_NAMES[mod] = _WIRE_PKG + mod[len(_PKG):]
        return name
    return mod


def register(*classes: Type) -> None:
    """Register message/payload classes (labgob.Register equivalent)."""
    for cls in classes:
        _REGISTRY[cls.__qualname__] = cls
        if wire_module(cls) != cls.__module__:
            _RENAMED.add(cls)
    _CHECK_MEMO.clear()


def registered(cls: Type) -> Type:
    """Class decorator form of :func:`register`."""
    register(cls)
    return cls


def _check_encodable(obj: Any) -> bool:
    """Raise on an unregistered class; True when ``obj`` holds a class
    whose wire name differs from its own (see :func:`wire_module`)."""
    if isinstance(obj, _PRIMITIVES):
        return False
    if isinstance(obj, (list, tuple, set, frozenset)):
        renamed = False
        for item in obj:
            renamed |= _check_encodable(item)
        return renamed
    if isinstance(obj, dict):
        renamed = False
        for k, v in obj.items():
            renamed |= _check_encodable(k)
            renamed |= _check_encodable(v)
        return renamed
    cls = type(obj)
    fields = _CHECK_MEMO.get(cls)
    if fields is None:
        if _np is not None and isinstance(obj, _np.ndarray):
            if obj.dtype.hasobject:
                raise CodecError(
                    "codec: object-dtype arrays smuggle arbitrary Python "
                    "objects past the registry; send a registered class "
                    "or a plain-dtype array"
                )
            return False  # plain-dtype arrays are buffer payloads
        if cls.__qualname__ not in _REGISTRY:
            raise CodecError(
                f"codec: {cls.__qualname__} is not registered; call "
                f"codec.register({cls.__name__}) before sending it on the wire "
                "(labgob.Register equivalent)"
            )
        fields = (
            tuple(f.name for f in dataclasses.fields(obj))
            if dataclasses.is_dataclass(obj)
            else ()
        )
        _CHECK_MEMO[cls] = fields
    if fields:
        missing_ok = not hasattr(obj, "__dict__")  # slotted: trust hasattr
        d = None if missing_ok else obj.__dict__
        for name in fields:
            absent = not hasattr(obj, name) if missing_ok else name not in d
            if absent:
                warnings.warn(
                    f"codec: {cls.__qualname__}.{name} missing at "
                    "encode time; receiver will see a partial message",
                    stacklevel=3,
                )
    return cls in _RENAMED


class _WirePickler(pickle._Pickler):  # type: ignore[name-defined]
    """The pure-Python pickler, writing each renamed registered class
    under its wire module (protocol 4 and up: ``STACK_GLOBAL``, as the
    C pickler writes a module-level class)."""

    def save_global(self, obj: Any, name: Any = None) -> None:
        if isinstance(obj, type) and obj in _RENAMED and name is None:
            self.save(wire_module(obj))
            self.save(obj.__qualname__)
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


def _dumps(obj: Any, renamed: bool, protocol: int, buffer_callback: Any = None) -> bytes:
    if not renamed:
        return pickle.dumps(obj, protocol=protocol, buffer_callback=buffer_callback)
    f = io.BytesIO()
    _WirePickler(f, protocol=protocol, buffer_callback=buffer_callback).dump(obj)
    return f.getvalue()


def encode(obj: Any) -> bytes:
    """Serialize ``obj`` to self-describing bytes, enforcing registration.

    Runs the same buffer rewrite as :func:`encode_oob` but without a
    ``buffer_callback``, so wrapped buffers serialize in-band — one
    self-contained segment, but memoryview payloads (which raw pickle
    rejects) still encode.  Readonly buffers reconstruct as ``bytes``,
    writable ones as ``bytearray``."""
    renamed = _check_encodable(obj)
    return _dumps(_wrap_buffers(obj), renamed, pickle.HIGHEST_PROTOCOL)


# -- out-of-band fast path --------------------------------------------------

# Header: format byte ‖ u32 buffer count; then per-buffer u64 lengths.
_OOB_FIRST = 0x01
_OOB_HDR = struct.Struct(">BI")
_OOB_LEN = struct.Struct(">Q")
# bytes blobs below this stay in-band: the PickleBuffer indirection and
# the extra iovec entry cost more than a small memcpy saves.
_OOB_MIN_BYTES = 2048
# Wrap depth: frame tuple → repb pair list → (req_id, value) pairs.
_OOB_DEPTH = 3


def _wrap_buffers(obj: Any, depth: int = _OOB_DEPTH) -> Any:
    """Shallow rebuild of ``obj`` with large bytes wrapped in
    PickleBuffer so protocol 5 ships them out-of-band.  numpy arrays
    need no wrapping (their reducer is already buffer-aware).  Depth-
    bounded: only frame-shaped nesting is rewritten, deep payload
    structure is left to the pickler.

    memoryview is wrapped regardless of size: the pickler cannot
    serialize one raw, and handlers legitimately hold them — OOB decode
    hands out views over the receive-side copy, and echoing a payload
    back is the simplest server.  Without a buffer_callback the wrapper
    serializes in-band and reconstructs as bytes/bytearray, so the same
    rewrite also makes the legacy :func:`encode` path view-safe."""
    if isinstance(obj, bytes) and len(obj) >= _OOB_MIN_BYTES:
        return pickle.PickleBuffer(obj)
    if isinstance(obj, memoryview):
        # PickleBuffer refuses non-contiguous views; flatten those first.
        return pickle.PickleBuffer(obj if obj.contiguous else obj.tobytes())
    if isinstance(obj, bytearray) and len(obj) >= _OOB_MIN_BYTES:
        return pickle.PickleBuffer(obj)
    if depth > 0:
        if type(obj) is tuple:
            return tuple(_wrap_buffers(x, depth - 1) for x in obj)
        if type(obj) is list:
            return [_wrap_buffers(x, depth - 1) for x in obj]
    return obj


def encode_oob(obj: Any) -> List[Any]:
    """Serialize ``obj`` into wire segments whose concatenation is one
    :func:`decode`-able payload, shipping numpy arrays and large bytes
    blobs as raw out-of-band segments (no serialize copy).  Falls back
    to a single legacy-format segment when the payload yields no
    buffers, so callers can use it unconditionally once the peer
    negotiated the format."""
    renamed = _check_encodable(obj)
    bufs: List[pickle.PickleBuffer] = []
    # buffer_callback returning a FALSY value is what takes the buffer
    # out-of-band (truthy would serialize it in-band as well) —
    # list.append's None is exactly right.
    pkl = _dumps(_wrap_buffers(obj), renamed, 5, buffer_callback=bufs.append)
    if not bufs:
        return [pkl]
    views = []
    lens = bytearray()
    for pb in bufs:
        mv = pb.raw()
        under = getattr(mv, "obj", None)
        if isinstance(under, bytes) and len(under) == mv.nbytes:
            # The buffer IS a whole bytes object — pass it through so
            # the ctypes layer gets a pointer without a view wrapper.
            views.append(under)
        else:
            views.append(mv)
        lens.extend(_OOB_LEN.pack(mv.nbytes))
    if len(views) >= 2 ** 32:
        # The header's buffer count is u32; wrapping it would desync
        # every buffer offset on decode.
        raise CodecError(
            f"codec: payload yields {len(views)} out-of-band buffers; "
            f"the wire header caps the count below {2 ** 32}"
        )
    head = _OOB_HDR.pack(_OOB_FIRST, len(views)) + bytes(lens) + pkl
    return [head, *views]


def decode(data: Any) -> Any:
    """Deserialize bytes produced by :func:`encode` (or a joined
    :func:`encode_oob` segment list) into a fresh object."""
    mv = memoryview(data)
    if mv.nbytes and mv[0] == _OOB_FIRST:
        _, nbufs = _OOB_HDR.unpack_from(mv, 0)
        off = _OOB_HDR.size
        sizes = [
            _OOB_LEN.unpack_from(mv, off + i * _OOB_LEN.size)[0]
            for i in range(nbufs)
        ]
        off += nbufs * _OOB_LEN.size
        tail = sum(sizes)
        pkl = mv[off: mv.nbytes - tail]
        # Fresh writable copies: decoded buffers must never alias the
        # sender's objects or the transport's receive buffer (value
        # isolation), and numpy rebuilds writable arrays over them.
        bufs = []
        boff = mv.nbytes - tail
        for n in sizes:
            bufs.append(bytearray(mv[boff: boff + n]))
            boff += n
        return _RestrictedUnpickler(io.BytesIO(pkl), buffers=bufs).load()
    return _RestrictedUnpickler(io.BytesIO(mv)).load()


def wire_size(obj: Any) -> int:
    """Byte size of ``obj`` on the wire (used by the network's byte
    counters, reference: labrpc/labrpc.go:375-383)."""
    return len(encode(obj))


class _RestrictedUnpickler(pickle.Unpickler):
    """Only resolves registered classes plus stdlib builtins — the decode
    side of the schema check."""

    # numpy's array reconstructors moved between numpy 1.x and 2.x;
    # allow both spellings (find_class sees whichever the encoder's
    # numpy emitted).
    _ALLOWED_MODULES = {
        "builtins",
        "collections",
        "numpy",
        "numpy.core.multiarray",
        "numpy.core.numeric",
        "numpy._core.multiarray",
        "numpy._core.numeric",
    }

    def find_class(self, module: str, name: str) -> Any:
        cls = _REGISTRY.get(name)
        if cls is not None and module in (cls.__module__, wire_module(cls)):
            return cls
        if module in self._ALLOWED_MODULES:
            return super().find_class(module, name)
        raise CodecError(
            f"codec: refusing to decode unregistered class {module}.{name}"
        )
