"""ctypes loader for the native TCP transport (``transport.cpp``).

The PyTorch port's own copy of the reference package's transport and
loader.  Built with g++ on first use (plain C ABI, no pybind11) into
``build/torch_native/`` at the repository root, never beside the
source; the library's name carries a hash of the source, so a stale
build is never loaded, and concurrent builders publish atomically
(:func:`~multiraft_tpu_torch.utils.native_build.build_and_load`).
There is no Python fallback.  Exposes
:class:`NativeTransport`, a thin Python veneer over the epoll loop:
connection ids, framed send, blocking event poll.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import threading
from typing import Optional, Tuple

from ...utils.native_build import build_and_load

__all__ = ["NativeTransport", "native_available", "EV_FRAME", "EV_ACCEPT", "EV_CLOSED"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "transport.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(_HERE))),
    "build", "torch_native",
)


def _library_path() -> str:
    """Where the transport library for the current source lives."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libmrtransport_{digest}.so")

EV_FRAME, EV_ACCEPT, EV_CLOSED = 0, 1, 2

_lib = None
_build_failed = False
_build_lock = threading.Lock()


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    with _build_lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            os.makedirs(BUILD_DIR, exist_ok=True)
            lib = build_and_load(_SRC, _library_path(), extra_flags=["-pthread"])
            lib.mrt_create.restype = ctypes.c_void_p
            lib.mrt_destroy.argtypes = [ctypes.c_void_p]
            lib.mrt_listen.restype = ctypes.c_int
            lib.mrt_listen.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
            lib.mrt_connect.restype = ctypes.c_int64
            lib.mrt_connect.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
            lib.mrt_send.restype = ctypes.c_int
            # c_char_p: bytes pass their buffer pointer straight through
            # (no copy) — safe because mrt_send consumes synchronously.
            lib.mrt_send.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_char_p, ctypes.c_uint32,
            ]
            lib.mrt_sendv.restype = ctypes.c_int
            lib.mrt_sendv.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.c_uint32,
            ]
            lib.mrt_close.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.mrt_wake.argtypes = [ctypes.c_void_p]
            lib.mrt_set_spin.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.mrt_poll.restype = ctypes.c_int64
            lib.mrt_poll.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_uint32,
                ctypes.c_int,
            ]
            _lib = lib
            return lib
        except Exception:
            _build_failed = True
            return None


def native_available() -> bool:
    return _load() is not None


class NativeTransport:
    """One framed-TCP endpoint: listener + outbound connections.

    The calling thread of :meth:`poll` IS the read reactor — epoll_wait
    and frame parsing run inline, and idle-connection sends write
    inline on the sender's thread, so a serial RPC crosses zero futex
    handoffs inside the transport (see transport.cpp's header).

    Thread contract: ``send``/``connect``/``close_conn``/``wake`` are
    safe from any thread (serialized against ``close`` by a lock).
    ``poll`` is owned by one dispatcher thread, and the owner must stop
    polling before calling ``close``.  :meth:`wake` interrupts a
    blocked :meth:`poll` (it returns ``None`` early) — the hook that
    lets a scheduler loop double as the IO dispatcher.
    """

    def __init__(self, buf_size: int = 1 << 20) -> None:
        lib = _load()
        if lib is None:
            raise RuntimeError("native transport unavailable (g++ build failed)")
        self._lib = lib
        self._h = lib.mrt_create()
        self._lock = threading.Lock()
        self._buf = (ctypes.c_uint8 * buf_size)()
        self._cap = buf_size
        # poll() is single-threaded by contract — reuse the out-params.
        self._pconn = ctypes.c_int64()
        self._ptyp = ctypes.c_int()

    def listen(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Bind+listen; returns the bound port (ephemeral for port 0)."""
        with self._lock:
            if self._h is None:
                raise OSError("transport closed")
            got = self._lib.mrt_listen(self._h, host.encode(), port)
        if got < 0:
            raise OSError(f"listen on {host}:{port} failed")
        return got

    def connect(self, host: str, port: int) -> int:
        """Begin a non-blocking connect; returns the conn id immediately.
        A failed handshake later surfaces as an EV_CLOSED event."""
        with self._lock:
            if self._h is None:
                raise ConnectionError("transport closed")
            cid = self._lib.mrt_connect(self._h, host.encode(), port)
        if cid < 0:
            raise ConnectionError(f"connect to {host}:{port} failed")
        return cid

    def send(self, conn: int, data: bytes) -> bool:
        # Senders may be any thread, so close() must not free the C++
        # Transport under a concurrent send — the lock stays (it is an
        # uncontended ~0.1 µs on the hot path; the big costs were the
        # frame copy and the thread handoffs, both gone).
        with self._lock:
            if self._h is None:
                return False
            return self._lib.mrt_send(self._h, conn, data, len(data)) == 0

    # writev caps iovec counts at IOV_MAX (1024 on Linux); chunk below it.
    _SENDV_MAX = 512

    def send_parts(self, conn: int, parts: list) -> bool:
        """Vectored raw write: ``parts`` are PRE-FRAMED byte runs
        (length prefixes included by the caller) delivered in order as
        one ``writev`` per chunk — the one-syscall-per-flush half of
        the reply-coalescing fast path.  Accepts ``bytes`` and
        buffer-protocol objects (memoryview/bytearray/numpy views);
        writable buffers pass their pointer zero-copy."""
        n = len(parts)
        if n == 0:
            return True
        if n == 1 and isinstance(parts[0], bytes):
            return self.send(conn, parts[0])
        for lo in range(0, n, self._SENDV_MAX):
            chunk = parts[lo: lo + self._SENDV_MAX]
            k = len(chunk)
            ptrs = (ctypes.c_void_p * k)()
            lens = (ctypes.c_uint32 * k)()
            keep = []  # pins every pointer's backing object until the call
            for i, p in enumerate(chunk):
                if isinstance(p, bytes):
                    ptrs[i] = ctypes.cast(ctypes.c_char_p(p), ctypes.c_void_p)
                    lens[i] = len(p)
                    keep.append(p)
                    continue
                mv = p if isinstance(p, memoryview) else memoryview(p)
                if mv.readonly:
                    b = bytes(mv)  # rare: readonly view not backed by bytes
                    ptrs[i] = ctypes.cast(ctypes.c_char_p(b), ctypes.c_void_p)
                    lens[i] = len(b)
                    keep.append(b)
                else:
                    arr = (ctypes.c_char * mv.nbytes).from_buffer(mv)
                    ptrs[i] = ctypes.addressof(arr)
                    lens[i] = mv.nbytes
                    keep.append(arr)
            with self._lock:
                if self._h is None:
                    return False
                ok = self._lib.mrt_sendv(self._h, conn, ptrs, lens, k) == 0
            del keep
            if not ok:
                return False
        return True

    def set_spin(self, us: int) -> None:
        """Busy-poll budget (µs) before :meth:`poll` blocks — trades a
        sliver of CPU for removing both futex wakes from an active
        round trip.  0 disables (the default)."""
        with self._lock:
            if self._h is not None:
                self._lib.mrt_set_spin(self._h, int(us))

    def close_conn(self, conn: int) -> None:
        with self._lock:
            if self._h is not None:
                self._lib.mrt_close(self._h, conn)

    def wake(self) -> None:
        """Interrupt a blocked :meth:`poll` (it returns ``None``)."""
        with self._lock:
            if self._h is not None:
                self._lib.mrt_wake(self._h)

    def poll(self, timeout: float) -> Optional[Tuple[int, int, bytes]]:
        """Next event as ``(conn_id, type, payload)``, or None on
        timeout or :meth:`wake`."""
        h = self._h
        if h is None:
            return None
        conn, typ = self._pconn, self._ptyp
        n = self._lib.mrt_poll(
            h, ctypes.byref(conn), ctypes.byref(typ),
            self._buf, self._cap, int(timeout * 1000),
        )
        if n < 0:
            return None
        if n > self._cap:  # grow and re-poll (frame stayed queued)
            self._cap = int(n)
            self._buf = (ctypes.c_uint8 * self._cap)()
            return self.poll(timeout)
        return conn.value, typ.value, ctypes.string_at(self._buf, int(n))

    def close(self) -> None:
        with self._lock:
            h, self._h = self._h, None
        if h:
            self._lib.mrt_destroy(h)

    def __del__(self) -> None:  # pragma: no cover - GC path
        try:
            self.close()
        except Exception:
            pass
