"""Shared build-and-load helper for the C++ extensions.

Both native components (the porcupine DFS checker and the TCP
transport) ship as a single .cpp compiled with g++ on first use — no
pybind11 in this image, plain C ABI via ctypes.  This helper owns the
one tricky part: concurrent processes (cluster children, parallel
pytest) must never dlopen a half-written .so, so the compile goes to a
process-unique temp name and is published with an atomic rename.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Sequence

__all__ = ["build_and_load"]


def build_and_load(src: str, so: str, extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Compile ``src`` → ``so`` if missing/stale and dlopen it.

    Raises on compile or load failure — callers decide whether to fall
    back to a Python implementation or to hard-fail.
    """
    if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", *extra_flags,
             src, "-o", tmp],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, so)
    return ctypes.CDLL(so)
