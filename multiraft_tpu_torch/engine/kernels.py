"""The engine's two leader-side reductions: hand-written CUDA kernels for
Hopper, their plain PyTorch versions, and the launch counters.

They replace the reference's Pallas TPU kernels
(``multiraft_tpu/engine/pallas_ops.py``):

* :func:`quorum_commit` — ``_commit_kernel`` / ``quorum_commit_pallas``:
  per (group, replica), the quorum-th largest ``eff_match`` under the
  current-term guard, the new commit index;
* :func:`vote_tally` — ``_tally_kernel`` / ``vote_tally_pallas``: which
  candidates hold a quorum of votes.

Dispatch is by the tensors' device: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel (built from ``csrc/`` with
``nvcc`` at first use, loaded with ``ctypes``) or raises.  Nothing falls
back.  ``LAUNCHES`` counts kernel launches, and only those.

Both kernels cut the row-major ``[G, P, ...]`` planes into tiles of
consecutive (g, p) rows, stage each tile into shared memory with bulk
asynchronous copies and walk the tiles with a persistent grid;
:func:`tile_plan` decides the tile, the shared memory and the grid, and
the C entry points refuse a plan they cannot take.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

__all__ = [
    "LAUNCHES", "MAX_P", "SOURCES", "TilePlan", "build_library",
    "empty_launch", "ptxas_report", "quorum_commit", "quorum_commit_plain",
    "reset_launches", "tile_plan", "vote_tally", "vote_tally_plain",
]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "raft_kernels.cu",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# A thread counts its row's P entries from the staged tile; the C entry
# points refuse P above this.
MAX_P = 32

TILE = 256  # rows a tile, one thread a row; a multiple of 32 (whole warps)
# Hopper's limits on shared memory and resident threads.
SMEM_PER_SM = 233_472
SMEM_RESERVED_PER_BLOCK = 1_024  # the runtime's own share of each block
THREADS_PER_SM = 2_048
H100_SMS = 132


def _smem_bytes(kernel: str, P: int) -> int:
    """Dynamic shared memory a block of ``kernel`` takes, which the C
    entry points require exactly: two 8-byte mbarriers padded to 16
    bytes; the commit kernel's scratch (a leader count for each of the
    8 warps and the list of a tile's leader rows); and two staged tiles
    of TILE rows of the planes it copies in bulk (eff_match, commit and
    is_leader, 4P + 5 bytes a row; votes, role and alive, P + 5)."""
    if kernel == "quorum_commit":
        return 16 + (4 * 8 + 4 * TILE) + 2 * TILE * (4 * P + 5)
    if kernel == "vote_tally":
        return 16 + 2 * TILE * (P + 5)
    raise ValueError(f"no kernel {kernel!r}")


@dataclass(frozen=True)
class TilePlan:
    """A launch of a tiled kernel: tiles of ``tile`` rows, one thread a
    row; ``smem_bytes`` of dynamic shared memory a block; ``grid``
    persistent blocks, each walking the tiles with stride ``grid``."""

    tile: int
    smem_bytes: int
    grid: int


def tile_plan(rows: int, P: int, kernel: str, sms: int = H100_SMS) -> TilePlan:
    """The tile plan of ``kernel`` ("quorum_commit" or "vote_tally") for
    ``rows`` = G*P rows on a card of ``sms`` SMs: as many persistent
    blocks as the SMs hold at once, by threads and shared memory, and no
    more than there are tiles."""
    if not 1 <= P <= MAX_P:
        raise ValueError(f"kernels support 1 <= P <= {MAX_P}, got P={P}")
    smem = _smem_bytes(kernel, P)
    per_sm = min(THREADS_PER_SM // TILE,
                 SMEM_PER_SM // (smem + SMEM_RESERVED_PER_BLOCK))
    tiles = -(-rows // TILE)
    return TilePlan(tile=TILE, smem_bytes=smem,
                    grid=max(1, min(tiles, per_sm * sms)))


LAUNCHES: Dict[str, int] = {"quorum_commit": 0, "vote_tally": 0}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------


def quorum_commit_plain(
    eff_match: torch.Tensor,  # i32[G,P,P] (diagonal = own last index)
    term: torch.Tensor,  # i32[G,P]
    commit: torch.Tensor,  # i32[G,P]
    base: torch.Tensor,  # i32[G,P]
    base_term: torch.Tensor,  # i32[G,P]
    log_term: torch.Tensor,  # i32[G,P,L]
    is_leader: torch.Tensor,  # bool[G,P]
    quorum: int,
) -> torch.Tensor:
    """New commit index per replica, by the Pallas kernel's counting
    identity: ``q = max_j match[j]`` over the j with at least ``quorum``
    entries ``>= match[j]`` (0 for the others), the term of ``q`` from
    ``base_term`` or the ring, and ``q`` taken iff leader, current term
    and ``q > commit``."""
    L = log_term.shape[-1]
    ge = eff_match[..., :, None] >= eff_match[..., None, :]  # [G,P,k,j]
    eligible = ge.sum(dim=-2) >= quorum  # [G,P,j]
    q = torch.where(eligible, eff_match, 0).amax(dim=-1)
    ring = torch.gather(log_term, -1, torch.remainder(q, L).long()[..., None])
    q_term = torch.where(q == base, base_term, ring[..., 0])
    ok = is_leader & (q_term == term) & (q > commit)
    return torch.where(ok, q, commit)


def vote_tally_plain(
    votes: torch.Tensor,  # bool[G,P,P]
    role: torch.Tensor,  # i32[G,P]
    alive: torch.Tensor,  # bool[G,P]
    quorum: int,
) -> torch.Tensor:
    """bool[G,P]: candidates (role 1) that are alive and hold a quorum."""
    return (role == 1) & alive & (votes.sum(dim=-1) >= quorum)


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build_library() -> Path:
    """Compile ``csrc/`` into ``build/torch_kernels/`` (named by a hash
    of the sources and flags) unless that library already exists.  What
    ``-Xptxas -v`` prints (registers, shared memory, stack frame and
    spills per kernel) is kept beside it (:func:`ptxas_report`)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libraft_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    _ptxas_path(out).write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def _ptxas_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def ptxas_report() -> str:
    """The ``-Xptxas -v`` output of the library's build."""
    return _ptxas_path(build_library()).read_text()


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.mrt_quorum_commit.argtypes = [vp] * 8 + [ci] * 7 + [vp]
            lib.mrt_quorum_commit.restype = ci
            lib.mrt_vote_tally.argtypes = [vp] * 4 + [ci] * 6 + [vp]
            lib.mrt_vote_tally.restype = ci
            lib.mrt_empty.argtypes = [ci] * 3 + [vp]
            lib.mrt_empty.restype = ci
            _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"{name}: expected {dtype}{list(shape)}, got "
            f"{t.dtype}{list(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _check_staged(name: str, t: torch.Tensor, dtype: torch.dtype,
                  shape: tuple) -> None:
    """:func:`_check`, and the 16-byte alignment that a bulk copy of the
    plane needs: a view at an offset may lack it."""
    _check(name, t, dtype, shape)
    if t.data_ptr() % 16 != 0:
        raise ValueError(
            f"{name}: expected a 16-byte aligned tensor, got address "
            f"{t.data_ptr():#x}"
        )


def _route(t: torch.Tensor, P: int) -> bool:
    """True: launch the kernel; False: CPU tensor, plain version."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    if P > MAX_P:
        raise ValueError(f"kernels support P <= {MAX_P}, got P={P}")
    return True


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@lru_cache(maxsize=64)
def _launch_plan(rows: int, P: int, kernel: str,
                 device: torch.device) -> Tuple[int, int, int]:
    """(tile, smem bytes, grid) of :func:`tile_plan` on ``device``."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = tile_plan(rows, P, kernel, sms=sms)
    return plan.tile, plan.smem_bytes, plan.grid


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def quorum_commit(
    eff_match: torch.Tensor,
    term: torch.Tensor,
    commit: torch.Tensor,
    base: torch.Tensor,
    base_term: torch.Tensor,
    log_term: torch.Tensor,
    is_leader: torch.Tensor,
    quorum: int,
) -> torch.Tensor:
    """:func:`quorum_commit_plain`, as the CUDA kernel on a CUDA tensor."""
    G, P, _ = eff_match.shape
    L = log_term.shape[-1]
    if not _route(eff_match, P):
        return quorum_commit_plain(
            eff_match, term, commit, base, base_term, log_term, is_leader,
            quorum,
        )
    _check_staged("eff_match", eff_match, torch.int32, (G, P, P))
    _check_staged("commit", commit, torch.int32, (G, P))
    for name, t in (("term", term), ("base", base), ("base_term", base_term)):
        _check(name, t, torch.int32, (G, P))
    _check("log_term", log_term, torch.int32, (G, P, L))
    _check_staged("is_leader", is_leader, torch.bool, (G, P))
    out = torch.empty((G, P), dtype=torch.int32, device=eff_match.device)
    rc = _library().mrt_quorum_commit(
        eff_match.data_ptr(), term.data_ptr(), commit.data_ptr(),
        base.data_ptr(), base_term.data_ptr(), log_term.data_ptr(),
        is_leader.data_ptr(), out.data_ptr(), G, P, L, int(quorum),
        *_launch_plan(G * P, P, "quorum_commit", out.device), _stream(out),
    )
    _raise_on(rc, "quorum_commit")
    LAUNCHES["quorum_commit"] += 1
    return out


def vote_tally(
    votes: torch.Tensor,
    role: torch.Tensor,
    alive: torch.Tensor,
    quorum: int,
) -> torch.Tensor:
    """:func:`vote_tally_plain`, as the CUDA kernel on a CUDA tensor."""
    G, P, _ = votes.shape
    if not _route(votes, P):
        return vote_tally_plain(votes, role, alive, quorum)
    _check_staged("votes", votes, torch.bool, (G, P, P))
    _check_staged("role", role, torch.int32, (G, P))
    _check_staged("alive", alive, torch.bool, (G, P))
    out = torch.empty((G, P), dtype=torch.bool, device=votes.device)
    rc = _library().mrt_vote_tally(
        votes.data_ptr(), role.data_ptr(), alive.data_ptr(), out.data_ptr(),
        G, P, int(quorum), *_launch_plan(G * P, P, "vote_tally", out.device),
        _stream(out),
    )
    _raise_on(rc, "vote_tally")
    LAUNCHES["vote_tally"] += 1
    return out


def empty_launch(plan: TilePlan, device: torch.device) -> None:
    """Launch an empty kernel with ``plan``'s grid, block and shared
    memory on ``device``'s current stream, by the route the two kernels
    take: the least time any of their launches can show.  It is not one
    of the engine's kernels and is not counted in ``LAUNCHES``."""
    rc = _library().mrt_empty(
        plan.grid, plan.tile, plan.smem_bytes,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on(rc, "empty")
