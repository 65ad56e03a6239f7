"""Threefry-2x32, bit-exact with ``jax.random`` under
``jax_threefry_partitionable=True``: a frozen copy of
``multiraft_tpu_torch/utils/prng.py`` at commit 73b8d79.

Keys are pairs of Python ints.  A bulk draw takes the flat counters of
the elements it wants (``g * P + p`` for replica ``p`` of group ``g``),
so a replay of a few groups draws exactly their elements of the whole
``[G, P]`` draw.
"""

from __future__ import annotations

from typing import Tuple

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x0, x1):
    """The 20-round block over counter words ``(x0, x1)``; Python ints
    or int64 tensors holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for an int32 seed."""
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit in int32")
    return (0, seed & _M32)


def fold_in(k: Key, data: int) -> Key:
    return threefry2x32(k[0], k[1], 0, int(data) & _M32)


def split2(k: Key) -> Tuple[Key, Key]:
    return (threefry2x32(k[0], k[1], 0, 0), threefry2x32(k[0], k[1], 0, 1))


def random_bits(k: Key, counters: torch.Tensor) -> torch.Tensor:
    """32 bits per element (int64 holding uint32) at flat ``counters``."""
    c = counters.to(torch.int64)
    a, b = threefry2x32(k[0], k[1], c >> 32, c & _M32)
    return a ^ b


def randint(k: Key, counters: torch.Tensor, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)`` at the
    elements ``counters`` of the flat draw."""
    ks = split2(k)
    higher = random_bits(ks[0], counters)
    lower = random_bits(ks[1], counters)
    span = (maxval - minval) & _M32 if maxval > minval else 1
    mult = (((2**16 % span) ** 2) & _M32) % span
    off = ((((higher % span) * mult) & _M32) + (lower % span)) & _M32
    return (off % span + minval).to(torch.int32)
