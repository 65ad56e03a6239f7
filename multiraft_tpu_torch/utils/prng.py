"""Threefry-2x32 counter-based PRNG, bit-exact with ``jax.random``.

The engine draws its election jitter, initial deadlines and message
drops from JAX's default PRNG in the reference package.  Parity tick
after tick needs the same numbers, so this module re-implements the
pieces the engine calls, under the reference's settings
(``jax_threefry_partitionable=True``, 64-bit types off):

* :func:`PRNGKey` — ``threefry_seed``: a seed becomes the pair
  ``(seed >> 32, seed & 0xFFFFFFFF)``;
* :func:`fold_in` — ``threefry_2x32(key, threefry_seed(data))``;
* :func:`split` — the partitionable ("fold-like") split: threefry over
  the 64-bit iota of the output shape, hi/lo words as the two counters;
* :func:`random_bits` — the partitionable 32-bit draw ``bits1 ^ bits2``
  over the same iota;
* :func:`randint` — two bit draws from ``split(key)`` combined modulo
  the span (jax ``_randint``);
* :func:`uniform` — 23 mantissa bits under exponent 0, minus one (jax
  ``_uniform``).

A key is a ``torch.uint32`` tensor of shape ``[2]``.  The arithmetic runs
in int64 with 32-bit masks: torch's ``uint32`` has no add or shift on
the CPU.  Key derivation (:func:`fold_in`, :func:`split`) on a CPU key
runs in Python integers, so a driver that keeps its key on the host
derives per-tick keys without a device launch; only the bulk draws
(:func:`random_bits` and the samplers on top of it) run on ``device``.
Each bulk draw is a few dozen small elementwise launches on the card;
fusing them into one kernel is left for later work.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

__all__ = ["PRNGKey", "fold_in", "split", "random_bits", "randint", "uniform"]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

Word = Union[int, torch.Tensor]


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) | (x >> (32 - r))) & _M32


def _threefry2x32(k1: Word, k2: Word, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """The 20-round Threefry-2x32 block over counter words ``(x0, x1)``.

    Works on Python ints and on int64 tensors alike (every value is a
    uint32 held in a wider type, re-masked after each add or shift)."""
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


def _words(key: torch.Tensor) -> Tuple[Word, Word]:
    if key.shape != (2,):
        raise ValueError(f"PRNG key must have shape [2], got {tuple(key.shape)}")
    if key.device.type == "cpu":
        a, b = key.tolist()
        return int(a), int(b)
    k = key.to(torch.int64)
    return k[0], k[1]


def _key(a: Word, b: Word, device: torch.device) -> torch.Tensor:
    if isinstance(a, int):
        return torch.tensor([a, b], dtype=torch.uint32, device=device)
    return torch.stack([a, b]).to(torch.uint32)


def PRNGKey(seed: int, device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed (64-bit types off)."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit in int32")
    return torch.tensor([0, seed & _M32], dtype=torch.uint32, device=device)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for an int32 ``data``."""
    k1, k2 = _words(key)
    a, b = _threefry2x32(k1, k2, 0, int(data) & _M32)
    return _key(a, b, key.device)


def _iota_words(
    shape: Sequence[int], device: torch.device, offset: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    n = 1
    for s in shape:
        n *= int(s)
    lo = torch.arange(
        offset, offset + n, dtype=torch.int64, device=device
    ).reshape(tuple(shape))
    return lo >> 32, lo & _M32


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` → uint32 ``[num, 2]``."""
    k1, k2 = _words(key)
    if isinstance(k1, int):
        rows = [_threefry2x32(k1, k2, 0, i) for i in range(num)]
        return torch.tensor(rows, dtype=torch.uint32, device=key.device)
    hi, lo = _iota_words((num,), key.device)
    a, b = _threefry2x32(k1, k2, hi, lo)
    return torch.stack([a, b], dim=1).to(torch.uint32)


def random_bits(
    key: torch.Tensor,
    shape: Sequence[int],
    device: Optional[torch.device] = None,
    offset: int = 0,
) -> torch.Tensor:
    """32 random bits per element (int64 tensor of uint32 values).

    ``offset`` skips that many elements of the flat draw: the bits of a
    block of rows of a larger draw, equal to slicing the whole draw
    (each element's counter is its flat index)."""
    device = key.device if device is None else torch.device(device)
    k1, k2 = _words(key)
    hi, lo = _iota_words(shape, device, offset)
    a, b = _threefry2x32(k1, k2, hi, lo)
    return a ^ b


def randint(
    key: torch.Tensor,
    shape: Sequence[int],
    minval: int,
    maxval: int,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``."""
    minval, maxval = int(minval), int(maxval)
    if not (-(2**31) <= minval < 2**31 and -(2**31) <= maxval < 2**31):
        raise ValueError("randint bounds must fit in int32")
    ks = split(key, 2)
    higher = random_bits(ks[0], shape, device)
    lower = random_bits(ks[1], shape, device)
    # uint32 arithmetic as jax does it: products and sums wrap at 2**32.
    span = (maxval - minval) & _M32 if maxval > minval else 1
    mult = (((2**16 % span) ** 2) & _M32) % span
    off = ((((higher % span) * mult) & _M32) + (lower % span)) & _M32
    return (off % span + minval).to(torch.int32)


def uniform(
    key: torch.Tensor,
    shape: Sequence[int],
    device: Optional[torch.device] = None,
    offset: int = 0,
) -> torch.Tensor:
    """``jax.random.uniform(key, shape, jnp.float32)`` in [0, 1)
    (``offset`` as in :func:`random_bits`)."""
    bits = random_bits(key, shape, device, offset)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0
