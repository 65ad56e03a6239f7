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

A bulk draw on a CUDA device is one launch of a hand-written kernel
(``engine/csrc/threefry.cu``, through ``engine.kernels.threefry``), which
equals the plain draw bit for bit; ``KERNEL_LAUNCHES`` counts its
launches.  It takes the key words, span, ``mult`` and offset as launch
arguments, packed by :func:`draw_args` from a key on the host, or reads a
key that lies on the card from device memory.  A draw on the CPU runs the
plain int64 version (:func:`random_bits_plain`, :func:`randint_plain`,
:func:`uniform_plain`), which the tests hold to ``jax.random``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

__all__ = [
    "PRNGKey", "fold_in", "split", "random_bits", "randint", "uniform",
    "random_bits_plain", "randint_plain", "uniform_plain", "DrawArgs",
    "draw_args",
]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

Word = Union[int, torch.Tensor]

# Launches of the draw kernel, counted by ``engine.kernels.threefry`` and
# reset by ``engine.kernels.reset_launches``.
KERNEL_LAUNCHES = 0
BITS, RANDINT, UNIFORM = 0, 1, 2  # the draw's sampler


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
    card = _card(key, device)
    if card is not None:
        return _draw(BITS, key, shape, card, offset=offset)
    return random_bits_plain(key, shape, device, offset)


def random_bits_plain(
    key: torch.Tensor,
    shape: Sequence[int],
    device: Optional[torch.device] = None,
    offset: int = 0,
) -> torch.Tensor:
    """:func:`random_bits` in int64 tensor ops on any device: the CPU's
    route, and the draw kernel's yardstick on the card."""
    device = key.device if device is None else torch.device(device)
    k1, k2 = _words(key)
    hi, lo = _iota_words(shape, device, offset)
    a, b = _threefry2x32(k1, k2, hi, lo)
    return a ^ b


def _span_mult(minval: int, maxval: int) -> Tuple[int, int]:
    """randint's span (1 where ``maxval <= minval``) and the multiplier
    ``2**32 % span`` of its combine, in uint32 as jax computes them."""
    span = (maxval - minval) & _M32 if maxval > minval else 1
    return span, (((2**16 % span) ** 2) & _M32) % span


def _int32_bounds(minval: int, maxval: int) -> Tuple[int, int]:
    minval, maxval = int(minval), int(maxval)
    if not (-(2**31) <= minval < 2**31 and -(2**31) <= maxval < 2**31):
        raise ValueError("randint bounds must fit in int32")
    return minval, maxval


def randint(
    key: torch.Tensor,
    shape: Sequence[int],
    minval: int,
    maxval: int,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``."""
    minval, maxval = _int32_bounds(minval, maxval)
    card = _card(key, device)
    if card is not None:
        return _draw(RANDINT, key, shape, card, minval=minval, maxval=maxval)
    return randint_plain(key, shape, minval, maxval, device)


def randint_plain(
    key: torch.Tensor,
    shape: Sequence[int],
    minval: int,
    maxval: int,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """:func:`randint` in int64 tensor ops on any device (as
    :func:`random_bits_plain`)."""
    minval, maxval = _int32_bounds(minval, maxval)
    ks = split(key, 2)
    higher = random_bits_plain(ks[0], shape, device)
    lower = random_bits_plain(ks[1], shape, device)
    # uint32 arithmetic as jax does it: products and sums wrap at 2**32.
    span, mult = _span_mult(minval, maxval)
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
    card = _card(key, device)
    if card is not None:
        return _draw(UNIFORM, key, shape, card, offset=offset)
    return uniform_plain(key, shape, device, offset)


def uniform_plain(
    key: torch.Tensor,
    shape: Sequence[int],
    device: Optional[torch.device] = None,
    offset: int = 0,
) -> torch.Tensor:
    """:func:`uniform` in int64 tensor ops on any device (as
    :func:`random_bits_plain`)."""
    bits = random_bits_plain(key, shape, device, offset)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


class DrawArgs(NamedTuple):
    """The draw kernel's launch arguments beside the output and a key on
    the card: the sampler (:data:`BITS`, :data:`RANDINT`, :data:`UNIFORM`),
    four key words from a key on the host (``random_bits``/``uniform``: the
    key's two and two zeros; ``randint``: ``split(key)``'s two keys; all
    zero for a key on the card, which the kernel reads and splits), the
    randint combine's ``span``, ``mult`` and ``minval``, and the two
    words of the flat counter's ``offset``."""

    sampler: int
    words: Tuple[int, int, int, int]
    span: int
    mult: int
    minval: int
    offset_hi: int
    offset_lo: int


def draw_args(
    sampler: int, key: torch.Tensor, offset: int = 0, minval: int = 0,
    maxval: int = 0,
) -> DrawArgs:
    """The launch arguments of a draw, computed as the plain draw computes
    them: ``split`` in Python integers, and :func:`randint`'s span and
    ``mult``."""
    offset = int(offset)
    if not 0 <= offset < 2**63:
        raise ValueError(f"offset {offset} is not a flat index")
    words = (0, 0, 0, 0)
    if key.device.type == "cpu":
        if sampler == RANDINT:
            (a1, a2), (b1, b2) = split(key, 2).tolist()
            words = (a1, a2, b1, b2)
        else:
            words = (*_words(key), 0, 0)
    elif key.device.type != "cuda":
        raise ValueError(f"no draw kernel for a key on {key.device}")
    span, mult = _span_mult(minval, maxval) if sampler == RANDINT else (1, 0)
    return DrawArgs(sampler, words, span, mult, int(minval), offset >> 32,
                    offset & _M32)


def _card(key: torch.Tensor, device) -> Optional[torch.device]:
    """The draw's device where it is a CUDA device (the kernel's route),
    else None (the plain route)."""
    d = key.device if device is None else torch.device(device)
    return d if d.type == "cuda" else None


def _draw(
    sampler: int, key: torch.Tensor, shape: Sequence[int], device: torch.device,
    offset: int = 0, minval: int = 0, maxval: int = 0,
) -> torch.Tensor:
    """A draw on a CUDA device: one launch of the draw kernel into a new
    output of the sampler's dtype."""
    from ..engine import kernels  # the engine imports this module

    args = draw_args(sampler, key, offset, minval, maxval)
    out = torch.empty(tuple(shape), dtype=kernels.DRAW_DTYPES[sampler], device=device)
    return kernels.threefry(out, args, None if key.device.type == "cpu" else key)
