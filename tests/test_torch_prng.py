"""The PyTorch port's threefry PRNG equals ``jax.random`` bit for bit
(multiraft_tpu_torch/utils/prng.py).

Every draw site of the engine goes through these functions: the
initial deadlines (``randint`` under ``fold_in(key, 0)``), the per-tick
keys (``fold_in`` by tick number), the election jitter (``randint``
under ``fold_in(tick_key, 7)``) and the message drops (``split`` of
``fold_in(tick_key, 0xFA)`` into 4 keys, then ``uniform``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiraft_tpu_torch.utils import prng

# Small shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the host's cores.
torch.set_num_threads(1)

SEEDS = (0, 1, 12345, 2**31 - 1, -1)
SHAPES = ((16, 3), (37, 5), (4, 3, 3), (41, 5, 5), (7, 2, 3, 2))


def _same(jax_value, torch_value):
    a = np.asarray(jax_value)
    b = torch_value.numpy()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_fold_in_match_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    _same(jk, tk)
    for data in (0, 1, 7, 0xFA, 41, 999, 2**31 - 1):
        _same(jax.random.fold_in(jk, data), prng.fold_in(tk, data))
    # Chained as the driver derives them: per-tick key, then drop key.
    for tick in (1, 2, 50, 1000):
        jt, tt = jax.random.fold_in(jk, tick), prng.fold_in(tk, tick)
        _same(jt, tt)
        _same(jax.random.fold_in(jt, 0xFA), prng.fold_in(tt, 0xFA))
        _same(jax.random.fold_in(jt, 7), prng.fold_in(tt, 7))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", (2, 4, 5))
def test_split_matches_jax(seed, num):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    _same(jax.random.split(jk, num), prng.split(tk, num))
    jt, tt = jax.random.fold_in(jk, 0xFA), prng.fold_in(tk, 0xFA)
    _same(jax.random.split(jt, num), prng.split(tt, num))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_randint_matches_jax(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for lo, hi in ((30, 60), (0, 1), (-5, 17), (5, 5), (-(2**31), 2**31 - 1)):
        want = jax.random.randint(jk, shape, lo, hi, dtype=jnp.int32)
        _same(want, prng.randint(tk, shape, lo, hi))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_matches_jax(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    jks, tks = jax.random.split(jk, 4), prng.split(tk, 4)
    for i in range(4):
        got = prng.uniform(tks[i], shape)
        assert got.dtype == torch.float32
        _same(jax.random.uniform(jks[i], shape), got)


def test_tensor_key_path_equals_host_key_path():
    """A key on a device is derived with tensor arithmetic rather than
    host integers; the threefry block gives the same words either way."""
    for seed in SEEDS:
        k1, k2 = prng.PRNGKey(seed).tolist()
        t1, t2 = torch.tensor(k1), torch.tensor(k2)
        for x0, x1 in ((0, 0), (0, 7), (0, 0xFA), (3, 2**32 - 1)):
            a = prng._threefry2x32(k1, k2, x0, x1)
            b = prng._threefry2x32(t1, t2, torch.tensor(x0), torch.tensor(x1))
            assert a == (int(b[0]), int(b[1]))


def test_draws_land_on_the_requested_device_with_engine_dtypes():
    key = prng.PRNGKey(3)
    out = prng.randint(key, (4, 3), 30, 60, device="cpu")
    assert out.device.type == "cpu" and out.dtype == torch.int32
    assert ((out >= 30) & (out < 60)).all()
    u = prng.uniform(key, (4, 3, 3), device="cpu")
    assert u.dtype == torch.float32 and ((u >= 0) & (u < 1)).all()
    assert prng.fold_in(key, 11).dtype == torch.uint32
    with pytest.raises(ValueError):
        prng.PRNGKey(2**31)


# ---------------------------------------------------------------------------
# The draw kernel's host side (engine/csrc/threefry.cu runs on the card only)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _kernel_model(args, n):
    """What the draw kernel computes from its launch arguments, element by
    element in Python integers (threefry.cu's loop body)."""
    w, out = args.words, []
    for e in range(n):
        c = (args.offset_hi << 32 | args.offset_lo) + e
        hi, lo = c >> 32, c & _M32

        def bits(k0, k1):
            a, b = prng._threefry2x32(k0, k1, hi, lo)
            return a ^ b

        if args.sampler == prng.RANDINT:
            h, l = bits(w[0], w[1]) % args.span, bits(w[2], w[3]) % args.span
            v = ((h * args.mult + l) & _M32) % args.span + args.minval
            out.append(np.int32(((v + 2**31) & _M32) - 2**31))
        elif args.sampler == prng.UNIFORM:
            f = np.array([(bits(w[0], w[1]) >> 9) | 0x3F800000], np.uint32)
            out.append(f.view(np.float32)[0] - np.float32(1.0))
        else:
            out.append(np.int64(bits(w[0], w[1])))
    return np.array(out)


@pytest.mark.parametrize("seed", SEEDS)
def test_draw_args_equal_what_the_plain_draw_computes(seed):
    """The key words (split in Python integers), span, ``mult`` and the
    offset's hi/lo words that the wrapper packs give, through the kernel's
    arithmetic, the plain draw: at span 1, span 2**31 - 1, a negative
    ``minval``, and an offset whose counter passes 2**32."""
    key = prng.fold_in(prng.PRNGKey(seed), 7)
    shape = (7, 3)
    for lo, hi in ((30, 60), (10, 20), (5, 5), (9, 2), (0, 2**31 - 1), (-5, 17),
                   (-(2**31), 2**31 - 1)):
        args = prng.draw_args(prng.RANDINT, key, minval=lo, maxval=hi)
        assert args.span == (hi - lo if hi > lo else 1)
        want = prng.randint(key, shape, lo, hi).numpy().ravel()
        np.testing.assert_array_equal(_kernel_model(args, want.size), want)
    for offset in (0, 41, 2**32 - 5, 3 * 2**32 + 11):
        for sampler, draw in ((prng.BITS, prng.random_bits), (prng.UNIFORM, prng.uniform)):
            args = prng.draw_args(sampler, key, offset=offset)
            assert (args.offset_hi << 32 | args.offset_lo) == offset
            assert args.words[:2] == tuple(key.tolist()) and args.words[2:] == (0, 0)
            want = draw(key, shape, offset=offset).numpy().ravel()
            got = _kernel_model(args, want.size)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_a_cpu_draw_takes_the_plain_path(monkeypatch):
    from multiraft_tpu_torch.engine import kernels

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU draw reached the kernel")

    monkeypatch.setattr(kernels, "threefry", refuse)
    prng.KERNEL_LAUNCHES = 3
    kernels.reset_launches()
    assert prng.KERNEL_LAUNCHES == 0
    key = prng.PRNGKey(5)
    prng.randint(key, (6, 3), 30, 60)
    prng.uniform(key, (4, 3, 3), "cpu", offset=9)
    prng.random_bits(key, (5,), torch.device("cpu"))
    assert prng.KERNEL_LAUNCHES == 0


def test_the_draw_wrapper_refuses_what_the_kernel_does_not_take():
    """Checked before any launch, so without a card: the output's dtype,
    its layout, its device; the offset; the key's device."""
    from multiraft_tpu_torch.engine import kernels

    key = prng.PRNGKey(2)
    args = prng.draw_args(prng.RANDINT, key, minval=30, maxval=60)
    with pytest.raises(ValueError, match="int32 output"):
        kernels.threefry(torch.empty(8, dtype=torch.int64), args)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.threefry(torch.empty(4, 6, dtype=torch.int32).t(), args)
    with pytest.raises(ValueError, match="CUDA output"):
        kernels.threefry(torch.empty(8, dtype=torch.int32), args)
    with pytest.raises(ValueError, match="float32 output"):
        kernels.threefry(torch.empty(8, dtype=torch.int32),
                         prng.draw_args(prng.UNIFORM, key))
    with pytest.raises(ValueError, match="flat index"):
        prng.draw_args(prng.BITS, key, offset=-1)
    with pytest.raises(ValueError, match="no draw kernel"):
        prng.draw_args(prng.BITS, torch.zeros(2, dtype=torch.uint32, device="meta"))
