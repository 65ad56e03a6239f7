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
