"""The port's threefry stream against jax.random (partitionable layout):
every function bitwise, on several seeds and shapes, odd sizes included."""

import jax
import numpy as np
import pytest

from repro_torch.core import prng
from repro_torch.testing import key_to_torch

SEEDS = [0, 7, 2**31 + 5]
SHAPES = [(1,), (7,), (1001,), (3, 5)]


def _bits(a):
    return np.asarray(a).view(np.int32)


def test_prngkey_matches():
    for seed in SEEDS + [-1, 2**40 + 3]:
        np.testing.assert_array_equal(
            prng.PRNGKey(seed, device="cpu").numpy(),
            np.asarray(jax.random.PRNGKey(seed)).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [1, 2, 3, 17])
def test_split_bitwise(seed, num):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        prng.split(key_to_torch(key), num).numpy(),
        np.asarray(jax.random.split(key, num)).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 7001, 2**32 - 1])
def test_fold_in_bitwise(seed, data):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        prng.fold_in(key_to_torch(key), data).numpy(),
        np.asarray(jax.random.fold_in(key, data)).astype(np.int64))


def test_fold_in_rejects_out_of_range():
    with pytest.raises(OverflowError):
        prng.fold_in(prng.PRNGKey(0, device="cpu"), -1)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_bitwise(seed, shape):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        _bits(prng.uniform(key_to_torch(key), shape).numpy()),
        _bits(jax.random.uniform(key, shape)))
    np.testing.assert_array_equal(
        _bits(prng.uniform(key_to_torch(key), shape, -2.5, 3.0).numpy()),
        _bits(jax.random.uniform(key, shape, minval=-2.5, maxval=3.0)))


def test_uniform_over_a_key_stack_is_vmap():
    keys = jax.random.split(jax.random.PRNGKey(3), 5)
    want = jax.vmap(lambda k: jax.random.uniform(k, (333,)))(keys)
    np.testing.assert_array_equal(
        _bits(prng.uniform(key_to_torch(keys), (333,)).numpy()), _bits(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("bounds", [(0, 617), (0, 32), (-5, 2**31 - 1), (3, 3)])
def test_randint_bitwise(seed, bounds):
    key = jax.random.PRNGKey(seed)
    got = prng.randint(key_to_torch(key), (1001,), *bounds)
    assert got.dtype == prng.torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.random.randint(key, (1001,), *bounds)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(100_001,), (3, 333)])
def test_gumbel_bitwise(seed, shape):
    # exact, not within an ulp: XLA's log is replayed (core/xla_math.py)
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        _bits(prng.gumbel(key_to_torch(key), shape).numpy()),
        _bits(jax.random.gumbel(key, shape)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(100_001,), (64, 128)])
def test_normal_bitwise(seed, shape):
    # exact, not within an ulp: XLA's erf_inv is replayed (core/xla_math.py)
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        _bits(prng.normal(key_to_torch(key), shape).numpy()),
        _bits(jax.random.normal(key, shape)))
