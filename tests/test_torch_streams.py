"""The port's slice draws (``core/streams.py``) against jax and the
reference's ``repro.core.streams``, bitwise, in both threefry layouts.

Each slice must equal the same slice of the whole ``jax.random`` draw:
the streaming engine reads its chunk's uniforms this way and stays
bitwise equal to the monolithic round only if they are the same bits.
The layout is toggled on the jax side with ``jax.threefry_partitionable``
and passed to the port as its ``partitionable`` keyword.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import streams as jstreams
from repro_torch.core import prng, streams
from repro_torch.testing import key_to_torch

LAYOUTS = [False, True]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32)


def _slices(d):
    """(start, size) pairs: the whole draw, a middle slice, a tail that
    ends at d (an odd d's last, padded pair in the legacy layout), and one
    element at each end."""
    return [(0, d), (d // 3, d // 2), (d - d // 4 - 1, d // 4 + 1), (0, 1),
            (d - 1, 1)]


@pytest.mark.parametrize("partitionable", LAYOUTS)
@pytest.mark.parametrize("d", [17, 1000, 1001, 65536])
def test_uniform_block_matches_jax(partitionable, d):
    key = jax.random.PRNGKey(42)
    tk = key_to_torch(key)
    with jax.threefry_partitionable(partitionable):
        full = np.asarray(jax.random.uniform(key, (d,), jnp.float32))
        for start, size in _slices(d):
            got = streams.uniform_block(tk, start, size, d,
                                        partitionable=partitionable)
            ref = jstreams.uniform_block(key, start, size, d)
            assert got.dtype == torch.float32 and got.shape == (size,)
            np.testing.assert_array_equal(_bits(got), _bits(full[start:start + size]))
            np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("partitionable", LAYOUTS)
@pytest.mark.parametrize("d", [17, 1000, 1001, 65536])
def test_gumbel_block_matches_jax(partitionable, d):
    key = jax.random.PRNGKey(9)
    tk = key_to_torch(key)
    with jax.threefry_partitionable(partitionable):
        full = np.asarray(jax.random.gumbel(key, (d,), jnp.float32))
        for start, size in _slices(d):
            got = streams.gumbel_block(tk, start, size, d,
                                       partitionable=partitionable)
            ref = jstreams.gumbel_block(key, start, size, d)
            np.testing.assert_array_equal(_bits(got), _bits(full[start:start + size]))
            np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_gumbel_block_whole_is_prng_gumbel():
    """Over [0, total) the slice form is the whole draw: the Gumbel map of
    ``1 - tiny`` rounds to 1.0 in float32, so no FMA question arises."""
    total = 1_000_003
    key = jax.random.PRNGKey(9)
    got = streams.gumbel_block(key_to_torch(key), 0, total, total)
    whole = prng.gumbel(key_to_torch(key), (total,))
    assert torch.equal(got.view(torch.int32), whole.view(torch.int32))
    np.testing.assert_array_equal(
        _bits(got), _bits(jax.random.gumbel(key, (total,), jnp.float32)))


@pytest.mark.parametrize("partitionable", LAYOUTS)
@pytest.mark.parametrize("total", [501, 1000])
def test_uniform_at_matches_gather(partitionable, total):
    key = jax.random.PRNGKey(3)
    idx = np.array([0, 7, total - 1, total // 2, 7, total // 2 + 1, 1,
                    total - 1])                     # any order, repeats
    with jax.threefry_partitionable(partitionable):
        full = np.asarray(jax.random.uniform(key, (total,), jnp.float32))
        ref = jstreams.uniform_at(key, jnp.asarray(idx, jnp.int32), total)
    for index in (torch.from_numpy(idx), torch.from_numpy(idx).to(torch.int32)):
        got = streams.uniform_at(key_to_torch(key), index, total,
                                 partitionable=partitionable)
        np.testing.assert_array_equal(_bits(got), _bits(full[idx]))
        np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("partitionable", LAYOUTS)
def test_leading_key_dims(partitionable):
    """``keys[..., 2]`` draws one slice per key, as jax's ``vmap`` over
    the reference's functions does."""
    d, start, size = 1001, 400, 333
    keys = jax.random.split(jax.random.PRNGKey(5), 6)
    tk = key_to_torch(keys).reshape(2, 3, 2)
    idx = np.array([1000, 3, 3, 512])
    with jax.threefry_partitionable(partitionable):
        uni = jax.vmap(lambda k: jstreams.uniform_block(k, start, size, d))(keys)
        gum = jax.vmap(lambda k: jstreams.gumbel_block(k, start, size, d))(keys)
        at = jax.vmap(lambda k: jstreams.uniform_at(k, jnp.asarray(idx), d))(keys)
    kw = dict(partitionable=partitionable)
    for got, ref in ((streams.uniform_block(tk, start, size, d, **kw), uni),
                     (streams.gumbel_block(tk, start, size, d, **kw), gum),
                     (streams.uniform_at(tk, torch.from_numpy(idx), d, **kw), at)):
        assert got.shape == (2, 3, ref.shape[-1])
        np.testing.assert_array_equal(_bits(got.reshape(6, -1)), _bits(ref))


def test_partitionable_block_is_prng_uniform_slice():
    """The default layout is the one :mod:`prng` draws in: a block of a
    batch of keys is the slice of ``prng.uniform``'s ``[N, d]`` stack."""
    keys = prng.split(prng.PRNGKey(11, device="cpu"), 4)
    d = 70_001
    whole = prng.uniform(keys, (d,))
    for start in (0, 65_536, 69_999):
        size = min(4096, d - start)
        got = streams.uniform_block(keys, start, size, d)
        assert torch.equal(got.view(torch.int32),
                           whole[:, start:start + size].view(torch.int32))
