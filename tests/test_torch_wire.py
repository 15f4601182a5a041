"""The packed vote wire's kernels (B3 vote_pack, B4a pack, B4b unpack, B5
popcount_accum) against the reference package, bitwise.

On the CPU the kernel wrappers take their plain-torch versions; they are
held against the reference's Pallas kernels run in interpret mode,
through the reference's padded flat wrappers in ``kernels/ops.py``.  The
padded word count is the wire format, so the port's words must equal the
reference's word for word, their number included.  The kernels
themselves are held against the plain versions on the card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import bitpack, ops, ref, vote_pack, vote_popcount
from repro_torch.testing import to_numpy, to_torch

DS = [1, 70_001, 262_144, 300_000]


def _mask(d, density, seed):
    rng = np.random.default_rng(seed)
    return (rng.random(d) < density).astype(np.uint8)


@pytest.mark.parametrize("density", [0.0, 0.05, 1.0])
@pytest.mark.parametrize("d", DS)
def test_pack_and_unpack_match_reference(d, density):
    mask = _mask(d, density, seed=d)
    before = (bitpack.pack.launches, bitpack.unpack.launches)
    words = ops.pack_votes(torch.from_numpy(mask))
    want = jops.pack_votes(jnp.asarray(mask), interpret=True)
    assert words.dtype == torch.int32 and words.shape == want.shape
    assert words.numel() == ref.wire_groups(d) * ref.LANES
    np.testing.assert_array_equal(to_numpy(words, np.uint32), np.asarray(want))
    back = ops.unpack_votes(to_torch(want), d)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jops.unpack_votes(want, d, interpret=True)))
    np.testing.assert_array_equal(back.numpy(), mask)
    assert (bitpack.pack.launches, bitpack.unpack.launches) == before


def _scores(d, seed):
    rng = np.random.default_rng(seed)
    s = (rng.standard_normal(d) ** 3).astype(np.float32)
    s[3::997] = np.nan         # NaN never votes
    s[5::1009] = np.inf
    return s


@pytest.mark.parametrize("tau", ["zero", "data", "inf", "-inf"])
@pytest.mark.parametrize("d", DS)
def test_vote_pack_matches_reference(d, tau):
    s = _scores(d, seed=d + 1)
    t = {"zero": 0.0, "inf": math.inf, "-inf": -math.inf,
         # about the 5% largest magnitude, as threshold voting sets it
         "data": float(np.nanquantile(np.abs(s[np.isfinite(s)]), 0.95))}[tau]
    scores = torch.from_numpy(np.abs(s))
    before = vote_pack.vote_pack.launches
    words = ops.pack_votes_threshold(scores, torch.tensor(t))
    want = jops.pack_votes_threshold(jnp.asarray(np.abs(s)), jnp.float32(t),
                                     interpret=True)
    assert words.shape == want.shape
    np.testing.assert_array_equal(to_numpy(words, np.uint32), np.asarray(want))
    assert vote_pack.vote_pack.launches == before


@pytest.mark.parametrize("n", [1, 8, 64])
@pytest.mark.parametrize("d", [1, 70_001, 300_000])
def test_count_votes_matches_reference(n, d):
    rng = np.random.default_rng(n * d)
    words = rng.integers(0, 2**32, (n, ref.wire_groups(d) * ref.LANES),
                         dtype=np.uint32)
    before = vote_popcount.popcount_accum.launches
    counts = ops.count_votes(to_torch(words), d)
    want = jops.count_votes(jnp.asarray(words), d, interpret=True)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want))
    assert vote_popcount.popcount_accum.launches == before


def test_count_votes_sums_packed_masks():
    d, n = 70_001, 5
    masks = np.stack([_mask(d, 0.3, seed=s) for s in range(n)])
    words = torch.stack([ops.pack_votes(torch.from_numpy(m)) for m in masks])
    np.testing.assert_array_equal(ops.count_votes(words, d).numpy(),
                                  masks.sum(0))


def test_wrappers_reject_bad_operands():
    with pytest.raises(TypeError):
        bitpack.pack(torch.zeros(8, dtype=torch.int32))
    with pytest.raises(TypeError):
        bitpack.unpack(torch.zeros(8, 1000, dtype=torch.int32), 10)
    with pytest.raises(ValueError):
        bitpack.unpack(torch.zeros(1, ref.LANES, dtype=torch.int32),
                       ref.GROUP * ref.LANES + 1)
    with pytest.raises(TypeError):
        vote_pack.vote_pack(torch.zeros(8, dtype=torch.float64),
                            torch.tensor(0.0))
    with pytest.raises(ValueError):
        vote_pack.vote_pack(torch.zeros(8), torch.zeros(2))
    with pytest.raises(TypeError):
        vote_popcount.popcount_accum(torch.zeros(2, ref.LANES,
                                                 dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        vote_popcount.popcount_accum(
            torch.zeros(2, 1, ref.LANES, dtype=torch.int32),
            ref.GROUP * ref.LANES + 1)
