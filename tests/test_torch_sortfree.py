"""The sort-free mode — threshold voting and block compaction — against
the reference, bitwise: the power-law threshold ``vote_tau`` in the
context each caller runs it, the threshold vote masks, the block
selection / compaction / scatter, the block round plan, and the stacked
``aggregate_stack`` over every mode pair that uses them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compaction as jcomp
from repro.core import fediac as jfediac
from repro.core import round_plan as jplan
from repro.core import voting as jvoting
from repro_torch.core import compaction, engines, fediac, round_plan, voting
from repro_torch.testing import key_to_torch

M = 0.7312345   # a max magnitude that is not a power of two
# the k of finding-2's sweep: every k up to 1003 and a stride to 200,000
KS = list(range(1, 1004)) + list(range(1004, 200_001, 997))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _port_taus(alpha, staged):
    m = torch.tensor(M, dtype=torch.float32)
    return np.array([float(voting.vote_tau(m, k, alpha, staged=staged))
                     for k in KS], np.float32)


@pytest.mark.parametrize("alpha", [-0.35, -0.5, -0.7, -1.0, -1.3, -2.0])
def test_vote_tau_matches_eager_reference(alpha):
    # the reference's aggregate_stack evaluates vote_tau eagerly
    m = jnp.float32(M)
    want = np.array([np.asarray(jvoting.vote_tau(m, k, alpha)) for k in KS])
    np.testing.assert_array_equal(_bits(_port_taus(alpha, staged=False)),
                                  _bits(want))


@pytest.mark.parametrize("alpha", [-1.0, -0.7])
def test_vote_tau_matches_staged_reference(alpha):
    # the reference's fediac_allreduce runs staged under shard_map, where
    # XLA folds k ** alpha at compile time and rewrites pow(k, -1) as 1/k
    ks = KS[:1003]
    staged = np.asarray(jax.jit(lambda m: jnp.stack(
        [jvoting.vote_tau(m, k, alpha) for k in ks]))(jnp.float32(M)))
    eager = np.array([np.asarray(jvoting.vote_tau(jnp.float32(M), k, alpha))
                      for k in ks])
    got = _port_taus(alpha, staged=True)[:1003]
    np.testing.assert_array_equal(_bits(got), _bits(staged))
    # the two contexts need different values exactly where XLA rewrites
    assert (staged != eager).any() == (alpha == -1.0)


@pytest.mark.parametrize("alpha", [-1.0, -0.7])
def test_threshold_vote_mask_bitwise(alpha):
    rng = np.random.default_rng(3)
    u = (rng.standard_normal((5, 20_000)) ** 3).astype(np.float32)
    k = 1000
    m = np.abs(u).max(1)
    want = jax.vmap(lambda s, mm: jvoting.threshold_vote_mask(
        s, k, mm, alpha))(jnp.asarray(u), jnp.asarray(m))
    got = voting.threshold_vote_mask(torch.from_numpy(u), k,
                                     torch.from_numpy(m), alpha)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    one = voting.threshold_vote_mask(torch.from_numpy(u[2]), k,
                                     torch.tensor(m[2]), alpha)
    np.testing.assert_array_equal(one.numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("d,block_size,capacity_frac", [
    (10_000, 4096, 0.05),    # ragged last block
    (12_288, 4096, 0.3),     # whole blocks, many overflow
    (777, 100, 0.5),
])
def test_block_select_compact_scatter_bitwise(d, block_size, capacity_frac):
    rng = np.random.default_rng(d)
    counts = rng.binomial(8, 0.12, d).astype(np.int32)
    values = rng.integers(-2**20, 2**20, d).astype(np.int32)
    a = 2
    jk, jp = jcomp.block_select(jnp.asarray(counts), a, block_size,
                                capacity_frac)
    tk, tp = compaction.block_select(torch.from_numpy(counts), a, block_size,
                                     capacity_frac)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert tp.dtype == torch.int32
    jb = jcomp.block_compact(jnp.asarray(values), jk, jp, block_size,
                             capacity_frac)
    tb = compaction.block_compact(torch.from_numpy(values), tk, tp,
                                  block_size, capacity_frac)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    js = jcomp.block_scatter(jb, jk, jp, d, block_size, capacity_frac)
    ts = compaction.block_scatter(tb, tk, tp, d, block_size, capacity_frac)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert compaction.block_plan(d, block_size, capacity_frac) == \
        jcomp.block_plan(d, block_size, capacity_frac)


def test_block_compact_stacks_row_by_row():
    rng = np.random.default_rng(1)
    counts = torch.from_numpy(rng.binomial(6, 0.2, 9000).astype(np.int32))
    keep, pos = compaction.block_select(counts, 2, 1000, 0.1)
    q = torch.from_numpy(rng.integers(-99, 99, (3, 9000)).astype(np.int32))
    stacked = compaction.block_compact(q, keep, pos, 1000, 0.1)
    for i in range(3):
        assert torch.equal(stacked[i],
                           compaction.block_compact(q[i], keep, pos, 1000, 0.1))


@pytest.mark.parametrize("floor", [0, 5000])
@pytest.mark.parametrize("dense", [False, True])
def test_block_round_plan_bitwise(floor, dense):
    n, d = 10, 40_000
    counts = np.random.default_rng(7).binomial(n, 0.08, d).astype(np.int32)
    jc = jfediac.FediACConfig(compact_mode="block", consensus_floor=floor)
    tc = fediac.FediACConfig(compact_mode="block", consensus_floor=floor)
    want = jplan.build_round_plan(jnp.asarray(counts), jc, n,
                                  with_dense_mask=dense)
    got = round_plan.build_round_plan(torch.from_numpy(counts), tc, n,
                                      with_dense_mask=dense)
    assert got.idx is None and got.keep is None and got.capacity == 0
    np.testing.assert_array_equal(got.keep_dense.numpy(),
                                  np.asarray(want.keep_dense))
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    if dense:
        np.testing.assert_array_equal(got.sel.numpy(), np.asarray(want.sel))
    else:
        assert got.sel is None


# block compaction keeps one vote per coordinate in the reference (it
# fails there at vote_chunk > 1), so block pairs run at vote_chunk 1
MODES = [(vm, cm, g) for vm, cm in [("threshold", "topk"), ("topk", "block"),
                                    ("threshold", "block")]
         for g in ((1, 4) if cm == "topk" else (1,))]


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("vote_mode,compact_mode,vote_chunk", MODES)
def test_aggregate_stack_sortfree_bitwise(vote_mode, compact_mode, vote_chunk,
                                          use_pallas):
    n, d = 6, 10_000
    rng = np.random.default_rng(vote_chunk)
    u = (rng.standard_normal((n, d)) * rng.exponential(1.0, d)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    kw = dict(vote_mode=vote_mode, compact_mode=compact_mode,
              vote_chunk=vote_chunk, alpha=-0.8)
    dj, rj, cj, tj = jfediac.aggregate_stack(
        jnp.asarray(u), jfediac.FediACConfig(use_pallas=use_pallas, **kw), key)
    dt, rt, ct, tt = fediac.aggregate_stack(
        torch.from_numpy(u),
        fediac.FediACConfig(engine=engines.EngineSpec(use_pallas=use_pallas),
                            **kw),
        key_to_torch(key))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(_bits(dt.numpy()), _bits(dj))
    np.testing.assert_array_equal(_bits(rt.numpy()), _bits(rj))
    assert ct.dtype == torch.int32 and int(ct.sum()) > 0
    assert tt == fediac.TrafficStats(**vars(tj))


def test_threshold_default_alpha_counts_match_reference():
    # alpha = -1 (the default): the eager tau is pow, not 1/k
    n, d = 4, 30_000
    u = (np.random.default_rng(2).standard_normal((n, d)) ** 3).astype(np.float32)
    key = jax.random.PRNGKey(0)
    jc = jfediac.FediACConfig(vote_mode="threshold")
    _, _, cj, _ = jfediac.aggregate_stack(jnp.asarray(u), jc, key)
    _, _, ct, _ = fediac.aggregate_stack(
        torch.from_numpy(u), fediac.FediACConfig(vote_mode="threshold"),
        key_to_torch(key))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
