"""The port's FediAC round against the reference, bitwise: the vote
selection, the consensus selection, the round plan and the whole
``aggregate_stack`` for vote_chunk 1 and 4, fused kernels off and on.

The reference's selection takes different algorithms by size (a sort
below 2^17 votes, a sample-certified threshold above; top_k below 2^15
counts, a count bisection above); the port sorts at every size, so both
regimes are compared.  The reference's fused path runs its Pallas kernels
in interpret mode, as its own tests do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fediac as jfediac
from repro.core import round_plan as jplan
from repro.core import selection as jsel
from repro_torch.core import engines, fediac, round_plan, selection
from repro_torch.testing import key_to_torch

RNG = np.random.default_rng(0)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _updates(n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d))
            * rng.exponential(1.0, d)).astype(np.float32)


@pytest.mark.parametrize("n,d,k_frac", [
    (4, 3000, 0.05),        # reference: full sort
    (3, 140_000, 0.05),     # reference: sample-certified fast path (d >= 2^17)
])
def test_topk_counts_stack_bitwise(n, d, k_frac):
    scores = RNG.standard_normal((n, d)).astype(np.float32)
    scores[:, ::7] = np.round(scores[:, ::7])       # ties, broken by index
    k = max(1, int(round(k_frac * d)))
    got = selection.topk_counts_stack(torch.from_numpy(scores), k)
    want = jsel.topk_counts_stack(jnp.asarray(scores), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("d,capacity", [
    (5000, 250),            # reference: lax.top_k
    (40_000, 2000),         # reference: bisection (d >= 2^15)
    (40_000, 20_000),       # capacity >= d/4: lax.top_k again
])
def test_consensus_topk_bitwise(d, capacity):
    counts = RNG.binomial(8, 0.1, d).astype(np.int32)   # heavy ties
    vals, idx = selection.consensus_topk(torch.from_numpy(counts), capacity)
    jv, ji = jsel.consensus_topk(jnp.asarray(counts), capacity, n_max=8)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    assert idx.dtype == torch.int32


@pytest.mark.parametrize("floor", [0, 10_000])
@pytest.mark.parametrize("dense", [False, True])
def test_build_round_plan_bitwise(floor, dense):
    n, d = 10, 40_000
    counts = RNG.binomial(n, 0.08, d).astype(np.int32)
    jc = jfediac.FediACConfig(consensus_floor=floor)
    tc = fediac.FediACConfig(consensus_floor=floor)
    want = jplan.build_round_plan(jnp.asarray(counts), jc, n,
                                  with_dense_mask=dense)
    got = round_plan.build_round_plan(torch.from_numpy(counts), tc, n,
                                      with_dense_mask=dense)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(_bits(got.keep.numpy()), _bits(want.keep))
    if dense:
        np.testing.assert_array_equal(got.sel.numpy(), np.asarray(want.sel))
    else:
        assert got.sel is None


@pytest.mark.parametrize("vote_chunk", [1, 4])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_aggregate_stack_bitwise(vote_chunk, use_pallas):
    n, d = 6, 8192
    u = _updates(n, d, seed=vote_chunk)
    key = jax.random.PRNGKey(11)
    jc = jfediac.FediACConfig(vote_chunk=vote_chunk, use_pallas=use_pallas)
    tc = fediac.FediACConfig(vote_chunk=vote_chunk,
                             engine=engines.EngineSpec(use_pallas=use_pallas))
    dj, rj, cj, tj = jfediac.aggregate_stack(jnp.asarray(u), jc, key)
    dt, rt, ct, tt = fediac.aggregate_stack(torch.from_numpy(u), tc,
                                            key_to_torch(key))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(_bits(dt.numpy()), _bits(dj))
    np.testing.assert_array_equal(_bits(rt.numpy()), _bits(rj))
    assert (ct.dtype, dt.dtype, rt.dtype) == (torch.int32, torch.float32,
                                              torch.float32)
    assert tt == fediac.TrafficStats(**vars(tj))


def test_engine_spec_routes_the_fused_path():
    n, d = 4, 4096
    u = torch.from_numpy(_updates(n, d, seed=5))
    key = torch.tensor([0, 3])
    spec_cfg = fediac.FediACConfig(engine=engines.EngineSpec(use_pallas=True))
    assert spec_cfg.kernels and not fediac.FediACConfig().kernels
    a = fediac.aggregate_round(u, spec_cfg, key)
    b = fediac.aggregate_stack(u, spec_cfg, key)
    c = fediac.aggregate_stack(u, fediac.FediACConfig(), key)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[1], c[1])   # a different random stream
    with pytest.raises(TypeError):       # the spec is the only switch
        fediac.FediACConfig(use_pallas=True)


def test_counts_and_residual_conservation():
    n, d = 8, 20_000
    cfg = fediac.FediACConfig(engine=engines.EngineSpec(use_pallas=True))
    u = torch.from_numpy(_updates(n, d, seed=9))
    delta, res, counts, _ = fediac.aggregate_stack(u, cfg, torch.tensor([0, 1]))
    assert int(counts.sum()) == n * cfg.k(d)
    # what left the clients is what the mean applies, up to float rounding
    np.testing.assert_allclose((u - res).mean(0).numpy(), delta.numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("override", [
    dict(robust_agg="trim"), dict(robust_agg="median")])
def test_allreduce_refuses_robust_closes(override):
    """The robust closes are modes the allreduce does not take: it sums on
    the wire, and refuses them as the reference's does."""
    cfg = fediac.FediACConfig(**override)
    u = torch.from_numpy(_updates(4, 64, seed=2))
    with pytest.raises(ValueError, match="robust_agg"):
        fediac.fediac_allreduce(u[0], torch.zeros(64), torch.tensor([0, 0]),
                                cfg)


@pytest.mark.parametrize("override", [
    dict(robust_agg="trim"), dict(robust_agg="median")])
def test_robust_closes_run_in_stacked_round(override):
    cfg = fediac.FediACConfig(**override)
    u = torch.from_numpy(_updates(4, 64, seed=2))
    delta, res, _, _ = fediac.aggregate_stack(u, cfg, torch.tensor([0, 0]))
    assert bool(torch.isfinite(delta).all() and torch.isfinite(res).all())


@pytest.mark.parametrize("name", ["async"])
def test_unported_engines_raise(name):
    """No engine of the reference is left unported: ``"async"`` runs, and
    its round is ``aggregate_stack``'s bit for bit; an unknown name still
    raises."""
    assert engines.get(name) == engines.EngineSpec(name=name)
    u = torch.from_numpy(_updates(4, 64, seed=3))
    key = torch.tensor([0, 5])
    got = fediac.aggregate_round(u, fediac.FediACConfig(engine=name), key)
    want = fediac.aggregate_stack(u, fediac.FediACConfig(), key)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        engines.get("no-such-engine")
